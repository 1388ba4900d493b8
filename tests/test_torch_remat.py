"""Remat (``system.remat``, ``remat_skip_blocks``) and the training path it
opens, against the JAX package, on the CPU.

* the loss and every gradient bit-equal with remat off, on, and with the
  last block exempt (fp32 and bf16, nViT and baseline);
* the loss and gradients under remat against ``jax.grad`` of the JAX
  package's loss under remat (the Pallas kernels in the generic
  interpreter), at the bound of the port's step tests (1e-4 relative L2);
* the recompute: the port's attention and gated-MLP forwards run once more
  per rematted site, as many times as ``pallas_call`` appears in JAX's
  gradient jaxpr — at the tiny width here, and at path A's full width
  (traced abstractly) against the launches chip_smoke.py expects per step;
* ``Trainer`` on tiny CIFAR-100 files with AutoAugment and remat, and a
  resume with both on, bit-equal to a straight run.
"""

import dataclasses
import json
import pickle
from collections import Counter

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.configs import schema as jax_schema
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.presets import flagship_config, preset
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.ops import flash_attention as fa
from nvit_tpu_torch.ops import gated_mlp as gm
from nvit_tpu_torch.train.step import make_loss_fn
from nvit_tpu_torch.train.trainer import Trainer
from tests.torch_parity import baseline_params, random_jax_params

torch.set_num_threads(1)

MODES = {"nvit": dict(bias=True), "baseline": dict(bias=True, use_nvit=False)}


def configs(mode, remat, skip=0, dtype="float32", n_layer=2):
    """(JAX Config, port Config) of a tiny model, field for field equal."""
    model = preset("nvit-tiny4")
    model.update(n_layer=n_layer, num_classes=10, flash_attn=True, **MODES[mode])
    system = dict(remat=remat, remat_skip_blocks=skip, dtype=dtype)
    return tuple(mod.Config(model=mod.ViTConfig(**model), system=mod.SystemConfig(**system))
                 for mod in (jax_schema, port_schema))


def batch(cfg, n=4, seed=21):
    rng = np.random.default_rng(seed)
    s = cfg.model.image_size
    return rng.integers(0, 256, (n, 3, s, s), dtype=np.uint8), rng.integers(0, 10, n).astype(np.int32)


def port_grads(cfg, params, imgs, labels):
    model = ViT(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg.model), strict=True)
    loss, _ = make_loss_fn(cfg)(model, normalize(torch.from_numpy(imgs)), torch.from_numpy(labels).long())
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gradients_are_bit_equal(mode, dtype):
    _, cfg = configs(mode, False, dtype=dtype)
    params = (baseline_params if mode == "baseline" else random_jax_params)(cfg.model, seed=3)
    imgs, labels = batch(cfg)
    ref_loss, ref = port_grads(cfg, params, imgs, labels)
    for remat, skip in ((True, 0), (True, 1)):
        _, c = configs(mode, remat, skip, dtype)
        loss, got = port_grads(c, params, imgs, labels)
        assert torch.equal(loss, ref_loss)
        assert set(got) == set(ref) and all(torch.equal(got[n], g) for n, g in ref.items()), (remat, skip)


def pallas_calls(jaxpr, found: Counter) -> Counter:
    """``pallas_call`` equations of a jaxpr and its sub-jaxprs, by output shapes."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            found[tuple(tuple(v.aval.shape) for v in eqn.outvars)] += 1
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else [value]:
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    pallas_calls(sub.jaxpr, found)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    pallas_calls(sub, found)
    return found


def jax_grad_fn(jcfg):
    from nvit_tpu.train.step import make_loss_fn as jax_make_loss_fn

    loss_fn = jax_make_loss_fn(jcfg)
    return jax.value_and_grad(lambda p, x, y: loss_fn(p, x, y, jnp.zeros((), jnp.int32))[0])


def kernel_kind(shapes) -> str:
    """A pallas_call of the attention (its outputs [BH, T, D] …) or the
    gated MLP ([n, H] …), forward (1–2 outputs) or backward."""
    if len(shapes[0]) == 3:
        return "attention fwd" if len(shapes) == 2 else "attention bwd"
    return "gated fwd" if len(shapes) == 1 else "gated bwd"


def jax_kernel_counts(jcfg, *args) -> Counter:
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    with force_on_tpu(), generic_interpret_mode():
        jaxpr = jax.make_jaxpr(jax_grad_fn(jcfg))(*args)
    out = Counter()
    for shapes, n in pallas_calls(jaxpr.jaxpr, Counter()).items():
        out[kernel_kind(shapes)] += n
    return out


@pytest.fixture
def twin_calls(monkeypatch):
    """Calls of the kernels' CPU twins, by the kernel they stand for."""
    calls = Counter()

    def counted(module, name, kind):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    counted(fa, "flash_attention_qknorm_ref", "attention fwd")
    counted(fa, "qknorm_attention_bwd_ref", "attention bwd")
    counted(gm, "gated_mlp_ref", "gated fwd")
    counted(gm, "gated_mlp_duv_ref", "gated bwd")
    return calls


@pytest.mark.parametrize("remat,skip", [(False, 0), (True, 0), (True, 1)])
def test_remat_recomputes_the_kernels_as_jax_does_and_matches_its_gradients(twin_calls, remat, skip):
    """nViT with biases, fp32: the twins' calls per kernel equal JAX's
    pallas_call count per kernel (3 sites: the cross-attention and 2
    blocks; each rematted site's forwards twice), and the loss and every
    gradient within 1e-4 relative L2 of ``jax.grad``'s (summation order
    only, as tests/test_torch_train.py's bias gradients)."""
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    jcfg, cfg = configs("nvit", remat, skip)
    params = random_jax_params(jcfg.model, seed=5)
    imgs, labels = batch(cfg)
    x, y = normalize(torch.from_numpy(imgs)).numpy(), labels
    want = jax_kernel_counts(jcfg, params, x, y)
    rematted = 3 - skip if remat else 0
    assert want == {"attention fwd": 3 + rematted, "attention bwd": 3, "gated fwd": 3 + rematted, "gated bwd": 3}
    with force_on_tpu(), generic_interpret_mode():
        jloss, jgrads = jax.jit(jax_grad_fn(jcfg))(params, x, y)
    loss, grads = port_grads(cfg, params, imgs, labels)
    assert dict(twin_calls) == dict(want)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jgrads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg.model)
    floor = 1e-6 * max(float(g.norm()) for g in jgrads.values())
    for name, g in jgrads.items():
        got = grads.get(name, torch.zeros_like(g))
        if g.norm() <= floor:  # outside the loss (the reconstruction head)
            assert got.norm() <= floor, name
            continue
        assert float((got - g).norm() / g.norm()) <= 1e-4, name


def test_full_width_recompute_counts_are_chip_smokes():
    """At path A's full width (traced abstractly), JAX's gradient under
    remat holds the per-kernel pallas_call counts that chip_smoke.py
    expects the port to launch per step: 13 sites, each rematted one's
    forwards twice, with and without ``remat_skip_blocks``."""
    import chip_smoke
    from nvit_tpu.models.vit import init_vit

    port = flagship_config(bias=True)
    model = jax_schema.ViTConfig(**dataclasses.asdict(port.model))
    shapes = jax.eval_shape(lambda k: init_vit(k, model), jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((32, 3, 224, 224), jnp.float32)
    y = jax.ShapeDtypeStruct((32,), jnp.int32)
    n_pass = 1 + model.n_layer
    for remat, skip in ((False, 0), (True, 0), (True, chip_smoke.REMAT_SKIP)):
        jcfg = jax_schema.Config(model=model, system=jax_schema.SystemConfig(remat=remat, remat_skip_blocks=skip))
        got = jax_kernel_counts(jcfg, shapes, x, y)
        want = chip_smoke.remat_launches("nvit-bias", n_pass - skip if remat else 0, n_pass)
        assert got == {"attention fwd": want["qknorm_attn_fwd"], "attention bwd": want["qknorm_attn_bwd"],
                       "gated fwd": want["gated_mlp_fwd_bias"], "gated bwd": want["gated_mlp_bwd_bias"]}


# ------------------------------------------------------------------ trainer
def write_cifar100(root, n_train=64, n_test=16, seed=0):
    base = root / "cifar-100-python"
    base.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    proto = rng.randint(0, 256, (100, 3072))
    for split, n in (("train", n_train), ("test", n_test)):
        y = rng.randint(0, 100, n)
        x = np.clip(proto[y] + rng.randint(-30, 30, (n, 3072)), 0, 255).astype(np.uint8)
        (base / split).write_bytes(pickle.dumps({b"data": x, b"fine_labels": y.tolist(),
                                                 b"coarse_labels": (y // 5).tolist()}))


def cifar_config(root, out, **training):
    """The packaged settings' data and system sections (cifar100, AutoAugment,
    remat) on a 1-layer tiny model."""
    model = preset("nvit-tiny4")
    model.update(n_layer=1, num_classes=100, image_size=32, flash_attn=True, bias=True)
    return port_schema.Config(
        model=port_schema.ViTConfig(**model),
        training=port_schema.TrainingConfig(batch_size=8, max_iters=4, eval_interval=2, log_interval=1,
                                            eval_iters=1, **training),
        optimizer=port_schema.OptimizerConfig(warmup_iters=0, lr_decay_iters=10),
        system=port_schema.SystemConfig(remat=True, dtype="float32", quick_validation_size=8),
        data=port_schema.DataConfig(dataset="cifar100", data_dir=str(root), out_dir=str(out),
                                    checkpoint_dir=str(out), num_workers=2, prefetch=2))


def leaves_of(out_dir):
    with np.load(out_dir / "checkpoint_latest.npz") as z:
        return [z[k] for k in sorted(z.files, key=lambda k: int(k.split("_")[1]))]


def test_trainer_on_cifar_files_with_autoaugment_and_remat(tmp_path):
    write_cifar100(tmp_path / "data")
    cfg = cifar_config(tmp_path / "data", tmp_path / "out")
    assert cfg.data.augmentation.enabled and cfg.data.augmentation.auto_augment and cfg.system.remat
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    assert trainer.trainset.name == "cifar100" and len(trainer.trainset) == 64
    lines = [json.loads(x) for x in (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    logs = [x for x in lines if "train/batch_loss" in x]
    assert [x["train/iter"] for x in logs] == [1, 2, 3, 4]
    assert all(np.isfinite([x["train/batch_loss"], x["train/data_wait_ms"]]).all() for x in logs)
    assert (tmp_path / "out" / "finished").read_text() == "max_iters:4"


def test_resume_with_autoaugment_is_bit_equal_to_a_straight_run(tmp_path):
    """Each step's augmentation is keyed by the run key and the step, so a
    run relaunched after 2 of 4 iterations draws what the straight run drew
    and ends with the same weights and moments, bit for bit."""
    write_cifar100(tmp_path / "data")
    straight, relaunched = tmp_path / "a", tmp_path / "b"
    Trainer(cifar_config(tmp_path / "data", straight), device="cpu").train()
    first = Trainer(cifar_config(tmp_path / "data", relaunched, max_iters_per_launch=2), device="cpu")
    first.train()
    assert first.iter_num == 2
    resumed = Trainer(cifar_config(tmp_path / "data", relaunched, init_from="resume"), device="cpu")
    assert resumed.iter_num == 2
    resumed.train()
    a, b = leaves_of(straight), leaves_of(relaunched)
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    # a run keyed otherwise ends elsewhere: the augmentation reached the weights
    other = tmp_path / "c"
    trainer = Trainer(cifar_config(tmp_path / "data", other), device="cpu")
    trainer.state.rng = np.array([7, 7], np.uint32)
    trainer.train()
    assert not all(np.array_equal(x, y) for x, y in zip(a, leaves_of(other)))
