"""bf16 AdamW moments with stochastic rounding (``optimizer.moments_dtype=
"bfloat16"``): the port's ``train/optim.py`` against ``nvit_tpu.train.optim``
on the CPU.

* the SR store of a port-layout fp32 tensor, read in the JAX leaf's layout,
  equals ``sr_bf16_hash`` / ``sr_bf16`` of the JAX-layout array bit for bit,
  for a linear weight, both patch embeds, a 1-D and a 0-D leaf, with a value
  that carries into the exponent, ±inf, NaN and the largest float;
* the per-leaf salts are ``crc32(keystr(path))`` of the JAX tree's paths;
* three training steps against JAX's ``make_train_step`` (the default hash
  dither; threefry's bits are held exactly above): parameters within
  ``tests/test_torch_train.py``'s fp32 bound (1e-4 a weight); moments
  bit-equal in ≥ 99.5% of elements, within one bf16 ulp in ≥ 99.9%, and the
  rest within 1e-2 of their leaf's largest magnitude.  The steps' fp32 noise
  moves a value across a dithered boundary now and then: measured 99.80%
  bit-equal at this config (99.90% at 2 layers), 2.5e-3 of the largest
  magnitude at worst, on near-cancellations of the momentum where the same
  steps with fp32 moments already differ by up to 8% relative;
* bf16-moment checkpoints cross both ways with ``nvit_tpu.ckpt``;
* a resumed run is bit-equal to a straight one, both dithers.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu.train import optim as jax_optim
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.ckpt.convert import jax_order, jax_path, state_dict_from_jax
from nvit_tpu_torch.configs import OptimizerConfig
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train import optim
from nvit_tpu_torch.train.state import TrainState
from nvit_tpu_torch.train.step import make_train_step
from nvit_tpu_torch.train.trainer import Trainer
from tests.torch_ckpt_cases import trainer_config
from tests.torch_parity import kohonen_fields, paired_configs, random_jax_params

torch.set_num_threads(1)

DITHERS = ("hash", "threefry")
# one leaf of each layout class: (port name, port shape) at local patch 4
LEAVES = [("transformer.h.0.c_fc.weight", (48, 16)), ("local_patch_embed.weight", (8, 3, 4, 4)),
          ("global_patch_embed.1.weight", (8, 3, 8, 8)), ("sz", (10,)), ("map_balance", ())]


def f32(bits: int) -> np.float32:
    return np.array([bits], np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("dither", DITHERS)
def test_sr_store_matches_jax_bit_for_bit(dither):
    rng = np.random.default_rng(0)
    cfg = OptimizerConfig(moments_dtype="bfloat16", sr_dither=dither)
    for name, shape in LEAVES:
        t = torch.zeros(shape)
        view = jax_order(name, t, 4)
        x = (rng.standard_normal(view.numel()) * 1e-3).astype(np.float32)
        if x.size > 6:  # carries into the exponent, ±inf, NaN, the largest float, 0
            x[:7] = [f32(0x3F7FFFFF), np.inf, -np.inf, np.nan, f32(0x7F7FFFFF), -f32(0x7F7FFFFF), 0.0]
        view.copy_(torch.from_numpy(x.reshape(view.shape)))
        index = optim.jax_index(name, shape, 4, "cpu")
        for count, salt in ((7, 0), (123456, 1)):
            pid = optim.leaf_salt(name)
            got = optim.sr_store(cfg, count, name, index)(t, salt)
            got = jax_order(name, got.view(torch.int16), 4).reshape(-1).numpy().view(np.uint16)
            if dither == "hash":
                seed = jax_optim._fmix32(jnp.uint32(count) ^ (jnp.uint32(2 * pid + salt) * jnp.uint32(0x9E3779B9)))
                want = jax_optim.sr_bf16_hash(jnp.asarray(x), seed)
            else:
                key = jax.random.fold_in(jax.random.PRNGKey(0x51AB), jnp.int32(count))
                want = jax_optim.sr_bf16(jnp.asarray(x), jax.random.fold_in(key, 2 * pid + salt))
            want = np.asarray(want).view(np.uint16).reshape(-1)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} count {count} salt {salt}")
    # the dither rounds up with probability fraction/ulp: 0x3F7FFFFF → 1.0 in some stores
    assert optim.sr_with_bits(torch.tensor([f32(0x3F7FFFFF)]), torch.tensor([0xFFFF])).item() == 1.0


def test_leaf_paths_and_salts_match_jax():
    from nvit_tpu.configs import schema as jax_schema
    from nvit_tpu.models.vit import init_vit
    from nvit_tpu_torch.configs import ViTConfig

    for fields in (kohonen_fields(), kohonen_fields(use_kohonen=False, use_nvit=False, bias=True)):
        shapes = jax.eval_shape(lambda k: init_vit(k, jax_schema.ViTConfig(**fields)), jax.random.PRNGKey(0))
        paths = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): jax.tree_util.keystr(p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        names = [n for n, _ in ViT(ViTConfig(**fields), device="cpu").named_parameters()]
        assert sorted(map(str, (jax_path(n) for n in names))) == sorted(map(str, paths))
        for name in names:
            keystr = paths[jax_path(name)]
            assert optim.keystr(jax_path(name)) == keystr
            assert optim.leaf_salt(name) == zlib.crc32(keystr.encode()) & 0x3FFFFFFF


BATCH = 4


def step_configs(dither):
    model = kohonen_fields(use_kohonen=False, n_layer=1, n_head=2, n_embd=32)
    return paired_configs(model, training=("TrainingConfig", dict(batch_size=BATCH)),
                          optimizer=("OptimizerConfig", dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=0,
                                                             lr_decay_iters=10, moments_dtype="bfloat16",
                                                             sr_dither=dither)),
                          system=("SystemConfig", dict(remat=False, dtype="float32")))


def step_batches(m):
    rng = np.random.default_rng(21)
    return [(rng.integers(0, 256, (BATCH, 3, m.image_size, m.image_size), dtype=np.uint8),
             rng.integers(0, m.num_classes, BATCH).astype(np.int32)) for _ in range(3)]


def test_three_bf16_moment_steps_match_jax(dither="hash"):
    from nvit_tpu.train.state import TrainState as JaxState
    from nvit_tpu.train.step import make_train_step as jax_make_train_step

    jcfg, pcfg = step_configs(dither)
    params = random_jax_params(jcfg.model, seed=11)
    jstate = JaxState(params=jax.tree_util.tree_map(jnp.asarray, params),
                      opt_state=jax_optim.init_fused_adamw(params, "bfloat16"),
                      step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(jcfg))
    model = ViT(pcfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, pcfg.model), strict=True)
    state = TrainState(model=model, step=0, generator=torch.Generator(),
                       opt_state=optim.init_fused_adamw(model.named_parameters(), "bfloat16"))
    step = make_train_step(pcfg)
    for imgs, labels in step_batches(jcfg.model):
        jstate, _ = jstep(jstate, jax_normalize(jnp.asarray(imgs)), jnp.asarray(labels))
        state, _ = step(state, normalize(torch.from_numpy(imgs)), torch.from_numpy(labels))
    assert state.opt_state.count == 3 == int(jstate.opt_state.count)

    got = {n: p.detach() for n, p in model.named_parameters()}
    for name, w in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), pcfg.model).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-4, err_msg=name)
    same = within_ulp = total = 0
    for mine, theirs in ((state.opt_state.mu, jstate.opt_state.mu), (state.opt_state.nu, jstate.opt_state.nu)):
        bits = jax.tree_util.tree_map(lambda a: np.asarray(a).view(np.int16), theirs)
        for name, t in state_dict_from_jax(bits, pcfg.model).items():
            assert mine[name].dtype == torch.bfloat16
            a, b = mine[name].view(torch.int16).int(), t.int()
            # one bf16 ulp is one step of the bit pattern where the signs agree
            same += int((a == b).sum())
            within_ulp += int(((a - b).abs() <= 1).sum())
            total += a.numel()
            beyond = (a - b).abs() > 1
            if beyond.any():
                fa, fb = mine[name].float(), t.view(torch.bfloat16).float()
                assert float((fa - fb).abs()[beyond].max()) <= 1e-2 * float(fb.abs().max()), name
    assert same >= 0.995 * total, (same, total)
    assert within_ulp >= 0.999 * total, (within_ulp, total)
    assert any(bool(m.any()) for m in state.opt_state.nu.values())


def test_bf16_moment_checkpoints_cross_both_ways(tmp_path):
    from nvit_tpu.ckpt.checkpoint import restore_for_resume as jax_restore
    from nvit_tpu.ckpt.checkpoint import save_checkpoint as jax_save
    from nvit_tpu.train.state import TrainState as JaxState

    jcfg, pcfg = step_configs("hash")
    rng = np.random.default_rng(5)
    # the port's: random bf16 moments, saved, restored by the JAX package
    model = ViT(pcfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(random_jax_params(jcfg.model, seed=3), pcfg.model), strict=True)
    opt = optim.init_fused_adamw(model.named_parameters(), "bfloat16")
    for tree in (opt.mu, opt.nu):
        for t in tree.values():
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    opt.count = 4
    state = TrainState(model=model, opt_state=opt, step=4, generator=torch.Generator())
    port_ckpt.save_checkpoint(tmp_path, "port", state, pcfg)
    jstate, _, _ = jax_restore(tmp_path, "port")
    want = port_ckpt.state_leaves(state)
    got = jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            a = a.view(np.int16).view("V2")
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    # the JAX package's: saved, restored by the port
    params = random_jax_params(jcfg.model, seed=4)
    jopt = jax_optim.init_fused_adamw(params, "bfloat16")
    rand = lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.bfloat16)  # noqa: E731
    jopt = jopt._replace(mu=jax.tree_util.tree_map(rand, jopt.mu), nu=jax.tree_util.tree_map(rand, jopt.nu),
                         count=jnp.asarray(6, jnp.int32))
    jstate = JaxState(params=params, opt_state=jopt, step=jnp.asarray(6, jnp.int32), rng=jax.random.PRNGKey(1))
    jax_save(tmp_path, "jax", jstate, jcfg)
    restored, _, _ = port_ckpt.restore_for_resume(tmp_path, "jax", device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in restored.opt_state.mu.values())
    with np.load(tmp_path / "jax.npz") as z:
        want = [z[f"leaf_{i}"] for i in range(len(z.files))]
    got = port_ckpt.state_leaves(restored)
    assert len(got) == len(want)
    assert all(a.dtype.itemsize == b.dtype.itemsize and a.shape == b.shape and a.tobytes() == b.tobytes()
               for a, b in zip(got, want))


@pytest.mark.parametrize("dither", DITHERS)
def test_bf16_moment_resume_is_bit_equal_to_a_straight_run(tmp_path, dither):
    opt = dict(warmup_iters=0, lr_decay_iters=10, moments_dtype="bfloat16", sr_dither=dither)
    straight, relaunched = tmp_path / "a", tmp_path / "b"
    Trainer(trainer_config(straight, optimizer=opt), device="cpu").train()
    first = Trainer(trainer_config(relaunched, optimizer=opt, training=dict(max_iters_per_launch=2)),
                    device="cpu")
    first.train()
    assert first.iter_num == 2
    resumed = Trainer(trainer_config(relaunched, optimizer=opt, training=dict(init_from="resume")), device="cpu")
    assert next(iter(resumed.state.opt_state.mu.values())).dtype == torch.bfloat16
    resumed.train()
    with np.load(straight / "checkpoint_latest.npz") as za, np.load(relaunched / "checkpoint_latest.npz") as zb:
        assert za.files == zb.files
        assert all(za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes() for k in za.files)
        assert any(za[k].dtype.kind == "V" for k in za.files)  # the moments, as bf16 records


def test_init_fused_adamw_takes_both_dtypes():
    named = [("w", torch.ones(2, 3)), ("b", torch.ones(3))]
    for dtype in ("float32", "bfloat16"):
        state = optim.init_fused_adamw(named, dtype)
        assert all(t.dtype == getattr(torch, dtype) and not t.any() for t in (*state.mu.values(), *state.nu.values()))
    with pytest.raises(ValueError, match="moments_dtype"):
        optim.init_fused_adamw(named, "float16")
    assert dataclasses.is_dataclass(state)
