"""The port's Kohonen train step and checkpoints against the JAX package,
on the CPU, at tiny sizes (16 px, 1 layer, d = 32; two 3×3 maps, or two
5×6 maps for the checkpoints):

* one and three ``make_train_step`` steps against the JAX package's, with
  gradient accumulation 1 and 2: the metrics and every parameter, both
  maps' nodes to a tighter bound (their Hebbian deltas are summed over
  micro-batches and added after the update);
* a Kohonen checkpoint crossing both ways with ``nvit_tpu.ckpt``
  bit-equal, a resume from the JAX package's checkpoint and serving from a
  bf16 export.

The JAX side runs its plain attention and MLP on the CPU (no Pallas kernel
is forced); the port runs its kernels' plain twins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt import checkpoint as jax_ckpt
from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu.train.optim import FusedAdamWState as JaxAdamWState
from nvit_tpu.train.state import TrainState as JaxTrainState
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.ckpt import export as port_export
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train.optim import init_fused_adamw
from nvit_tpu_torch.train.state import TrainState
from nvit_tpu_torch.train.step import make_train_step
from nvit_tpu_torch.train.trainer import Trainer
from tests.torch_parity import kohonen_fields, kohonen_params, paired_configs

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- train steps
BATCH = 4
TRAIN_SECTIONS = dict(
    training=("TrainingConfig", dict(batch_size=BATCH)),
    # no warmup: every step moves the weights (lr = 1e-3, then cosine); a
    # strong Hebbian channel (α = min_lr = 0.2 scheduled up to 2.0) so the
    # deltas' sum and timing show in the nodes
    optimizer=("OptimizerConfig", dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=0, lr_decay_iters=10)),
    system=("SystemConfig", dict(remat=False, dtype="float32", log_gpu_stats=True)),
)
TRAIN_MODEL = dict(kohonen_alpha=2.0, kohonen_scheduler_enabled=True, kohonen_scheduler_warmup_steps=2,
                   kohonen_scheduler_decay_steps=6, kohonen_scheduler_min_lr=0.2)
METRICS = ("class_loss", "total_loss", "kohonen_consistency", "kohonen_smoothness", "local_quantization",
           "global_quantization", "reconstruction", "grad_norm", "param_norm")
NODES = ("local_kohonen.nodes", "global_kohonen.nodes")


def train_configs(accum: int):
    sections = dict(TRAIN_SECTIONS, training=("TrainingConfig", dict(batch_size=BATCH,
                                                                     gradient_accumulation_steps=accum)))
    return paired_configs(kohonen_fields(**TRAIN_MODEL), **sections)


def train_batches(cfg, n=3):
    rng = np.random.default_rng(21)
    m = cfg.model
    return [(rng.integers(0, 256, (BATCH, 3, m.image_size, m.image_size), dtype=np.uint8),
             rng.integers(0, m.num_classes, BATCH).astype(np.int32)) for _ in range(n)]


@pytest.fixture(scope="module")
def three_steps():
    """accum → (initial params, [(JAX params, JAX metrics, port params, port
    metrics) after steps 1, 2, 3]), each side run once for the module."""
    from nvit_tpu.train.optim import init_fused_adamw as jax_init
    from nvit_tpu.train.step import make_train_step as jax_make_train_step

    out = {}
    for accum in (1, 2):
        jcfg, cfg = train_configs(accum)
        params = kohonen_params(jcfg.model, seed=11)
        jstate = JaxTrainState(params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=jax_init(params),
                               step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
        jstep = jax.jit(jax_make_train_step(jcfg))
        model = ViT(cfg.model, device="cpu")
        model.load_state_dict(state_dict_from_jax(params, cfg.model), strict=True)
        state = TrainState(model=model, opt_state=init_fused_adamw(model.named_parameters()), step=0,
                           generator=torch.Generator())
        step = make_train_step(cfg)
        after = []
        for imgs, labels in train_batches(cfg):
            jstate, jm = jstep(jstate, jax_normalize(jnp.asarray(imgs)), jnp.asarray(labels))
            state, m = step(state, normalize(t(imgs)), t(labels))
            after.append((state_dict_from_jax(jax.device_get(jstate.params), cfg.model),
                          {k: float(jm[k]) for k in METRICS},
                          {n: p.detach().clone() for n, p in state.model.named_parameters()},
                          {k: float(m[k]) for k in METRICS}))
        out[accum] = (state_dict_from_jax(params, cfg.model), after)
    return out


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(three_steps, accum, steps):
    """fp32, after one and three steps: every metric (the Kohonen terms
    included) within 1e-4 relative; every parameter within 1e-4 (a tenth of
    lr), the whole update within 1e-5 relative L2; each map's nodes, which
    also take the Hebbian delta, within 1e-5 relative L2 of their update.
    With accumulation 2 the deltas of the two micro-batches are summed."""
    before, after = three_steps[accum]
    want, jm, got, m = after[steps - 1]
    for k in METRICS:
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
    diff2 = ref2 = 0.0
    for name, w in want.items():
        if name not in got:  # the maps' buffers
            assert torch.equal(w, before[name]), name
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-4, err_msg=name)
        d_got, d_want = got[name] - before[name], w - before[name]
        diff2 += float(torch.sum((d_got - d_want) ** 2))
        ref2 += float(torch.sum(d_want ** 2))
    assert diff2 ** 0.5 <= 1e-5 * ref2 ** 0.5
    for name in NODES:
        d_got, d_want = got[name] - before[name], want[name] - before[name]
        assert float((d_got - d_want).norm()) <= 1e-5 * float(d_want.norm()), name
    assert torch.equal(got["map_balance"], before["map_balance"])  # outside the loss: never moves


def test_hebbian_delta_is_what_moves_the_nodes(three_steps):
    """The Hebbian channel is most of the nodes' first update (so the step
    tests above see it): their update is 10× an Adam step's ±lr reach."""
    before, after = three_steps[1]
    _, _, got, _ = after[0]
    for name in NODES:
        assert float((got[name] - before[name]).abs().max()) > 1e-2, name


# ------------------------------------------------------------- checkpoints
CKPT_MODEL = kohonen_fields(kohonen_nodes=64, bias=True)


@pytest.fixture(scope="module")
def jax_kohonen_checkpoint(tmp_path_factory):
    """A Kohonen checkpoint the JAX package wrote: (directory, JAX state)."""
    jcfg, _ = paired_configs(CKPT_MODEL)
    params = kohonen_params(jcfg.model, seed=5)
    rng = np.random.default_rng(105)
    mu = jax.tree_util.tree_map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda a: rng.random(np.shape(a)).astype(np.float32), params)
    state = JaxTrainState(params=params, opt_state=JaxAdamWState(count=np.int32(7), mu=mu, nu=nu),
                          step=np.int32(7), rng=np.array([12345, 678], np.uint32))
    d = tmp_path_factory.mktemp("jax_kohonen")
    jax_ckpt.save_checkpoint(d, "checkpoint_latest", state, jcfg, {"val/loss": 2.0}, {"eval_count": 1})
    return d, state


def test_kohonen_checkpoint_crosses_both_ways(jax_kohonen_checkpoint, tmp_path):
    """The JAX package's checkpoint restores in the port bit-exact (params
    with the recomputed buffers, both moments, step, count, key); the port's
    own, every leaf moved, restores in the JAX package bit-exact."""
    d, js = jax_kohonen_checkpoint
    state, cfg, _ = port_ckpt.restore_for_resume(d, "checkpoint_latest", device="cpu")
    for got, want in ((state.model.state_dict(), js.params), (state.opt_state.mu, js.opt_state.mu),
                      (state.opt_state.nu, js.opt_state.nu)):
        want = state_dict_from_jax(want, cfg.model)
        for k, v in got.items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    assert set(state.opt_state.mu) == {n for n, _ in state.model.named_parameters()}
    assert (state.step, state.opt_state.count) == (7, 7)
    with torch.no_grad():
        for p in (*state.model.parameters(), *state.opt_state.mu.values(), *state.opt_state.nu.values()):
            p.add_(0.5)
    state.step = 9
    state.opt_state = dataclasses.replace(state.opt_state, count=9)
    port_ckpt.save_checkpoint(tmp_path, "checkpoint_best", state, cfg, {"val/loss": 1.5}, {})
    back, jcfg, _ = jax_ckpt.restore_for_resume(tmp_path, "checkpoint_best")
    assert jcfg.model.use_kohonen and jcfg.model.kohonen_nodes == 64
    got, want = jax.tree_util.tree_leaves(back), port_ckpt.state_leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)


def test_resume_from_jax_and_serve_an_export(jax_kohonen_checkpoint, tmp_path):
    """The port's Trainer resumes the JAX package's Kohonen checkpoint for
    two steps on synthetic data; its bf16 export serves probabilities within
    one bf16 rounding's reach of the fp32 checkpoint's (max |Δp| 2e-2)."""
    d, _ = jax_kohonen_checkpoint
    meta = port_ckpt.load_checkpoint_meta(d, "checkpoint_latest")
    cfg = port_ckpt.config_of(meta)
    cfg = dataclasses.replace(
        cfg,
        training=dataclasses.replace(cfg.training, init_from="resume", max_iters=9, eval_interval=100,
                                     log_interval=1, eval_iters=1, batch_size=4),
        system=dataclasses.replace(cfg.system, quick_validation_size=8, dtype="float32", remat=False),
        data=dataclasses.replace(cfg.data, dataset="synthetic", checkpoint_dir=str(d), out_dir=str(tmp_path),
                                 augmentation=port_schema.AugmentationConfig(auto_augment=False)))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.iter_num == 7
    trainer.train()
    assert (tmp_path / "finished").read_text() == "max_iters:9"
    port_export.export_for_inference(tmp_path, "checkpoint_latest", tmp_path / "deploy", dtype="bfloat16")
    served = Predictor.from_export(tmp_path / "deploy", "checkpoint_latest", device="cpu", compute_dtype=None)
    exact = Predictor.from_checkpoint(tmp_path, "checkpoint_latest", device="cpu", compute_dtype=None)
    imgs = np.random.default_rng(2).integers(0, 256, (3, 3, 16, 16), dtype=np.uint8)
    p, q = served.predict_probs(imgs), exact.predict_probs(imgs)
    assert p.shape == (3, 10) and np.isfinite(p).all() and np.abs(p - q).max() <= 2e-2
