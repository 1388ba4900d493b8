"""Observability of the port's training (``obs/grad_hist.py``,
``obs/profiling.py``, the Trainer's histogram step, trace window and NaN
sanitizer) against the JAX package on the CPU.

* ``grad_histogram`` bins by the exact exponent (``frexp``): on random
  tensors with zeros, NaN, ±inf and a downsample its counts equal JAX's
  wherever XLA's ``log2`` floors to the exact exponent; at exact powers of
  two XLA's ``log2`` is not exact and JAX bins a few an octave low (2^13,
  2^15, 2^26, 2^27 among 2^-50..2^24; ROADMAP.md §3), where the port follows
  the bins' definition;
* one histogram step of a tiny model gives JAX's key set, each tensor's
  counts within 1% (L1) of JAX's;
* the Trainer logs histograms only at the evals fed by a histogram step;
* ``profile_steps=2`` writes a trace under ``out_dir/profile`` that holds
  the step's ``nvit.step.*`` spans, and ``maybe_trace`` writes one when
  enabled;
* a step with two micro-batches under a profiler records the forward and
  backward spans twice and the update once, on the host only; a profiler
  of all threads records the serving batcher's spans on its thread;
* ``debug_nans`` raises ``FloatingPointError`` on a step with a NaN input,
  as the JAX step does under ``jax_debug_nans``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu.obs import grad_hist as jax_hist
from nvit_tpu.train.optim import init_fused_adamw as jax_init_adamw
from nvit_tpu.train.state import TrainState as JaxState
from nvit_tpu.train.step import make_train_step as jax_make_train_step
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.obs import grad_hist
from nvit_tpu_torch.obs.profiling import maybe_trace
from nvit_tpu_torch.serve import InferenceService
from nvit_tpu_torch.train.optim import init_fused_adamw
from nvit_tpu_torch.train.state import TrainState, create_train_state
from nvit_tpu_torch.train.step import make_train_step
from nvit_tpu_torch.train.trainer import Trainer
from tests.torch_ckpt_cases import trainer_config
from tests.torch_parity import kohonen_fields, paired_configs, random_jax_params
from tests.torch_serving import _FakePredictor

torch.set_num_threads(1)


def exact_bins(x: np.ndarray) -> np.ndarray:
    """The bins' definition, in float64: bin 0 below 2^MIN_EXP, then one octave each, 63 for ±inf/NaN."""
    mag = np.abs(x.astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        idx = np.clip(np.floor(np.log2(np.maximum(mag, 2.0 ** grad_hist.MIN_EXP))) - (grad_hist.MIN_EXP - 1), 0, 63)
    idx = np.where(mag < 2.0 ** grad_hist.MIN_EXP, 0, idx)
    return np.where(np.isfinite(mag), idx, 63).astype(np.int64)


def test_grad_histogram_matches_jax():
    np.testing.assert_array_equal(grad_hist.histogram_edges(), jax_hist.histogram_edges())
    assert (grad_hist.BINS, grad_hist.MIN_EXP, grad_hist.MAX_ELEMS) == (
        jax_hist.BINS, jax_hist.MIN_EXP, jax_hist.MAX_ELEMS)
    rng = np.random.default_rng(0)
    for n in (1000, 65537):
        x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-16, 6, n)).astype(np.float32)
        x[::97] = 0
        x[1::101] = np.nan
        x[2::103] = np.inf
        x[3::107] = -np.inf
        got = grad_hist.grad_histogram(torch.from_numpy(x)).numpy()
        want = np.asarray(jax_hist.grad_histogram(jnp.asarray(x)))
        kept = x[::-(-n // grad_hist.MAX_ELEMS)] if n > grad_hist.MAX_ELEMS else x
        assert got.dtype == np.int32 and got.sum() == kept.size
        np.testing.assert_array_equal(got, np.bincount(exact_bins(kept), minlength=64))
        # JAX's per-element bins, by its own expression: equal to the port's
        # wherever XLA's log2 floors to the exact exponent
        mag = jnp.abs(jnp.asarray(kept))
        jbin = jnp.clip(jnp.floor(jnp.log2(jnp.maximum(mag, 2.0 ** jax_hist.MIN_EXP))) - (jax_hist.MIN_EXP - 1), 0, 63)
        jbin = np.asarray(jnp.where(jnp.isnan(mag), 63.0, jnp.where(mag < 2.0 ** jax_hist.MIN_EXP, 0.0, jbin)))
        np.testing.assert_array_equal(want, np.bincount(jbin.astype(np.int64), minlength=64))
        misbinned = jbin != exact_bins(kept)
        assert misbinned.sum() <= 2, misbinned.sum()  # measured 0–1 per tensor
        np.testing.assert_array_equal(got, want + np.bincount(exact_bins(kept)[misbinned], minlength=64)
                                      - np.bincount(jbin[misbinned].astype(np.int64), minlength=64))
    # exact powers of two: the port by the definition; XLA's log2 puts some an octave low
    x = np.ldexp(1.0, np.arange(-50, 25)).astype(np.float32)
    np.testing.assert_array_equal(grad_hist.grad_histogram(torch.from_numpy(x)).numpy(),
                                  np.bincount(exact_bins(x), minlength=64))


BATCH = 4


def configs(**system):
    return paired_configs(kohonen_fields(use_kohonen=False), training=("TrainingConfig", dict(batch_size=BATCH)),
                          optimizer=("OptimizerConfig", dict(learning_rate=1e-3, warmup_iters=0)),
                          system=("SystemConfig", dict(remat=False, dtype="float32", **system)))


def port_state(pcfg, params):
    model = ViT(pcfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, pcfg.model), strict=True)
    return TrainState(model=model, opt_state=init_fused_adamw(model.named_parameters()), step=0,
                      generator=torch.Generator())


def jax_state(params):
    return JaxState(params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=jax_init_adamw(params),
                    step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))


def batch(m, seed=21):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (BATCH, 3, m.image_size, m.image_size), dtype=np.uint8),
            rng.integers(0, m.num_classes, BATCH).astype(np.int32))


def test_histogram_step_matches_jax():
    jcfg, pcfg = configs()
    params = random_jax_params(jcfg.model, seed=11)
    imgs, labels = batch(jcfg.model)
    _, jm = jax.jit(jax_make_train_step(jcfg, log_histograms=True))(
        jax_state(params), jax_normalize(jnp.asarray(imgs)), jnp.asarray(labels))
    _, pm = make_train_step(pcfg, log_histograms=True)(
        port_state(pcfg, params), normalize(torch.from_numpy(imgs)), torch.from_numpy(labels))
    want = {k: np.asarray(v) for k, v in jm.items() if k.startswith("gradhist/")}
    got = {k: v.numpy() for k, v in pm.items() if k.startswith("gradhist/")}
    assert set(got) == set(want) and len(got) > 30
    for k, w in want.items():
        assert got[k].dtype == np.int32 and got[k].sum() == w.sum(), k
        assert np.abs(got[k] - w).sum() <= 0.01 * w.sum(), k
    assert not any(k.startswith("gradhist/") for k in make_train_step(pcfg)(
        port_state(pcfg, params), normalize(torch.from_numpy(imgs)), torch.from_numpy(labels))[1])


def test_trainer_logs_histograms_only_at_eval_cadence(tmp_path):
    cfg = trainer_config(tmp_path, training=dict(max_iters=6, eval_interval=2, log_interval=1),
                         system=dict(remat=False, dtype="float32", quick_validation_size=8,
                                     log_grad_histograms=True))
    trainer = Trainer(cfg, device="cpu")
    steps = []
    hist_step = trainer._train_step_hist
    trainer._train_step_hist = lambda *a: (steps.append(trainer.iter_num), hist_step(*a))[1]
    trainer.train()
    # the steps feeding the evals at 2 and 4; the one reaching max_iters (6) runs no histograms
    assert steps == [1, 3]
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    with_hist = [x["_step"] for x in lines if any(k.startswith("gradhist/") for k in x)]
    assert with_hist == [2, 4]
    n_params = sum(1 for _ in trainer.state.model.parameters())
    for line in lines:
        hists = {k: v for k, v in line.items() if k.startswith("gradhist/")}
        assert not hists or ("val/loss" in line and len(hists) == n_params)
        for k, counts in hists.items():
            assert len(counts) == 64 and sum(counts) > 0, k


def test_profile_steps_write_a_trace(tmp_path):
    cfg = trainer_config(tmp_path, system=dict(remat=False, dtype="float32", quick_validation_size=8,
                                               profile_steps=2))
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    assert trainer._trace is None
    traces = list((tmp_path / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    names = {e.get("name") for e in events}
    assert {"nvit.step.forward", "nvit.step.backward", "nvit.step.update"} <= names
    # the context manager: a trace when enabled, nothing otherwise
    for enabled in (False, True):
        with maybe_trace(tmp_path / str(enabled), enabled, torch.device("cpu")):
            torch.ones(4).add_(1)
        assert (tmp_path / str(enabled) / "profile").exists() == enabled


def test_step_spans_per_micro_batch(tmp_path):
    cfg = trainer_config(tmp_path, training=dict(gradient_accumulation_steps=2))
    step = make_train_step(cfg)
    state = create_train_state(cfg, device="cpu")
    imgs = torch.zeros(4, 3, 16, 16)
    labels = torch.arange(4) % 10
    step(state, imgs, labels)  # the first call's one-off work outside the profile
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, imgs, labels)
    spans = [e for e in prof.events() if e.name.startswith("nvit.")]
    assert sorted(e.name for e in spans) == ["nvit.step.backward"] * 2 + ["nvit.step.forward"] * 2 + [
        "nvit.step.update"]
    # host ranges of FUNCTION scope (0), as an autograd.Function's, not USER_SCOPE
    assert all(e.device_type == torch.autograd.DeviceType.CPU and e.scope == 0 for e in spans)
    forward, backward, update = (sorted((e for e in spans if e.name == n), key=lambda e: e.time_range.start)
                                 for n in ("nvit.step.forward", "nvit.step.backward", "nvit.step.update"))
    assert (forward[0].time_range.end <= backward[0].time_range.start <= forward[1].time_range.start
            <= backward[1].time_range.start <= update[0].time_range.start)
    assert any(e.name.startswith("aten::") and update[0].time_range.start <= e.time_range.start
               <= update[0].time_range.end for e in prof.events())


def test_serving_spans_on_the_batcher_thread():
    service = InferenceService(_FakePredictor(), max_batch=8, batch_window_ms=20)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    experimental_config=config) as prof:
            service.predict(np.zeros((1, 3, 4, 4), np.uint8))
    finally:
        service.close()
    spans = {e.name: e for e in prof.events() if e.name.startswith("nvit.")}
    assert set(spans) == {"nvit.serve.window", "nvit.serve.batch", "nvit.serve.forward"}
    assert spans["nvit.serve.window"].time_range.elapsed_us() >= 20e3
    assert len({e.thread for e in spans.values()}) == 1 and all(e.scope == 0 for e in spans.values())


def test_debug_nans_raises_where_jax_raises(tmp_path):
    jcfg, pcfg = configs(debug_nans=True)
    params = random_jax_params(jcfg.model, seed=12)
    imgs, labels = batch(jcfg.model)
    images = np.array(jax_normalize(jnp.asarray(imgs)))
    images[0, 0, 3, 5] = np.nan
    with jax.debug_nans(True), pytest.raises(FloatingPointError):
        jax.jit(jax_make_train_step(jcfg))(jax_state(params), jnp.asarray(images), jnp.asarray(labels))
    with pytest.raises(FloatingPointError, match="the loss"):
        make_train_step(pcfg)(port_state(pcfg, params), torch.from_numpy(images), torch.from_numpy(labels))
    # finite inputs pass the check, and the Trainer runs with it
    make_train_step(pcfg)(port_state(pcfg, params), normalize(torch.from_numpy(imgs)), torch.from_numpy(labels))
    Trainer(trainer_config(tmp_path, training=dict(max_iters=2),
                           system=dict(remat=False, dtype="float32", quick_validation_size=8, debug_nans=True)),
            device="cpu").train()
