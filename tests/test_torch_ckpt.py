"""The port's checkpoint files against the JAX package's, on the CPU.

* ``ckpt/tree.py``'s skeleton and flatten order against
  ``jax.tree_util.tree_flatten_with_path(create_train_state(cfg))`` (paths,
  shapes, dtypes) and its run key against ``jax.random.split``, for nViT and
  baseline, each with and without biases;
* a checkpoint written by ``nvit_tpu.ckpt.checkpoint.save_checkpoint``
  restores in the port bit-exact (every param and moment after the layout
  transform, ``step``, ``count``, ``rng``, ``meta["trainer"]``), and the
  port's forward on it matches ``vit_apply``'s; a port checkpoint restores
  in ``nvit_tpu.ckpt.checkpoint.restore_for_resume`` bit-exact;
* bf16 (and fp32) exports cross both ways, bf16 as ``|V2`` records on disk;
* the Trainer's lifecycle: N straight steps bit-equal to N/2, a save, a
  resume and N/2; the ``finished`` sentinel rule; ``eval_only``; numbered
  checkpoints; the async write's error box; a signal inside a step deferred
  to its end, and a second one forcing the exit without a save.
"""

import dataclasses
import gc
import json
import signal
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt import checkpoint as jax_ckpt
from nvit_tpu.ckpt import export as jax_export
from nvit_tpu.configs import schema as jax_schema
from nvit_tpu.models.vit import vit_apply
from nvit_tpu.train.optim import FusedAdamWState as JaxAdamWState
from nvit_tpu.train.state import TrainState as JaxTrainState
from nvit_tpu.train.state import create_train_state as jax_create_train_state
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.ckpt import export as port_export
from nvit_tpu_torch.ckpt.convert import jax_params_from_state_dict, state_dict_from_jax
from nvit_tpu_torch.ckpt.tree import flatten, run_key, train_state_specs
from nvit_tpu_torch.models.presets import preset
from nvit_tpu_torch.train.state import create_train_state
from nvit_tpu_torch.train.trainer import Trainer
from tests.torch_parity import random_jax_params

torch.set_num_threads(1)

MODES = {  # the four parameter trees: nViT / baseline, without / with biases
    "nvit": dict(use_nvit=True), "baseline": dict(use_nvit=False),
    "nvit-bias": dict(use_nvit=True, bias=True), "baseline-bias": dict(use_nvit=False, bias=True),
}
FWD_TOL = dict(rtol=1e-4, atol=1e-5)  # fp32 forward: summation order only (test_torch_slice.py)


def model_fields(mode: str) -> dict:
    return dict(image_size=16, n_layer=2, n_head=2, n_embd=32, num_classes=10,
                local_patch_size=4, global_patch_size=8, flash_attn=False, **MODES[mode])


def configs(mode: str):
    """(JAX Config, port Config), field for field equal."""
    m = model_fields(mode)
    return (jax_schema.Config(model=jax_schema.ViTConfig(**m)),
            port_schema.Config(model=port_schema.ViTConfig(**m)))


def jax_key(k):
    return getattr(k, "name", getattr(k, "key", getattr(k, "idx", k)))


# ------------------------------------------------------------ leaf order
@pytest.mark.parametrize("mode", MODES)
def test_skeleton_and_flatten_order_are_jax_train_state(mode):
    jcfg, cfg = configs(mode)
    abstract = jax.eval_shape(lambda: jax_create_train_state(jcfg))
    leaves, _ = jax.tree_util.tree_flatten_with_path(abstract)
    want = [(tuple(jax_key(k) for k in path), tuple(x.shape), str(x.dtype)) for path, x in leaves]
    got = [(path, spec.shape, spec.dtype) for path, spec in train_state_specs(cfg)]
    assert got == want


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_run_key_is_jax_split(seed):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed))[1])
    np.testing.assert_array_equal(run_key(seed), want)
    assert run_key(seed).dtype == np.uint32


def test_fresh_state_carries_the_jax_run_key():
    _, cfg = configs("nvit")
    state = create_train_state(cfg, seed=3, device="cpu")
    np.testing.assert_array_equal(state.rng, np.asarray(jax.random.split(jax.random.PRNGKey(3))[1]))


# ----------------------------------------------------- JAX → port → JAX
def jax_state(jcfg, seed: int) -> JaxTrainState:
    """A JAX TrainState with random params and moments (numpy leaves)."""
    params = random_jax_params(jcfg.model, seed=seed)
    rng = np.random.default_rng(seed + 100)
    mu = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda a: rng.random(a.shape).astype(np.float32), params)
    return JaxTrainState(params=params, opt_state=JaxAdamWState(count=np.int32(7), mu=mu, nu=nu),
                         step=np.int32(7), rng=np.array([12345, 678], np.uint32))


TRAINER_META = {"best_val_loss": 2.25, "early_stopping_counter": 3, "eval_count": 4}


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """mode → (directory, JAX state) of a checkpoint the JAX package wrote."""
    out = {}
    for i, mode in enumerate(MODES):
        jcfg, _ = configs(mode)
        d = tmp_path_factory.mktemp(f"jax_{mode}")
        state = jax_state(jcfg, seed=i)
        jax_ckpt.save_checkpoint(d, "checkpoint_latest", state, jcfg, {"val/loss": 2.25}, TRAINER_META)
        out[mode] = (d, state)
    return out


def assert_tensors_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", MODES)
def test_jax_checkpoint_restores_bit_exact(jax_checkpoints, mode):
    d, js = jax_checkpoints[mode]
    jcfg, cfg = configs(mode)
    state, saved_cfg, meta = port_ckpt.restore_for_resume(d, "checkpoint_latest", device="cpu")
    assert saved_cfg == cfg
    assert_tensors_equal(state.model.state_dict(), state_dict_from_jax(js.params, cfg.model))
    assert_tensors_equal(state.opt_state.mu, state_dict_from_jax(js.opt_state.mu, cfg.model))
    assert_tensors_equal(state.opt_state.nu, state_dict_from_jax(js.opt_state.nu, cfg.model))
    assert (state.step, state.opt_state.count) == (7, 7)
    np.testing.assert_array_equal(state.rng, js.rng)
    assert state.rng.dtype == np.uint32
    assert meta["trainer"] == TRAINER_META and meta["iter_num"] == 7
    # the forward on the restored weights is the JAX package's
    img = np.random.default_rng(5).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        logits = state.model.eval()(torch.from_numpy(img))
    want = jax.jit(lambda p, x: vit_apply(p, jcfg.model, x, step=0, train=False).logits)(
        js.params, jnp.asarray(img))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_port_checkpoint_restores_in_jax_bit_exact(jax_checkpoints, tmp_path, mode):
    d, _ = jax_checkpoints[mode]
    state, cfg, meta = port_ckpt.restore_for_resume(d, "checkpoint_latest", device="cpu")
    with torch.no_grad():  # a state of the port's own: move every leaf
        for t in (*state.model.parameters(), *state.opt_state.mu.values(), *state.opt_state.nu.values()):
            t.add_(0.5)
    state.step, state.rng = 9, np.array([1, 2], np.uint32)
    state.opt_state = dataclasses.replace(state.opt_state, count=9)
    port_ckpt.save_checkpoint(tmp_path, "checkpoint_best", state, cfg, {"val/loss": 1.5}, TRAINER_META)
    js, jcfg, jmeta = jax_ckpt.restore_for_resume(tmp_path, "checkpoint_best")
    assert jcfg == configs(mode)[0] and jmeta["trainer"] == TRAINER_META and jmeta["iter_num"] == 9
    got = jax.tree_util.tree_leaves(js)
    want = port_ckpt.state_leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert_tensors_equal(state_dict_from_jax(jax.device_get(js.params), cfg.model),
                         state.model.state_dict())


def test_inverse_layout_transform_round_trips():
    _, cfg = configs("nvit-bias")
    params = random_jax_params(configs("nvit-bias")[0].model, seed=3)
    back = jax_params_from_state_dict(state_dict_from_jax(params, cfg.model), cfg.model)
    for (pa, a), (pb, b) in zip(flatten(params), flatten(back)):
        assert pa == pb and np.array_equal(a, b)


def test_orbax_checkpoint_is_refused(jax_checkpoints, tmp_path):
    d, _ = jax_checkpoints["nvit"]
    meta = json.loads((d / "checkpoint_latest.json").read_text())
    meta["format"] = "nvit_tpu.ckpt.orbax.v1"
    (tmp_path / "c.json").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="do-not-port"):
        port_ckpt.restore_for_resume(tmp_path, "c", device="cpu")


# ----------------------------------------------------------------- export
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_export_crosses_both_ways(jax_checkpoints, tmp_path, dtype):
    d, js = jax_checkpoints["nvit-bias"]
    _, cfg = configs("nvit-bias")
    jax_path = jax_export.export_for_inference(d, "checkpoint_latest", tmp_path / "jax", dtype=dtype)
    port_path = port_export.export_for_inference(d, "checkpoint_latest", tmp_path / "port", dtype=dtype)
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert a.files == b.files
        for k in a.files:  # the same bytes, |V2 records for bf16
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
            assert (a[k].dtype.kind, a[k].dtype.itemsize) == (("V", 2) if dtype == "bfloat16" else ("f", 4))
    jmeta = json.loads(jax_path.with_suffix(".json").read_text())
    pmeta = json.loads(port_path.with_suffix(".json").read_text())
    assert pmeta == jmeta
    # JAX's export in the port, the port's in JAX
    sd, model_cfg = port_export.load_export(tmp_path / "jax", "checkpoint_latest")
    assert model_cfg == cfg.model
    torch_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = {k: v.to(torch_dtype) for k, v in state_dict_from_jax(js.params, cfg.model).items()}
    assert_tensors_equal(sd, want)
    jp, _ = jax_export.load_export(tmp_path / "port", "checkpoint_latest")
    jq, _ = jax_export.load_export(tmp_path / "jax", "checkpoint_latest")
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(jq)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_export_refuses_int8(jax_checkpoints, tmp_path):
    d, _ = jax_checkpoints["nvit"]
    with pytest.raises(NotImplementedError, match="int8 serving"):
        port_export.export_for_inference(d, "checkpoint_latest", tmp_path, dtype="int8")


def test_predictor_from_checkpoint_and_export(jax_checkpoints, tmp_path):
    from nvit_tpu_torch.infer import Predictor

    d, js = jax_checkpoints["nvit"]
    _, cfg = configs("nvit")
    port_export.export_for_inference(d, "checkpoint_latest", tmp_path, dtype="float32")
    images = np.random.default_rng(0).integers(0, 256, (3, 3, 16, 16), dtype=np.uint8)
    a = Predictor.from_checkpoint(d, "checkpoint_latest", device="cpu", compute_dtype=None)
    b = Predictor.from_export(tmp_path, "checkpoint_latest", device="cpu", compute_dtype=None)
    assert_tensors_equal(a.model.state_dict(), state_dict_from_jax(js.params, cfg.model))
    np.testing.assert_array_equal(a.predict_probs(images), b.predict_probs(images))


# ---------------------------------------------------------------- trainer
def trainer_config(out_dir, **sections):
    model = preset("nvit-tiny4")
    model.update(n_layer=1, num_classes=10, image_size=16, flash_attn=True)
    cfg = port_schema.Config(
        model=port_schema.ViTConfig(**model),
        training=port_schema.TrainingConfig(batch_size=8, max_iters=4, eval_interval=2,
                                            log_interval=1, eval_iters=1),
        optimizer=port_schema.OptimizerConfig(warmup_iters=0, lr_decay_iters=10),
        system=port_schema.SystemConfig(remat=False, dtype="float32", quick_validation_size=8),
        data=port_schema.DataConfig(dataset="synthetic", out_dir=str(out_dir), checkpoint_dir=str(out_dir),
                                    augmentation=port_schema.AugmentationConfig(auto_augment=False)),
    )
    for section, kw in sections.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})
    return cfg


@pytest.fixture(scope="module")
def tiny_data():
    """The synthetic 16 px arrays, made once for the module's trainers."""
    from nvit_tpu_torch.data.datasets import load_dataset

    kw = dict(image_size=16, num_classes=10)
    return load_dataset("synthetic", "", train=True, **kw), load_dataset("synthetic", "", train=False, **kw)


@pytest.fixture
def trainer_with(tiny_data, monkeypatch):
    import nvit_tpu_torch.train.trainer as trainer_module

    monkeypatch.setattr(trainer_module, "load_dataset",
                        lambda name, data_dir, *, train, **kw: tiny_data[0 if train else 1])
    return lambda cfg: Trainer(cfg, device="cpu")


def leaves_of(out_dir, name="checkpoint_latest"):
    with np.load(out_dir / f"{name}.npz") as z:
        return [z[k] for k in sorted(z.files, key=lambda k: int(k.split("_")[1]))]


def test_resumed_run_is_bit_equal_to_the_straight_run(trainer_with, tmp_path):
    straight, relaunched = tmp_path / "a", tmp_path / "b"
    trainer_with(trainer_config(straight)).train()
    first = trainer_with(trainer_config(relaunched, training=dict(max_iters_per_launch=2)))
    first.train()
    assert first.iter_num == 2 and not (relaunched / "finished").exists()
    resumed = trainer_with(trainer_config(relaunched, training=dict(init_from="resume")))
    assert resumed.iter_num == 2 and resumed._eval_count == 1
    resumed.train()
    a, b = leaves_of(straight), leaves_of(relaunched)
    assert len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))
    ma, mb = (port_ckpt.load_checkpoint_meta(d, "checkpoint_latest") for d in (straight, relaunched))
    assert ma["iter_num"] == mb["iter_num"] == 4 and ma["trainer"] == mb["trainer"]
    assert ma["trainer"]["eval_count"] == 2
    assert (straight / "finished").read_text() == (relaunched / "finished").read_text() == "max_iters:4"
    # checkpoint_best: at the eval of iteration 2 if it improved on iteration 0's, in both runs
    assert port_ckpt.checkpoint_exists(straight, "checkpoint_best") == port_ckpt.checkpoint_exists(
        relaunched, "checkpoint_best")


def test_finished_sentinel_rule(trainer_with, tmp_path):
    trainer_with(trainer_config(tmp_path, training=dict(max_iters=2))).train()
    assert (tmp_path / "finished").read_text() == "max_iters:2"
    again = trainer_with(trainer_config(tmp_path, training=dict(max_iters=2, init_from="resume")))
    again.train()
    assert again.iter_num == 2  # a completed run is not relaunched
    longer = trainer_with(trainer_config(tmp_path, training=dict(max_iters=3, init_from="resume")))
    longer.train()
    assert longer.iter_num == 3 and (tmp_path / "finished").read_text() == "max_iters:3"
    (tmp_path / "finished").write_text("early_stop")
    final = trainer_with(trainer_config(tmp_path, training=dict(max_iters=5, init_from="resume")))
    final.train()
    assert final.iter_num == 3 and (tmp_path / "finished").read_text() == "early_stop"


def test_eval_only_and_numbered_checkpoints(trainer_with, tmp_path):
    trainer_with(trainer_config(tmp_path, training=dict(save_numbered_checkpoints=True))).train()
    assert [port_ckpt.checkpoint_exists(tmp_path, f"checkpoint_{i:07d}") for i in (2, 4)] == [True, True]
    assert port_ckpt.load_checkpoint_meta(tmp_path, "checkpoint_0000002")["iter_num"] == 2
    ev = trainer_with(trainer_config(tmp_path, training=dict(init_from="resume", eval_only=True)))
    metrics = ev.validate_only()
    assert set(metrics) == {"val/loss", "val/top1_accuracy", "val/top5_accuracy"}
    assert np.isfinite(list(metrics.values())).all()
    with pytest.raises(ValueError, match="checkpoint"):
        trainer_with(trainer_config(tmp_path / "fresh")).validate_only()


def test_async_write_failure_is_raised_at_join(monkeypatch, tmp_path):
    _, cfg = configs("nvit")
    state = create_train_state(cfg, device="cpu")

    def full_disk(*args):
        raise OSError("No space left on device")

    monkeypatch.setattr(port_ckpt, "write_files", full_disk)
    pending = port_ckpt.save_checkpoint_async(tmp_path, "checkpoint_latest", state, cfg)
    with pytest.raises(RuntimeError, match="No space left"):
        pending.result()


def test_async_snapshot_is_taken_at_the_call(tmp_path):
    """The host copy is synchronous: an in-place update after the call
    cannot reach the file."""
    _, cfg = configs("nvit")
    state = create_train_state(cfg, device="cpu")
    want = port_ckpt.state_leaves(state)
    pending = port_ckpt.save_checkpoint_async(tmp_path, "c", state, cfg)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    pending.result()
    got = leaves_of(tmp_path, "c")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("signals,code", [(1, 0), (2, 1)])
def test_signal_inside_a_step_waits_for_its_end(trainer_with, tmp_path, signals, code):
    """One SIGTERM inside step 2 saves checkpoint_latest after the step and
    exits 0; a second one inside the same step exits 1 at once, no save."""
    trainer = trainer_with(trainer_config(tmp_path, training=dict(max_iters=10, eval_interval=100)))
    step = trainer._train_step_norms

    def signalled_step(state, images, labels):
        if state.step == 1:
            for _ in range(signals):
                # to this thread: a process-directed signal may wait for another
                # thread, and a second one sent meanwhile merges with it
                signal.pthread_kill(threading.get_ident(), signal.SIGTERM)
        return step(state, images, labels)

    trainer._train_step = trainer._train_step_norms = signalled_step
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exit_info:
        trainer.train()
    assert exit_info.value.code == code
    assert signal.getsignal(signal.SIGTERM) is before
    if code == 0:
        assert trainer.iter_num == 2
        assert port_ckpt.load_checkpoint_meta(tmp_path, "checkpoint_latest")["iter_num"] == 2
        assert all(np.array_equal(a, b) for a, b in zip(leaves_of(tmp_path), port_ckpt.state_leaves(trainer.state)))
    else:
        assert not port_ckpt.checkpoint_exists(tmp_path, "checkpoint_latest")


def test_finished_trainer_restores_the_signal_handlers_and_is_freed(trainer_with, tmp_path):
    """The handlers live while train() runs: a Trainer that has finished
    leaves the process's handlers as it found them and holds no reference
    from them, so it is freed with its state."""
    before = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    trainer = trainer_with(trainer_config(tmp_path, training=dict(max_iters=1)))
    step, installed = trainer._train_step_norms, []

    def watched_step(state, images, labels):
        installed.append(all(signal.getsignal(s) is not h for s, h in before.items()))
        return step(state, images, labels)

    trainer._train_step = trainer._train_step_norms = watched_step
    assert {s: signal.getsignal(s) for s in before} == before  # not at construction
    trainer.train()
    assert installed == [True]
    assert {s: signal.getsignal(s) for s in before} == before
    freed = weakref.ref(trainer)
    del trainer, watched_step
    gc.collect()
    assert freed() is None
