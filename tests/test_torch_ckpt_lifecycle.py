"""The Trainer's lifecycle on the CPU (a companion of
tests/test_torch_ckpt.py): a resumed run bit-equal to a straight one, the
finished sentinel, eval_only and numbered checkpoints, the async write's
error box and snapshot, signals deferred to the step's end, the handlers
restored."""

import gc
import signal
import threading
import weakref

import numpy as np
import pytest
import torch

from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.train.state import create_train_state
from tests.torch_ckpt_cases import configs, leaves_of, tiny_data, trainer_config, trainer_with  # noqa: F401 (fixtures)

torch.set_num_threads(1)


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
