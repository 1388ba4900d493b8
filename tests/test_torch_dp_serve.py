"""The port's data-parallel serving and the Trainer's multi-rank refusals,
on the CPU:

* ``Predictor(data_parallel=True, devices=[cpu, cpu])``: two replicas, each
  batch padded to a multiple of two and split, at batches 1, 3 and 8
  against the one-replica probabilities (rtol 1e-6), float and int8;
* ``serve --data-parallel`` answering ``/predict`` in a subprocess, and a
  two-replica ``InferenceService`` over HTTP counting its padded rows;
* the multi-rank settings: ``model_parallel > 1`` on one rank is JAX's
  ``ValueError``, ``fsdp`` across two ranks passes ``check_ported`` (and on
  one rank warns); refused: several cards with ``use_ddp`` and no group,
  ``use_ddp`` off under a launcher, and global batches the data ranks do
  not divide (``ValueError``);
* ``Predictor(data_parallel=True, model_parallel=2)`` lays a data × model
  grid over its devices.
"""

import http.client
import json
import logging
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.parallel.mesh import DataGroup
from nvit_tpu_torch.serve import InferenceService, make_handler
from nvit_tpu_torch.train.trainer import Trainer, check_ported
from tests.test_torch_trainer import trainer_config
from tests.torch_dp import base_env, spawn, wait_all
from tests.torch_serving import tiny_checkpoint

torch.set_num_threads(1)

CPUS = [torch.device("cpu"), torch.device("cpu")]


def images(b: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, 3, 16, 16), dtype=np.uint8)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_data_parallel_predictor_gives_the_one_replica_probabilities(tmp_path, quantize):
    """fp32 compute, rtol 1e-6: the replicas' forwards run other batch
    shapes than the one replica's (batch 3: two of 2 rows against one of 3),
    which the CPU's kernels may sum in another order (measured ≤ 6.3e-7)."""
    tiny_checkpoint(tmp_path)
    one = Predictor.from_checkpoint(tmp_path, device="cpu", quantize=quantize, compute_dtype=None)
    two = Predictor.from_checkpoint(tmp_path, device="cpu", quantize=quantize, compute_dtype=None,
                                    data_parallel=True, devices=CPUS)
    assert two.batch_multiple == 2 and len(two.replicas) == 2 and two.replicas[0] is not two.replicas[1]
    for a, b in zip(two.replicas[0].state_dict().values(), two.replicas[1].state_dict().values()):
        assert torch.equal(a, b)
    seen = []
    for replica in two.replicas:
        replica.register_forward_hook(lambda mod, args, out: seen.append(args[0].shape[0]))
    for b in (1, 3, 8):
        seen.clear()
        x = images(b, seed=b)
        got = two.predict_probs(x)
        assert got.shape == (b, 10) and seen == [-(-b // 2)] * 2  # padded, one chunk a replica
        np.testing.assert_allclose(got, one.predict_probs(x), rtol=1e-6, atol=0)


def test_data_parallel_predictor_devices_and_refusals(tmp_path):
    tiny_checkpoint(tmp_path)
    pred = Predictor.from_checkpoint(tmp_path, device="cpu", data_parallel=True)
    assert pred.devices == [torch.device("cpu")] and pred.batch_multiple == 1  # the CPU is one device
    with pytest.raises(ValueError, match="data_parallel=True"):
        Predictor.from_checkpoint(tmp_path, device="cpu", devices=CPUS)
    with pytest.raises(ValueError, match="data_parallel=True or model_parallel > 1"):
        Predictor.from_checkpoint(tmp_path, device="cpu", devices=CPUS)
    grid = Predictor.from_checkpoint(tmp_path, device="cpu", data_parallel=True, model_parallel=2,
                                     devices=CPUS * 2)
    assert grid.layout == {"data": 2, "model": 2, "devices": ["cpu"] * 4} and grid.batch_multiple == 2


def post(port: int, batch: np.ndarray) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/predict", body=json.dumps({"images": batch.tolist(), "top_k": 10}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200, body
    return body


def test_two_replica_service_answers_predict_over_http(tmp_path):
    """An InferenceService over the two-replica Predictor behind the HTTP
    handler: the served top-10 probabilities are the one replica's, and the
    stats count the rows padded to the replica multiple."""
    tiny_checkpoint(tmp_path)
    one = Predictor.from_checkpoint(tmp_path, device="cpu", compute_dtype=None)
    service = InferenceService(Predictor.from_checkpoint(tmp_path, device="cpu", data_parallel=True,
                                                         devices=CPUS, compute_dtype=None), max_batch=8)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for b in (1, 3):
            x = images(b, seed=10 + b)
            served = post(server.server_address[1], x)
            want = one.predict_probs(x)
            for row in range(b):
                np.testing.assert_allclose(served["probs"][row], want[row][served["labels"][row]], rtol=1e-6)
        stats = service.stats.snapshot()
        # batch 1 → bucket 1 → 2 rows for two replicas; batch 3 → bucket 4 → 4 rows
        assert stats["device_programs"] == 2 and service.stats.padded_images == 6
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_serve_cli_data_parallel_in_a_subprocess(tmp_path):
    """``python -m nvit_tpu_torch.serve --data-parallel`` answers /predict
    with the one-replica probabilities and drains on SIGTERM."""
    tiny_checkpoint(tmp_path)
    proc = spawn(["-m", "nvit_tpu_torch.serve", "--checkpoint", str(tmp_path), "--data-parallel",
                  "--device", "cpu", "--port", "0"], base_env(), tmp_path)
    try:
        port = None
        for _ in range(600):
            proc.log.seek(0)
            text = proc.log.read().decode(errors="replace")
            if "serving" in text:
                port = int(text.split("serving", 1)[1].split("\n", 1)[0].rsplit(":", 1)[1])
                break
            assert proc.poll() is None, text
            threading.Event().wait(0.1)
        assert port is not None, "the server never started"
        x = images(2, seed=5)
        served = post(port, x)
        want = Predictor.from_checkpoint(tmp_path, device="cpu").predict_probs(x)
        for row in range(2):
            np.testing.assert_allclose(served["probs"][row], want[row][served["labels"][row]], rtol=1e-6)
        proc.terminate()
    finally:
        (output,) = wait_all([proc])
    assert "drained; exiting" in output


@pytest.mark.parametrize("system,world", [(dict(model_parallel=2), 1), (dict(fsdp=True), 2)])
def test_tensor_parallelism_and_fsdp_across_ranks_stay_refused(tmp_path, system, world):
    """Slice 16 ported both: ``model_parallel=2`` on one rank raises JAX's
    ``ValueError`` (≙ trainer.py:99-104), and ``fsdp`` across two ranks
    passes ``check_ported``; a world the model axis does not divide raises
    (≙ make_mesh)."""
    cfg = trainer_config(tmp_path, system=system)
    check_ported(cfg, world)
    if world == 1:
        with pytest.raises(ValueError, match="model_parallel=2 requires a multi-device mesh"):
            Trainer(cfg, device="cpu")
        with pytest.raises(ValueError, match="3 devices not divisible by model_parallel=2"):
            check_ported(cfg, 3)


def test_fsdp_on_one_rank_warns(tmp_path, caplog):
    logger = logging.getLogger("nvit_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        trainer = Trainer(trainer_config(tmp_path, system=dict(fsdp=True)), device="cpu")
    finally:
        logger.removeHandler(caplog.handler)
    assert trainer.world == 1
    assert any("fsdp requested on one rank" in r.getMessage() for r in caplog.records)


def test_no_setting_trains_on_fewer_cards_than_asked(tmp_path, monkeypatch):
    """Several cards, use_ddp, no group: a ValueError naming torchrun;
    use_ddp off under a launcher of two: a ValueError; a global batch (or
    micro-batch) the ranks do not divide: a ValueError."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = trainer_config(tmp_path, system=dict(use_ddp=True))
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node=2 -m nvit_tpu_torch"):
        Trainer(cfg, device="cuda")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="use_ddp is false"):
        Trainer(trainer_config(tmp_path, system=dict(use_ddp=False)), device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    two = DataGroup(0, 2, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="not divisible by the 2 ranks"):
        Trainer(trainer_config(tmp_path, training=dict(batch_size=7)), device="cpu", group=two)
    with pytest.raises(ValueError, match="per-micro-batch size 3"):
        Trainer(trainer_config(tmp_path, training=dict(batch_size=6, gradient_accumulation_steps=2)),
                device="cpu", group=two)
