"""The port's serve CLI on the CPU (a companion of tests/test_torch_cli.py):
``--model-parallel 2`` and ``--data-parallel`` serving,
``InferenceService.warmup(all_buckets=True)`` on the JAX package's bucket
ladder, and one run in a subprocess (an export served over HTTP, SIGHUP
reload, SIGTERM drain)."""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nvit_tpu.serve as jax_serve
from nvit_tpu_torch.ckpt import export as port_export
from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.serve import InferenceService
from nvit_tpu_torch.serve import main as serve_main
from tests.torch_cli_cases import REPO, clean_environment, tiny_checkpoint  # noqa: F401 (autouse)

torch.set_num_threads(1)


class NoServer:  # stands in for the HTTP server: serve_forever returns at once
    def __init__(self, address, handler):
        self.server_address = address

    def serve_forever(self):
        pass

    def server_close(self):
        pass


def served_predictor(monkeypatch, argv: list) -> Predictor:
    """``serve_main(argv)`` with the HTTP server stood in for → the served Predictor."""
    import nvit_tpu_torch.serve as serve

    services = []
    make_handler = serve.make_handler
    monkeypatch.setattr(serve, "make_handler", lambda service: services.append(service) or make_handler(service))
    monkeypatch.setattr(serve, "ThreadingHTTPServer", NoServer)
    monkeypatch.setattr(serve.signal, "signal", lambda *args: None)  # this process keeps its handlers
    serve_main(argv)
    (service,) = services
    return service.predictor


@pytest.mark.parametrize("flags,item", [(["--model-parallel", "2"], "slice 16")])
def test_serve_cli_refuses_unported_options(tmp_path, monkeypatch, capsys, flags, item):
    """Slice 16 ported ``--model-parallel``: it serves
    ``Predictor(model_parallel=2)`` (on the CPU two shards on the one CPU)
    with the one-device probabilities (rtol 1e-5: the row-parallel sums
    reassociate), and ``/stats`` names the layout."""
    tiny_checkpoint(tmp_path)
    pred = served_predictor(monkeypatch, ["--checkpoint", str(tmp_path), *flags, "--device", "cpu", "--port", "0"])
    assert "drained; exiting" in capsys.readouterr().out
    assert pred.layout == {"data": 1, "model": 2, "devices": ["cpu", "cpu"]}
    images = np.random.default_rng(3).integers(0, 256, (3, 3, 16, 16), dtype=np.uint8)
    want = Predictor.from_checkpoint(tmp_path, device="cpu", compute_dtype=None).predict_probs(images)
    got = Predictor.from_checkpoint(tmp_path, device="cpu", compute_dtype=None,
                                    model_parallel=2).predict_probs(images)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert InferenceService(pred).layout() == pred.layout


def test_serve_cli_data_parallel_serves_the_replicated_predictor(tmp_path, monkeypatch, capsys):
    """``--data-parallel`` builds ``Predictor(data_parallel=True)`` (on the
    CPU one replica: the CPU is one device) and serves its probabilities."""
    tiny_checkpoint(tmp_path)
    pred = served_predictor(monkeypatch, ["--checkpoint", str(tmp_path), "--data-parallel", "--device", "cpu",
                                          "--port", "0"])
    assert "drained; exiting" in capsys.readouterr().out
    assert pred.batch_multiple == 1 and pred.devices == [torch.device("cpu")]
    images = np.random.default_rng(3).integers(0, 256, (3, 3, 16, 16), dtype=np.uint8)
    want = Predictor.from_checkpoint(tmp_path, device="cpu").predict_probs(images)
    np.testing.assert_array_equal(pred.predict_probs(images), want)


@pytest.mark.parametrize("max_batch", [1, 5, 8, 24])
def test_warmup_all_buckets_is_the_jax_ladder(tmp_path, max_batch):
    tiny_checkpoint(tmp_path)
    pred = Predictor.from_checkpoint(tmp_path, device="cpu")
    batches = []
    run = pred.predict_probs
    pred.predict_probs = lambda x: batches.append(len(x)) or run(x)
    service = InferenceService(pred, max_batch=max_batch, builder=lambda: pred)
    service.warmup()
    assert service._bucket_sizes() == [1] and batches == [1]
    service.warmup(all_buckets=True)
    want = jax_serve.InferenceService._bucket_sizes(
        SimpleNamespace(_pinned=None, _warm_all=True, max_batch=max_batch))
    assert service._bucket_sizes() == want and batches[1:] == want
    assert service.stats.device_programs == 0  # warmup is not traffic
    del batches[:]
    service.reload()  # the replacement is warmed on the same ladder
    assert batches == want


def test_serve_cli_in_a_subprocess(tmp_path):
    """An export served over HTTP on the CPU: /predict against the same
    export in this process, SIGHUP reloads it, SIGTERM drains and exits 0."""
    tiny_checkpoint(tmp_path)
    port_export.export_for_inference(tmp_path, "checkpoint_best", tmp_path / "deploy")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nvit_tpu_torch.serve", "--export", "--checkpoint", str(tmp_path / "deploy"),
         "--port", "0", "--device", "cpu", "--max-batch", "4", "--warm-buckets"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()

    def wait_for(*texts: str) -> str:
        while True:
            line = lines.get(timeout=120)
            if line.startswith(texts):
                return line

    try:
        port = int(wait_for("serving").rsplit(":", 1)[1])
        image = np.random.default_rng(0).integers(0, 256, (3, 16, 16), dtype=np.uint8)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/predict", body=json.dumps({"images": image.tolist(), "top_k": 10}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        served = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        probs = Predictor.from_export(tmp_path / "deploy", device="cpu").predict_probs(image[None])[0]
        np.testing.assert_allclose(served["probs"][0], probs[served["labels"][0]], rtol=1e-6)
        proc.send_signal(signal.SIGHUP)
        assert wait_for("reloaded", "reload failed").startswith("reloaded")
        proc.send_signal(signal.SIGTERM)
        wait_for("drained; exiting")
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
