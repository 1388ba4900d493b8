"""The port's serving modes from their command lines, on the CPU:

* ``python -m nvit_tpu_torch.serve``: ``--aot`` refuses ``--int8``,
  ``--export``, ``--data-parallel`` and ``--model-parallel`` with JAX's
  message; ``--int8`` serves the checkpoint quantized (its ``main`` in this
  process, the HTTP server stubbed); ``--aot`` serves an artifact in a
  subprocess, answering a request as the artifact does here, and drains;
* ``python -m nvit_tpu_torch.scripts.serve_bench`` at a tiny checkpoint:
  one JSON line per batch window, with the JAX script's keys;
* the slice's modules import no jax.
"""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from nvit_tpu_torch import serve
from nvit_tpu_torch.ckpt.aot import export_aot, load_aot
from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.ops.quant import is_quantized
from nvit_tpu_torch.scripts import serve_bench
from tests.torch_serving import tiny_checkpoint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("flags", [["--int8"], ["--export"], ["--data-parallel"], ["--model-parallel", "2"]])
def test_serve_cli_aot_is_exclusive(capsys, flags):
    with pytest.raises(SystemExit) as exit_info:
        serve.main(["--aot", *flags])
    assert exit_info.value.code == 2 and "--aot is exclusive" in capsys.readouterr().err


class _NoServer:
    """Stands in for the HTTP server: ``serve_forever`` returns at once."""

    def __init__(self, address, handler):
        self.server_address = address

    def serve_forever(self):
        pass

    def server_close(self):
        pass


def test_serve_cli_int8_serves_the_checkpoint_quantized(tmp_path, monkeypatch, capsys):
    tiny_checkpoint(tmp_path)
    services = []
    make_handler = serve.make_handler
    monkeypatch.setattr(serve, "make_handler", lambda service: services.append(service) or make_handler(service))
    monkeypatch.setattr(serve, "ThreadingHTTPServer", _NoServer)
    monkeypatch.setattr(serve.signal, "signal", lambda *args: None)  # this process keeps its handlers
    serve.main(["--checkpoint", str(tmp_path), "--int8", "--device", "cpu", "--port", "0"])
    assert "drained; exiting" in capsys.readouterr().out
    (service,) = services
    assert is_quantized(service.predictor.model)
    images = np.random.default_rng(1).integers(0, 256, (2, 3, 16, 16), dtype=np.uint8)
    want = Predictor.from_checkpoint(tmp_path, device="cpu", quantize="int8").predict_probs(images)
    np.testing.assert_array_equal(service.predictor.predict_probs(images), want)


def test_serve_cli_aot_in_a_subprocess(tmp_path):
    """An artifact pinned at 2, served over HTTP: one image padded to the
    pin, the answer equal to the artifact's own; SIGTERM drains, exit 0."""
    tiny_checkpoint(tmp_path)
    export_aot(tmp_path, "checkpoint_best", tmp_path / "deploy", batch=2, device="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nvit_tpu_torch.serve", "--aot", "--checkpoint", str(tmp_path / "deploy"),
         "--port", "0", "--device", "cpu"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()

    def wait_for(text: str) -> str:
        while True:
            line = lines.get(timeout=120)
            if line.startswith(text):
                return line

    try:
        port = int(wait_for("serving").rsplit(":", 1)[1])
        image = np.random.default_rng(0).integers(0, 256, (3, 16, 16), dtype=np.uint8)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/predict", body=image.tobytes(), headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        served = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        padded = np.concatenate([image[None], np.zeros_like(image[None])])
        probs = load_aot(tmp_path / "deploy", "checkpoint_best", device="cpu").predict_probs(padded)[0]
        assert served["labels"][0][0] == int(np.argmax(probs))
        np.testing.assert_allclose(served["probs"][0][0], probs.max(), rtol=1e-6)
        proc.send_signal(signal.SIGTERM)
        wait_for("drained; exiting")
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("int8", [False, True])
def test_serve_bench_prints_a_line_per_window(tmp_path, capsys, int8):
    tiny_checkpoint(tmp_path)
    lines = serve_bench.main(["--checkpoint", str(tmp_path), "--clients", "3", "--requests", "2",
                              "--window-ms", "5", "--max-batch", "4", "--device", "cpu",
                              *(["--int8"] if int8 else [])])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines and [x["window_ms"] for x in lines] == [0.0, 5.0]
    for x in lines:
        assert set(x) == {"metric", "window_ms", "clients", "requests_per_sec", "p50_ms", "p99_ms", "stats"}
        assert x["metric"] == "serve_requests_per_sec" and x["clients"] == 3
        assert x["requests_per_sec"] > 0 and 0 < x["p50_ms"] <= x["p99_ms"]
        assert x["stats"]["requests"] == 6 and x["stats"]["errors"] == 0


def test_slice_modules_import_no_jax():
    code = (
        "import sys, nvit_tpu_torch.ops.quant, nvit_tpu_torch.ckpt.aot, nvit_tpu_torch.scripts.serve_bench, "
        "nvit_tpu_torch.debug, nvit_tpu_torch.debug.cli; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nvit_tpu', 'ml_dtypes')); "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
