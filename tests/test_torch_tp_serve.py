"""The port's tensor-parallel serving on the CPU:

* ``Predictor(model_parallel=2, devices=[cpu, cpu])``: each trunk block's
  two shards in one process, the partial products summed in shard order —
  float probabilities against one device's (rtol 1e-5) and against
  ``nvit_tpu``'s Predictor (atol 1e-5), nViT with biases, the baseline and
  the Kohonen SOM; a data 2 × model 2 grid over four CPU entries;
* the ``auto`` softmax gate under TP takes the whole model's arm, where
  the rank's own heads alone would take the other;
* JAX's refusals (``infer.py:59-96``): int8 with ``model_parallel > 1``,
  ``model_parallel`` not dividing the devices, or not in (1, n) without
  ``data_parallel``;
* ``python -m nvit_tpu_torch.serve --model-parallel 2`` answering
  ``/predict`` with the one-device probabilities, ``/stats`` naming the
  layout, and draining on SIGTERM.
"""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

import nvit_tpu_torch.ops.flash_attention as fa
from nvit_tpu_torch.configs import Config, ViTConfig
from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.parallel.tensor import LocalShards
from tests.torch_dp import base_env, spawn, wait_all
from tests.torch_serving import tiny_checkpoint

torch.set_num_threads(1)

CPUS = [torch.device("cpu")] * 2


def images(b: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, 3, 16, 16), dtype=np.uint8)


@pytest.mark.parametrize("model_kw", [dict(), dict(use_nvit=False), dict(use_kohonen=True, kohonen_nodes=18)],
                         ids=["nvit", "baseline", "kohonen"])
def test_model_parallel_predictor_gives_the_one_device_and_jax_probabilities(tmp_path, model_kw):
    """fp32 compute: the two shards' probabilities within rtol 1e-5 of one
    device's (the row-parallel sums reassociate: measured ≤ 1.1e-6
    relative) and within 1e-5 absolute of the JAX package's Predictor on the
    same checkpoint, at batches 1, 3 and 8."""
    from nvit_tpu.infer import Predictor as JaxPredictor

    tiny_checkpoint(tmp_path, **model_kw)
    one = Predictor.from_checkpoint(tmp_path, device="cpu", compute_dtype=None)
    two = Predictor.from_checkpoint(tmp_path, device="cpu", compute_dtype=None, model_parallel=2, devices=CPUS)
    jax_pred = JaxPredictor.from_checkpoint(tmp_path, compute_dtype=None)
    assert two.layout == {"data": 1, "model": 2, "devices": ["cpu", "cpu"]} and two.batch_multiple == 1
    blocks = two.model.transformer["h"]
    assert all(isinstance(b, LocalShards) and len(b.shards) == 2 for b in blocks)
    d = one.cfg.n_embd
    assert blocks[0].shards[1].c_fc.weight.shape == (4 * d, d) and blocks[0].shards[1]._heads() == 1
    for name, p in blocks[0].shards[0].named_parameters():  # copies, no view keeping the whole alive
        assert p.untyped_storage().nbytes() == p.numel() * p.element_size(), name
    for b in (1, 3, 8):
        x = images(b, seed=b)
        got = two.predict_probs(x)
        np.testing.assert_allclose(got, one.predict_probs(x), rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, jax_pred.predict_probs(x), rtol=0, atol=1e-5)


def test_data_by_model_grid_and_refusals(tmp_path):
    tiny_checkpoint(tmp_path)
    one = Predictor.from_checkpoint(tmp_path, device="cpu", compute_dtype=None)
    grid = Predictor.from_checkpoint(tmp_path, device="cpu", compute_dtype=None, data_parallel=True,
                                     model_parallel=2, devices=CPUS * 2)
    assert grid.layout["data"] == 2 and grid.layout["model"] == 2 and grid.batch_multiple == 2
    x = images(3, seed=7)
    np.testing.assert_allclose(grid.predict_probs(x), one.predict_probs(x), rtol=1e-5, atol=0)
    # on the CPU without devices=, N shards on the one CPU
    assert Predictor.from_checkpoint(tmp_path, device="cpu", model_parallel=2).layout["model"] == 2
    with pytest.raises(ValueError, match="not supported with quantize"):
        Predictor.from_checkpoint(tmp_path, device="cpu", model_parallel=2, quantize="int8", devices=CPUS)
    with pytest.raises(ValueError, match="3 devices not divisible by model_parallel=2"):
        Predictor.from_checkpoint(tmp_path, device="cpu", model_parallel=2, devices=CPUS + CPUS[:1])
    with pytest.raises(ValueError, match="would idle 2 of 4 devices"):
        Predictor.from_checkpoint(tmp_path, device="cpu", model_parallel=2, devices=CPUS * 2)
    with pytest.raises(ValueError, match="data_parallel=True or model_parallel > 1"):
        Predictor.from_checkpoint(tmp_path, device="cpu", devices=CPUS)


def test_auto_gate_takes_the_whole_models_arm(tmp_path, monkeypatch):
    """sqk_eff 1 on head 0 (scale·max s² = 8 < 20) and 2 on head 1 (32):
    one device's "auto" takes the row-max arm; shard 0's heads alone would
    take the bounded one, and under TP shard 0 takes row-max too."""
    cfg = Config(model=ViTConfig(image_size=16, n_layer=1, n_head=2, n_embd=128, num_classes=10,
                                 local_patch_size=4, global_patch_size=8, use_nvit=True, flash_attn=True,
                                 bounded_softmax="auto"))
    one = Predictor.from_config(cfg, seed=0, device="cpu", compute_dtype=None)
    with torch.no_grad():
        sqk = one.model.transformer["h"][0].sqk
        sqk[:64] = cfg.model.base_scale
        sqk[64:] = 2 * cfg.model.base_scale
    two = Predictor(one.model.state_dict(), cfg.model, device="cpu", compute_dtype=None, model_parallel=2)
    scale = cfg.model.head_dim ** 0.5
    shard0 = two.model.transformer["h"][0].shards[0]
    assert fa.bounded_arm(sqk[:64].reshape(1, 64).detach() / cfg.model.base_scale, scale, "auto")
    assert shard0._sqk()[1] == "rowmax" and shard0._sqk()[0].shape == (1, 64)
    modes = []
    ref = fa.flash_attention_qknorm_ref
    monkeypatch.setattr(fa, "flash_attention_qknorm_ref",
                        lambda q, k, v, s, sc, mode="rowmax": modes.append((s.shape[0], mode)) or ref(q, k, v, s, sc,
                                                                                                       mode))
    x = images(2, seed=3)
    want = one.predict_probs(x)
    assert modes == [(2, "auto"), (2, "auto")]  # the cross-attention, then block 0 on one device
    modes.clear()
    np.testing.assert_allclose(two.predict_probs(x), want, rtol=1e-5, atol=0)
    assert modes == [(2, "auto"), (1, "rowmax"), (1, "rowmax")]


def get(port: int, path: str, body=None) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST" if body else "GET", path, body=body, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    assert resp.status == 200, out
    return out


def test_serve_cli_model_parallel_in_a_subprocess(tmp_path):
    tiny_checkpoint(tmp_path)
    proc = spawn(["-m", "nvit_tpu_torch.serve", "--checkpoint", str(tmp_path), "--model-parallel", "2",
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
        served = get(port, "/predict", json.dumps({"images": x.tolist(), "top_k": 10}))
        want = Predictor.from_checkpoint(tmp_path, device="cpu").predict_probs(x)
        for row in range(2):
            np.testing.assert_allclose(served["probs"][row], want[row][served["labels"][row]], rtol=1e-2)
        stats = get(port, "/stats")
        assert stats["layout"] == {"data": 1, "model": 2, "devices": ["cpu", "cpu"]} and stats["requests"] == 1
        proc.terminate()
    finally:
        (output,) = wait_all([proc])
    assert "drained; exiting" in output
