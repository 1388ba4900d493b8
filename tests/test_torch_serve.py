"""The serving layer's HTTP contract on a stand-in predictor (a companion of
tests/test_torch_slice.py): power-of-two padding, bad requests answered 400,
a device failure 500, and dynamic batching coalescing concurrent requests."""

import json
import threading

import numpy as np
import pytest

from nvit_tpu_torch.serve import InferenceService, _pad_batch
from tests.torch_serving import _FakePredictor, _request, serving


@pytest.mark.parametrize("b,want", [(1, 1), (3, 4), (5, 8), (8, 8)])
def test_pad_batch_to_power_of_two(b, want):
    imgs = np.ones((b, 3, 4, 4), np.uint8)
    padded, real = _pad_batch(imgs, 8)
    assert padded.shape[0] == want and real == b
    assert (padded[b:] == 0).all()


@pytest.mark.parametrize("body,content_type,code", [
    (b"{not json", "application/json", 400),
    (json.dumps([1, 2]).encode(), "application/json", 400),
    (json.dumps({"images": np.zeros((1, 3, 5, 5)).tolist()}).encode(), "application/json", 400),
    (json.dumps({"images": np.zeros((3, 4, 4)).tolist(), "top_k": 9}).encode(), "application/json", 400),
    (json.dumps({"images": np.full((3, 4, 4), 256.0).tolist()}).encode(), "application/json", 400),
    (b"\x00" * 7, "application/octet-stream", 400),
])
def test_bad_requests_are_400(body, content_type, code):
    service = InferenceService(_FakePredictor(), max_batch=4)
    srv, thread = serving(service)
    try:
        status, out = _request(srv.server_address, "POST", "/predict", body, content_type)
        assert status == code and "error" in out
        assert service.stats.snapshot()["errors"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


def test_device_failure_is_500_and_dynamic_batching_coalesces():
    service = InferenceService(_FakePredictor(fail=True), max_batch=4)
    srv, thread = serving(service)
    try:
        body = json.dumps({"images": np.zeros((3, 4, 4)).tolist()}).encode()
        status, out = _request(srv.server_address, "POST", "/predict", body)
        assert status == 500 and "device lost" in out["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)

    fake = _FakePredictor()
    batched = InferenceService(fake, max_batch=8, batch_window_ms=200)
    results = [None] * 4
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (1, 3, 4, 4), dtype=np.uint8) for _ in range(4)]

    def call(i):
        results[i] = batched.predict(imgs[i], top_k=2)

    workers = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    batched.close()
    assert all(not w.is_alive() for w in workers)
    direct = InferenceService(_FakePredictor(), max_batch=8)
    for i in range(4):
        assert results[i] == direct.predict(imgs[i], top_k=2)
    assert sum(fake.batches) >= 4 and len(fake.batches) < 4  # coalesced
