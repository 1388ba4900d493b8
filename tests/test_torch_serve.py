"""The serving layer's HTTP contract on a stand-in predictor (a companion of
tests/test_torch_slice.py): power-of-two padding, bad requests answered 400,
a device failure 500, dynamic batching coalescing concurrent requests, and
the batcher's host timings (``ServingStats``, ``GET /stats``)."""

import json
import threading
import time

import numpy as np
import pytest

from nvit_tpu_torch.serve import DynamicBatcher, InferenceService, _pad_batch
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


class _SlowPredictor(_FakePredictor):
    def predict_probs(self, images):
        time.sleep(0.02)
        return super().predict_probs(images)


def test_batcher_times_its_queue_window_batch_and_forward():
    window = 0.05
    service = InferenceService(_SlowPredictor(), max_batch=8, batch_window_ms=window * 1e3)
    service.warmup()  # a fresh ServingStats after it
    assert service.stats.snapshot()["queue_wait_ms"] is None
    try:
        service.predict(np.zeros((1, 3, 4, 4), np.uint8))  # one row under max_batch: taken when the window closes
    finally:
        service.close()
    st = service.stats
    assert st.queued == 1 and st.device_programs == 1
    assert st.queue_wait_s >= window and st.window_s >= window
    assert st.forward_s >= 0.02 and 0 < st.batch_s < st.forward_s
    snap = st.snapshot()
    assert snap["queue_wait_ms"] >= 1e3 * window
    assert set(snap["host_ms_per_forward"]) == {"window", "batch", "forward"}
    assert snap["host_ms_per_forward"]["window"] >= 1e3 * window and snap["host_ms_per_forward"]["forward"] >= 20

    # the batcher alone: two riders of one window, their waits summed
    calls = []
    batcher = DynamicBatcher(lambda parts: np.concatenate(parts), 8, 4 * window,
                             record=lambda *a: calls.append(a))
    out = [None, None]
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, batcher.submit(np.full((i + 1, 2), i))))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    batcher.close()
    assert not any(t.is_alive() for t in threads)
    assert [o.tolist() for o in out] == [[[0, 0]], [[1, 1], [1, 1]]]
    (riders, wait_s, window_s), = calls
    assert riders == 2 and window_s >= 4 * window and wait_s >= 4 * window
