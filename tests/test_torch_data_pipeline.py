"""The port's array batches and device prefetch against the JAX pipeline (a
companion of tests/test_torch_data.py)."""

import threading

import numpy as np
import pytest
import torch

from nvit_tpu.data import datasets as jax_datasets
from nvit_tpu.data import pipeline as jax_pipeline
from nvit_tpu_torch.data import datasets, pipeline
from tests.torch_data_cases import host_batches

torch.set_num_threads(1)


# --------------------------------------------------------------- pipeline
@pytest.mark.parametrize("kw", [
    dict(epoch=3, shuffle=True),
    dict(epoch=0, shuffle=False, drop_last=False),
    dict(epoch=1, shuffle=True, start_batch=2),
    dict(epoch=2, shuffle=True, shard_index=1, shard_count=3),
])
def test_array_batches_equal_the_jax_pipeline(kw):
    rng = np.random.default_rng(22)
    imgs = rng.integers(0, 256, (41, 3, 4, 4), dtype=np.uint8)
    labels = rng.integers(0, 5, 41).astype(np.int32)
    idx_kw = {k: v for k, v in kw.items() if k in ("epoch", "shuffle", "shard_index", "shard_count")}
    np.testing.assert_array_equal(pipeline.epoch_indices(41, seed=4, **idx_kw),
                                  jax_pipeline.epoch_indices(41, seed=4, **idx_kw))
    want = list(jax_pipeline.make_epoch_iterator(jax_datasets.ArrayDataset(imgs, labels, 5), batch_size=4,
                                                 seed=4, **{"drop_last": True, **kw}))
    got = list(pipeline.make_epoch_iterator(datasets.ArrayDataset(imgs, labels, 5), batch_size=4, seed=4,
                                            **{"drop_last": True, **kw}))
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_device_prefetch_yields_every_batch():
    host = host_batches(7)
    got = list(pipeline.device_prefetch(iter(host), "cpu", size=2))
    assert len(got) == 7
    for (gi, gl), (hi, hl) in zip(got, host):
        assert gi.dtype == torch.uint8 and gl.dtype == torch.int64
        np.testing.assert_array_equal(gi.numpy(), hi)
        np.testing.assert_array_equal(gl.numpy(), hl)


def test_device_prefetch_reraises_the_producers_error():
    def source():
        yield from host_batches(2)
        raise OSError("corrupt shard")

    got = []
    with pytest.raises(OSError, match="corrupt shard"):
        for batch in pipeline.device_prefetch(source(), "cpu", size=1):
            got.append(batch)
    assert len(got) == 2


def test_device_prefetch_abandoned_releases_the_producer_and_the_source():
    closed = threading.Event()

    def source():
        try:
            yield from host_batches(1000)
        finally:
            closed.set()

    before = {t.ident for t in threading.enumerate()}
    it = pipeline.device_prefetch(source(), "cpu", size=2)
    assert len([next(it) for _ in range(3)]) == 3
    it.close()  # what a capped eval's break does
    assert closed.wait(5)
    left = [t for t in threading.enumerate() if t.ident not in before and t.name == "nvit-prefetch"]
    for t in left:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in left)
