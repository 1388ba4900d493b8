"""HTTP serving frontend for the port's Predictor (≙ nvit_tpu/serve.py).

Same contract as the JAX package's server:

* ``GET  /healthz``  → ``{"status": "ok", "model": {...}}``
* ``GET  /stats``    → request/image/error counts, latency percentiles over
  the last 1024 requests, device-program count, realized coalescing factor
  and padding overhead (ServingStats)
* ``POST /predict``  → raw uint8 bytes of one [C, H, W] image
  (``Content-Type: application/octet-stream``), or JSON
  ``{"images": [[[...]]], "top_k": 5}`` with one [C,H,W] image or a
  [B,C,H,W] batch of 0-255 ints; response ``{"labels": [[...]], "probs": [[...]]}``.

Requests are padded up to the next power-of-two batch (≤ max_batch), so the
device sees a handful of batch shapes; ``batch_window_ms > 0`` coalesces
concurrent requests into one forward (DynamicBatcher).  Serve with the
stdlib server::

    service = InferenceService(Predictor.from_config(cfg, device="cuda"), max_batch=32)
    service.warmup()
    ThreadingHTTPServer((host, port), make_handler(service)).serve_forever()

The command-line ``main()`` comes with checkpoint loading (ROADMAP.md).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler

import numpy as np

from nvit_tpu_torch.infer import Predictor, topk_from_probs

logger = logging.getLogger("nvit_tpu_torch.serve")


def _pad_batch(images: np.ndarray, max_batch: int) -> tuple[np.ndarray, int]:
    """Pad [B, C, H, W] up to the next power of two (≤ max_batch);
    returns (padded, real_batch)."""
    b = images.shape[0]
    if b > max_batch:
        raise ValueError(f"batch {b} exceeds max_batch {max_batch}")
    padded = 1
    while padded < b:
        padded *= 2
    padded = min(padded, max_batch)
    if padded == b:
        return images, b
    pad = np.zeros((padded - b, *images.shape[1:]), dtype=images.dtype)
    return np.concatenate([images, pad], axis=0), b


class DynamicBatcher:
    """Coalesce concurrent prediction requests into one device forward.

    A worker thread drains the queue: the first waiting request opens a
    window of ``window_s``; everything that arrives before it closes (up to
    ``max_batch`` rows in all) rides the same forward.  ``run`` takes the
    coalesced [B, C, H, W] batch and returns [B, num_classes] probabilities.
    """

    def __init__(self, run, max_batch: int, window_s: float):
        self._run = run
        self.max_batch = max_batch
        self.window_s = window_s
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="nvit-batcher")
        self._thread.start()

    def submit(self, images: np.ndarray) -> np.ndarray:
        """Block until this request's rows come back: → probs [b, classes]."""
        item = {"images": images, "event": threading.Event(), "result": None, "error": None}
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(item)
            self._cv.notify_all()
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:  # closed and drained
                    return
                deadline = time.monotonic() + self.window_s
                while not self._closed:
                    total = sum(i["images"].shape[0] for i in self._queue)
                    remaining = deadline - time.monotonic()
                    if total >= self.max_batch or remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch: list[dict] = [self._queue.pop(0)]
                taken = batch[0]["images"].shape[0]
                while self._queue and taken + self._queue[0]["images"].shape[0] <= self.max_batch:
                    item = self._queue.pop(0)
                    batch.append(item)
                    taken += item["images"].shape[0]
            try:
                imgs = (
                    np.concatenate([i["images"] for i in batch], axis=0)
                    if len(batch) > 1
                    else batch[0]["images"]
                )
                probs = self._run(imgs)
                ofs = 0
                for item in batch:
                    n = item["images"].shape[0]
                    item["result"] = probs[ofs : ofs + n]
                    ofs += n
            except Exception as e:  # fail every rider, keep serving the queue
                logger.exception("batched forward failed")
                for item in batch:
                    item["error"] = e
            finally:
                for item in batch:
                    item["event"].set()


class ServingStats:
    """Thread-safe serving counters + latency reservoir for ``GET /stats``.

    ``images / device_programs`` is the realized coalescing factor, and
    ``padded_images`` vs ``images`` the device work the power-of-two padding
    adds."""

    WINDOW = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.images = 0
        self.errors = 0
        self.device_programs = 0
        self.device_images = 0
        self.padded_images = 0
        self.reloads = 0
        self._lat_ms: list[float] = []

    def record_request(self, rows: int, latency_ms: float) -> None:
        with self._lock:
            self.requests += 1
            self.images += rows
            self._lat_ms.append(latency_ms)
            if len(self._lat_ms) > self.WINDOW:
                del self._lat_ms[: -self.WINDOW]

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_reload(self) -> None:
        with self._lock:
            self.reloads += 1

    def record_program(self, rows: int, padded_rows: int) -> None:
        with self._lock:
            self.device_programs += 1
            self.device_images += rows
            self.padded_images += padded_rows

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            out = {
                "requests": self.requests,
                "images": self.images,
                "errors": self.errors,
                "device_programs": self.device_programs,
                "reloads": self.reloads,
                "coalesced_images_per_program": (
                    round(self.device_images / self.device_programs, 3)
                    if self.device_programs
                    else None
                ),
                "padding_overhead": (
                    round(self.padded_images / self.device_images - 1.0, 3)
                    if self.device_images
                    else None
                ),
            }
        if lat:
            out["latency_ms"] = {
                "window": len(lat),
                "p50": round(lat[len(lat) // 2], 2),
                "p99": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))], 2),
                "max": round(lat[-1], 2),
            }
        return out


def _model_info(cfg) -> dict:
    return {
        "image_size": cfg.image_size, "num_classes": cfg.num_classes,
        "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
        "use_nvit": cfg.use_nvit, "use_kohonen": cfg.use_kohonen,
    }


class InferenceService:
    """Thread-safe top-k prediction on a Predictor, shared by all handlers.

    ``batch_window_ms > 0`` turns on dynamic batching; ``builder`` is a
    zero-argument factory of a replacement Predictor for ``reload()``."""

    def __init__(self, predictor: Predictor, *, max_batch: int = 64,
                 batch_window_ms: float = 0.0, builder=None):
        self.predictor = predictor
        self._builder = builder
        self._reload_lock = threading.Lock()  # serializes concurrent reloads
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self.stats = ServingStats()
        self._batcher = (
            DynamicBatcher(self._padded_probs, self.max_batch, batch_window_ms / 1e3)
            if batch_window_ms > 0
            else None
        )
        self.model_info = _model_info(predictor.cfg)
        c = predictor.cfg
        self._shape = (c.channels, c.image_size, c.image_size)

    def warmup(self) -> None:
        """Run one batch-1 request before traffic: builds the kernels (first
        use) and grows the allocator off the serving clock."""
        self.predict(np.zeros((1, *self._shape), dtype=np.uint8))
        # /stats describes live traffic only
        self.stats = ServingStats()

    def reload(self, builder=None) -> None:
        """Hot-swap the model with a freshly built predictor: built and warmed
        off the serving path, swapped under the lock; on failure the old
        model keeps serving and the exception propagates."""
        builder = builder or self._builder
        if builder is None:
            raise RuntimeError(
                "no builder recorded — construct InferenceService(builder=...) "
                "or pass reload(builder=...)"
            )
        with self._reload_lock:
            new = builder()
            if (new.cfg.image_size, new.cfg.num_classes) != (
                self.model_info["image_size"], self.model_info["num_classes"]
            ):
                raise ValueError(
                    f"reloaded model geometry ({new.cfg.image_size}px, "
                    f"{new.cfg.num_classes} classes) differs from the serving "
                    f"contract ({self.model_info['image_size']}px, "
                    f"{self.model_info['num_classes']} classes)"
                )
            new.predict_probs(np.zeros((1, *self._shape), dtype=np.uint8))  # warm it
            with self._lock:
                self.predictor = new
                self.model_info = _model_info(new.cfg)
            self.stats.record_reload()

    def parse(self, body: bytes, content_type: str) -> tuple[np.ndarray, int]:
        """→ (images uint8 [B, C, H, W], top_k)."""
        if content_type.startswith("application/octet-stream"):
            expect = int(np.prod(self._shape))
            if len(body) != expect:
                raise ValueError(f"raw body must be {expect} bytes ({self._shape} uint8), got {len(body)}")
            return np.frombuffer(body, dtype=np.uint8).reshape(1, *self._shape), 1
        req = json.loads(body)
        if not isinstance(req, dict) or "images" not in req:
            raise ValueError('JSON body must be an object with an "images" field')
        try:
            images = np.asarray(req["images"], dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise ValueError(f"images must be a numeric array: {e}") from e
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4 or images.shape[1:] != self._shape:
            raise ValueError(f"images must be [B,{','.join(map(str, self._shape))}], got {images.shape}")
        # isfinite first: json.loads accepts NaN/Infinity, and NaN passes both
        # range comparisons below
        if images.size == 0 or not np.isfinite(images).all():
            raise ValueError("pixel values must be finite numbers in 0..255")
        if images.min() < 0 or images.max() > 255:
            raise ValueError("pixel values must be 0..255")
        top_k = req.get("top_k", 1)
        if not isinstance(top_k, int) or isinstance(top_k, bool) or not (
            1 <= top_k <= self.model_info["num_classes"]
        ):
            raise ValueError(f"top_k must be an int in 1..{self.model_info['num_classes']}, got {top_k!r}")
        return np.rint(images).astype(np.uint8), top_k

    def _padded_probs(self, images: np.ndarray) -> np.ndarray:
        """One device forward over a (possibly coalesced) batch, padded to the
        next power of two, serialized through the lock → probs for exactly
        the input rows."""
        b = images.shape[0]
        images, _ = _pad_batch(images, self.max_batch)
        with self._lock:
            probs = np.asarray(self.predictor.predict_probs(images))
        self.stats.record_program(b, images.shape[0])
        return probs[:b]

    def predict(self, images: np.ndarray, top_k: int = 1) -> dict:
        if images.shape[0] > self.max_batch:
            self.stats.record_error()
            raise ValueError(f"batch {images.shape[0]} exceeds max_batch {self.max_batch}")
        t0 = time.perf_counter()
        try:
            probs = (
                self._batcher.submit(images)
                if self._batcher is not None
                else self._padded_probs(images)
            )
        except Exception:
            self.stats.record_error()
            raise
        self.stats.record_request(images.shape[0], (time.perf_counter() - t0) * 1e3)
        labels, top_probs = topk_from_probs(probs, top_k)
        return {"labels": labels.tolist(), "probs": top_probs.tolist()}

    def close(self) -> None:
        """Stop the batching worker (if any); in-flight requests complete."""
        if self._batcher is not None:
            self._batcher.close()


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging, not stderr
            logger.debug(fmt, *args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "model": service.model_info})
            elif self.path == "/stats":
                self._reply(200, service.stats.snapshot())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                # bound the allocation BEFORE reading: JSON spends ≤ 4 bytes a
                # pixel; a negative length would read until EOF
                limit = service.max_batch * int(np.prod(service._shape)) * 8 + 65536
                if length <= 0 or length > limit:
                    self._reply(
                        413 if length > limit else 400,
                        {"error": f"Content-Length must be in 1..{limit}, got {length}"},
                    )
                    return
                body = self.rfile.read(length)
                images, top_k = service.parse(body, self.headers.get("Content-Type", ""))
            except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
                service.stats.record_error()
                self._reply(400, {"error": str(e)})
                return
            except Exception as e:  # read failure (socket error)
                logger.exception("reading /predict request failed")
                service.stats.record_error()
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                result = service.predict(images, top_k)
            except (ValueError, TypeError, KeyError) as e:
                self._reply(400, {"error": str(e)})  # predict() recorded it
                return
            except Exception as e:  # device/runtime failure → 500 for every rider
                logger.exception("/predict forward failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, result)

    return Handler
