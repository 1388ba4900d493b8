"""HTTP serving frontend for the port's Predictor (≙ nvit_tpu/serve.py).

Same contract as the JAX package's server:

* ``GET  /healthz``  → ``{"status": "ok", "model": {...}}``
* ``GET  /stats``    → request/image/error counts, latency percentiles over
  the last 1024 requests, device-program count, realized coalescing factor,
  padding overhead, the mean queue wait per request and the host's
  milliseconds per forward in the batch window, the batch's concat and
  pad, and the forward (ServingStats)
* ``POST /predict``  → raw uint8 bytes of one [C, H, W] image
  (``Content-Type: application/octet-stream``), or JSON
  ``{"images": [[[...]]], "top_k": 5}`` with one [C,H,W] image or a
  [B,C,H,W] batch of 0-255 ints; response ``{"labels": [[...]], "probs": [[...]]}``.

Requests are padded up to the next power-of-two batch (≤ max_batch), so the
device sees a handful of batch shapes; ``batch_window_ms > 0`` coalesces
concurrent requests into one forward (DynamicBatcher).  From the command
line, on the card::

    python -m nvit_tpu_torch.serve --checkpoint out --name checkpoint_best --port 8321
    python -m nvit_tpu_torch.serve --export --checkpoint deploy --warm-buckets [--int8]
    python -m nvit_tpu_torch.serve --aot --checkpoint deploy --name checkpoint_best

SIGTERM or SIGINT drains: the server stops accepting, answers every request
it accepted, and exits 0 ("drained; exiting").  SIGHUP reloads the model
from the same files off the serving path and swaps it in; if the rebuild
fails, the old model keeps serving.  ``--int8`` serves w8a8
(``ops/quant.py``); ``--aot`` serves an artifact of ``ckpt/aot.py`` (no model
built from code; a pinned batch pads every request up to it and caps it),
and excludes ``--int8`` (baked in at export), ``--export``,
``--data-parallel`` and ``--model-parallel``.  ``--data-parallel`` serves
one replica per visible card (``Predictor(data_parallel=True)``; each
batch split over them); ``--model-parallel N`` shards the trunk over N
cards (``Predictor(model_parallel=N)``: every card a shard, or with
``--data-parallel`` a data × model grid; on the CPU N shards on the one
CPU), and ``/stats`` reports the layout.  In a program::

    service = InferenceService(Predictor.from_config(cfg, device="cuda"), max_batch=32)
    service.warmup()
    ThreadingHTTPServer((host, port), make_handler(service)).serve_forever()
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from nvit_tpu_torch.ckpt.aot import load_aot
from nvit_tpu_torch.infer import Predictor, topk_from_probs
from nvit_tpu_torch.obs.profiling import span

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
    riders' [b, C, H, W] arrays and returns [Σb, num_classes] probabilities.
    ``record(riders, queue_wait_s, window_s)``, if given, gets each batch's
    rider count, their summed wait from ``submit`` to being taken, and the
    seconds from the worker's first sight of a rider to the window's close
    (the ``nvit.serve.window`` span).
    """

    def __init__(self, run, max_batch: int, window_s: float, record=None):
        self._run = run
        self._record = record
        self.max_batch = max_batch
        self.window_s = window_s
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name="nvit-batcher")
        self._thread.start()

    def submit(self, images: np.ndarray) -> np.ndarray:
        """Block until this request's rows come back: → probs [b, classes]."""
        item = {"images": images, "event": threading.Event(), "result": None, "error": None,
                "t": time.perf_counter()}
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
                t_open = time.perf_counter()
                with span("nvit.serve.window"):
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
                t_taken = time.perf_counter()
            try:
                if self._record is not None:
                    self._record(len(batch), sum(t_taken - i["t"] for i in batch), t_taken - t_open)
                probs = self._run([i["images"] for i in batch])
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
    adds.  The host's seconds at the batcher's boundaries, summed:
    ``queue_wait_s`` over requests (``submit`` → taken into a batch; 0
    without a batch window), and over forwards ``window_s`` (the batch
    window), ``batch_s`` (concat and pad) and ``forward_s`` (the
    Predictor's call under the lock), each timed where the span of the
    same name runs (``nvit.serve.window``, ``.batch``, ``.forward``)."""

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
        self.queued = 0  # requests taken from the batcher's queue
        self.queue_wait_s = 0.0
        self.window_s = 0.0
        self.batch_s = 0.0
        self.forward_s = 0.0
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

    def record_window(self, riders: int, queue_wait_s: float, window_s: float) -> None:
        with self._lock:
            self.queued += riders
            self.queue_wait_s += queue_wait_s
            self.window_s += window_s

    def record_program(self, rows: int, padded_rows: int, batch_s: float, forward_s: float) -> None:
        with self._lock:
            self.device_programs += 1
            self.device_images += rows
            self.padded_images += padded_rows
            self.batch_s += batch_s
            self.forward_s += forward_s

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
                "queue_wait_ms": round(1e3 * self.queue_wait_s / self.queued, 3) if self.queued else None,
                "host_ms_per_forward": (
                    {k: round(1e3 * v / self.device_programs, 3)
                     for k, v in (("window", self.window_s), ("batch", self.batch_s), ("forward", self.forward_s))}
                    if self.device_programs
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
        self._warm_all = False
        self._reload_lock = threading.Lock()  # serializes concurrent reloads
        # an AOT artifact with a pinned batch (ckpt/aot.py) takes exactly that
        # batch: every request is padded up to it, and it caps the accepted batch
        self._pinned = getattr(predictor, "pinned_batch", None)
        self.max_batch = self._pinned or max_batch
        self._lock = threading.Lock()
        self.stats = ServingStats()
        self._batcher = (
            DynamicBatcher(self._padded_probs, self.max_batch, batch_window_ms / 1e3, self._record_window)
            if batch_window_ms > 0
            else None
        )
        self.model_info = _model_info(predictor.cfg)
        c = predictor.cfg
        self._shape = (c.channels, c.image_size, c.image_size)

    def warmup(self, all_buckets: bool = False) -> None:
        """Run a batch-1 request before traffic: builds the kernels (first
        use) and grows the allocator off the serving clock.  ``all_buckets``
        also runs every batch shape the service can dispatch
        (``_bucket_sizes``), so no live request meets one first."""
        self._warm_all = bool(all_buckets)
        self.predict(np.zeros((1, *self._shape), dtype=np.uint8))
        for b in self._bucket_sizes():
            if b > 1:
                self._padded_probs([np.zeros((b, *self._shape), dtype=np.uint8)])
        # /stats describes live traffic only
        self.stats = ServingStats()

    def _bucket_sizes(self) -> list[int]:
        """Every batch shape the service dispatches: the pinned batch of an
        AOT artifact; else bucket 1, and after ``warmup(all_buckets=True)``
        the power-of-two ladder and max_batch itself (``_pad_batch`` clamps
        its top bucket to max_batch)."""
        if self._pinned:
            return [self._pinned]
        buckets = [1]
        if self._warm_all:
            b = 2
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            if self.max_batch > 1:
                buckets.append(self.max_batch)
        return buckets

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
            if getattr(new, "pinned_batch", None) != self._pinned:
                raise ValueError(f"reloaded artifact pins batch {getattr(new, 'pinned_batch', None)} "
                                 f"but the service was built for {self._pinned}")
            if (new.cfg.image_size, new.cfg.num_classes) != (
                self.model_info["image_size"], self.model_info["num_classes"]
            ):
                raise ValueError(
                    f"reloaded model geometry ({new.cfg.image_size}px, "
                    f"{new.cfg.num_classes} classes) differs from the serving "
                    f"contract ({self.model_info['image_size']}px, "
                    f"{self.model_info['num_classes']} classes)"
                )
            for b in self._bucket_sizes():  # warm it on the live service's shapes
                new.predict_probs(np.zeros((b, *self._shape), dtype=np.uint8))
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

    def _record_window(self, riders: int, queue_wait_s: float, window_s: float) -> None:
        self.stats.record_window(riders, queue_wait_s, window_s)

    def _padded_probs(self, parts: list[np.ndarray]) -> np.ndarray:
        """One device forward over the requests' [b, C, H, W] ``parts``
        (several when coalesced), concatenated and padded to the artifact's
        pinned batch or the next power of two, serialized through the lock
        → probs for exactly the input rows."""
        t0 = time.perf_counter()
        with span("nvit.serve.batch"):
            images = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
            b = images.shape[0]
            if self._pinned:
                pad = np.zeros((self._pinned - b, *images.shape[1:]), dtype=images.dtype)
                images = np.concatenate([images, pad], axis=0) if b < self._pinned else images
            else:
                images, _ = _pad_batch(images, self.max_batch)
        batch_s = time.perf_counter() - t0
        with self._lock, span("nvit.serve.forward"):
            t1 = time.perf_counter()
            probs = np.asarray(self.predictor.predict_probs(images))
            forward_s = time.perf_counter() - t1
        # the Predictor pads again to a replica multiple under --data-parallel
        # (infer.py::predict_probs): those rows are device work too
        m = getattr(self.predictor, "batch_multiple", 1)
        self.stats.record_program(b, -(-images.shape[0] // m) * m, batch_s, forward_s)
        return probs[:b]

    def predict(self, images: np.ndarray, top_k: int = 1) -> dict:
        if images.shape[0] > self.max_batch:
            self.stats.record_error()
            if self._pinned:
                raise ValueError(f"batch {images.shape[0]} exceeds the artifact's pinned batch {self._pinned}")
            raise ValueError(f"batch {images.shape[0]} exceeds max_batch {self.max_batch}")
        t0 = time.perf_counter()
        try:
            probs = (
                self._batcher.submit(images)
                if self._batcher is not None
                else self._padded_probs([images])
            )
        except Exception:
            self.stats.record_error()
            raise
        self.stats.record_request(images.shape[0], (time.perf_counter() - t0) * 1e3)
        labels, top_probs = topk_from_probs(probs, top_k)
        return {"labels": labels.tolist(), "probs": top_probs.tolist()}

    def layout(self) -> dict:
        """The predictor's data replicas × model shards (one of each for an
        AOT artifact)."""
        return getattr(self.predictor, "layout", {"data": 1, "model": 1})

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
                self._reply(200, {**service.stats.snapshot(), "layout": service.layout()})
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


def main(argv=None) -> None:
    """Serve a checkpoint (or, with ``--export``, an export; with ``--aot``,
    an AOT artifact) over HTTP."""
    ap = argparse.ArgumentParser(description="Serve an nvit_tpu_torch checkpoint over HTTP")
    ap.add_argument("--checkpoint", default="out", help="checkpoint (or export) directory")
    ap.add_argument("--name", default="checkpoint_best", help="checkpoint name")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321, help="0 takes a free port")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="dynamic-batching window: concurrent requests arriving within this "
                         "many ms share one forward (0 = off)")
    ap.add_argument("--export", action="store_true",
                    help="load a params-only export (ckpt.export), not a training checkpoint")
    ap.add_argument("--warm-buckets", action="store_true",
                    help="run every power-of-two batch bucket at startup")
    ap.add_argument("--device", default="cuda", help="the card unless 'cpu' is asked for")
    ap.add_argument("--int8", action="store_true",
                    help="int8-quantize the model for serving (w8a8, ops/quant.py)")
    ap.add_argument("--aot", action="store_true",
                    help="load an AOT artifact (ckpt.aot): no model built from code; "
                         "--int8 is baked in at export time")
    ap.add_argument("--data-parallel", action="store_true",
                    help="one replica per visible card, each batch split over them")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="shard the trunk over this many cards (tensor parallelism); with "
                         "--data-parallel a data x model grid of the visible cards")
    args = ap.parse_args(argv)
    if args.aot and (args.int8 or args.data_parallel or args.export or args.model_parallel > 1):
        # export-time properties of the artifact: accepting them here would serve something else
        ap.error("--aot is exclusive: bake --int8 into the artifact via "
                 "ckpt.aot, and --export/--data-parallel/--model-parallel do not apply")

    def build():
        if args.aot:
            return load_aot(args.checkpoint, args.name, device=args.device)
        load = Predictor.from_export if args.export else Predictor.from_checkpoint
        return load(args.checkpoint, args.name, device=args.device, data_parallel=args.data_parallel,
                    model_parallel=args.model_parallel, quantize="int8" if args.int8 else None)

    service = InferenceService(build(), max_batch=args.max_batch,
                               batch_window_ms=args.batch_window_ms, builder=build)
    t0 = time.perf_counter()
    service.warmup(all_buckets=args.warm_buckets)
    print(f"warmed batches {service._bucket_sizes()} in {time.perf_counter() - t0:.3f} s", flush=True)

    class DrainingHTTPServer(ThreadingHTTPServer):
        # non-daemon handler threads: server_close() joins them, so every
        # request accepted before the shutdown is answered before the exit
        daemon_threads = False

    server = DrainingHTTPServer((args.host, args.port), make_handler(service))

    def drain(signum, frame):
        # a second signal takes the default action: a wedged drain stays killable
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.SIG_DFL)
        print(f"signal {signum}: draining in-flight requests", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    def reload_safe():
        try:
            service.reload()
            print(f"reloaded {args.checkpoint}/{args.name}", flush=True)
        except Exception as e:  # the old model keeps serving
            logger.exception("reload failed")
            print(f"reload failed (still serving the previous model): {e}", flush=True)

    def hup(signum, frame):
        print("SIGHUP: reloading model", flush=True)
        threading.Thread(target=reload_safe, daemon=True).start()

    signal.signal(signal.SIGTERM, drain)
    signal.signal(signal.SIGINT, drain)
    signal.signal(signal.SIGHUP, hup)
    host, port = server.server_address[:2]
    print(f"serving {args.checkpoint}/{args.name} on http://{host}:{port}", flush=True)
    server.serve_forever()
    server.server_close()
    service.close()
    print("drained; exiting", flush=True)


if __name__ == "__main__":
    main()
