"""The serving cells: an open loop of single-image requests into the
program's ``InferenceService`` over a ``Predictor`` holding the benchmark's
weights.

The arrivals are a Poisson process at the workload's fixed rate, made the
same for every seed: the gaps are the exponential distribution's quantiles
at (i + ½)/N, put in an order drawn from the seed; each request's image is
drawn from a pool made from the seed.  A pool of client threads sends each
request when it is due; latency counts from the due time to the returned
result, so a stall is charged to every request it delays, and a request
that found no free client is counted.  The HTTP socket is left out.  Every
device forward is timed by a wrapper around the predictor's
``predict_probs`` (the service calls it once per forward, padded); in a
traced run the wrapper also starts and stops the profiler around a stretch
of forwards.
"""

from __future__ import annotations

import math
import queue
import threading
import time
import traceback

import numpy as np
import torch

from benchmark.device import peak_bytes, reset_peak, stage, sync
from benchmark.record import Run, percentile
from benchmark.reference import check
from benchmark.reference import model as ref
from benchmark.spec import Cell, port_config
from benchmark.trace import Profile
from benchmark.weights import generator, make_images, make_weights, stream_seed


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of ``rate · seconds`` requests:
    the first at the start, each next one a gap later (the last gap drawn
    falls after the window)."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    np.random.default_rng(stream_seed(seed, "arrivals")).shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def pool(cell: Cell, seed: int, device) -> torch.Tensor:
    m = cell.model
    g = generator(device, seed, "pool")
    return make_images(cell.workload["pool_images"], m["image_size"], m["channels"], g, device)


class Forwards:
    """Wraps ``predict_probs``: each forward's (start, end, rows) after
    ``t0``.  From ``trace_at`` each of ``profiles`` in turn profiles whole
    forwards for ``seconds``: at a forward's boundary the serving thread
    asks the main thread (``serve_profiler``) to start or stop the profile
    and waits until it has, since the profiler is driven from the thread
    that first set it up."""

    def __init__(self, fn, profiles=(), seconds: float = 1.0):
        self._fn, self.profiles, self.seconds = fn, list(profiles), seconds
        self.t0 = self.trace_at = math.inf
        self.spans: list[tuple[float, float, int]] = []
        self.rows: list[list[int]] = [[] for _ in self.profiles]  # each profile's forwards
        self.commands: queue.SimpleQueue = queue.SimpleQueue()
        self._phase = 0
        self._since = None  # when the running profile started

    def _ask(self, what: str) -> None:
        done = threading.Event()
        self.commands.put((what, self.profiles[self._phase], done))
        done.wait()

    def __call__(self, images):
        if self._since is None and self._phase < len(self.profiles) and time.perf_counter() >= self.trace_at:
            self._ask("start")
            self._since = time.perf_counter()
        start = time.perf_counter()
        out = self._fn(images)
        end = time.perf_counter()
        if start >= self.t0:
            self.spans.append((start, end, images.shape[0]))
        if self._since is not None:
            self.rows[self._phase].append(images.shape[0])
            if end - self._since >= self.seconds:
                self._ask("stop")
                self._since = None
                self._phase += 1
        return out

    def serve_profiler(self, timeout: float = 0.0) -> None:
        """Run the serving thread's requests to start or stop a profile."""
        try:
            while True:
                what, profile, done = self.commands.get(timeout=timeout) if timeout else self.commands.get_nowait()
                profile.start() if what == "start" else profile.stop()
                done.set()
        except queue.Empty:
            pass

    def finish(self) -> None:
        """Stop a profile the load ended inside (its stretch does not count)."""
        if self._since is not None:
            self.profiles[self._phase].stop()
            self._since = None
            self._phase = len(self.profiles) + 1

    @property
    def traced(self) -> bool:
        return self._phase == len(self.profiles) > 0


class Clients:
    """``n`` threads that each send one request at a time.  Each answer is
    copied into arrays made at the start and its objects dropped, as a
    client in another process would: answers kept as Python objects grow
    the serving process's heap by some 10⁵ containers a run, and the
    collector's full pass over it stalls the batcher mid-window."""

    def __init__(self, service, images: np.ndarray, top_k: int, n: int, count: int):
        self.service, self.images, self.top_k = service, images, top_k
        self.q: queue.SimpleQueue = queue.SimpleQueue()
        self.sent = np.full(count, np.nan)
        self.done = np.full(count, np.nan)
        self.labels = np.full((count, top_k), -1, dtype=np.int64)
        self.probs = np.full((count, top_k), np.nan)
        self.failed = 0
        self.waited = 0  # requests that found every client busy
        self._free = n
        self._left = count
        self._lock = threading.Lock()
        self.all_done = threading.Event()
        self._threads = [threading.Thread(target=self._work, daemon=True, name=f"bench-client-{i}")
                         for i in range(n)]
        for t in self._threads:
            t.start()

    def send(self, i: int, image_index: int) -> None:
        with self._lock:
            if self._free == 0:
                self.waited += 1
            self._free -= 1
        self.q.put((i, image_index))

    def _work(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            i, k = item
            self.sent[i] = time.perf_counter()
            try:
                answer = self.service.predict(self.images[k:k + 1], top_k=self.top_k)
                self.done[i] = time.perf_counter()
                self.labels[i], self.probs[i] = answer["labels"][0], answer["probs"][0]
            except Exception:  # a failed request stays missing: it counts against every limit
                with self._lock:
                    self.failed += 1
                    if self.failed == 1:
                        traceback.print_exc()
            with self._lock:
                self._free += 1
                self._left -= 1
                if self._left == 0:
                    self.all_done.set()

    def close(self) -> None:
        for _ in self._threads:
            self.q.put(None)
        for t in self._threads:
            t.join(timeout=10)


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, group=None):
    """One run → (Run, the numbers that decide ``correct``)."""
    run, labels, probs, ref_logp = open_loop(cell, seed, seconds, trace, device, t_start)
    return run, check.serve_numbers(labels, probs, ref_logp, run.counters["failed"])


def readings(cell: Cell, seed: int, device, group=None, program: bool = True, control: bool = True,
             seconds: float = 3.0):
    """The readings that the limits are set from, for one seed, each from a
    ``seconds`` open loop at the cell's rate → (what, numbers) pairs: the
    program's; with ``control`` the program's own int8 path in its place,
    and each answer given to the next request of the sample."""
    for quantize in ([None] if program else []) + (["int8"] if control else []):
        run, labels, probs, ref_logp = open_loop(cell, seed, seconds, False, device, time.time(), quantize)
        yield ("program" if quantize is None else "control int8",
               check.serve_numbers(labels, probs, ref_logp, run.counters["failed"]))
        if quantize is None and control:
            yield ("fault answer to another request",
                   check.serve_numbers(labels[1:] + labels[:1], probs[1:] + probs[:1], ref_logp, 0))
        if device.type == "cuda":
            torch.cuda.empty_cache()


def open_loop(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, quantize=None):
    """One run → (Run, the sample's returned labels and probs, their
    reference log-probabilities).  ``quantize`` serves the predictor's
    int8 path (the control)."""
    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.serve import InferenceService
    from nvit_tpu_torch.train.state import compute_dtype_of

    w = cell.workload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = port_config(cell.config)
    predictor = Predictor(make_weights(cell.model, seed, device), cfg.model, device=device,
                          compute_dtype=compute_dtype_of(cfg), quantize=quantize)
    stage("weights and predictor", t_start)
    # traced: after the window the load goes on through three profiled
    # stretches (the profiler's start-up, the device's side, the host's too),
    # so nothing of the window runs under the profiler; the host's stretch
    # records the main thread's operations (the profiler's host side is per
    # thread), so its gaps name little
    profiles = [Profile(device), Profile(device), Profile(device, host=True)] if trace else []
    fwd = Forwards(predictor.predict_probs, profiles, w["trace_seconds"])
    predictor.predict_probs = fwd
    service = InferenceService(predictor, max_batch=w["max_batch"], batch_window_ms=w["batch_window_ms"])
    service.warmup(all_buckets=True)
    stage("warm-up of every batch bucket", t_start)
    images_dev = pool(cell, seed, device)
    images = images_dev.cpu().numpy()
    extra = 3 * w["trace_seconds"] + 4.0 if trace else 0.0  # the profiler's first start takes seconds
    due = schedule(w["rate_per_s"], seconds + extra, seed)
    in_window = int(np.searchsorted(due, seconds))
    picks = np.random.default_rng(stream_seed(seed, "images")).integers(0, len(images), len(due))
    clients = Clients(service, images, w["top_k"], w["clients"], len(due))
    sync(device)
    reset_peak(device)
    stage("images, arrivals and clients", t_start)

    t_window = time.time()
    t0 = time.perf_counter()
    fwd.t0 = t0
    fwd.trace_at = t0 + seconds
    counts = None
    for i, d in enumerate(due):
        fwd.serve_profiler()
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if i == in_window:  # the window's close: what the service counted in it
            st = service.stats
            counts = (st.device_images, st.device_programs, st.padded_images)
            peak = peak_bytes(device)
        clients.send(i, int(picks[i]))
    deadline = time.perf_counter() + max(0.0, t0 + seconds + extra - time.perf_counter()) + 60.0
    while not clients.all_done.is_set() and time.perf_counter() < deadline:
        fwd.serve_profiler(timeout=0.01)
    fwd.serve_profiler()
    fwd.finish()
    if counts is None:
        st = service.stats
        counts = (st.device_images, st.device_programs, st.padded_images)
        peak = peak_bytes(device)
    device_images, programs, padded = counts
    service.close()
    clients.close()

    due, done, sent = due[:in_window], clients.done[:in_window], clients.sent[:in_window]
    latency = np.where(np.isnan(done), np.inf, done - (t0 + due)) * 1e3
    late = (sent - (t0 + due)) * 1e3
    missing = int(np.isinf(latency).sum())
    spans = [s for s in fwd.spans if s[0] < t0 + seconds]
    serving_s = max((e for _, e, _ in spans), default=t0) - t0
    run = Run(model=cell.model, workload=w, chips=cell.chips, setup_s=t_window - t_start,
              window_s=float(due[-1]) if len(due) > 1 else seconds, peak_bytes=peak,
              counters={"attempted": len(due), "failed": missing, "raised": clients.failed,
                        "latency_ms": latency.tolist(), "late_ms": late[~np.isnan(late)].tolist(),
                        "waited_for_client": clients.waited, "device_images": device_images,
                        "device_programs": programs, "padded_images": padded,
                        "forward_s": sum(e - s for s, e, _ in spans), "forwards": len(spans),
                        "rows": sum(r for _, _, r in spans), "rows_s": serving_s})
    lat = run.counters["latency_ms"]
    run.summary = (f"requests {len(lat)}: p50 {percentile(lat, 50)} ms, p95 {percentile(lat, 95)} ms, "
                   f"p99 {percentile(lat, 99)} ms; missing {missing} ({clients.failed} raised); "
                   f"found no free client {clients.waited}; forwards {len(spans)}")
    if fwd.traced:
        run.trace = profiles[1].trace(len(fwd.rows[1]), fwd.rows[1])
        run.host_trace = profiles[2].trace(len(fwd.rows[2]), fwd.rows[2])
        run.counters["busy_s"], run.counters["trace_window_s"] = run.trace.busy_s(), run.trace.window_s

    # the sample that is checked, drawn from the seed among the finished requests
    finished = np.nonzero(~np.isinf(latency))[0]
    rng = np.random.default_rng(stream_seed(seed, "check"))
    sample = np.sort(rng.choice(finished, size=min(w["check_sample"], len(finished)), replace=False))
    labels = [clients.labels[i].tolist() for i in sample]
    probs = [clients.probs[i].tolist() for i in sample]
    del service, predictor, fwd, clients
    sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_logp = reference_logp(cell, seed, device, images_dev[torch.as_tensor(picks[sample], device=device)])
    return run, labels, probs, ref_logp


@torch.no_grad()
def reference_logp(cell: Cell, seed: int, device, images_u8: torch.Tensor, rows: int = 32):
    """The reference's log-probabilities [n, classes] (numpy) of ``images_u8``."""
    sd = make_weights(cell.model, seed, device)
    out = [torch.log_softmax(ref.logits(cell.model, sd, images_u8[r:r + rows]), dim=-1).cpu()
           for r in range(0, images_u8.shape[0], rows)]
    return torch.cat(out).double().numpy() if out else np.zeros((0, cell.model["num_classes"]))
