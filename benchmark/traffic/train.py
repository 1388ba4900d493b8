"""The training cells: the program's step driven back to back over a pool
of batches, on one card or as one rank of several.

Set-up builds the one ``TrainState`` the window drives, with the weights
drawn from the seed, and runs its first ``check_steps`` steps through the
window's own call on distinct batches: they are the warm-up, and the
reference follows them.  The window then dispatches steps back to back
and syncs once at its end.  Over several ranks the step count is fixed
before the window from two timed steps, so every rank runs the same steps.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from benchmark.device import peak_bytes, reset_peak, stage, sync
from benchmark.record import Run
from benchmark.reference import check
from benchmark.reference import model as ref
from benchmark.spec import Cell, port_config
from benchmark.trace import Profile, warm_profiler
from benchmark.weights import generator, make_images, make_weights


def set_backends() -> None:
    """fp32 products in fp32 (no TF32), and cuBLAS's bf16 split-K partials
    summed in fp32, as the program's Trainer sets it on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def data(cell: Cell, seed: int, rank: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s pool: uint8 images [P, B, C, S, S] and labels [P, B]."""
    w, m = cell.workload, cell.model
    p, b, s = w["pool_batches"], w["batch_per_rank"], m["image_size"]
    g = generator(device, seed, "data", rank)
    images = make_images(p * b, s, m["channels"], g, device).view(p, b, m["channels"], s, s)
    labels = torch.randint(0, m["num_classes"], (p, b), generator=g, device=device)
    return images, labels


def check_batches(cell: Cell, seed: int, device, ranks: list[int]) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The checked steps' global batches over ``ranks`` (rank order)."""
    pools = [data(cell, seed, r, device) for r in ranks]
    n = cell.workload["check_steps"]
    p = cell.workload["pool_batches"]
    return [(torch.cat([im[i % p] for im, _ in pools]), torch.cat([lb[i % p] for _, lb in pools]))
            for i in range(n)]


def reference(cell: Cell, seed: int, device, world: int, quant=None, rows_of=None) -> dict:
    """The reference's readings over the checked steps of the global batch
    (``rows_of``: keep only these rows of each batch, for a planted fault)."""
    sd0 = make_weights(cell.model, seed, device)
    batches = check_batches(cell, seed, device, list(range(world)))
    if rows_of is not None:
        batches = [(im[rows_of], lb[rows_of]) for im, lb in batches]
    return ref.train_steps(cell.model, cell.config["optimizer"], sd0, batches,
                           cell.workload["reference_rows"], quant)


class Program:
    """The program's training step on this rank, built and warmed."""

    def __init__(self, cell: Cell, seed: int, device, group=None):
        from nvit_tpu_torch.data.augment import normalize
        from nvit_tpu_torch.models.vit import ViT
        from nvit_tpu_torch.parallel.mesh import broadcast_
        from nvit_tpu_torch.train.optim import init_fused_adamw
        from nvit_tpu_torch.train.state import TrainState
        from nvit_tpu_torch.train.step import make_train_step

        self.cell, self.seed, self.device, self.group = cell, seed, device, group
        self.rank = 0 if group is None else group.rank
        self.world = 1 if group is None else group.world
        cfg = port_config(cell.config)
        model = ViT(cfg.model, device=device)
        model.load_state_dict(make_weights(cell.model, seed, device), strict=True)
        if group is not None:  # the initial broadcast of data parallelism
            broadcast_(group, model.state_dict().values())
        self.state = TrainState(model=model, opt_state=init_fused_adamw(model.named_parameters(),
                                                                         cfg.optimizer.moments_dtype),
                                step=0, generator=torch.Generator())
        self.images, self.labels = data(cell, seed, self.rank, device)
        self.normalize = normalize
        self.step_fn = make_train_step(cfg, log_norms=False, group=group)
        self.beta1 = cfg.optimizer.beta1
        self.steps = 0

    def step(self):
        i = self.steps % self.images.shape[0]
        self.steps += 1
        return self.step_fn(self.state, self.normalize(self.images[i]), self.labels[i])[1]

    def check_steps(self) -> dict:
        """The first steps, read as the reference reads its own."""
        out: dict = {"loss": [], "reconstruction": []}
        for i in range(self.cell.workload["check_steps"]):
            metrics = self.step()
            out["loss"].append(metrics["total_loss"].item())
            out["reconstruction"].append(metrics["reconstruction"].item())
            if i == 0:
                mu = self.state.opt_state.mu
                norms = torch.stack([(m.float() / (1.0 - self.beta1)).norm() for m in mu.values()])
                out["grad_norm"] = dict(zip(mu, norms.tolist()))
        with torch.no_grad():
            sd0 = make_weights(self.cell.model, self.seed, self.device)
            params = dict(self.state.model.named_parameters())
            norms = torch.stack([(params[n].float() - sd0[n]).norm() for n in sd0])
            out["delta_norm"] = dict(zip(sd0, norms.tolist()))
            del sd0
        return out

    def close(self) -> None:
        del self.state, self.step_fn, self.images, self.labels
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _reduce_max(group, value: float) -> float:
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.control)
    return float(t.item())


def _broadcast(group, value: float) -> float:
    t = torch.tensor([value], dtype=torch.float64)
    dist.broadcast(t, src=0, group=group.control)
    return float(t.item())


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, group=None):
    """One run on this rank → (Run, the numbers that decide ``correct``;
    None on ranks but 0)."""
    set_backends()
    w = cell.workload
    prog = Program(cell, seed, device, group)
    stage("weights, data and the step", t_start)
    readings = prog.check_steps()
    stage("the checked steps", t_start)
    sync(device)
    if group is None:
        reset_peak(device)
        t_window = time.time()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            prog.step()
        sync(device)
        window_s = time.perf_counter() - t0
        steps = prog.steps - w["check_steps"]
    else:
        # every rank runs the same steps: a count from two timed steps, then
        # rank 0's top-up to the window's length (a host exchange, no sync)
        ta = time.perf_counter()
        for _ in range(2):
            prog.step()
        sync(device)
        per = _reduce_max(group, (time.perf_counter() - ta) / 2)
        steps = int(_broadcast(group, max(1, math.ceil(seconds / per))))
        reset_peak(device)
        dist.barrier(group=group.control)
        t_window = time.time()
        t0 = time.perf_counter()
        for _ in range(steps):
            prog.step()
        elapsed = time.perf_counter() - t0
        more = int(_broadcast(group, math.ceil(max(0.0, seconds - elapsed) * steps / elapsed)))
        for _ in range(more):
            prog.step()
        steps += more
        sync(device)
        window_s = _reduce_max(group, time.perf_counter() - t0)
    peak = peak_bytes(device)
    if group is not None:
        peak = int(_reduce_max(group, peak))
    b = w["batch_per_rank"]
    images = steps * b * prog.world
    run = Run(model=cell.model, workload=w, chips=cell.chips, backward=True,
              setup_s=t_window - t_start, window_s=window_s, peak_bytes=peak,
              counters={"attempted": steps, "failed": 0, "steps": steps, "images": images,
                        "rows": steps * b, "rows_s": window_s},
              summary=f"steps {steps} in {window_s} s; images {images}")
    if trace:
        # the profiler's start-up, after the window: once started it slows
        # every later launch a little
        if device.type == "cuda":
            warm_profiler(device)
        sess = Profile(device)
        sess.start()
        for _ in range(w["trace_steps"]):
            prog.step()
        sess.stop()
        run.trace = sess.trace(w["trace_steps"], [b] * w["trace_steps"])
        host = Profile(device, host=True)  # names the idle gaps; slows the host
        host.start()
        for _ in range(w["host_trace_steps"]):
            prog.step()
        host.stop()
        run.host_trace = host.trace(w["host_trace_steps"], [b] * w["host_trace_steps"])
        busy = [run.trace.busy_s(), run.trace.window_s]
        if group is not None:
            every = [None] * prog.world
            dist.all_gather_object(every, busy, group=group.control)
            busy = [sum(x[0] for x in every) / prog.world, busy[1]]
        run.counters["busy_s"], run.counters["trace_window_s"] = busy
    prog.close()
    del prog
    numbers = None
    if group is None or group.rank == 0:
        numbers = check.train_numbers(readings, reference(cell, seed, device, 1 if group is None else group.world))
    if group is not None:
        dist.barrier(group=group.control)
    return run, numbers


def readings(cell: Cell, seed: int, device, group=None, program: bool = True, control: bool = True,
             seconds: float = 0.0):
    """The readings that the limits are set from, for one seed → (what,
    numbers) pairs on rank 0: the program's first steps against the
    reference; with ``control`` the reference in fp8 in the program's
    place, half of each batch left out (the mean over the rest) and, for a
    cell on several cards, the exchange left out (rank 0's rows alone).
    The control and the faults need one card only."""
    set_backends()
    rank0 = group is None or group.rank == 0
    world = cell.chips
    ref_readings, ref_world = None, None
    if program:
        prog = Program(cell, seed, device, group)
        got = prog.check_steps()
        prog.close()
        del prog
        if rank0:
            ref_world = 1 if group is None else group.world
            ref_readings = reference(cell, seed, device, ref_world)
            yield "program", check.train_numbers(got, ref_readings)
    if rank0 and control:
        if ref_world != world:
            ref_readings = reference(cell, seed, device, world)
        fp8 = reference(cell, seed, device, world, quant=ref.fp8_quant)
        yield "control fp8", check.train_numbers(fp8, ref_readings)
        rows = cell.workload["batch_per_rank"] * world
        half = reference(cell, seed, device, world, rows_of=slice(0, rows // 2))
        yield "fault half batch", check.train_numbers(half, ref_readings)
        if world > 1:
            yield "fault no exchange", check.train_numbers(reference(cell, seed, device, 1), ref_readings)
    if group is not None:
        dist.barrier(group=group.control)
