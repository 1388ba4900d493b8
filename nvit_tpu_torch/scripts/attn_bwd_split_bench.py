"""The q-sub-tiled QK-norm attention backward (K10) against the integrated
one (≙ scripts/attn_bwd_split_bench.py).

The JAX script is an A/B of the integrated QK-norm backward (``_bwd_qknorm``
in static "bounded" mode) against ``_bwd_split_kernel``, the same function
walked in ``nsplit`` independent query sub-tiles, at the flagship shape
[B·H, T, D] = [384, 784, 64] bf16 — one layer's worth per call.  This is its
``main()`` on the port, with B·H as B = 32, H = 12 of the port's
[B, H, T, D] layout: one forward through K5 ("bounded") for o and lse; the
reference backward through K5's backward; K10 at nsplit 2 and 7, each held
to a max relative error below 3e-2 on dq, dk, dv and dsqk; K2 (the row-max
recompute, equal to K5's here where the clamp is inert) once beside them;
then the times of all four.  It ends with ``DONE``.

On the card (the default; times by CUDA events)::

    python -m nvit_tpu_torch.scripts.attn_bwd_split_bench

On the CPU, through the plain twins at a small shape (times on the host
clock, of the twins)::

    python -m nvit_tpu_torch.scripts.attn_bwd_split_bench --device cpu --batch 1 --heads 2 --t 128

Without a card it exits non-zero unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from nvit_tpu_torch.ops import flash_attention as fa

BH, T, D = 384, 784, 64
H = 12  # the port's [B, H, T, D] layout of BH: B = 32
B = BH // H
SCALE = 8.0  # sqrt(64)
WARMUP, ITERS = 2, 30
NSPLITS = (2, 7)
MAX_REL_ERR = 3e-2  # the script's bound on every gradient, against the integrated backward
GRADS = ("dq", "dk", "dv", "dsqk")


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the kernels) or cpu (the plain twins)")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--heads", type=int, default=H)
    p.add_argument("--t", type=int, default=T, help="tokens (a multiple of 16)")
    return p.parse_args(argv)


def make_inputs(b: int, h: int, t: int, device: torch.device, seed: int = 0):
    """The script's distributions, from one generator: q, k ~ N(0, 1), v ~
    0.3·N, dO ~ 0.1·N in bf16, and one [D] row s = 1 + 0.02·N(0, 1) shared
    by every head → (q, k, v, sqk_eff [H, D] fp32, do)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    q = normal(b, h, t, D).to(torch.bfloat16)
    k = normal(b, h, t, D).to(torch.bfloat16)
    v = normal(b, h, t, D).to(torch.bfloat16) * 0.3
    s = 1.0 + 0.02 * normal(D)
    do = normal(b, h, t, D).to(torch.bfloat16) * 0.1
    return q, k, v, s.expand(h, D).contiguous(), do


def max_rel_err(ref: torch.Tensor, got: torch.Tensor) -> float:
    a, b = ref.float(), got.float()
    return ((a - b).abs().max() / (a.abs().max() + 1e-9)).item()


def time_fn(tag: str, fn, on_card: bool) -> float:
    """Mean ms of ``fn`` over ITERS calls after WARMUP: CUDA events around
    the loop on the card, the host clock on the CPU."""
    for _ in range(WARMUP):
        outs = fn()
    if on_card:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            outs = fn()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / ITERS
    else:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            outs = fn()
        dt = (time.perf_counter() - t0) / ITERS * 1e3
    chk = outs[0].float().sum().item()
    clock = "CUDA events" if on_card else "host clock, CPU twins"
    print(f"{tag:28s} {dt:8.3f} ms   (chk {chk:.5e}; {clock}, mean of {ITERS})", flush=True)
    return dt


def main(argv: list[str] | None = None) -> dict:
    """Run the A/B → {"calls": backward calls per arm, "max_rel_err":
    {arm: {grad: err}}, "ms": {arm: ms}}; raises ``AssertionError`` if K10
    misses the 3e-2 bound."""
    args = parse_args(argv)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("attn_bwd_split_bench: no CUDA device; pass --device cpu to run the plain twins")
    print(f"device: {torch.cuda.get_device_name(device) if on_card else 'cpu (plain twins)'}; "
          f"[B, H, T, D] = [{args.batch}, {args.heads}, {args.t}, {D}] bf16, scale {SCALE:g}", flush=True)
    q, k, v, sqk, do = make_inputs(args.batch, args.heads, args.t, device)

    # forward once in "bounded" mode (K5), the JAX script's, for o and lse
    if on_card:
        o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, SCALE, with_lse=True, mode="bounded")
    else:
        o, lse = fa.flash_attention_qknorm_ref(q, k, v, sqk, SCALE, "bounded")
    bwd = fa.qknorm_attention_bwd if on_card else fa.qknorm_attention_bwd_ref
    calls = {"integrated": 0, "rowmax": 0, "subtiled": 0}

    def integrated():  # ≙ _bwd_qknorm(static, …) with static = (SCALE, T, "bounded"): K5's backward
        calls["integrated"] += 1
        return bwd(q, k, v, sqk, SCALE, o, lse, do, "bounded")

    def rowmax():  # K2
        calls["rowmax"] += 1
        return bwd(q, k, v, sqk, SCALE, o, lse, do, "rowmax")

    def subtiled(nsplit):  # K10
        calls["subtiled"] += 1
        return fa.qknorm_attention_bwd_subtiled(q, k, v, sqk, SCALE, o, lse, do, nsplit)

    ref = integrated()
    errors = {}
    for nsplit in NSPLITS:
        outs = subtiled(nsplit)
        errors[f"nsplit={nsplit}"] = err = {n: max_rel_err(a, b) for n, a, b in zip(GRADS, ref, outs)}
        for name in GRADS:
            print(f"nsplit={nsplit} {name}: max_rel_err={err[name]:.3e}", flush=True)
        for name in GRADS:
            if not err[name] < MAX_REL_ERR:
                raise AssertionError((nsplit, name, err[name]))
    errors["rowmax"] = err = {n: max_rel_err(a, b) for n, a, b in zip(GRADS, ref, rowmax())}
    for name in GRADS:
        print(f"rowmax (K2) {name}: max_rel_err={err[name]:.3e}", flush=True)

    ms = {"integrated (nsplit=1)": time_fn("integrated (nsplit=1)", integrated, on_card),
          "rowmax (K2)": time_fn("rowmax (K2)", rowmax, on_card)}
    for nsplit in NSPLITS:
        tag = f"split nsplit={nsplit}"
        ms[tag] = time_fn(tag, lambda n=nsplit: subtiled(n), on_card)
    print("DONE", flush=True)
    return {"calls": calls, "max_rel_err": errors, "ms": ms}


if __name__ == "__main__":
    main()
