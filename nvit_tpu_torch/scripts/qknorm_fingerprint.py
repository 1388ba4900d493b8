"""The attention kernels' outputs on seeded inputs, saved, and two such
files compared byte for byte: a change to the tile loops K1, K2, K5, K7, K8
and K9 share with each other (and K10) is held to their earlier outputs.

    PYTHONPATH=<tree> python nvit_tpu_torch/scripts/qknorm_fingerprint.py --out <file>
    python nvit_tpu_torch/scripts/qknorm_fingerprint.py --compare <file> <file>
    PYTHONPATH=<tree> python nvit_tpu_torch/scripts/qknorm_fingerprint.py --time

The first form runs, with whichever ``nvit_tpu_torch`` comes first on
``PYTHONPATH``, the projection prologue, K1 (``mode="rowmax"``), K5's
forward ("bounded", "auto"), K2 and K5's backward, and the plain kernels K7,
K8 (with their prologue) and K9 at chip_smoke.py's check shapes —
[4, 12, 784, 64] and [2, 4, 100, 32], and [2, 12, 1100, 64] where the JAX
package takes K9, q/k/v as contiguous tensors and as strided views of one
fused QKV buffer — on inputs made on the card from fixed seeds, and saves
every output (o, lse, dq, dk, dv, dsqk, q̂_s, k̂, k̂_s, qs, ks, the padded lse
and Δ) to ``--out``.  Run it once per tree on the same
card.  The second form prints, per output, whether the two files hold the
same bytes, and exits non-zero if any differs.  The third times each of the
four QK-norm calls (K1, K5's forward, K2, K5's backward, the prologue included) at
the batch-32 shape [32, 12, 784, 64] on strided QKV views, by CUDA events:
the median of 20 single calls, as chip_smoke.py times them, which carries
the wrappers' host time, and the median over 5 runs of 20 back-to-back
calls of a run's mean, in which the card, not the host, sets the pace.  It
prints the card's name and power limit and one JSON line; run it with each
tree in turns (parent, change, change, parent).  It uses only entry points
that the attention kernels have had since their wgmma designs, so an earlier
tree can write the first file.  Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import sys

import torch

SHAPES = ((4, 12, 784, 64), (2, 4, 100, 32))
PLAIN_SHAPES = SHAPES + ((2, 12, 1100, 64),)  # K9's T


def inputs(b, h, t, d, seed, view):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if view:  # heads as strided views of one fused [B, T, 3·H·D] projection
        qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = (x.reshape(b, t, h, d).permute(0, 2, 1, 3) for x in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn(b, h, t, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    sqk = 1.0 + 0.1 * torch.randn(h, d, generator=g, device="cuda")
    do = torch.randn(b, t, h, d, generator=g, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)
    return q, k, v, sqk, do


def fingerprint() -> dict[str, torch.Tensor]:
    from nvit_tpu_torch.ops import flash_attention as fa

    out = {}
    for b, h, t, d in SHAPES:
        for view in (False, True):
            tag = f"{b}x{h}x{t}x{d}{'-view' if view else ''}"
            q, k, v, sqk, do = inputs(b, h, t, d, seed=t + d + view, view=view)
            scale = float(d) ** 0.5
            for mode in ("rowmax", "bounded", "auto"):
                o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True, mode=mode)
                out[f"{tag}/{mode}/o"], out[f"{tag}/{mode}/lse"] = o, lse
                if mode == "auto":  # its backward is K2's, taken below
                    continue
                for name, x in zip(("dq", "dk", "dv", "dsqk"), fa.qknorm_attention_bwd(q, k, v, sqk, scale, o, lse,
                                                                                      do, mode)):
                    out[f"{tag}/{mode}/{name}"] = x
            o, lse = out[f"{tag}/rowmax/o"], out[f"{tag}/rowmax/lse"]
            for name, x in zip(("qs", "kh", "ks", "lse_pad", "delta_pad"),
                               fa.qknorm_project_bf16(q, k, sqk, scale, o=o, do=do, lse=lse)):
                out[f"{tag}/prologue/{name}"] = x
    for b, h, t, d in PLAIN_SHAPES:  # K7, K8 and K9 (and their prologue)
        for view in (False, True):
            tag = f"{b}x{h}x{t}x{d}{'-view' if view else ''}/plain"
            q, k, v, _, do = inputs(b, h, t, d, seed=t + d + view + 7, view=view)
            scale = float(d) ** -0.5
            o, lse = fa.flash_attention_fwd(q, k, v, scale, with_lse=True)
            out[f"{tag}/K7/o"], out[f"{tag}/K7/lse"] = o, lse
            for name, x in zip(("dq", "dk", "dv"), fa.attention_bwd_fused(q, k, v, o, lse, do, scale)):
                out[f"{tag}/K8/{name}"] = x
            delta = fa.attention_delta(o, do)
            for name, x in zip(("dq", "dk", "dv"), fa.attention_bwd_split(q, k, v, do, lse, delta, scale)):
                out[f"{tag}/K9/{name}"] = x
            for name, x in zip(("qs", "ks", "lse_pad", "delta_pad"),
                               fa.flash_project_bf16(q, k, scale, lse=lse, o=o, do=do)):
                out[f"{tag}/prologue/{name}"] = x
    torch.cuda.synchronize()
    return {key: x.detach().contiguous().cpu() for key, x in out.items()}


def times() -> dict[str, dict[str, float]]:
    import statistics

    from nvit_tpu_torch.ops import flash_attention as fa

    q, k, v, sqk, do = inputs(32, 12, 784, 64, seed=11, view=True)
    scale = 8.0
    o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
    o_b, lse_b = fa.qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True, mode="bounded")
    calls = {
        "K1": lambda: fa.qknorm_attention_fwd(q, k, v, sqk, scale),
        "K5 forward": lambda: fa.qknorm_attention_fwd(q, k, v, sqk, scale, mode="bounded"),
        "K2": lambda: fa.qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do),
        "K5 backward": lambda: fa.qknorm_attention_bwd(q, k, v, sqk, scale, o_b, lse_b, do, "bounded"),
    }
    def event_ms(fn, calls: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    out = {"single": {}, "run of 20": {}}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out["single"][name] = statistics.median(event_ms(fn, 1) for _ in range(20))
        out["run of 20"][name] = statistics.median(event_ms(fn, 20) for _ in range(5))
    return out


def compare(a: str, b: str) -> int:
    fa_, fb = torch.load(a), torch.load(b)
    if fa_.keys() != fb.keys():
        print(f"the files hold different outputs: {sorted(fa_.keys() ^ fb.keys())}")
        return 1
    differ = 0
    for key in fa_:
        same = fa_[key].dtype == fb[key].dtype and fa_[key].shape == fb[key].shape and torch.equal(
            fa_[key].view(torch.uint8), fb[key].view(torch.uint8))
        differ += not same
        print(f"{key}: {'bit-equal' if same else 'DIFFERS'}")
    print(f"{len(fa_) - differ} of {len(fa_)} outputs bit-equal")
    return int(differ > 0)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="write this tree's outputs here")
    p.add_argument("--compare", nargs=2, metavar="FILE", help="compare two files of outputs")
    p.add_argument("--time", action="store_true", help="time the four calls at the batch-32 shape")
    args = p.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not (args.out or args.time):
        p.error("give --out, --compare or --time")
    if not torch.cuda.is_available():
        print("qknorm_fingerprint: no CUDA card", file=sys.stderr)
        return 1
    import json
    import subprocess

    import nvit_tpu_torch

    print(f"nvit_tpu_torch from {nvit_tpu_torch.__file__}")
    if args.time:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
        print(smi)
        print(json.dumps({"ms": times()}))
        return 0
    out = fingerprint()
    torch.save(out, args.out)
    print(f"{len(out)} outputs written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
