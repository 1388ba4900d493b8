"""The comparison that decides ``correct``: the numbers read from the
program's timed path against the plain reference's, each held to its limit
from the workload file.

Training (the first steps of the object the window then drives):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``recon_gap``: the same of the reported reconstruction term;
* ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step, over ``1 − β₁``), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same of each leaf's change over the checked steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by weight decay and round-off alone).

Serving (a sample of the finished requests, drawn from the seed):

* ``mean_logp_gap``: the mean gap between a returned probability's log and
  the reference's at the returned class, over every class returned to the
  sample (the largest gap, and how far the returned first class lies below
  the reference's best, do not separate the program from its int8 path);
* ``missing``: requests that failed or never came back (exact: limit 0).
"""

from __future__ import annotations

import math
import statistics

EXCLUDE_BELOW = 1e-3  # a leaf's gradient under this share of the median leaf's


def _leaf_gap(prog: dict[str, float], ref: dict[str, float], names) -> float:
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref`` as ``reference.model.train_steps`` returns them."""
    def rel(key):
        return max(abs(p - r) / abs(r) for p, r in zip(prog[key], ref[key], strict=True))

    med = statistics.median(ref["grad_norm"].values())
    moving = [n for n, g in ref["grad_norm"].items() if g >= EXCLUDE_BELOW * med]
    return {
        "loss_gap": rel("loss"),
        "recon_gap": rel("reconstruction"),
        "grad_gap": _leaf_gap(prog["grad_norm"], ref["grad_norm"], ref["grad_norm"]),
        "change_gap": _leaf_gap(prog["delta_norm"], ref["delta_norm"], moving),
    }


def serve_numbers(labels, probs, ref_logp, missing: int) -> dict[str, float]:
    """``labels`` / ``probs``: each sampled request's returned classes and
    probabilities (lists); ``ref_logp``: [n, classes] reference
    log-probabilities of the same requests' images."""
    gaps = [abs(math.log(p) - float(ref[c])) if p > 0 else math.inf
            for lab, pr, ref in zip(labels, probs, ref_logp, strict=True) for c, p in zip(lab, pr)]
    return {"mean_logp_gap": sum(gaps) / len(gaps) if gaps else math.inf, "missing": float(missing)}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """→ (every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())  # NaN fails
    return ok, checks
