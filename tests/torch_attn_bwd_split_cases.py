"""Shared inputs, helpers and fixtures of tests/test_torch_attn_bwd_split.py,
tests/test_torch_attn_bwd_split_chunks.py."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu_torch.ops import flash_attention as fa

JAX_SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "attn_bwd_split_bench.py"
# (jax dtype, torch dtype, bound on max|Δ| / max|ref| and on the relative L2
# of dq/dk/dv).  Both are scaled by the reference: at the script's scales of
# v and dO, |dq| is a few 1e-3, so an absolute limit of 2e-2 would pass a zero
# gradient.  fp32: summation order only.  bf16: the max bound is PERF.md §2's
# 2e-2 scaled as its dsqk limit is (an output's last bf16 bit may land either
# side); the L2 bound holds the rounding points — moving any one of q̂_s, k̂,
# k̂_s, P or dS to fp32 puts 2.5e-3 or more into some output's relative L2,
# where the shared points leave it under 1e-4.
DTYPES = {
    "fp32": (jnp.float32, torch.float32, 1e-4, 1e-5),
    "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 1e-3),
}
# max|Δ dsqk| / max|dsqk|, both dtypes: dsqk is fp32 and sums the fp32 dq̂ and
# dk̂, so a moved bf16 rounding point shows there as 7e-4 or more
DSQK_RTOL = 1e-4
SCALE = 8.0  # the JAX script's SCALE, which its bwd_split bakes in
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def jax_script(tmp_path_factory):
    """scripts/attn_bwd_split_bench.py as a module, its import side effects
    kept off the shared lock file and the test run's JAX settings."""
    saved = {key: getattr(jax.config, key) for key in CACHE_KEYS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NVIT_TPU_LOCK", str(tmp_path_factory.mktemp("lock") / "lock"))
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location("jax_attn_bwd_split_bench", JAX_SCRIPT)
        module = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(module)
        finally:
            for key, value in saved.items():
                jax.config.update(key, value)
    yield module
    module._TPU_LOCK.close()


def inputs(seed, b, h, t, d):
    """q, k, v, sqk_eff [H, D], dO as float32 numpy arrays, the script's scales."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, t, d), dtype=np.float32) for _ in range(2))
    v = 0.3 * rng.standard_normal((b, h, t, d), dtype=np.float32)
    do = 0.1 * rng.standard_normal((b, h, t, d), dtype=np.float32)
    sqk = (1.0 + 0.1 * rng.standard_normal((h, d))).astype(np.float32)
    return q, k, v, sqk, do


def to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def forward_residuals(q, k, v, sqk, do, tdt):
    """The torch operands and the twin's forward (o, lse), row-max arm, at
    the script's SCALE = 8."""
    qt, kt, vt, dot = (to_torch(x, tdt) for x in (q, k, v, do))
    st = torch.from_numpy(sqk)
    o, lse = fa.flash_attention_qknorm_ref(qt, kt, vt, st, SCALE)
    return qt, kt, vt, st, dot, o, lse
