"""K10, the q-sub-tiled QK-norm attention backward, against the JAX package.

K10 replaces scripts/attn_bwd_split_bench.py::_bwd_split_kernel; in the port
it is a CUDA kernel (``qknorm_attention_bwd_subtiled``) whose CPU dispatch is
its plain twin.  Here the twin is held against the script's own
``bwd_split``, run as the JAX tests run the Pallas kernels
(``force_tpu_interpret_mode``), against the integrated backward's twin (K2's)
and through the port of the script's ``main()``.  Inputs are made from a
seed with numpy and handed to both frameworks.

The JAX script is imported from its file, not run: at import it takes an
exclusive flock on the TPU lock file (``acquire_tpu_lock``, which waits up
to 7200 s for another holder) and points JAX's persistent compile cache into
the repository. So the import runs with ``NVIT_TPU_LOCK`` on a private file,
and the two cache settings (and ``sys.path``, which the script extends) are
restored right after it.

Companion files: tests/test_torch_attn_bwd_split_chunks.py; shared inputs:
tests/torch_attn_bwd_split_cases.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nvit_tpu_torch.ops import flash_attention as fa
from tests.torch_attn_bwd_split_cases import (
    DSQK_RTOL,
    DTYPES,
    SCALE,
    as_np,
    forward_residuals,
    inputs,
    jax_script,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(1, 4, 128, 64), (1, 3, 112, 32)])  # [BH, T, D] = [4, 128, 64], [3, 112, 32]
@pytest.mark.parametrize("nsplit", [2, 7])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k10_twin_matches_pallas_bwd_split(jax_script, shape, nsplit, dtype):
    """The twin against the script's ``bwd_split`` (the Pallas kernel in
    interpret mode) on the same operands and forward residuals; JAX's
    [BH, …] is the port's [B, H, …] reshaped."""
    jdt, tdt, max_rtol, l2_rtol = DTYPES[dtype]
    assert jax_script.SCALE == SCALE
    b, h, t, d = shape
    q, k, v, sqk, do = inputs(t + d + nsplit, b, h, t, d)
    qt, kt, vt, st, dot, o, lse = forward_residuals(q, k, v, sqk, do, tdt)
    got = fa.qknorm_attention_bwd_subtiled_ref(qt, kt, vt, st, SCALE, o, lse, dot, nsplit)

    def jx(x, dt):
        return jnp.asarray(as_np(x).reshape(b * h, t, -1)).astype(dt)

    s3 = jnp.asarray(np.repeat(sqk[None, :, None, :], b, axis=0).reshape(b * h, 1, d))
    with pltpu.force_tpu_interpret_mode():
        want = jax_script.bwd_split(nsplit, jx(qt, jdt), jx(kt, jdt), jx(vt, jdt), s3, jx(dot, jdt),
                                    jx(lse.unsqueeze(-1), jnp.float32), jx(o, jdt))
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert g.dtype == tdt and g.shape == (b, h, t, d), name
        g, w = as_np(g).reshape(b * h, t, d), as_np(w)
        assert np.abs(g - w).max() <= max_rtol * np.abs(w).max(), name
        assert np.linalg.norm(g - w) <= l2_rtol * np.linalg.norm(w), name
    dsqk, dsqk_ref = as_np(got[3]).reshape(b * h, d), as_np(want[3]).reshape(b * h, d)
    assert got[3].dtype == torch.float32
    assert np.abs(dsqk - dsqk_ref).max() <= DSQK_RTOL * np.abs(dsqk_ref).max()


@pytest.mark.parametrize("nsplit", [2, 7])
def test_k10_twin_matches_the_integrated_twin(nsplit):
    """One pass over the sub-tiles computes K2's function: the twin against
    ``qknorm_attention_bwd_ref`` (row-max arm) within the script's 3e-2 max
    relative error, bf16."""
    from nvit_tpu_torch.scripts.attn_bwd_split_bench import MAX_REL_ERR, max_rel_err

    q, k, v, sqk, do = inputs(3 + nsplit, 2, 2, 128, 64)
    qt, kt, vt, st, dot, o, lse = forward_residuals(q, k, v, sqk, do, torch.bfloat16)
    got = fa.qknorm_attention_bwd_subtiled_ref(qt, kt, vt, st, SCALE, o, lse, dot, nsplit)
    want = fa.qknorm_attention_bwd_ref(qt, kt, vt, st, SCALE, o, lse, dot)
    for name, g, w in zip(("dq", "dk", "dv", "dsqk"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert max_rel_err(w, g) < MAX_REL_ERR, name


def test_k10_dispatch_and_refusals():
    """CPU tensors run the twin; the kernel's launcher refuses them and
    counts nothing; a T off the 16-row grid or an nsplit that leaves an
    empty sub-tile raises on both."""
    q, k, v, sqk, do = inputs(5, 1, 2, 64, 32)
    qt, kt, vt, st, dot, o, lse = forward_residuals(q, k, v, sqk, do, torch.bfloat16)
    args = (qt, kt, vt, st, SCALE, o, lse, dot)
    got = fa.qknorm_attention_bwd_subtiled(*args, 2)
    want = fa.qknorm_attention_bwd_subtiled_ref(*args, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    before = fa.qknorm_attention_bwd_subtiled.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch_bwd_subtiled(*args, 2)
    for fn in (fa.qknorm_attention_bwd_subtiled, fa.qknorm_attention_bwd_subtiled_ref,
               fa._launch_bwd_subtiled):
        with pytest.raises(ValueError, match="empty q sub-tile"):
            fn(*args, 5)  # ((64 // 5) // 16)·16 = 0
    assert fa.qknorm_attention_bwd_subtiled.launches == before

    q, k, v, sqk, do = inputs(6, 1, 2, 100, 32)
    qt, kt, vt, st, dot, o, lse = forward_residuals(q, k, v, sqk, do, torch.bfloat16)
    for fn in (fa.qknorm_attention_bwd_subtiled, fa._launch_bwd_subtiled):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(qt, kt, vt, st, SCALE, o, lse, dot, 2)


def test_bench_entry_point_on_the_cpu(capsys):
    """``python -m nvit_tpu_torch.scripts.attn_bwd_split_bench --device cpu``
    at a small shape: the error lines, the four times and DONE; without a
    card and without ``--device cpu`` it exits non-zero."""
    from nvit_tpu_torch.scripts import attn_bwd_split_bench as bench

    result = bench.main(["--device", "cpu", "--batch", "1", "--heads", "2", "--t", "128"])
    out = capsys.readouterr().out
    for nsplit in bench.NSPLITS:
        for name in bench.GRADS:
            assert f"nsplit={nsplit} {name}: max_rel_err=" in out
    for tag in ("integrated (nsplit=1)", "rowmax (K2)", "split nsplit=2", "split nsplit=7"):
        assert any(line.startswith(tag) and " ms " in line for line in out.splitlines()), tag
        assert result["ms"][tag] > 0
    assert out.rstrip().endswith("DONE")
    per_arm = bench.WARMUP + bench.ITERS
    assert result["calls"] == {"integrated": 1 + per_arm, "rowmax": 1 + per_arm,
                               "subtiled": len(bench.NSPLITS) * (1 + per_arm)}
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as exc:
            bench.main([])
        assert exc.value.code not in (0, None)
