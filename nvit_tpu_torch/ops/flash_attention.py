"""Flash attention: the CUDA kernels, their plain twins, and the
``autograd.Function``s that join them.

nViT mode (QK-norm): K1 replaces nvit_tpu/ops/flash_attention.py::
_fwd_qknorm_kernel (row-max arm), launched there by ``_fwd_qknorm_call``; K2
replaces ``_bwd_fused_qknorm_kernel``, launched by ``_bwd_qknorm``.  K5 is
their bounded-softmax arm, chosen by ``mode`` (≙ ``_fwd_qknorm``'s):
"rowmax" (K1, K2), "bounded" (K5 forward and backward) or "auto" (K5's
forward for every head while scale·max(sqk_eff²) < 20, else K1's — the card
decides, so the host never waits — and K2 backward, as ``_bwd_qknorm``).
The kernels are ``csrc/qknorm_attn_fwd.cu`` and ``csrc/qknorm_attn_bwd.cu``
(wgmma, ``csrc/hopper.cuh``), each after the projection prologue
``csrc/qknorm_project.cu`` (``qknorm_project_bf16``), which rounds q̂/k̂ to
bf16 once per call; K5's launches are counted apart (``.launches_bounded``,
``.launches_auto``).
Past ``FUSED_BWD_MAX_T`` the JAX package projects q̂/k̂ in fp32 and takes the
plain flash kernels whatever the mode; so does ``flash_attention_qknorm``.
K10 (``qknorm_attention_bwd_subtiled``, in ``csrc/qknorm_attn_bwd.cu``)
replaces scripts/attn_bwd_split_bench.py::_bwd_split_kernel, K2's plain
recompute walked in ``nsplit`` query sub-tiles in one pass: after the same
prologue, K2's dK/dV walk over the sub-tiles' chunks (``subtile_chunks``)
with a fifth product for each key tile's share of dq̂, summed over the key
tiles by a second kernel.  It is on no training or serving path, only
behind that script's port (``nvit_tpu_torch.scripts.attn_bwd_split_bench``).

Baseline mode (plain softmax(q·kᵀ·scale)·v): K7 replaces ``_fwd_kernel``
(launched by ``_fwd``); K8 replaces ``_bwd_fused_kernel`` and K9 the split
``_dq_kernel`` / ``_dkv_kernel``, both launched by ``_bwd``.  The kernels are
``csrc/flash_attn_fwd.cu`` (K7) and ``csrc/flash_attn_bwd.cu`` (K8 and K9:
one tiled backward whose dQ pass keeps either kernel's rounding), after the
backward's prologue ``flash_project_bf16`` (``csrc/qknorm_project.cu``'s
plain mode), which rounds q·scale (and k·scale for K8) to bf16 once per call.
They run the QK-norm kernels' wgmma tile loops (``csrc/attn_fwd.cuh``,
``csrc/attn_bwd.cuh``) with the plain operands; the sources' headers say what
bounds them on the H100 and how the designs answer that.

``flash_attention_qknorm`` and ``flash_attention`` take q/k/v as
``[B, H, T, D]`` tensors — any strides with a contiguous last dim, so the
heads can stay views of the fused QKV projection — and are differentiable:

* CUDA tensors launch the kernels (bf16, head dim 32 or 64) or raise;
* CPU tensors run the ``*_ref`` twins, the plain PyTorch versions of the TPU
  kernels' math with their rounding points, forward and backward.

Without autograd (``torch.inference_mode``, ``no_grad``, or no input that
requires grad) the forward computes no lse and saves nothing: it is the
registered operator ``torch.ops.nvit.qknorm_attention`` or
``torch.ops.nvit.flash_attention`` (end of this file), which
``torch.export`` records as a call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NORM_EPS = 1e-30  # ≙ flash_attention.py _NORM_EPS: floors all-zero rows
BLOCK = 64  # K2's tile rows (csrc/qknorm_attn_bwd.cu)
# softmax stabilizers of the QK-norm kernels, by their kernel-side number
MODES = {"rowmax": 0, "bounded": 1, "auto": 2}
BOUND_GATE = 20.0  # ≙ _BOUND_GATE: "auto" takes the bounded arm below it
BOUNDED_EXP_FLOOR = -60.0  # ≙ _BOUNDED_EXP_FLOOR: exp arguments clamped at it


def _norm32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(x/max(‖x‖, eps), max(‖x‖, eps))`` (≙ flash_attention.py:_normed_scaled)."""
    x32 = x.float()
    norm = torch.clamp_min(torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True)), NORM_EPS)
    return x32 / norm, norm


def _normed_scaled(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fp32 ``s ⊙ x/max(‖x‖, eps)``, the multiply order of the TPU kernels."""
    return s * _norm32(x)[0]


_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def _entry(lib: str, symbol: str, argtypes: tuple):
    """The C entry point ``symbol`` of ``csrc/<lib>.cu``, built and typed at
    first use and kept: the QK-norm wrappers run twice per attention call,
    so the per-call Python stays small."""
    from nvit_tpu_torch.ops._build import load_library

    fn = getattr(load_library(lib), symbol)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")


def _count(wrapper, mode: str) -> None:
    """One launch on the wrapper's counter for ``mode``: ``.launches`` for
    "rowmax", ``.launches_<mode>`` otherwise."""
    attr = "launches" if mode == "rowmax" else f"launches_{mode}"
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def head_bounds(sqk_eff: torch.Tensor, scale: float) -> torch.Tensor:
    """K5's per-head stabilizer scale·max_d(s_d²) → [H] fp32, from the raw
    fp32 sqk_eff (≙ _fwd_qknorm_kernel's ``bound``)."""
    s = sqk_eff.float()
    return scale * torch.amax(s * s, dim=-1)


def bounded_arm(sqk_eff: torch.Tensor, scale: float, mode: str) -> bool:
    """Whether the forward takes the bounded arm: always in "bounded"; in
    "auto" iff scale·max(sqk_eff²) over ALL heads < BOUND_GATE (≙
    _fwd_qknorm's cond).  Reads the value on the host: the twins' choice,
    never the kernel path's."""
    _check_mode(mode)
    if mode != "auto":
        return mode == "bounded"
    return bool(torch.amax(head_bounds(sqk_eff, scale)) < BOUND_GATE)


def flash_attention_qknorm_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    mode: str = "rowmax",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K1 (K5 in the bounded arm): → (o [B, H, T, D] in v.dtype,
    lse [B, H, T] fp32).

    The TPU kernel's single pass: fp32 norms with the 1e-30 floor, the softmax
    scale folded into q̂ as (s·scale)·qn before the cast, fp32 scores, row-max
    softmax — or, in the bounded arm (``bounded_arm``), exp(max(S − bound,
    −60)) against the per-head bound — bf16(P)·V accumulated in fp32, divided
    by the fp32 row sum."""
    h, d = sqk_eff.shape
    s = sqk_eff.float().reshape(1, h, 1, d)
    qhat = _normed_scaled(q, s * scale).to(v.dtype)
    khat = _normed_scaled(k, s).to(v.dtype)
    scores = torch.matmul(qhat.float(), khat.float().transpose(-1, -2))
    if bounded_arm(sqk_eff, scale, mode):
        m = head_bounds(sqk_eff, scale).reshape(1, h, 1, 1)
        p = torch.exp(torch.clamp_min(scores - m, BOUNDED_EXP_FLOOR))
    else:
        m = torch.amax(scores, dim=-1, keepdim=True)
        p = torch.exp(scores - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (pv / l).to(v.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return o, lse


def qknorm_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, mode: str = "rowmax",
    bounds: list[tuple[int, int]] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K2 (≙ _bwd_fused_qknorm_kernel; K5's backward with
    ``mode="bounded"``; K10's with ``bounds``) → (dq, dk, dv in the inputs'
    dtypes, dsqk [B, H, D] fp32 per (b, h)).

    The TPU kernel body with its rounding points: q̂_s = bf16((s·scale)·qn),
    k̂ = bf16(s·kn), k̂_s = bf16((s·scale)·kn); P = exp(S − lse) — in
    "bounded", exp(max(S − bound, −60) + (bound − lse)), and in "auto" the
    plain form, as ``_bwd_qknorm``; Δ = rowsum
    (dO∘O) in fp32; dS = P·(dP − Δ); bf16(P) and bf16(dS) feed the fp32
    products dV, dk̂, dq̂; dsqk = Σ_t(dq̂⊙qn + dk̂⊙kn); then the justnorm VJP
    divides by the floored norms.  The query rows are walked in the row
    ranges ``bounds`` (default one, [0, T)), in order: each range takes its
    own Δ and its complete dq̂ rows, and dV and dk̂ accumulate in fp32 across
    the ranges, as K10 walks its sub-tiles."""
    _check_mode(mode)
    h, d = sqk_eff.shape
    s = sqk_eff.float().reshape(1, h, 1, d)
    qn, qnorm = _norm32(q)
    kn, knorm = _norm32(k)
    qhat_s = ((s * scale) * qn).to(v.dtype).float()
    khat_t = (s * kn).to(v.dtype).float().transpose(-1, -2)
    khat_s = ((s * scale) * kn).to(v.dtype).float()
    do32, o32, v32_t = do.float(), o.float(), v.float().transpose(-1, -2)
    bound = head_bounds(sqk_eff, scale).reshape(1, h, 1, 1) if mode == "bounded" else None
    dv = torch.zeros_like(khat_s)
    dkhat = torch.zeros_like(khat_s)
    dqhat = []
    for a, e in bounds or [(0, q.shape[2])]:
        qh, doh, lse_h = qhat_s[..., a:e, :], do32[..., a:e, :], lse[..., a:e].unsqueeze(-1)
        scores = torch.matmul(qh, khat_t)
        if bound is not None:
            p = torch.exp(torch.clamp_min(scores - bound, BOUNDED_EXP_FLOOR) + (bound - lse_h))
        else:
            p = torch.exp(scores - lse_h)
        delta = torch.sum(doh * o32[..., a:e, :], dim=-1, keepdim=True)
        ds = (p * (torch.matmul(doh, v32_t) - delta)).to(q.dtype).float()
        dv = dv + torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doh)
        dkhat = dkhat + torch.matmul(ds.transpose(-1, -2), qh)
        dqhat.append(torch.matmul(ds, khat_s))
    dqhat = torch.cat(dqhat, dim=-2)
    dsqk = torch.sum(dqhat * qn + dkhat * kn, dim=-2)
    return (_justnorm_vjp(dqhat, qn, qnorm, s).to(q.dtype), _justnorm_vjp(dkhat, kn, knorm, s).to(k.dtype),
            dv.to(v.dtype), dsqk)


def _justnorm_vjp(dxhat: torch.Tensor, xn: torch.Tensor, norm: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fp32 dx = (s⊙dx̂ − xn·Σ(xn ⊙ s⊙dx̂))/‖x‖: the VJP of x̂ = s ⊙ x/‖x‖."""
    dxn = s * dxhat
    return (dxn - xn * torch.sum(xn * dxn, dim=-1, keepdim=True)) / norm


def split_bounds(t: int, nsplit: int) -> list[tuple[int, int]]:
    """K10's query sub-tiles (≙ scripts/attn_bwd_split_bench.py:_split_bounds):
    ``nsplit`` row ranges of ((t // nsplit) // 16)·16 rows covering [0, t),
    the last taking the rest.  Raises ``ValueError`` unless t is a multiple
    of 16 and every sub-tile is non-empty."""
    if t % 16:
        raise ValueError(f"the q-sub-tiled backward needs T a multiple of 16, got T={t}")
    if nsplit < 1 or (t // nsplit) // 16 < 1:
        raise ValueError(f"nsplit={nsplit} leaves an empty q sub-tile at T={t} "
                         f"(needs ((T // nsplit) // 16)·16 >= 16)")
    step = ((t // nsplit) // 16) * 16
    return [(i * step, (i + 1) * step) for i in range(nsplit - 1)] + [((nsplit - 1) * step, t)]


def qknorm_attention_bwd_subtiled_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, nsplit: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K10 (≙ scripts/attn_bwd_split_bench.py:_bwd_split_kernel)
    → (dq, dk, dv in the inputs' dtypes, dsqk [B, H, D] fp32 per (b, h)):
    K2's twin in its plain-recompute arm (P = exp(S − lse), no clamp), its
    query rows walked in the ``split_bounds(T, nsplit)`` sub-tiles."""
    t = _check_operands(q, k, v, sqk_eff)[2]
    return qknorm_attention_bwd_ref(q, k, v, sqk_eff, scale, o, lse, do, bounds=split_bounds(t, nsplit))


def _check_qkv(q, k, v) -> tuple[int, int, int, int]:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got {q.shape}, {k.shape}, {v.shape}")
    if q.shape[2] < 1:
        raise ValueError("attention over an empty sequence")
    return tuple(q.shape)


def _check_operands(q, k, v, sqk_eff):
    b, h, t, d = _check_qkv(q, k, v)
    if tuple(sqk_eff.shape) != (h, d):
        raise ValueError(f"sqk_eff must be [H, D] = [{h}, {d}], got {tuple(sqk_eff.shape)}")
    return b, h, t, d


def _check_cuda_bf16(name: str, tensors, d: int) -> None:
    if not all(x.is_cuda for x in tensors):
        raise ValueError(f"{name} launches a CUDA kernel: all operands must be CUDA tensors")
    if not all(x.dtype == torch.bfloat16 for x in tensors):
        raise ValueError(f"{name} takes bf16 q/k/v, got {[x.dtype for x in tensors]}")
    if d not in (32, 64):
        raise ValueError(f"{name} takes head dim 32 or 64, got {d}")


def _aligned(x: torch.Tensor) -> bool:
    return x.stride(-1) == 1 and not any(st % 8 for st in x.stride()[:3]) and x.data_ptr() % 16 == 0


def _launch_strides(x: torch.Tensor, name: str) -> tuple[int, int, int]:
    """(batch, head, token) element strides the kernel addresses x with; its
    16-byte vector loads need a contiguous last dim and 8-element alignment."""
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous, got strides {x.stride()}")
    if not _aligned(x):
        raise ValueError(f"{name}: strides {x.stride()} / pointer not 16-byte aligned")
    return x.stride(0), x.stride(1), x.stride(2)


def qknorm_project_bf16_ref(
    q: torch.Tensor, k: torch.Tensor, sqk_eff: torch.Tensor, scale: float, *,
    o: torch.Tensor | None = None, do: torch.Tensor | None = None, lse: torch.Tensor | None = None,
) -> tuple:
    """Plain twin of the QK-norm kernels' prologue (``csrc/qknorm_project.cu``)
    → (q̂_s, k̂, k̂_s, lse_pad, Δ_pad), the last three None in the forward's call.

    q̂_s = bf16((s·scale) ⊙ qn), k̂ = bf16(s ⊙ kn) — the TPU kernels' rounding
    points, K1's multiply order — each [B·H, T, D] contiguous.  Given o, do
    and lse (the backward's call), also k̂_s = bf16((s·scale) ⊙ kn), and lse
    and Δ = rowsum(dO ∘ O) in fp32, each [B·H, T_pad] with
    T_pad = 64·ceil(T/64), zero past T."""
    b, h, t, d = q.shape
    s = sqk_eff.float().reshape(1, h, 1, d)
    flat = lambda x: x.to(torch.bfloat16).reshape(b * h, t, d)  # noqa: E731
    qs, kh = flat(_normed_scaled(q, s * scale)), flat(_normed_scaled(k, s))
    if o is None:
        return qs, kh, None, None, None
    ks = flat(_normed_scaled(k, s * scale))
    pad = -(-t // BLOCK) * BLOCK - t
    stats = [torch.nn.functional.pad(x.float().reshape(b * h, t), (0, pad))
             for x in (lse, attention_delta(o, do))]
    return qs, kh, ks, *stats


def qknorm_project_bf16(
    q: torch.Tensor, k: torch.Tensor, sqk_eff: torch.Tensor, scale: float, *,
    o: torch.Tensor | None = None, do: torch.Tensor | None = None, lse: torch.Tensor | None = None,
) -> tuple:
    """The QK-norm kernels' prologue, ``csrc/qknorm_project.cu`` → as
    ``qknorm_project_bf16_ref``.  It projects q and k once per call, so the
    attention kernels' tile walks read bf16 q̂/k̂ instead of normalising
    every key tile again for every query block.  CUDA tensors launch the
    kernel and count it in ``.launches``; CPU tensors run the twin."""
    if not q.is_cuda:
        return qknorm_project_bf16_ref(q, k, sqk_eff, scale, o=o, do=do, lse=lse)
    b, h, t, d = _check_operands(q, k, k, sqk_eff)
    _check_cuda_bf16("qknorm_project_bf16", (q, k), d)
    if not sqk_eff.is_cuda:
        raise ValueError("qknorm_project_bf16 launches a CUDA kernel: all operands must be CUDA tensors")
    sqk = sqk_eff.to(torch.float32).contiguous()
    stats = o is not None
    if stats and not (do is not None and lse is not None and o.shape == q.shape and do.shape == q.shape
                      and tuple(lse.shape) == (b, h, t) and lse.dtype == torch.float32):
        raise ValueError("qknorm_project_bf16: o and do must match q, and lse be fp32 [B, H, T]")
    scratch = lambda: torch.empty((b * h, t, d), dtype=torch.bfloat16, device=q.device)  # noqa: E731
    qs, kh = scratch(), scratch()
    ks = scratch() if stats else None
    t_pad = -(-t // BLOCK) * BLOCK
    lse_pad, delta = ((torch.empty((b * h, t_pad), dtype=torch.float32, device=q.device) for _ in range(2))
                      if stats else (None, None))
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    strides = (ctypes.c_int64 * 12)(
        *_launch_strides(q, "q"), *_launch_strides(k, "k"),
        *(_launch_strides(o, "o") if stats else (0, 0, 0)),
        *(_launch_strides(do, "do") if stats else (0, 0, 0)),
    )
    fn = _entry("qknorm_project", "nvit_qknorm_project",
                (_PTR,) * 11 + (_INT,) * 4 + (_F32, _STRIDES, _PTR))
    lse = lse.contiguous() if stats else None
    err = fn(
        q.data_ptr(), k.data_ptr(), sqk.data_ptr(), qs.data_ptr(), kh.data_ptr(), ptr(ks), ptr(o), ptr(do),
        ptr(lse), ptr(lse_pad), ptr(delta), b, h, t, d, float(scale), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"qknorm_project launch failed: cudaError {err}")
    qknorm_project_bf16.launches += 1
    return qs, kh, ks, lse_pad, delta


qknorm_project_bf16.launches = 0


def qknorm_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    *, with_lse: bool = False, mode: str = "rowmax",
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch K1 ("rowmax") or K5 ("bounded", "auto") on CUDA tensors, after
    the projection prologue (``qknorm_project_bf16``) → (o [B, H, T, D] bf16,
    lse [B, H, T] fp32 or None).  o is a [B, H, T, D] view of [B, T, H, D]
    storage, so merging the heads afterwards costs no copy.  Counts each
    launch in ``.launches`` (rowmax), ``.launches_bounded`` or
    ``.launches_auto`` (whose arm the card picks)."""
    _check_mode(mode)
    b, h, t, d = _check_operands(q, k, v, sqk_eff)
    _check_cuda_bf16("qknorm_attention_fwd", (q, k, v), d)
    if not sqk_eff.is_cuda:
        raise ValueError("qknorm_attention_fwd launches a CUDA kernel: all operands must be CUDA tensors")
    sqk = sqk_eff.to(torch.float32).contiguous()
    # [B·H, T, D] scratch, addressed as [B, H, T, D]
    qs, kh = (x.view(b, h, t, d) for x in qknorm_project_bf16(q, k, sqk, scale)[:2])
    o = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_int64 * 12)(*(
        st for x, name in ((qs, "q"), (kh, "k"), (v, "v"), (o, "o")) for st in _launch_strides(x, name)
    ))
    fn = _entry("qknorm_attn_fwd", "nvit_qknorm_attn_fwd",
                (_PTR,) * 6 + (_INT,) * 4 + (_F32, _INT, _STRIDES, _PTR))
    err = fn(
        qs.data_ptr(), kh.data_ptr(), v.data_ptr(), sqk.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, h, t, d, float(scale), MODES[mode], strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"qknorm_attn_fwd launch failed: cudaError {err}")
    _count(qknorm_attention_fwd, mode)
    return o, lse


qknorm_attention_fwd.launches = 0
qknorm_attention_fwd.launches_bounded = 0
qknorm_attention_fwd.launches_auto = 0


def _bwd_operands(name: str, q, k, v, sqk_eff, o, lse, do):
    """Checks and launch operands shared by K2 and K10 → (b, h, t, d, fp32
    sqk, contiguous lse, aligned do, (dq, dk, dv) as views of ONE bf16
    [B, T, 3, H, D] buffer, the strides: q, k, v, do, dq, dk, dv)."""
    b, h, t, d = _check_operands(q, k, v, sqk_eff)
    _check_cuda_bf16(name, (q, k, v, o, do), d)
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (b, h, t):
        raise ValueError(f"o/do must be {tuple(q.shape)} and lse {(b, h, t)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    if not (sqk_eff.is_cuda and lse.is_cuda and lse.dtype == torch.float32):
        raise ValueError(f"{name} takes CUDA sqk_eff and fp32 CUDA lse")
    if not _aligned(do):
        do = do.contiguous()
    buf = torch.empty((b, t, 3, h, d), dtype=torch.bfloat16, device=q.device)
    grads = tuple(buf[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    views = ((q, "q"), (k, "k"), (v, "v"), (do, "do"), (grads[0], "dq"), (grads[1], "dk"), (grads[2], "dv"))
    strides = (ctypes.c_int64 * (3 * len(views)))(*(st for x, nm in views for st in _launch_strides(x, nm)))
    return b, h, t, d, sqk_eff.to(torch.float32).contiguous(), lse.contiguous(), do, grads, strides


def qknorm_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, mode: str = "rowmax",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 ("rowmax", "auto") or K5's backward ("bounded") on CUDA
    tensors, after the projection prologue (``qknorm_project_bf16``, which
    also forms Δ) → (dq, dk, dv bf16 [B, H, T, D], dsqk [B, H, D] fp32 per
    (b, h)).
    dq/dk/dv are views of ONE [B, T, 3, H, D] buffer.  ``o``/``lse`` are the
    forward's (``with_lse=True``) in the same mode; ``do`` may be any view
    with a contiguous head dim.  Counts each launch in ``.launches`` (K2) or
    ``.launches_bounded`` (K5)."""
    _check_mode(mode)
    b, h, t, d, sqk, lse, do, (dq, dk, dv), strides = _bwd_operands("qknorm_attention_bwd", q, k, v, sqk_eff,
                                                                     o, lse, do)
    part = torch.empty((b * h, 2 * -(-t // BLOCK), d), dtype=torch.float32, device=q.device)
    qs, kh, ks, lse_pad, delta = qknorm_project_bf16(q, k, sqk, scale, o=o, do=do, lse=lse)
    fn = _entry("qknorm_attn_bwd", "nvit_qknorm_attn_bwd",
                (_PTR,) * 14 + (_INT,) * 4 + (_F32, _INT, _STRIDES, _PTR))
    bounded = mode == "bounded"  # ≙ _bwd_qknorm: "auto" recomputes exp(s − lse)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sqk.data_ptr(), qs.data_ptr(), kh.data_ptr(),
        ks.data_ptr(), lse_pad.data_ptr(), delta.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), part.data_ptr(), b, h, t, d, float(scale), int(bounded), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"qknorm_attn_bwd launch failed: cudaError {err}")
    _count(qknorm_attention_bwd, "bounded" if bounded else "rowmax")
    # the per-tile partials summed in a fixed order: deterministic dsqk
    return dq, dk, dv, part.sum(dim=1).reshape(b, h, d)


qknorm_attention_bwd.launches = 0
qknorm_attention_bwd.launches_bounded = 0


def subtile_chunks(t: int, nsplit: int) -> list[tuple[int, int]]:
    """K10's query chunks: each ``split_bounds(t, nsplit)`` sub-tile, in
    order, cut into row ranges of at most 64 rows that never cross its end
    (112 = 64 + 48) — the query tiles the kernel walks; every start is a
    multiple of 16 and the ranges cover [0, t) end to end."""
    return [(a, min(a + BLOCK, e)) for a0, e in split_bounds(t, nsplit) for a in range(a0, e, BLOCK)]


def qknorm_attention_bwd_subtiled(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, nsplit: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10, the q-sub-tiled QK-norm attention backward → (dq, dk, dv,
    dsqk [B, H, D] fp32 per (b, h)), K2's function with ``o``/``lse`` from a
    forward in any mode.  CUDA tensors launch the projection prologue
    (``qknorm_project_bf16``) and the kernel (bf16, head dim 32 or 64) or
    raise, and count the kernel in ``.launches``; CPU tensors run
    ``qknorm_attention_bwd_subtiled_ref`` — chosen by where the tensors lie,
    nothing else.  T must be a multiple of 16 and every one of the
    ``nsplit`` sub-tiles non-empty (``split_bounds``)."""
    if not q.is_cuda:
        return qknorm_attention_bwd_subtiled_ref(q, k, v, sqk_eff, scale, o, lse, do, nsplit)
    return _launch_bwd_subtiled(q, k, v, sqk_eff, scale, o, lse, do, nsplit)


qknorm_attention_bwd_subtiled.launches = 0


def _launch_bwd_subtiled(q, k, v, sqk_eff, scale: float, o, lse, do, nsplit: int):
    """One call of K10 (the prologue, then csrc/qknorm_attn_bwd.cu's
    ``nvit_qknorm_attn_bwd_subtiled``) → as ``qknorm_attention_bwd_subtiled``;
    raises on anything but CUDA operands.  dq/dk/dv are views of ONE
    [B, T, 3, H, D] buffer."""
    chunks = subtile_chunks(q.shape[-2], nsplit)
    b, h, t, d, sqk, lse, do, (dq, dk, dv), strides = _bwd_operands(
        "qknorm_attention_bwd_subtiled", q, k, v, sqk_eff, o, lse, do)
    qs, kh, ks, lse_pad, delta = qknorm_project_bf16(q, k, sqk, scale, o=o, do=do, lse=lse)
    n_tiles, n = -(-t // BLOCK), len(chunks)
    part = torch.empty((b * h, n_tiles + n, d), dtype=torch.float32, device=q.device)
    # each 64-key tile's share of each chunk's dq̂, summed over the tiles by the second kernel
    shares = torch.empty((b * h, n_tiles, n, BLOCK * d), dtype=torch.float32, device=q.device)
    starts = (ctypes.c_int32 * (n + 1))(*(a for a, _ in chunks), t)
    fn = _entry("qknorm_attn_bwd", "nvit_qknorm_attn_bwd_subtiled",
                (_PTR,) * 15 + (_INT,) * 4 + (ctypes.POINTER(ctypes.c_int32), _INT, _STRIDES, _PTR))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sqk.data_ptr(), qs.data_ptr(), kh.data_ptr(), ks.data_ptr(),
        lse_pad.data_ptr(), delta.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        shares.data_ptr(), part.data_ptr(), b, h, t, d, starts, n, strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"qknorm_attn_bwd_subtiled launch failed: cudaError {err}")
    _count(qknorm_attention_bwd_subtiled, "rowmax")
    # the per-tile and per-chunk partials summed in a fixed order: deterministic dsqk
    return dq, dk, dv, part.sum(dim=1).reshape(b, h, d)


class FlashQKNormFn(torch.autograd.Function):
    """K1 (K5) forward, K2 (K5) backward (≙ _flash_qknorm_padded's custom
    VJP); the plain twins on CPU tensors.  Saves q, k, v, o, lse and sqk_eff,
    as ``_flash_qknorm_padded_fwd`` does.  The gradient of ``sqk_eff [H, D]``
    is the per-(b, h) dsqk summed over b — the VJP of the ``s3`` broadcast."""

    @staticmethod
    def forward(ctx, q, k, v, sqk_eff, scale, mode):
        if q.is_cuda:
            o, lse = qknorm_attention_fwd(q, k, v, sqk_eff, scale, with_lse=True, mode=mode)
        else:
            o, lse = flash_attention_qknorm_ref(q, k, v, sqk_eff, scale, mode)
        ctx.save_for_backward(q, k, v, sqk_eff, o, lse)
        ctx.scale, ctx.mode = scale, mode
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, sqk_eff, o, lse = ctx.saved_tensors
        do = do.to(o.dtype)  # ≙ _bwd_qknorm: g.astype(o3.dtype)
        bwd = qknorm_attention_bwd if q.is_cuda else qknorm_attention_bwd_ref
        dq, dk, dv, dsqk = bwd(q, k, v, sqk_eff, ctx.scale, o, lse, do, ctx.mode)
        return dq, dk, dv, dsqk.sum(dim=0).to(sqk_eff.dtype), None, None


def flash_attention_qknorm(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    mode: str = "rowmax",
) -> torch.Tensor:
    """Fused nViT attention (≙ flash_attention.py:flash_attention_qknorm) →
    [B, H, T, D] in v.dtype; ``mode`` is the softmax stabilizer (``MODES``).
    K1/K2 (K5) on CUDA tensors, the twins on CPU tensors — chosen by where
    the tensors lie, nothing else.  Past ``FUSED_BWD_MAX_T``, as the JAX
    package, q̂ = s ⊙ q/max(‖q‖, 1e-30) and k̂ are projected in fp32, cast to
    v's dtype and handed to ``flash_attention`` (K7, then K9 backward) with
    the same scale, whatever the mode."""
    _check_mode(mode)
    b, h, t, d = _check_operands(q, k, v, sqk_eff)
    if t > FUSED_BWD_MAX_T:  # ≙ flash_attention.py:706-714
        s = sqk_eff.reshape(1, h, 1, d)
        return flash_attention(_normed_scaled(q, s).to(v.dtype), _normed_scaled(k, s).to(v.dtype),
                               v, scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, sqk_eff)):
        return FlashQKNormFn.apply(q, k, v, sqk_eff, scale, mode)
    return torch.ops.nvit.qknorm_attention(q, k, v, sqk_eff, scale, mode)


# ------------------------------------------------------------ baseline mode
# The JAX package's ``_bwd`` takes the fused single-program backward while
# the padded T is at most this, else the split dq / dk-dv kernels.  The two
# round dq differently (see ``attention_dq_ref``), so the port switches at the
# same T to keep the JAX package's rounding at every length; it picks no tile
# (≙ nvit_tpu/ops/tuning.py FUSED_BWD_MAX_T, whose v5e override is not ported).
FUSED_BWD_MAX_T = 1024


def _scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x · scale`` in x's dtype, as a JAX array times a Python float: the
    weak-typed scale is rounded to x's dtype, the product rounded once."""
    return x * torch.tensor(scale, dtype=x.dtype)


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K7 (≙ _fwd_kernel): → (o [B, H, T, D] in v.dtype, lse
    [B, H, T] fp32).

    q·scale is rounded to the input dtype before the fp32 scores (the TPU
    kernel folds the scale into the q operand); row-max softmax in fp32,
    bf16(P)·V accumulated in fp32 and divided by the fp32 row sum."""
    scores = torch.matmul(_scaled(q, scale).float(), k.float().transpose(-1, -2))
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return (pv / l).to(v.dtype), (m + torch.log(l)).squeeze(-1)


def _probs(qs: torch.Tensor, k: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """fp32 P = exp(qs·kᵀ − lse), recomputed from the forward's statistic."""
    return torch.exp(torch.matmul(qs.float(), k.float().transpose(-1, -2)) - lse.unsqueeze(-1))


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O) in fp32 → [B, H, T]."""
    return torch.sum(do.float() * o.float(), dim=-1)


def attention_bwd_fused_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K8 (≙ _bwd_fused_kernel) → (dq, dk, dv) in the inputs'
    dtypes.

    qs = bf16(q·scale) and ks = bf16(k·scale) (the scale folded into both
    operands); Δ = rowsum(dO∘O) inside; P = exp(qs·kᵀ − lse), dS = P(dP − Δ);
    then dv = bf16(P)ᵀ·dO, dk = bf16(dS)ᵀ·qs, dq = bf16(dS)·ks in fp32."""
    qs, ks = _scaled(q, scale), _scaled(k, scale)
    do32 = do.float()
    p = _probs(qs, k, lse)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = (p * (dp - attention_delta(o, do).unsqueeze(-1))).to(q.dtype).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do32).to(v.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float()).to(k.dtype)
    dq = torch.matmul(ds, ks.float()).to(q.dtype)
    return dq, dk, dv


def attention_dq_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: float,
) -> torch.Tensor:
    """Plain twin of K9's dQ half (≙ _dq_kernel) → dq in q.dtype.  Δ comes
    from outside; unlike K8, dq = (bf16(dS)·k)·scale with the scale applied
    to the fp32 product, then one cast."""
    p = _probs(_scaled(q, scale), k, lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta.unsqueeze(-1))).to(k.dtype).float()
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def attention_dkv_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K9's dK/dV half (≙ _dkv_kernel) → (dk, dv): Pᵀ
    recomputed from lse with qs = bf16(q·scale); dv = bf16(Pᵀ)·dO,
    dk = bf16(dSᵀ)·qs in fp32."""
    qs = _scaled(q, scale)
    pt = _probs(qs, k, lse).transpose(-1, -2)
    dpt = torch.matmul(v.float(), do.float().transpose(-1, -2))
    dst = (pt * (dpt - delta.unsqueeze(-2))).to(q.dtype).float()
    dv = torch.matmul(pt.to(do.dtype).float(), do.float()).to(v.dtype)
    dk = torch.matmul(dst, qs.float()).to(k.dtype)
    return dk, dv


def _bf16_scale(scale: float) -> float:
    """The operand-fold scale the kernels use: rounded to bf16 (``_scaled``)."""
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *, with_lse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch K7 on CUDA tensors → (o [B, H, T, D] bf16, lse [B, H, T] fp32 or
    None).  The kernel folds the bf16-rounded scale into each q tile it
    loads, so it needs no prologue.  o is a [B, H, T, D] view of [B, T, H, D]
    storage, so merging the heads afterwards costs no copy.  Counts each
    launch in ``.launches``."""
    b, h, t, d = _check_qkv(q, k, v)
    _check_cuda_bf16("flash_attention_fwd", (q, k, v), d)
    o = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_int64 * 12)(*(
        st for x, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o")) for st in _launch_strides(x, name)
    ))
    fn = _entry("flash_attn_fwd", "nvit_flash_attn_fwd", (_PTR,) * 5 + (_INT,) * 4 + (_F32, _STRIDES, _PTR))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None, b, h, t, d, _bf16_scale(scale), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_project_bf16_ref(
    q: torch.Tensor, k: torch.Tensor, scale: float, *, lse: torch.Tensor, o: torch.Tensor | None = None,
    do: torch.Tensor | None = None, delta: torch.Tensor | None = None,
) -> tuple:
    """Plain twin of the baseline backward's prologue (``csrc/qknorm_project.cu``,
    ``nvit_flash_project``) → (qs, ks, lse_pad, Δ_pad).

    qs = bf16(q·scale), the TPU kernels' fold with the scale rounded to bf16
    (``_scaled``), [B·H, T, D] contiguous.  Given o and do (K8's call): also
    ks = bf16(k·scale) and Δ = rowsum(dO ∘ O) in fp32; given ``delta`` (K9's
    call): ks is None and Δ is that one.  lse and Δ come back fp32
    [B·H, T_pad] with T_pad = 64·ceil(T/64), zero past T."""
    b, h, t, d = q.shape
    flat = lambda x: _scaled(x.to(torch.bfloat16), scale).reshape(b * h, t, d)  # noqa: E731
    ks = flat(k) if delta is None else None
    if delta is None:
        delta = attention_delta(o, do)
    pad = -(-t // BLOCK) * BLOCK - t
    stats = [torch.nn.functional.pad(x.float().reshape(b * h, t), (0, pad)) for x in (lse, delta)]
    return flat(q), ks, *stats


def flash_project_bf16(
    q: torch.Tensor, k: torch.Tensor, scale: float, *, lse: torch.Tensor, o: torch.Tensor | None = None,
    do: torch.Tensor | None = None, delta: torch.Tensor | None = None,
) -> tuple:
    """The baseline backward's prologue, ``nvit_flash_project`` in
    ``csrc/qknorm_project.cu`` → as ``flash_project_bf16_ref``: the K8/K9
    walks read q·scale (and k·scale) once per tile they visit, so it is
    rounded here once per call.  Pass o and do (K8) or ``delta`` (K9), not
    both.  CUDA tensors launch the kernel and count it in ``.launches``; CPU
    tensors run the twin."""
    if (delta is None) == (o is None or do is None):
        raise ValueError("flash_project_bf16 takes o and do (K8) or delta (K9)")
    if not q.is_cuda:
        return flash_project_bf16_ref(q, k, scale, lse=lse, o=o, do=do, delta=delta)
    b, h, t, d = _check_qkv(q, k, k)
    split = delta is not None
    _check_cuda_bf16("flash_project_bf16", (q, k) + (() if split else (o, do)), d)
    stats = (lse,) + ((delta,) if split else ())
    if not split and (o.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"flash_project_bf16: o and do must be {tuple(q.shape)}")
    if not all(x.is_cuda and x.dtype == torch.float32 and tuple(x.shape) == (b, h, t) for x in stats):
        raise ValueError(f"flash_project_bf16: lse (and delta) must be fp32 CUDA {(b, h, t)}")
    scratch = lambda: torch.empty((b * h, t, d), dtype=torch.bfloat16, device=q.device)  # noqa: E731
    qs = scratch()
    ks = None if split else scratch()
    t_pad = -(-t // BLOCK) * BLOCK
    lse_pad, delta_pad = (torch.empty((b * h, t_pad), dtype=torch.float32, device=q.device) for _ in range(2))
    lse = lse.contiguous()
    delta = delta.contiguous() if split else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    strides = (ctypes.c_int64 * 12)(
        *_launch_strides(q, "q"), *_launch_strides(k, "k"),
        *(_launch_strides(o, "o") if not split else (0, 0, 0)),
        *(_launch_strides(do, "do") if not split else (0, 0, 0)),
    )
    fn = _entry("qknorm_project", "nvit_flash_project", (_PTR,) * 10 + (_INT,) * 4 + (_F32, _STRIDES, _PTR))
    err = fn(
        q.data_ptr(), k.data_ptr(), qs.data_ptr(), ptr(ks), ptr(o), ptr(do), lse.data_ptr(), ptr(delta),
        lse_pad.data_ptr(), delta_pad.data_ptr(), b, h, t, d, _bf16_scale(scale), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_project launch failed: cudaError {err}")
    flash_project_bf16.launches += 1
    return qs, ks, lse_pad, delta_pad


flash_project_bf16.launches = 0


def _launch_bwd(q, k, v, o, lse, do, delta, scale: float, *, split: bool):
    """One backward of csrc/flash_attn_bwd.cu, after its prologue
    (``flash_project_bf16``) → (dq, dk, dv) bf16 [B, H, T, D], views of ONE
    [B, T, 3, H, D] buffer.  ``split=False`` is K8 (Δ from o and dO in the
    prologue, dq = bf16(dS)·bf16(k·scale)); ``split=True`` is K9 (Δ given,
    dq = (bf16(dS)·k)·scale in fp32)."""
    b, h, t, d = _check_qkv(q, k, v)
    name = "attention_bwd_split" if split else "attention_bwd_fused"
    _check_cuda_bf16(name, (q, k, v, do) + (() if split else (o,)), d)
    if do.shape != q.shape or tuple(lse.shape) != (b, h, t):
        raise ValueError(f"do must be {tuple(q.shape)} and lse {(b, h, t)}, got "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    if not (lse.is_cuda and lse.dtype == torch.float32):
        raise ValueError(f"{name} takes an fp32 CUDA lse")
    if not _aligned(do):
        do = do.contiguous()
    if split:
        if tuple(delta.shape) != (b, h, t) or not delta.is_cuda or delta.dtype != torch.float32:
            raise ValueError(f"{name} takes an fp32 CUDA delta of shape {(b, h, t)}")
        qs, ks, lse_pad, delta_pad = flash_project_bf16(q, k, scale, lse=lse, delta=delta)
    else:
        if o.shape != q.shape:
            raise ValueError(f"o must be {tuple(q.shape)}, got {tuple(o.shape)}")
        qs, ks, lse_pad, delta_pad = flash_project_bf16(q, k, scale, lse=lse, o=o, do=do)
    grads = torch.empty((b, t, 3, h, d), dtype=torch.bfloat16, device=q.device)
    dq, dk, dv = (grads[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    strides = (ctypes.c_int64 * 18)(*(
        st for x, nm in ((k, "k"), (v, "v"), (do, "do"), (dq, "dq"), (dk, "dk"), (dv, "dv"))
        for st in _launch_strides(x, nm)
    ))
    fn = _entry("flash_attn_bwd", "nvit_flash_attn_bwd", (_PTR,) * 10 + (_INT,) * 4 + (_F32, _INT, _STRIDES, _PTR))
    err = fn(
        k.data_ptr(), v.data_ptr(), do.data_ptr(), qs.data_ptr(), None if ks is None else ks.data_ptr(),
        lse_pad.data_ptr(), delta_pad.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, d,
        float(scale), int(split), strides, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: cudaError {err}")
    return dq, dk, dv


def attention_bwd_fused(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K8 on CUDA tensors → (dq, dk, dv) bf16, views of one
    [B, T, 3, H, D] buffer.  ``o``/``lse`` are K7's (``with_lse=True``).
    Counts each launch in ``.launches``."""
    out = _launch_bwd(q, k, v, o, lse, do, None, scale, split=False)
    attention_bwd_fused.launches += 1
    return out


attention_bwd_fused.launches = 0


def attention_bwd_split(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K9 (the dK/dV and dQ passes of ``_dkv_kernel`` / ``_dq_kernel``)
    on CUDA tensors → (dq, dk, dv) bf16, views of one [B, T, 3, H, D] buffer;
    ``delta`` is ``attention_delta(o, do)``.  Counts each launch in
    ``.launches``."""
    out = _launch_bwd(q, k, v, None, lse, do, delta, scale, split=True)
    attention_bwd_split.launches += 1
    return out


attention_bwd_split.launches = 0


class FlashAttnFn(torch.autograd.Function):
    """K7 forward; K8 backward, or K9 past ``FUSED_BWD_MAX_T`` (≙
    _flash_padded's custom VJP, which saves q, k, v, o and lse); the plain
    twins on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.is_cuda:
            o, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
        else:
            o, lse = flash_attention_ref(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale = ctx.scale
        do = do.to(o.dtype)  # ≙ _bwd: g.astype(o3.dtype)
        if q.shape[2] <= FUSED_BWD_MAX_T:
            bwd = attention_bwd_fused if q.is_cuda else attention_bwd_fused_ref
            dq, dk, dv = bwd(q, k, v, o, lse, do, scale)
        else:
            delta = attention_delta(o, do)  # ≙ _bwd:290, outside the kernels
            if q.is_cuda:
                dq, dk, dv = attention_bwd_split(q, k, v, do, lse, delta, scale)
            else:
                dq = attention_dq_ref(q, k, v, do, lse, delta, scale)
                dk, dv = attention_dkv_ref(q, k, v, do, lse, delta, scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Fused non-causal attention (≙ flash_attention.py:flash_attention) →
    [B, H, T, D] in v.dtype; q and k are cast to v.dtype first, as there.
    K7/K8/K9 on CUDA tensors, the twins on CPU tensors — chosen by where the
    tensors lie, nothing else."""
    _check_qkv(q, k, v)
    q, k = q.to(v.dtype), k.to(v.dtype)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttnFn.apply(q, k, v, scale)
    return torch.ops.nvit.flash_attention(q, k, v, scale)


# ------------------------------------------------------ registered operators
# The serving forwards (no autograd) as ``torch.library`` operators, so that
# ``torch.export`` records them as calls (it cannot trace a ctypes launch) and
# an exported program runs the same kernels (ckpt/aot.py).  The CUDA key
# launches K1/K5 after the prologue, or K7, or raises; the CPU key runs the
# twin.  The fake implementation gives the output's shape, dtype and strides
# without storage: every check that reads a pointer, and every launch count,
# runs in the real implementation only, when the program executes.


def _attention_out(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """An empty [B, H, T, D] output laid out as its implementation writes it:
    a view of [B, T, H, D] storage on the card, contiguous from the twins."""
    b, h, t, d = q.shape
    if q.device.type == "cuda":
        return v.new_empty((b, t, h, d)).permute(0, 2, 1, 3)
    return v.new_empty((b, h, t, d))


@torch.library.custom_op("nvit::qknorm_attention", mutates_args=(), device_types="cpu")
def qknorm_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor,
                        scale: float, mode: str) -> torch.Tensor:
    """K1 (K5) forward without lse; on CPU tensors its twin."""
    return flash_attention_qknorm_ref(q, k, v, sqk_eff, scale, mode)[0]


@qknorm_attention_op.register_kernel("cuda")
def _qknorm_attention_cuda(q, k, v, sqk_eff, scale, mode):
    return qknorm_attention_fwd(q, k, v, sqk_eff, scale, mode=mode)[0]


@qknorm_attention_op.register_fake
def _qknorm_attention_fake(q, k, v, sqk_eff, scale, mode):
    return _attention_out(q, v)


@torch.library.custom_op("nvit::flash_attention", mutates_args=(), device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K7 forward without lse; on CPU tensors its twin."""
    return flash_attention_ref(q, k, v, scale)[0]


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, scale):
    return flash_attention_fwd(q, k, v, scale)[0]


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, scale):
    return _attention_out(q, v)
