"""The port's baseline mode (``use_nvit=False``) against the JAX package on the CPU.

* K7/K8/K9's plain twins against the Pallas kernels they replace
  (``_fwd_kernel``, ``_bwd_fused_kernel``, ``_dq_kernel``/``_dkv_kernel``),
  run as tests/test_flash_attention.py runs them
  (``force_tpu_interpret_mode``), fed the same residuals; K9 is reached at a
  small T by ``NVIT_TUNE_FUSED_BWD_MAX_T=0``, which ``nvit_tpu/ops/tuning.py``
  reads at call time;
* ``FlashAttnFn`` on the CPU against ``jax.vjp`` of the JAX package's
  ``flash_attention``, through the fused and the split backward;
* the baseline ``Block``, ``CrossAttentionBlock`` and ``ViT`` forward against
  ``block_apply`` / ``cross_attention_apply`` / ``vit_apply``, on the plain
  path and on the kernel path (the JAX package's Pallas kernels forced
  through the generic interpreter, tests/kernel_force.py);
* ``state_dict_from_jax`` for a baseline tree, and two ``make_train_step``
  steps of a small baseline model against the JAX package's.

Inputs are made from a seed with numpy and handed to both frameworks.  Every
tolerance is stated where it is used.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nvit_tpu.configs import schema as jax_schema
from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu.models.blocks import block_apply, cross_attention_apply
from nvit_tpu.models.vit import vit_apply
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.ops import flash_attention as fa
from nvit_tpu_torch.ops.attention import attention, sdpa
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train.optim import decay_mask, init_fused_adamw
from nvit_tpu_torch.train.state import TrainState
from nvit_tpu_torch.train.step import make_train_step
from tests.torch_parity import baseline_params, port_config, random_jax_params

# the module, not the function the package re-exports under its name
jax_fa = importlib.import_module("nvit_tpu.ops.flash_attention")

torch.set_num_threads(1)

# fp32: the same math, summation order only (tests/test_flash_attention.py's
# tolerances); bf16: one bf16 rounding of q·scale, P, dS or O may land on
# either side, 2^-7 ≈ 8e-3 relative
TOL = {"fp32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
# (b, h, t, d): ragged T at head dim 32, where the scale 1/sqrt(32) is not
# bf16-exact; an exact tile at head dim 64
SHAPES = [(2, 2, 100, 32), (1, 2, 64, 64)]


def qkv(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d), dtype=np.float32) for _ in range(4)]  # q, k, v, dO


def as_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(dtype)


def unpad(x, shape):
    """[B·H, T_pad, D] → [B, H, T, D]; an lse [B·H, T_pad, 1] → [B, H, T]."""
    b, h, t, d = shape
    x = np.asarray(x, np.float32)[:, :t]
    return x.reshape(b, h, t) if x.shape[-1] == 1 else x.reshape(b, h, t, d)


@pytest.fixture(scope="module")
def residuals():
    """Per (dtype, shape), computed once: the numpy q, k, v, dO and the JAX
    package's padded [B·H, T_pad, D] operands with ``_fwd``'s (o, lse), in
    interpret mode.  T is padded to the 128 lane multiple, which both of
    ``_bwd``'s paths accept, so K7, K8 and K9 share one forward."""
    cache = {}

    def get(dtype, shape):
        if (dtype, shape) not in cache:
            b, h, t, d = shape
            jdt = JDT[dtype]
            arrays = qkv(50 + t + d, *shape)
            t_pad = jax_fa._pad_len(t)
            q3, k3, v3, g = (jnp.pad(jnp.asarray(x).astype(jdt).reshape(b * h, t, d),
                                     ((0, 0), (0, t_pad - t), (0, 0))) for x in arrays)
            scale = 1.0 / float(np.sqrt(d))
            with pltpu.force_tpu_interpret_mode():
                o, lse = jax_fa._fwd(q3, k3, v3, scale, t)
            cache[dtype, shape] = dict(arrays=arrays, scale=scale, res=(q3, k3, v3, o, lse), g=g)
        return cache[dtype, shape]

    return get


# ------------------------------------------------------------------ K7
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k7_twin_matches_pallas(residuals, shape, dtype):
    b, h, t, d = shape
    case = residuals(dtype, shape)
    *_, o_ref, lse_ref = case["res"]
    o, lse = fa.flash_attention_ref(*(to_torch(x, TDT[dtype]) for x in case["arrays"][:3]), case["scale"])
    assert o.dtype == TDT[dtype] and o.shape == shape and lse.shape == (b, h, t)
    np.testing.assert_allclose(as_np(o), unpad(o_ref, shape), **TOL[dtype])
    # lse: fp32 scores of the same operands in both policies — summation order only
    np.testing.assert_allclose(lse.numpy(), unpad(lse_ref, shape), rtol=1e-4, atol=1e-4)


def test_scale_is_rounded_to_the_input_dtype_first():
    """The TPU kernels' ``q_ref[0] * scale`` rounds the weak-typed Python
    scale to bf16 before the product; at D = 32 that changes q·scale."""
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    scale = 1.0 / np.sqrt(32.0)
    want = np.asarray((jnp.asarray(x).astype(jnp.bfloat16) * float(scale)).astype(jnp.float32))
    got = fa._scaled(torch.from_numpy(x).bfloat16(), float(scale)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert fa._bf16_scale(scale) != np.float32(scale) and fa._bf16_scale(0.125) == 0.125


# ------------------------------------------------------------------ K8, K9
def jax_bwd(case):
    """dq, dk, dv of the JAX package's ``_bwd`` (interpret mode) on the
    shared residuals; it takes the fused kernel unless
    NVIT_TUNE_FUSED_BWD_MAX_T is below T_pad."""
    t = case["arrays"][0].shape[2]
    with pltpu.force_tpu_interpret_mode():
        return jax_fa._bwd(case["scale"], t, case["res"], case["g"])


def port_operands(case, dtype, shape):
    """q, k, v, dO, o, lse as the port's tensors; o and lse are the JAX
    forward's, so each backward twin is held alone."""
    tdt = TDT[dtype]
    q, k, v, do = (to_torch(x, tdt) for x in case["arrays"])
    *_, o, lse = case["res"]
    return q, k, v, do, to_torch(unpad(o, shape), tdt), torch.from_numpy(unpad(lse, shape).copy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k8_twin_matches_pallas(residuals, shape, dtype):
    """attention_bwd_fused_ref against _bwd_fused_kernel (``_bwd`` at
    T_pad ≤ 1024)."""
    case = residuals(dtype, shape)
    want = jax_bwd(case)
    q, k, v, do, o, lse = port_operands(case, dtype, shape)
    got = fa.attention_bwd_fused_ref(q, k, v, o, lse, do, case["scale"])
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == TDT[dtype] and a.shape == shape, name
        np.testing.assert_allclose(as_np(a), unpad(r, shape), **TOL[dtype], err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k9_twins_match_pallas(monkeypatch, residuals, shape, dtype):
    """attention_dq_ref / attention_dkv_ref against _dq_kernel / _dkv_kernel:
    ``_bwd`` takes the split kernels with NVIT_TUNE_FUSED_BWD_MAX_T=0 and Δ
    from outside; the port's Δ = rowsum(dO∘O) of the same o."""
    case = residuals(dtype, shape)
    monkeypatch.setenv("NVIT_TUNE_FUSED_BWD_MAX_T", "0")
    want = jax_bwd(case)
    q, k, v, do, o, lse = port_operands(case, dtype, shape)
    delta = fa.attention_delta(o, do)
    got = (fa.attention_dq_ref(q, k, v, do, lse, delta, case["scale"]),
           *fa.attention_dkv_ref(q, k, v, do, lse, delta, case["scale"]))
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == TDT[dtype] and a.shape == shape, name
        np.testing.assert_allclose(as_np(a), unpad(r, shape), **TOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype,split", [("fp32", False), ("bf16", True)])
def test_flash_attn_fn_matches_jax_vjp(monkeypatch, dtype, split):
    """FlashAttnFn on CPU tensors (K7's twin forward; K8's, or past
    FUSED_BWD_MAX_T K9's, twin backward) against jax.vjp of the JAX
    package's flash_attention at T = 100, D = 32; both sides take the split
    backward when the threshold is 0.  Tolerances as the twins'."""
    if split:
        monkeypatch.setenv("NVIT_TUNE_FUSED_BWD_MAX_T", "0")
        monkeypatch.setattr(fa, "FUSED_BWD_MAX_T", 0)
    shape = (2, 2, 100, 32)
    q, k, v, do = qkv(80 + int(split), *shape)
    scale = 1.0 / float(np.sqrt(32))
    jdt, tdt = JDT[dtype], TDT[dtype]
    with pltpu.force_tpu_interpret_mode():
        out_ref, vjp = jax.vjp(lambda a, b_, c: jax_fa.flash_attention(a, b_, c, scale),
                               *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
        grads_ref = vjp(jnp.asarray(do).astype(jdt))
    leaves = [to_torch(x, tdt).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, scale)
    assert out.grad_fn is not None and out.dtype == tdt
    out.backward(to_torch(do, tdt))
    np.testing.assert_allclose(as_np(out), as_np(out_ref), **TOL[dtype])
    for name, a, r in zip(("dq", "dk", "dv"), leaves, grads_ref):
        assert a.grad.dtype == tdt, name
        np.testing.assert_allclose(as_np(a.grad), as_np(r), **TOL[dtype], err_msg=name)


def test_dispatch_on_cpu_is_the_twin_and_wrappers_refuse_cpu():
    """CPU tensors run the twins, chosen by device alone; the launch wrappers
    raise on them instead of falling back, and count no launch."""
    q, k, v, do = (to_torch(x, torch.bfloat16) for x in qkv(90, 1, 2, 40, 32))
    want, lse = fa.flash_attention_ref(q, k, v, 0.25)
    assert torch.equal(fa.flash_attention(q, k, v, 0.25), want)
    assert torch.equal(attention(q, k, v, 0.25, use_flash=True), want)
    assert torch.equal(attention(q, k, v, 0.25, use_flash=False), sdpa(q, k, v, 0.25))
    with torch.inference_mode():
        assert fa.flash_attention(q, k, v, 0.25).grad_fn is None
    delta = fa.attention_delta(want, do)
    counters = (fa.flash_attention_fwd, fa.attention_bwd_fused, fa.attention_bwd_split)
    before = [f.launches for f in counters]
    for call in (lambda: fa.flash_attention_fwd(q, k, v, 0.25),
                 lambda: fa.attention_bwd_fused(q, k, v, want, lse, do, 0.25),
                 lambda: fa.attention_bwd_split(q, k, v, do, lse, delta, 0.25)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [f.launches for f in counters] == before


def test_backward_prologue_twin_matches_jax_fold_and_delta():
    """The baseline backward's prologue on CPU tensors (its twin,
    ``flash_project_bf16_ref``): qs and ks bit-equal to ``_bwd_fused_kernel``'s
    bf16 fold ``q3 * scale`` at D = 32, where 1/sqrt(32) is not bf16-exact,
    and a ragged T; Δ within 1e-6 of ``_bwd``'s XLA rowsum(g ∘ o) in fp32;
    lse and Δ zero-padded to whole 64-row tiles.  K9's call copies the given
    Δ and makes no ks."""
    b, h, t, d = 2, 2, 100, 32
    q, k, o, do = qkv(91, b, h, t, d)
    lse = np.random.default_rng(92).standard_normal((b, h, t), dtype=np.float32)
    scale = 1.0 / float(np.sqrt(d))
    qt, kt, ot, dot = (to_torch(x, torch.bfloat16) for x in (q, k, o, do))
    lse_t = torch.from_numpy(lse)
    qs, ks, lse_pad, delta_pad = fa.flash_project_bf16(qt, kt, scale, lse=lse_t, o=ot, do=dot)
    for got, x in ((qs, q), (ks, k)):
        want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16) * scale).reshape(b * h, t, d)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b * h, t, d)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    g32, o32 = (jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32) for x in (do, o))
    jdelta = np.asarray(jnp.sum(g32 * o32, axis=-1)).reshape(b * h, t)  # ≙ _bwd's Δ
    assert tuple(lse_pad.shape) == tuple(delta_pad.shape) == (b * h, 128)
    np.testing.assert_allclose(delta_pad[:, :t].numpy(), jdelta, rtol=1e-6, atol=1e-6)
    assert torch.equal(lse_pad[:, :t], lse_t.reshape(b * h, t))
    assert not lse_pad[:, t:].any() and not delta_pad[:, t:].any()
    delta = fa.attention_delta(ot, dot)
    qs9, ks9, lse9, delta9 = fa.flash_project_bf16(qt, kt, scale, lse=lse_t, delta=delta)
    assert ks9 is None and torch.equal(qs9, qs) and torch.equal(lse9, lse_pad)
    assert torch.equal(delta9[:, :t], delta.reshape(b * h, t)) and not delta9[:, t:].any()
    with pytest.raises(ValueError, match="o and do"):
        fa.flash_project_bf16(qt, kt, scale, lse=lse_t)


# ------------------------------------------------------------ model
def base_cfg(**kw):
    base = dict(image_size=16, n_layer=2, n_head=4, n_embd=128, num_classes=7,
                local_patch_size=4, global_patch_size=8, use_nvit=False, flash_attn=False)
    base.update(kw)
    return jax_schema.ViTConfig(**base)


def port_model(params, cfg):
    model = ViT(port_config(cfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, port_config(cfg)), strict=True)
    return model.eval()


POLICY = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: summation order only; bf16: a few bf16 roundings through the chain
MODEL_TOL = {"fp32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture(scope="module")
def jax_forwards():
    """JAX blocks and logits of one random baseline tree, plain and with the
    Pallas kernels forced (generic interpreter), per policy."""
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    params = baseline_params(base_cfg(), seed=5)
    rng = np.random.default_rng(6)
    img = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    acts = [rng.standard_normal((2, 16, 128)).astype(np.float32) for _ in range(2)]
    out = {}
    for flash in (False, True):
        cfg = base_cfg(flash_attn=flash)
        with force_on_tpu(), generic_interpret_mode():
            for policy, (jdt, _) in POLICY.items():
                def fwd(p, x0, x1, x, cfg=cfg, jdt=jdt):  # one program per case
                    return (block_apply(p["blocks"][0], cfg, x0, compute_dtype=jdt),
                            cross_attention_apply(p["cross_attention"], cfg, x0, x1, compute_dtype=jdt),
                            vit_apply(p, cfg, x, compute_dtype=jdt).logits)

                got = jax.jit(fwd)(params, *(jnp.asarray(a).astype(jdt or jnp.float32) for a in acts),
                                   jnp.asarray(img))
                out[flash, policy] = [np.asarray(x, np.float32) for x in got]
    return params, img, acts, out


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_baseline_model_matches_jax(jax_forwards, flash, policy):
    """Block, CrossAttentionBlock and the whole ViT forward, baseline mode:
    the plain path (flash_attn=False) and the kernel path (K7 and K3 twins)
    against the JAX package's on the same weights and inputs."""
    params, img, acts, want = jax_forwards
    _, tdt = POLICY[policy]
    model = port_model(params, base_cfg(flash_attn=flash))
    x0, x1 = (to_torch(a, tdt or torch.float32) for a in acts)
    with torch.no_grad():
        blk = model.transformer["h"][0](x0, compute_dtype=tdt)
        cross = model.cross_attention(x0, x1, compute_dtype=tdt)
        logits = model(torch.from_numpy(img), compute_dtype=tdt)
    # the RMSNorm weight multiply promotes the residual stream to fp32
    assert blk.dtype == torch.float32 and logits.dtype == torch.float32
    for name, got, ref in zip(("block", "cross-attention", "logits"), (blk, cross, logits),
                              want[flash, policy]):
        np.testing.assert_allclose(as_np(got), ref, **MODEL_TOL[policy], err_msg=name)


def test_baseline_state_dict_keys_and_strict_load():
    """The baseline key set is state_dict_from_params' plus the blocks'
    RMSNorm weights, which that function drops; no sz and no scale vectors."""
    from nvit_tpu.ckpt.torch_interop import state_dict_from_params

    cfg = base_cfg()
    params = random_jax_params(cfg, seed=7)
    ours = state_dict_from_jax(params, port_config(cfg))
    ref = state_dict_from_params(params, cfg, warn_dropped=False)
    block_norms = {f"transformer.h.{i}.{n}.weight" for i in range(cfg.n_layer)
                   for n in ("rmsnorm_att", "rmsnorm_mlp")}
    assert set(ours) == set(ref) | block_norms and not set(ref) & block_norms
    assert not any(k.endswith(("sz", "sqk", "suv", "alpha")) for k in ours)
    for key in ref:
        np.testing.assert_array_equal(ours[key].numpy(), ref[key], err_msg=key)
    for i in range(cfg.n_layer):
        np.testing.assert_array_equal(ours[f"transformer.h.{i}.rmsnorm_att.weight"].numpy(),
                                      params["blocks"][i]["rmsnorm_att"])
    model = ViT(port_config(cfg), device="cpu")
    model.load_state_dict(ours, strict=True)
    assert set(model.state_dict()) == set(ours)
    fresh = ViT(port_config(cfg), device="cpu").init_weights(torch.Generator().manual_seed(0))
    assert all(torch.equal(p, torch.ones_like(p)) for n, p in fresh.named_parameters() if "norm.weight" in n
               and not n.startswith("mlp_head"))


def test_baseline_decay_mask_leaves_norm_weights_undecayed():
    from nvit_tpu.train.optim import decay_mask as jax_decay_mask

    cfg = base_cfg()
    params = random_jax_params(cfg)
    mask = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                  jax_decay_mask(params), params)
    want = {n: bool(t.flatten()[0]) for n, t in state_dict_from_jax(mask, port_config(cfg)).items()}
    model = ViT(port_config(cfg), device="cpu")
    assert decay_mask(model.named_parameters()) == want
    assert not want["transformer.h.0.rmsnorm_att.weight"] and not want["cross_attention.local_norm.weight"]


# ------------------------------------------------------------ training
BATCH = 4
TRAIN_CASES = ["float32", "bfloat16"]
METRICS = ("class_loss", "total_loss", "reconstruction", "grad_norm", "learning_rate")


def train_configs(dtype):
    """(JAX Config, port Config) of a 2-layer baseline model on the kernel
    path, field for field equal; accumulation 1."""
    sections = dict(
        model=dict(image_size=16, n_layer=2, n_head=4, n_embd=128, num_classes=10,
                   local_patch_size=4, global_patch_size=8, use_nvit=False, flash_attn=True),
        training=dict(batch_size=BATCH),
        optimizer=dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=0, lr_decay_iters=10),
        system=dict(remat=False, dtype=dtype, log_gpu_stats=True),
    )

    def build(mod):
        return mod.Config(model=mod.ViTConfig(**sections["model"]),
                          training=mod.TrainingConfig(**sections["training"]),
                          optimizer=mod.OptimizerConfig(**sections["optimizer"]),
                          system=mod.SystemConfig(**sections["system"]))

    return build(jax_schema), build(port_schema)


def train_batches():
    rng = np.random.default_rng(31)
    return [(rng.integers(0, 256, (BATCH, 3, 16, 16), dtype=np.uint8),
             rng.integers(0, 10, BATCH).astype(np.int32)) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_two_steps():
    """JAX parameters and metrics after two baseline steps per policy."""
    from nvit_tpu.train.optim import init_fused_adamw as jax_init
    from nvit_tpu.train.state import TrainState as JaxState
    from nvit_tpu.train.step import make_train_step as jax_make_train_step
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    out = {}
    with force_on_tpu(), generic_interpret_mode():
        for dtype in TRAIN_CASES:
            jcfg, _ = train_configs(dtype)
            params = baseline_params(jcfg.model, seed=12)
            state = JaxState(params=jax.tree_util.tree_map(jnp.asarray, params),
                             opt_state=jax_init(params), step=jnp.zeros((), jnp.int32),
                             rng=jax.random.PRNGKey(0))
            step = jax.jit(jax_make_train_step(jcfg))
            metrics = []
            for imgs, labels in train_batches():
                state, m = step(state, jax_normalize(jnp.asarray(imgs)), jnp.asarray(labels))
                metrics.append({k: float(m[k]) for k in METRICS})
            out[dtype] = (params, jax.tree_util.tree_map(np.asarray, state.params), metrics)
    return out


@pytest.mark.parametrize("dtype", TRAIN_CASES)
def test_two_baseline_train_steps_match_jax(jax_two_steps, dtype):
    """Parameters and metrics after two steps (no renorm in baseline).  The
    bounds are on the UPDATES (after − before), relative to JAX's, as in
    tests/test_torch_train.py.  One step's fp32 gradients agree to ~3e-7
    relative, except skip_param's: the baseline block returns x + …, with
    x = rms_norm(h) ∝ h, so norm_skip's justnorm VJP (⟂ its input) leaves
    d skip_param a cancellation (measured 1e-2 relative in fp32), and Adam
    passes that on.  bf16 gradients agree to ~1e-2 (bf16 roundings through 2
    layers).
    * fp32: metrics rtol 1e-4; every weight within 1e-4 (a tenth of lr); the
      whole update within 1e-4 relative L2 (measured 2.1e-5).
    * bf16: metrics rtol 3e-2; the whole update within 0.1 relative L2
      (measured 0.068) and each parameter's within 0.3 (measured ≤ 0.12)."""
    params0, jax_params, jax_metrics = jax_two_steps[dtype]
    _, cfg = train_configs(dtype)
    model = ViT(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(params0, cfg.model), strict=True)
    state = TrainState(model=model, opt_state=init_fused_adamw(model.named_parameters()),
                       step=0, generator=torch.Generator())
    step = make_train_step(cfg)
    metrics = []
    for imgs, labels in train_batches():
        state, m = step(state, normalize(torch.from_numpy(imgs)), torch.from_numpy(labels))
        metrics.append({k: float(m[k]) for k in METRICS})

    rtol = 1e-4 if dtype == "float32" else 3e-2
    for got, want in zip(metrics, jax_metrics):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)

    before = state_dict_from_jax(params0, cfg.model)
    want = state_dict_from_jax(jax_params, cfg.model)
    got = {n: p.detach() for n, p in state.model.named_parameters()}
    diff2 = ref2 = 0.0
    moved = 0
    for name, w in want.items():
        d_got, d_want = got[name] - before[name], w - before[name]
        diff2 += float(torch.sum((d_got - d_want) ** 2))
        ref2 += float(torch.sum(d_want ** 2))
        if dtype == "float32":
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-4, err_msg=name)
        elif d_want.norm() > 0:
            assert (d_got - d_want).norm() <= 0.3 * d_want.norm(), name
        moved += int(not torch.equal(got[name], before[name]))
    assert diff2 ** 0.5 <= (1e-4 if dtype == "float32" else 0.1) * ref2 ** 0.5
    assert moved > len(want) // 2


def test_trainer_trains_baseline(tmp_path):
    """The Trainer runs baseline mode end to end on tiny synthetic data: no
    sqk drift metrics and no per-block scale columns in ``stat``."""
    import json

    from nvit_tpu_torch.obs.metrics import hparams_str
    from nvit_tpu_torch.train.trainer import Trainer

    cfg = port_schema.Config(
        model=port_schema.ViTConfig(image_size=16, n_layer=1, n_head=4, n_embd=128, num_classes=10,
                                    local_patch_size=4, global_patch_size=8, use_nvit=False,
                                    flash_attn=True),
        training=port_schema.TrainingConfig(batch_size=8, max_iters=4, eval_interval=2,
                                            log_interval=2, eval_iters=1,
                                            always_save_checkpoint=False),
        optimizer=port_schema.OptimizerConfig(warmup_iters=1, lr_decay_iters=10),
        system=port_schema.SystemConfig(remat=False, dtype="float32", quick_validation_size=8),
        data=port_schema.DataConfig(dataset="synthetic", out_dir=str(tmp_path),
                                    augmentation=port_schema.AugmentationConfig(auto_augment=False)),
    )
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    evals = [x for x in lines if "val/loss" in x]
    logs = [x for x in lines if "train/batch_loss" in x]
    assert [x["train/iter"] for x in logs] == [2, 4] and len(evals) == 2
    assert all(np.isfinite(x["train/batch_loss"]) for x in logs)
    assert not any(k.startswith("scales/") for x in evals for k in x)
    assert hparams_str(trainer.state.model, cfg) == ""
    assert (tmp_path / "finished").read_text() == "max_iters:4"
    assert trainer._sqk_drift_metrics() == {}
