"""The port's int8 w8a8 serving (``nvit_tpu_torch/ops/quant.py``) against
the JAX package's (``nvit_tpu/ops/quant.py``), on the CPU.

The JAX side runs jitted, as every JAX serving path does (``quantize_vit_params``
is one jitted program; ``quantized_linear`` runs inside the jitted
forward): XLA compiles ``/ 127`` to a product with fp32(1/127), which the
port copies (``INV_127``); JAX's eager ops divide, and their scales differ
from the compiled ones by one ulp in 132 of 3072 columns (ROADMAP.md §3).

Tolerances, stated once: ``wq``, ``scale``, ``xq`` and ``sx`` bit-equal;
``quantized_linear`` (alone, the suv fold) bit-equal, with a bias in fp32
within one ulp (XLA's FMA of the epilogue); the int8
forward's logits within 1e-2 relative L2 of JAX's int8 forward in fp32
compute and 3e-2 in bf16 (``FORWARD_TOL``; the port runs its kernels'
twins, JAX its plain attention — the same math, rounded apart in bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.configs.schema import ViTConfig
from nvit_tpu.core.layers import concat_linears as jax_concat_linears
from nvit_tpu.models.vit import vit_apply
from nvit_tpu.ops import quant as jq
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.core.layers import concat_linears, linear
from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.ops import quant as tq
from tests.torch_parity import kohonen_params, port_config, random_jax_params

torch.set_num_threads(1)

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def weights(seed, k=64, n=96):
    """[K, N] fp32 weights with an all-zero column (the 1e-12 floor) and a
    column of halves (round-half-to-even ties at scale 1/127·|max|)."""
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = np.linspace(-127, 127, k).round() / 2 / 127
    w[0, 1] = 1.0  # max 1: the column's values sit on ties of wq = w·127
    return w


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_weight_and_activations_are_bit_equal(dtype):
    w = weights(0)
    wq, scale = jax.jit(jq.quantize_weight)(jnp.asarray(w))
    pwq, pscale = tq.quantize_weight(t(w.T))
    assert pwq.dtype == torch.int8 and pscale.dtype == torch.float32
    np.testing.assert_array_equal(pwq.numpy(), np.asarray(wq).T)
    np.testing.assert_array_equal(pscale.numpy(), np.asarray(scale))
    x = np.random.default_rng(1).standard_normal((3, 50, 64)).astype(np.float32)
    x[0, 0] = 0.0  # the 1e-8 floor
    xq, sx = jax.jit(jq.quantize_activations)(jnp.asarray(x).astype(JDT[dtype]))
    pxq, psx = tq.quantize_activations(t(x).to(TDT[dtype]))
    np.testing.assert_array_equal(pxq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(psx.numpy(), np.asarray(sx))


@pytest.mark.parametrize("bias", [False, True])
def test_quantized_linear_matches_jax(bias):
    """Through ``core.layers.linear`` with a compute dtype: x cast first, the
    result in x's dtype; bit-equal to JAX's ``linear`` on the int8 leaf."""
    from nvit_tpu.core.layers import linear as jax_linear

    w = weights(2)
    p = jax.jit(jq.quantize_linear_params)({"w": jnp.asarray(w), **({"b": jnp.asarray(w[0] * 3)} if bias else {})})
    x = np.random.default_rng(3).standard_normal((2, 40, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_linear(p, x, compute_dtype=jnp.bfloat16))(p, jnp.asarray(x))
    wq, scale = tq.quantize_weight(t(w.T))
    got = linear(t(x), tq.QuantParams(wq, scale), t(w[0] * 3) if bias else None, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_fused_qkv_and_suv_fold_match_jax():
    """The fused QKV of three int8 linears with biases (wq and scale
    concatenated on the out axis): within one fp32 ulp of JAX's; the suv fold
    into c_fc's scale: bit-equal."""
    ws = [weights(s) for s in (4, 5, 6)]
    jparts = [jax.jit(jq.quantize_linear_params)({"w": jnp.asarray(w), "b": jnp.asarray(w[1])}) for w in ws]
    tparts = [(tq.QuantParams(*tq.quantize_weight(t(w.T))), t(w[1])) for w in ws]
    x = np.random.default_rng(7).standard_normal((2, 30, 64)).astype(np.float32)
    want = jax.jit(lambda ps, x: jq.quantized_linear(jax_concat_linears(ps), x))(jparts, jnp.asarray(x))
    got = linear(t(x), *concat_linears(tparts))
    # XLA contracts the epilogue's product and the bias add into one FMA; the
    # port rounds the product first (27% of values differ): within one fp32
    # ulp of the product and one of the result
    bias = np.concatenate([w[1] for w in ws])
    got, want = got.numpy(), np.asarray(want)
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(got - bias)) + np.spacing(np.abs(want)))
    suv = (1 + 0.1 * np.random.default_rng(8).standard_normal(96)).astype(np.float32)
    jfold = {"wq": jparts[0]["wq"], "scale": jparts[0]["scale"] * jnp.asarray(suv)}
    tfold = tq.QuantParams(tparts[0][0].wq, tparts[0][0].scale * t(suv))
    np.testing.assert_array_equal(linear(t(x), tfold).numpy(),
                                  np.asarray(jax.jit(jq.quantized_linear)(jfold, jnp.asarray(x))))


MODELS = {  # name → ViTConfig fields over the tiny model
    "nvit": dict(use_nvit=True),
    "baseline": dict(use_nvit=False),
    "nvit-kohonen": dict(use_nvit=True, use_kohonen=True, kohonen_nodes=18),
    "baseline-kohonen": dict(use_nvit=False, use_kohonen=True, kohonen_nodes=18),
}


def tiny(**kw) -> ViTConfig:
    base = dict(image_size=16, n_layer=2, n_head=2, n_embd=64, num_classes=10, local_patch_size=4,
                global_patch_size=8, bias=True)
    base.update(kw)
    return ViTConfig(**base)


# relative L2 of the logits: fp32 compute isolates the int8 math (measured
# ≤ 3.3e-8); bf16 compute adds the bf16 roundings the float path already
# shows against JAX (0.3–0.75% here), which the per-token requantization
# of each linear's input carries on (measured ≤ 1.4%: nViT with Kohonen)
FORWARD_TOL = {None: 1e-2, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("name", MODELS)
def test_int8_forward_matches_jax(name):
    """nViT / baseline × Kohonen off / on (biases on): ``quantize_vit`` of the
    converted model against ``vit_apply`` on ``quantize_vit_params``, in fp32
    and bf16 compute."""
    jcfg = tiny(**MODELS[name], flash_attn=False)
    params = kohonen_params(jcfg, seed=9) if jcfg.use_kohonen else random_jax_params(jcfg, seed=9)
    img = np.random.default_rng(10).uniform(-1, 1, (3, 3, 16, 16)).astype(np.float32)
    cfg = port_config(dataclasses.replace(jcfg, flash_attn=True))  # the twins of K1/K5, K7
    pred = Predictor(state_dict_from_jax(params, cfg), cfg, device="cpu", quantize="int8")
    assert tq.is_quantized(pred.model)
    for tdt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax.jit(lambda p, x: vit_apply(jq.quantize_vit_params(p), jcfg, x,
                                                         compute_dtype=jdt).logits)(params, img),
                          np.float32)
        with torch.no_grad():
            got = pred.model(t(img), compute_dtype=tdt).float().numpy()
        assert got.shape == (3, 10) and np.isfinite(got).all()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < FORWARD_TOL[tdt]


def test_predictor_quantize_modes_and_idempotence():
    """An unknown mode raises JAX's ValueError; quantizing twice changes no
    buffer; the int8 model holds int8 linears and the fp32 rest."""
    jcfg = tiny(use_nvit=True, flash_attn=True)
    cfg = port_config(jcfg)
    sd = state_dict_from_jax(random_jax_params(jcfg, seed=11), cfg)
    with pytest.raises(ValueError, match="unknown quantize mode 'int4'"):
        Predictor(sd, cfg, device="cpu", quantize="int4")
    pred = Predictor(sd, cfg, device="cpu", quantize="int8")
    before = {k: v.clone() for k, v in pred.model.state_dict().items()}
    tq.quantize_vit(pred.model)
    after = pred.model.state_dict()
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)
    n_linears = 4 + len(tq.CROSS_LINEARS) + cfg.n_layer * len(tq.BLOCK_LINEARS)
    assert sum(k.endswith(".wq") for k in after) == n_linears
    assert all(after[k].dtype == torch.int8 for k in after if k.endswith(".wq"))
    assert after["transformer.h.0.suv"].dtype == torch.float32
    assert tq.quantized_size_bytes(pred.model) < sum(v.numel() * 4 for v in sd.values()) / 2
