"""The port's Kohonen SOM (``som/kohonen.py``) and its losses against the
JAX package, on the CPU, at tiny sizes:

* the spec, grid, wrap offsets and neighbourhood table (square,
  non-square — 32 nodes give a 5×6 grid —, non-periodic, σ given)
  bit-equal;
* ``bmu``'s indices (equal, or a tie within one rounding), representations
  (bit-equal) and node gradient in fp32 and bf16; ``hebbian_delta``;
* the losses and their gradients, with collapsed nodes: finite, and zero
  where the norms are zero.

tests/test_torch_kohonen_model.py holds the model and the schedule,
tests/test_torch_kohonen_train.py the train step and the checkpoints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt.torch_interop import _som_grid_buffers
from nvit_tpu.models import losses as jL
from nvit_tpu.som import kohonen as jsom
from nvit_tpu_torch.models import losses as tL
from nvit_tpu_torch.som import kohonen as tsom

torch.set_num_threads(1)

FP32 = dict(rtol=1e-5, atol=1e-6)  # summation order only
BF16_ULP = 2.0 ** -8  # one bf16 rounding, relative


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_same_bmu(got: torch.Tensor, want, x: np.ndarray, nodes: np.ndarray):
    """Indices equal, or, where they differ, a tie: the two nodes' distances
    (from the rounded operands, in float64) within one fp32 rounding."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    diff = np.nonzero(got != want)
    if diff[0].size:
        xs, n = x[diff].astype(np.float64), nodes.astype(np.float64)
        d_got = np.sum((xs - n[got[diff]]) ** 2, -1)
        d_want = np.sum((xs - n[want[diff]]) ** 2, -1)
        scale = np.sum(xs * xs, -1) + np.sum(n[want[diff]] ** 2, -1)
        assert np.all(np.abs(d_got - d_want) <= 4 * 2.0 ** -24 * scale)
    assert diff[0].size <= max(1, got.size // 100)


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("num_nodes,sigma,periodic", [(9, None, True), (30, None, True), (30, None, False),
                                                      (16, 1.5, True)])
def test_spec_grid_and_kernel_match_jax(num_nodes, sigma, periodic):
    """Square, non-square (32 nodes → 5×6 = 30), non-periodic and σ-given
    grids: the spec, the locations, the wrap offsets (the interop's buffers)
    and the fp32 neighbourhood table, all bit-equal."""
    want = jsom.make_spec(32, num_nodes, alpha=0.02, sigma=sigma, periodic=periodic)
    spec = tsom.make_spec(32, num_nodes, alpha=0.02, sigma=sigma, periodic=periodic)
    assert tuple(spec) == tuple(want)
    np.testing.assert_array_equal(tsom.grid_locations(spec), jsom.grid_locations(want))
    if periodic and sigma is None:
        locations, offsets = _som_grid_buffers(num_nodes)
        np.testing.assert_array_equal(tsom.grid_locations(spec), locations)
        np.testing.assert_array_equal(tsom.wrap_offsets(spec), offsets)
    kernel = tsom.neighborhood_kernel(spec)
    assert kernel.dtype == torch.float32 and kernel is tsom.neighborhood_kernel(spec)  # built once
    np.testing.assert_array_equal(kernel.numpy(), np.asarray(jsom.neighborhood_kernel(want)))


# ----------------------------------------------------------------- bmu
def bmu_inputs(seed: int):
    rng = np.random.default_rng(seed)
    nodes = (0.5 * rng.standard_normal((30, 32))).astype(np.float32)
    nodes[7] = nodes[3]  # an exact tie: both frameworks take the first
    x = (0.5 * rng.standard_normal((2, 24, 32))).astype(np.float32)
    x[0, 0] = nodes[3]
    w = rng.standard_normal(x.shape).astype(np.float32)
    return nodes, x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bmu_matches_jax(dtype):
    """Indices equal but for ties within one rounding (an exact tie takes
    the first node); the representations bit-equal (the rounded nodes); the
    node gradient of Σ repr·w — an fp32 sum per node, rounded once to the
    compute dtype — within summation order in fp32 and one bf16 rounding."""
    nodes, x, w = bmu_inputs(3)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)

    def jloss(n):
        rep, _ = jsom.bmu(n, jnp.asarray(x).astype(jdt))
        return jnp.sum(rep.astype(jnp.float32) * w)

    (jrep, jidx), jgrad = jsom.bmu(jnp.asarray(nodes), jnp.asarray(x).astype(jdt)), jax.grad(jloss)(nodes)
    tn = t(nodes).requires_grad_()
    rep, idx = tsom.bmu(tn, t(x).to(tdt))
    torch.sum(rep.float() * t(w)).backward()
    rounded = lambda a: np.asarray(jnp.asarray(a).astype(jdt).astype(jnp.float32))  # noqa: E731
    assert_same_bmu(idx, jidx, rounded(x), rounded(nodes))
    assert int(idx[0, 0]) == 3 and rep.dtype == tdt
    np.testing.assert_array_equal(rep.detach().float().numpy(), np.asarray(jrep.astype(jnp.float32)))
    tol = FP32 if dtype == "float32" else dict(rtol=BF16_ULP, atol=1e-6)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jgrad), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hebbian_delta_matches_jax(dtype):
    """Δ = lr·α·(K @ xsum − (K @ counts) ⊙ nodes) on JAX's own BMUs, with an
    fp32 lr tensor over T as "reference" takes it: summation order only."""
    nodes, x, _ = bmu_inputs(4)
    spec = tsom.make_spec(32, 32, alpha=0.02)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(x).astype(jdt)
    _, idx = jsom.bmu(jnp.asarray(nodes), xj)
    lr = jnp.float32(0.37) / x.shape[-2]
    want = jsom.hebbian_delta(jnp.asarray(nodes), jsom.neighborhood_kernel(jsom.make_spec(32, 32)), xj, idx,
                              lr, spec.alpha)
    got = tsom.hebbian_delta(t(nodes), tsom.neighborhood_kernel(spec), t(x).to(tdt), t(idx).long(),
                             torch.tensor(0.37, dtype=torch.float32) / x.shape[-2], spec.alpha)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * float(jnp.abs(want).max()))


# -------------------------------------------------------------- losses
@pytest.mark.parametrize("collapsed", [False, True])
def test_losses_and_gradients_match_jax(collapsed):
    """Huber, consistency and smoothness, values and gradients, against the
    JAX package's (fp32, summation order).  Collapsed: a zero representation
    row and a map of zero nodes — every gradient finite, the zero row's
    consistency gradient exactly 0, and the zero map's smoothness gradient
    0 (every distance is 0), where a plain norm's would be NaN."""
    rng = np.random.default_rng(9 + collapsed)
    m, n, d = 3, 3, 8
    nodes = rng.standard_normal((2, m * n, d)).astype(np.float32)
    reps = rng.standard_normal((2, 4, 6, d)).astype(np.float32)
    idx = rng.integers(0, m * n, (2, 4, 6))
    if collapsed:
        nodes[0] = 0.0
        reps[0, 1, 2] = reps[1, 1, 2] = 0.0
    np.testing.assert_array_equal(tL.neighbor_indices(t(np.arange(m * n)), m, n).numpy(),
                                  np.asarray(jL.neighbor_indices(jnp.arange(m * n), m, n)))

    def losses(lib, mod, a, b, nl, ng):
        if lib == "jax":
            il, ig = jnp.asarray(idx[0]), jnp.asarray(idx[1])
        else:
            il, ig = t(idx[0]), t(idx[1])
        return {"huber": mod.huber_loss(a, b), "consistency": mod.consistency_loss(a, b),
                "smoothness": mod.smoothness_loss(nl, il, ng, ig, m, n)}

    for name in ("huber", "consistency", "smoothness"):
        jf = lambda a, b, nl, ng: losses("jax", jL, a, b, nl, ng)[name]  # noqa: E731
        want, jgrads = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, (*reps, *nodes)))
        leaves = [t(a).requires_grad_() for a in (*reps, *nodes)]
        got = losses("torch", tL, *leaves)[name]
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), **FP32, err_msg=name)
        for leaf, jg in zip(leaves, jgrads):
            g = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
            assert torch.isfinite(g).all(), name
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6, err_msg=name)
        if collapsed and name == "consistency":
            assert torch.all(leaves[0].grad[1, 2] == 0) and torch.all(leaves[1].grad[1, 2] == 0)
        if collapsed and name == "smoothness":
            assert torch.all(leaves[2].grad == 0)
