"""The JAX package's ``TrainState`` as an ordered list of leaves, without jax.

A checkpoint of the JAX package (``nvit_tpu/ckpt/checkpoint.py``) stores
``jax.tree_util.tree_leaves(TrainState)`` as ``leaf_0 … leaf_{n-1}``.  This
module gives the port that order and those shapes from the config alone:

* ``param_tree`` — the skeleton of ``init_vit``'s tree (``nvit_tpu/models/
  vit.py:63-96``): nested dicts and the list of blocks, each leaf a
  ``Spec(shape, dtype)``, for nViT and baseline, with or without biases,
  with or without the Kohonen maps, and int8-quantized (the tree of
  ``nvit_tpu/ops/quant.py::quantize_vit_params``: dict keys sort, so a
  linear's leaves come as ``b``, ``scale``, ``wq``);
* ``flatten`` / ``unflatten`` — ``jax.tree_util``'s order: dict keys sorted,
  list items in order;
* ``train_state_specs`` — ``TrainState(params, opt_state=FusedAdamWState(
  count, mu, nu), step, rng)`` (``nvit_tpu/train/state.py:23-27``,
  ``nvit_tpu/train/optim.py:71-74``) flattened: the params, then ``count``,
  ``mu`` and ``nu`` (the params' paths and shapes), ``step`` and ``rng``;
* ``run_key`` — the run's key, which the JAX package splits from the seed
  (``jax.random.split(PRNGKey(seed))[1]``, threefry-2x32), computed here
  with numpy.
"""

from __future__ import annotations

from typing import Any, Iterator, NamedTuple

import numpy as np

from nvit_tpu_torch.configs import Config, ViTConfig
from nvit_tpu_torch.models.vit import kohonen_spec

Path = tuple[Any, ...]  # dict keys (str) and list indices (int), root first


class Spec(NamedTuple):
    shape: tuple[int, ...]
    dtype: str = "float32"


def param_tree(cfg: ViTConfig, *, int8: bool = False) -> dict[str, Any]:
    """``init_vit``'s tree for ``cfg`` with ``Spec`` leaves; with ``int8``,
    ``quantize_vit_params``' tree: every linear ``{"wq" int8 [in, out],
    "scale" [out][, "b" [out]]}``."""
    cfg.validate()
    d, c, bias = cfg.n_embd, cfg.channels, cfg.bias
    lp, gp = cfg.local_patch_size, cfg.global_patch_size
    vec = Spec((d,))

    def _linear(i: int, o: int, bias: bool) -> dict[str, Spec]:
        p = {"wq": Spec((i, o), "int8"), "scale": Spec((o,))} if int8 else {"w": Spec((i, o))}
        if bias:
            p["b"] = Spec((o,))
        return p

    def block() -> dict[str, Any]:
        p: dict[str, Any] = {
            "query": _linear(d, d, bias), "key": _linear(d, d, bias), "value": _linear(d, d, bias),
            "att_c_proj": _linear(d, d, bias), "c_fc": _linear(d, 8 * d, bias),
            "mlp_c_proj": _linear(4 * d, d, bias), "skip_param": Spec((1,)),
        }
        if cfg.use_nvit:
            p.update(attn_alpha=vec, mlp_alpha=vec, sqk=vec, suv=Spec((8 * d,)))
        else:
            p.update(rmsnorm_att=vec, rmsnorm_mlp=vec)
        return p

    ca: dict[str, Any] = {"q_local": _linear(d, d, bias), "k_global": _linear(d, d, bias),
                          "v_global": _linear(d, d, bias), "proj": _linear(d, 2 * d, bias),
                          "out_proj": _linear(d, d, bias)}
    if cfg.use_nvit:
        ca.update(attn_alpha=vec, sqk=vec)
    else:
        ca.update(local_norm=vec, global_norm=vec)
    params: dict[str, Any] = {
        "local_patch_embed": _linear(c * lp * lp, d, True),
        "global_patch_embed": _linear(c * gp * gp, d, True),
        "local_pos_embed": Spec((1, cfg.n_patches, d)),
        "global_pos_embed": Spec((1, cfg.n_patches, d)),
        "cross_attention": ca,
        "reconstruction_head": _linear(d, lp * lp * c, True),
        "blocks": [block() for _ in range(cfg.n_layer)],
        "head_norm": {"w": vec, "b": vec},
        "head": _linear(d, cfg.num_classes, True),
    }
    if cfg.use_kohonen:
        spec = kohonen_spec(cfg)
        for name in ("local_kohonen", "global_kohonen"):
            params[name] = {"nodes": Spec((spec.num_nodes, d))}
        params["map_balance"] = Spec(())
    if cfg.use_nvit:
        params["sz"] = Spec((cfg.num_classes,))
    return params


def flatten(tree: Any, prefix: Path = ()) -> list[tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten(tree[k], (*prefix, k))]
    if isinstance(tree, list):
        return [item for i, x in enumerate(tree) for item in flatten(x, (*prefix, i))]
    return [(prefix, tree)]


def unflatten(skeleton: Any, leaves: Iterator[Any]) -> Any:
    """``skeleton``'s structure with its leaves taken, in flatten order, from ``leaves``."""
    if isinstance(skeleton, dict):
        return {k: unflatten(skeleton[k], leaves) for k in sorted(skeleton)}
    if isinstance(skeleton, list):
        return [unflatten(x, leaves) for x in skeleton]
    return next(leaves)


def train_state_specs(cfg: Config) -> list[tuple[Path, Spec]]:
    """Every leaf of the JAX ``TrainState`` of ``cfg``, in its flatten order,
    with the paths ``tree_flatten_with_path`` gives (attribute names for the
    named tuples' fields)."""
    params = flatten(param_tree(cfg.model))
    moments = cfg.optimizer.moments_dtype
    return [
        *((("params", *p), s) for p, s in params),
        (("opt_state", "count"), Spec((), "int32")),
        *((("opt_state", "mu", *p), Spec(s.shape, moments)) for p, s in params),
        *((("opt_state", "nu", *p), Spec(s.shape, moments)) for p, s in params),
        (("step",), Spec((), "int32")),
        (("rng",), Spec((2,), "uint32")),
    ]


_M32 = 0xFFFFFFFF


def threefry2x32(key: tuple, count: tuple) -> tuple:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as ``jax.random``
    applies it.  Each word is an int or an int64 tensor of uint32 values
    (the tensor case runs one threefry per element)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (count[0] + ks[0]) & _M32, (count[1] + ks[1]) & _M32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def run_key(seed: int) -> np.ndarray:
    """``jax.random.split(jax.random.PRNGKey(seed))[1]`` → uint32 [2].  The
    key of a seed is (0, seed mod 2³²), as without JAX's 64-bit mode; row i
    of the (partitionable) split is threefry(key, (0, i))."""
    return np.array(threefry2x32((0, seed & _M32), (0, 1)), dtype=np.uint32)
