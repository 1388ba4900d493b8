"""Shared inputs of the port's tensor-parallel and FSDP tests
(tests/test_torch_tp_*.py, tests/test_torch_fsdp_*.py): the tiny config of
tests/test_parallel.py:18 (2 layers, 2 heads, d = 32, biases, the Kohonen
SOM with 18 nodes) on the kernels' path (their twins on the CPU) and its
baseline twin, global batch 8 with gradient accumulation 2, fp32; the JAX
package's step on the global batch; the layouts' pieces, cut and joined
here independently of ``nvit_tpu_torch.parallel``."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu.train.state import TrainState as JaxTrainState
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train.optim import init_fused_adamw
from nvit_tpu_torch.train.state import TrainState
from nvit_tpu_torch.train.step import make_train_step
from tests.torch_parity import baseline_params, kohonen_fields, kohonen_params, paired_configs

BATCH, ACCUM, STEPS = 8, 2, 3
# the tolerances of tests/test_torch_dp_step.py
TOL = dict(rtol=1e-5, atol=1e-6)
UPDATE_REL_L2 = {"kohonen": 1e-5, "baseline": 1e-4}
NODES = ("local_kohonen.nodes", "global_kohonen.nodes")
TINY = dict(image_size=16, n_layer=2, n_head=2, n_embd=32, num_classes=10, local_patch_size=4,
            global_patch_size=8, bias=True, flash_attn=True)
MODELS = {
    # tests/test_parallel.py's tiny_config with a strong Hebbian channel
    "kohonen": kohonen_fields(**TINY, kohonen_alpha=2.0, kohonen_scheduler_enabled=True,
                              kohonen_scheduler_warmup_steps=2, kohonen_scheduler_decay_steps=6,
                              kohonen_scheduler_min_lr=0.2),
    "baseline": dict(TINY, use_nvit=False, use_kohonen=False),
}
# name → (model_parallel, fsdp)
LAYOUTS = {"tp1x2": (2, False), "fsdp2x1": (1, True), "tp2x2": (2, False), "fsdp2x2": (2, True)}
COLUMN = ("query", "key", "value", "c_fc")
ROW = ("att_c_proj", "mlp_c_proj")


def configs(model: str, out_dir, *, layout: str | None = None, **optimizer):
    """(JAX Config, port Config) of ``model`` on ``layout``."""
    mp, fsdp = LAYOUTS[layout] if layout else (1, False)
    jcfg, cfg = paired_configs(
        MODELS[model],
        training=("TrainingConfig", dict(batch_size=BATCH, gradient_accumulation_steps=ACCUM)),
        optimizer=("OptimizerConfig", dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=0,
                                           lr_decay_iters=10, **optimizer)),
        system=("SystemConfig", dict(remat=False, dtype="float32", log_gpu_stats=True, use_ddp=True,
                                     model_parallel=mp, fsdp=fsdp)),
    )
    data = dataclasses.replace(cfg.data, out_dir=str(out_dir), dataset="synthetic")
    return jcfg, dataclasses.replace(cfg, data=data)


def jax_params(model: str, jcfg):
    return kohonen_params(jcfg.model, seed=21) if model == "kohonen" else baseline_params(jcfg.model, seed=22)


def batches(cfg, steps: int = STEPS):
    rng = np.random.default_rng(43)
    m = cfg.model
    return [(rng.integers(0, 256, (BATCH, 3, m.image_size, m.image_size), dtype=np.uint8),
             rng.integers(0, m.num_classes, BATCH).astype(np.int32)) for _ in range(steps)]


def job(name: str, model: str, layout: str, out_dir, **optimizer) -> dict:
    jcfg, cfg = configs(model, out_dir, layout=layout, **optimizer)
    return dict(name=name, cfg=cfg, state_dict=state_dict_from_jax(jax_params(model, jcfg), cfg.model),
                batches=batches(cfg), aug=False)


def jax_steps(out_dir) -> dict:
    """model → (initial state dict, [(JAX metrics, JAX state dict) after each step])."""
    from nvit_tpu.train.optim import init_fused_adamw as jax_init
    from nvit_tpu.train.step import make_train_step as jax_make_train_step

    out = {}
    for model in MODELS:
        jcfg, cfg = configs(model, out_dir)
        params = jax_params(model, jcfg)
        state = JaxTrainState(params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=jax_init(params),
                              step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
        step = jax.jit(jax_make_train_step(jcfg))
        after = []
        for imgs, labels in batches(cfg):
            state, m = step(state, jax_normalize(jnp.asarray(imgs)), jnp.asarray(labels))
            after.append(({k: float(v) for k, v in jax.device_get(m).items() if np.ndim(v) == 0},
                          state_dict_from_jax(jax.device_get(state.params), cfg.model)))
        out[model] = (state_dict_from_jax(params, cfg.model), after)
    return out


def one_process(model: str, out_dir) -> tuple[dict, dict]:
    """The port's one-process step on the global batches → (last metrics, parameters)."""
    jcfg, cfg = configs(model, out_dir)
    vit = ViT(cfg.model, device="cpu")
    vit.load_state_dict(state_dict_from_jax(jax_params(model, jcfg), cfg.model), strict=True)
    state = TrainState(model=vit, opt_state=init_fused_adamw(vit.named_parameters()), step=0,
                       generator=torch.Generator())
    step = make_train_step(cfg, log_norms=True)
    for imgs, labels in batches(cfg):
        state, m = step(state, normalize(torch.from_numpy(imgs)), torch.from_numpy(labels))
    return {k: float(v) for k, v in m.items()}, {n: p.detach().clone() for n, p in vit.named_parameters()}


def compared_metrics(metrics: dict) -> list[str]:
    return [k for k in metrics if k.endswith(("_loss", "_norm")) or k.startswith(("kohonen_", "local_q",
                                                                                   "global_q"))]


def assert_matches_jax(run: dict, jax_run, model: str, steps: int, what: str) -> None:
    """A rank's metrics within TOL and its whole parameters' update within
    the relative L2 of tests/test_torch_dp_step.py, against JAX's step on
    the global batch after ``steps`` steps."""
    before, after = jax_run
    jm, want = after[steps - 1]
    keys = compared_metrics(jm)
    m = run["metrics"][steps - 1]
    assert keys and set(keys) <= set(m), sorted(set(keys) - set(m))
    for k in keys:
        np.testing.assert_allclose(m[k], jm[k], **TOL, err_msg=f"{what}: {k}")
    params = run["params"][steps - 1]
    diff2 = ref2 = 0.0
    for name, p in params.items():
        d_got, d_want = p - before[name], want[name] - before[name]
        diff2 += float(torch.sum((d_got - d_want) ** 2))
        ref2 += float(torch.sum(d_want ** 2))
    assert diff2 ** 0.5 <= UPDATE_REL_L2[model] * ref2 ** 0.5, what
    if model == "kohonen":
        for name in NODES:
            d_got, d_want = params[name] - before[name], want[name] - before[name]
            assert float((d_got - d_want).norm()) <= 1e-5 * float(d_want.norm()), (what, name)


# elements of the whole parameters that may miss TOL against the port's
# one-process step after three steps, each within 1e-5 (ROADMAP.md §3)
OFF_TOL_ELEMENTS = 6


def assert_matches_one_process(run: dict, metrics: dict, params: dict) -> None:
    for k in compared_metrics(metrics):
        np.testing.assert_allclose(run["metrics"][-1][k], metrics[k], **TOL, err_msg=k)
    off = 0
    for name, p in params.items():
        err = (run["params"][-1][name] - p).abs()
        off += int((err > TOL["atol"] + TOL["rtol"] * p.abs()).sum())
        assert float(err.max()) <= 1e-5, name
    assert off <= OFF_TOL_ELEMENTS, off


def trunk_dim(name: str) -> int | None:
    """The dim a trunk parameter is cut along (tests/test_fsdp.py's specs in
    the [out, in] layout), None for a replicated one."""
    parts = name.split(".")
    if parts[:2] != ["transformer", "h"]:
        return None
    module, attr = parts[-2], parts[-1]
    if module in COLUMN:
        return 0
    return 1 if module in ROW and attr == "weight" else None


def piece(name: str, full: torch.Tensor, coords: tuple[int, int], layout: str) -> torch.Tensor:
    """Rank (d, m)'s piece of ``full``: the model shard — for c_fc the u rows
    m·H/M … and the same rows of v, stacked — then, under FSDP, data piece d."""
    dim = trunk_dim(name)
    if dim is None:
        return full
    mp, fsdp = LAYOUTS[layout]
    d, m = coords
    x = full.movedim(dim, 0)
    if name.split(".")[-2] == "c_fc":
        half = x.shape[0] // 2
        c = half // mp
        x = torch.cat([x[m * c:(m + 1) * c], x[half + m * c:half + (m + 1) * c]])
    else:
        c = x.shape[0] // mp
        x = x[m * c:(m + 1) * c]
    if fsdp:
        dp = 2
        c = x.shape[0] // dp
        x = x[d * c:(d + 1) * c]
    return x.movedim(0, dim)


def join(name: str, ranks: list[dict], key: str, layout: str) -> torch.Tensor:
    """The whole tensor ``name`` of ``key`` ("params", "mu", "nu") from the
    ranks' pieces (each ``{"coords": (d, m), key: {...}}``)."""
    dim = trunk_dim(name)
    if dim is None:
        return ranks[0][key][name]
    mp, fsdp = LAYOUTS[layout]
    by = {r["coords"]: r[key][name].movedim(dim, 0) for r in ranks}
    shards = [torch.cat([by[(d, m)] for d in range(2)]) if fsdp else by[(0, m)] for m in range(mp)]
    if name.split(".")[-2] == "c_fc":
        c = shards[0].shape[0] // 2
        x = torch.cat([s[:c] for s in shards] + [s[c:] for s in shards])
    else:
        x = torch.cat(shards)
    return x.movedim(0, dim).contiguous()
