"""Reference checkpoints in and out (≙ nvit_tpu/ckpt/torch_interop.py).

A user of the reference PyTorch trainer brings a ``checkpoint_{latest,best}.pt``
here and continues training (``import``), or takes a model trained here back
to the reference as a ``.pt`` whose ``model`` loads with ``strict=True``
(``export``)::

    python -m nvit_tpu_torch.ckpt.torch_interop import --pt out/checkpoint_best.pt --dest out_port
    python -m nvit_tpu_torch.ckpt.torch_interop export --checkpoint out_port --name checkpoint_best \\
        --dest out/checkpoint_from_port.pt

The port's ``ViT.state_dict()`` already has the reference's keys and layouts
(Conv2d patch embeds, ``[out, in]`` linears), so the mapping only reconciles
the reference's quirks, as the JAX package does:

* nViT-mode reference blocks construct ``rmsnorm_att/mlp`` weights they never
  use: import drops them, export writes unit weights (zero moments);
* baseline-mode reference blocks do not construct them (the upstream crash
  bug, PARITY.md) while the port's do: import sets unit weights (zero
  moments), export drops them, with a warning once they have trained away
  from one;
* the Kohonen ``locations`` / ``offsets`` buffers are grid geometry: the
  port's own are kept on import and written on export.

The AdamW moments travel both ways: the reference's ``AdamW.state_dict()``
indexes its parameters by the optimizer's groups [decay (ndim ≥ 2),
no-decay, (nViT) ``sz``] over the reference module's own parameter order
(``reference_state_dict_order``: key before query), never the port's.  An
imported checkpoint is written in the JAX package's format
(``ckpt/checkpoint.py``) with fp32 moments, ``step`` = ``iter_num``, the
moments' ``count`` = the largest torch ``step``, the key ``PRNGKey(seed)`` =
(0, seed) and ``best_val_loss`` seeded from ``metrics["val/loss"]``; resume
it with ``training.init_from=resume``.  Everything runs on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from nvit_tpu_torch.ckpt.checkpoint import restore_for_resume, save_checkpoint
from nvit_tpu_torch.configs import Config, ViTConfig, merge_dataclass
from nvit_tpu_torch.models.vit import ViT, kohonen_spec
from nvit_tpu_torch.som.kohonen import grid_locations, wrap_offsets
from nvit_tpu_torch.train.optim import init_fused_adamw
from nvit_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

EXPORT_FORMAT = "nvit_tpu.torch_interop.v1"

# the reference ViTConfig's field names (model.py:13-40): the model_args contract
REFERENCE_MODEL_ARGS = (
    "image_size", "n_layer", "n_head", "n_embd", "base_scale", "use_nvit",
    "flash_attn", "sz_init_value", "sz_init_scaling", "dropout", "bias",
    "channels", "num_classes", "local_patch_size", "global_patch_size",
    "kohonen_nodes", "kohonen_alpha", "use_kohonen", "reconstruction_weight",
    "map_balance_weight", "kohonen_scheduler_enabled",
    "kohonen_scheduler_warmup_steps", "kohonen_scheduler_decay_steps",
    "kohonen_scheduler_min_lr", "local_quantization_weight",
    "global_quantization_weight",
)
_BLOCK_NORMS = ("rmsnorm_att", "rmsnorm_mlp")


# --------------------------------------------------------------------- config
def vit_config_from_model_args(model_args: Mapping[str, Any]) -> ViTConfig:
    """The reference's ``model_args`` → ``ViTConfig``; keys the port does not
    have are ignored (logged)."""
    ours = {f.name for f in dataclasses.fields(ViTConfig)}
    known = {k: v for k, v in model_args.items() if k in ours}
    dropped = sorted(set(model_args) - set(known))
    if dropped:
        logger.info("ignoring unknown model_args keys: %s", dropped)
    return merge_dataclass(ViTConfig(), known)


def model_args_from_config(cfg: ViTConfig) -> dict[str, Any]:
    """``ViTConfig`` → the reference's ``model_args`` (exactly its fields)."""
    return {name: getattr(cfg, name) for name in REFERENCE_MODEL_ARGS}


def _lenient_merge(obj: Any, overrides: Mapping[str, Any]) -> Any:
    """``merge_dataclass`` that drops unknown keys and sections with a log
    line: a reference settings tree carries torch-only keys."""
    fields = {f.name for f in dataclasses.fields(obj)}
    kept: dict[str, Any] = {}
    for key, value in overrides.items():
        lk = key.lower()
        if lk not in fields:
            logger.info("ignoring unknown config key '%s'", key)
            continue
        current = getattr(obj, lk)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kept[lk] = dataclasses.asdict(_lenient_merge(current, value))
        else:
            kept[lk] = value
    return merge_dataclass(obj, kept)


def config_from_reference_checkpoint(ckpt: Mapping[str, Any]) -> Config:
    """The checkpoint's settings tree (leniently), its ``model_args`` taking
    the model section."""
    cfg = Config()
    settings = ckpt.get("config")
    if isinstance(settings, Mapping):
        cfg = _lenient_merge(cfg, dict(settings))
    model_args = ckpt.get("model_args")
    if isinstance(model_args, Mapping):
        cfg = dataclasses.replace(cfg, model=vit_config_from_model_args(model_args))
    return cfg


# ---------------------------------------------------------- state_dict layout
def reference_state_dict_order(cfg: ViTConfig) -> list[str]:
    """The reference ViT's ``state_dict()`` keys in order: torch's module
    walk, direct parameters before children, children in registration order
    (model.py:278-356).  The AdamW enumeration derives from it."""
    keys = ["local_pos_embed", "global_pos_embed"]
    if cfg.use_kohonen:
        keys.append("map_balance")
    if cfg.use_nvit:
        keys.append("sz")
    keys += ["local_patch_embed.weight", "local_patch_embed.bias",
             "global_patch_embed.1.weight", "global_patch_embed.1.bias"]
    if cfg.use_kohonen:
        for s in ("local", "global"):
            keys += [f"{s}_kohonen.nodes", f"{s}_kohonen.locations", f"{s}_kohonen.offsets"]
    ca = "cross_attention"
    if cfg.use_nvit:
        keys += [f"{ca}.attn_alpha", f"{ca}.sqk"]
    else:
        keys += [f"{ca}.local_norm.weight", f"{ca}.global_norm.weight"]
    for name in ("q_local", "k_global", "v_global", "proj", "out_proj"):
        keys.append(f"{ca}.{name}.weight")
        if cfg.bias:
            keys.append(f"{ca}.{name}.bias")
    keys += ["reconstruction_head.0.weight", "reconstruction_head.0.bias"]
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        keys.append(f"{p}.skip_param")
        if cfg.use_nvit:
            keys += [f"{p}.attn_alpha", f"{p}.mlp_alpha", f"{p}.sqk", f"{p}.suv"]
        # children in registration order: key BEFORE query (model.py:50-55)
        for name in ("key", "query", "value", "att_c_proj", "c_fc", "mlp_c_proj"):
            keys.append(f"{p}.{name}.weight")
            if cfg.bias:
                keys.append(f"{p}.{name}.bias")
        if cfg.use_nvit:
            keys += [f"{p}.{n}.weight" for n in _BLOCK_NORMS]
    keys += ["mlp_head.0.weight", "mlp_head.0.bias", "mlp_head.1.weight", "mlp_head.1.bias"]
    return keys


def _reference_param_groups(model_sd: Mapping[str, Any], cfg: ViTConfig) -> list[list[str]]:
    """The reference's AdamW groups (model.py:369-385): [decay (dim ≥ 2),
    no-decay (dim < 2), (nViT) sz] over its parameters, buffers dropped."""
    names = [k for k in reference_state_dict_order(cfg) if not k.endswith((".locations", ".offsets"))]
    missing = [n for n in names if n not in model_sd]
    if missing:
        raise KeyError(f"state_dict missing expected reference keys: {missing[:4]}…")
    dims = {k: len(model_sd[k].shape) for k in names}
    if cfg.use_nvit:
        return [[n for n in names if "sz" not in n and dims[n] >= 2],
                [n for n in names if "sz" not in n and dims[n] < 2],
                ["sz"]]
    return [[n for n in names if dims[n] >= 2], [n for n in names if dims[n] < 2]]


def _reference_param_order(model_sd: Mapping[str, Any], cfg: ViTConfig) -> list[str]:
    """The flat parameter enumeration the reference's AdamW state indexes."""
    return [n for g in _reference_param_groups(model_sd, cfg) for n in g]


def _block_norm_keys(cfg: ViTConfig) -> list[str]:
    return [f"transformer.h.{i}.{n}.weight" for i in range(cfg.n_layer) for n in _BLOCK_NORMS]


def port_state_dict(ref_sd: Mapping[str, Any], cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """A reference ``state_dict`` → the port's ``ViT.state_dict()``: nViT's
    unused block norms dropped, the baseline's set to one, the Kohonen
    buffers the port's own."""
    sd = {k: torch.as_tensor(v) for k, v in ref_sd.items()}
    for key in _block_norm_keys(cfg):
        if cfg.use_nvit:
            sd.pop(key, None)
        else:
            sd[key] = torch.ones(cfg.n_embd)
    if cfg.use_kohonen:
        spec = kohonen_spec(cfg)
        for s in ("local", "global"):
            sd[f"{s}_kohonen.locations"] = torch.from_numpy(grid_locations(spec))
            sd[f"{s}_kohonen.offsets"] = torch.from_numpy(wrap_offsets(spec))
    return sd


def reference_state_dict(sd: Mapping[str, torch.Tensor], cfg: ViTConfig, *,
                         warn_dropped: bool = True) -> dict[str, torch.Tensor]:
    """The port's ``ViT.state_dict()`` → the reference's, in its key order,
    CPU copies: nViT's unused block norms at one, the baseline's dropped."""
    if not cfg.use_nvit and warn_dropped:
        for key in _block_norm_keys(cfg):
            if not torch.all(sd[key] == 1):
                logger.warning("dropping trained %s (reference baseline blocks do not construct "
                               "RMSNorms — upstream bug, PARITY.md)", key)
    unused = set(_block_norm_keys(cfg)) if cfg.use_nvit else set()
    return {k: torch.ones(cfg.n_embd) if k in unused else sd[k].detach().to("cpu", copy=True)
            for k in reference_state_dict_order(cfg)}


# ------------------------------------------------------------------- moments
def moment_trees_from_torch(opt_sd: Any, model_sd: Mapping[str, Any], cfg: ViTConfig
                            ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor], int] | None:
    """A reference ``AdamW.state_dict()`` → (mu, nu, count), fp32 moments
    under the port's parameter names.  None (fresh moments) when the dict is
    absent or not the reference's AdamW; a parameter torch never stepped
    starts at zero, as a fresh AdamW holds it."""
    if not isinstance(opt_sd, Mapping) or not opt_sd.get("param_groups"):
        return None
    order = _reference_param_order(model_sd, cfg)
    indices = [i for g in opt_sd["param_groups"] for i in g.get("params", ())]
    if len(indices) != len(order):
        logger.warning("optimizer param count %d != model param count %d — not a reference AdamW "
                       "state, starting moments fresh", len(indices), len(order))
        return None
    state = opt_sd.get("state", {})
    mu: dict[str, torch.Tensor] = {}
    nu: dict[str, torch.Tensor] = {}
    steps = [0]
    for idx, name in zip(indices, order):
        ent = state.get(idx, state.get(str(idx)))
        if ent is None:
            mu[name] = torch.zeros(tuple(model_sd[name].shape))
            nu[name] = torch.zeros(tuple(model_sd[name].shape))
            continue
        mu[name] = torch.as_tensor(ent["exp_avg"]).float()
        nu[name] = torch.as_tensor(ent["exp_avg_sq"]).float()
        steps.append(int(ent["step"]))
    for key in _block_norm_keys(cfg):
        for tree in (mu, nu):
            if cfg.use_nvit:
                tree.pop(key, None)
            else:  # the port's baseline norms, which the reference lacks
                tree[key] = torch.zeros(cfg.n_embd)
    return mu, nu, max(steps)


def torch_optimizer_state_dict(mu: Mapping[str, torch.Tensor], nu: Mapping[str, torch.Tensor],
                               count: int, cfg: ViTConfig, model_sd: Mapping[str, Any],
                               opt_cfg: Any) -> dict[str, Any]:
    """The port's moments → an ``AdamW.state_dict()`` that the reference's
    ``configure_optimizers`` result loads (the inverse of
    ``moment_trees_from_torch``); ``model_sd`` is the exported reference
    state_dict.  nViT's unused block norms get zero moments."""
    state: dict[int, dict[str, Any]] = {}
    param_groups = []
    idx = 0
    for gi, names in enumerate(_reference_param_groups(model_sd, cfg)):
        ids = []
        for name in names:
            if name in mu:
                a, b = mu[name].detach().float().cpu(), nu[name].detach().float().cpu()
            else:
                a = b = torch.zeros(tuple(model_sd[name].shape))
            state[idx] = {"step": torch.tensor(float(count)),
                          "exp_avg": a.contiguous().clone(), "exp_avg_sq": b.contiguous().clone()}
            ids.append(idx)
            idx += 1
        param_groups.append({
            "params": ids, "lr": float(opt_cfg.learning_rate),
            "betas": (float(opt_cfg.beta1), float(opt_cfg.beta2)), "eps": 1e-8,
            # group 0 decays, the others do not (≙ model.py:372-383)
            "weight_decay": float(opt_cfg.weight_decay) if gi == 0 else 0.0,
            "amsgrad": False, "maximize": False, "foreach": None, "capturable": False,
            "differentiable": False, "fused": False,
        })
    return {"state": state, "param_groups": param_groups}


# ------------------------------------------------------------------ the CLI
def import_torch_checkpoint(pt_path: str | Path, dest: str | Path, name: str = "checkpoint_latest",
                            seed: int = 0) -> Path:
    """Reference ``.pt`` → a resumable checkpoint ``<dest>/<name>`` in the
    JAX package's format.  The ``.pt`` must be the trainer's whole dict
    (``model`` and ``model_args``, train.py:640-650); a bare state_dict
    raises."""
    # a trusted local artifact: the reference dict holds plain python and
    # numpy objects (the settings tree, numpy's RNG state) that weights_only refuses
    ckpt = torch.load(str(pt_path), map_location="cpu", weights_only=False)
    if not isinstance(ckpt, Mapping) or "model" not in ckpt or "model_args" not in ckpt:
        raise ValueError(f"{pt_path} is not a reference trainer checkpoint "
                         "(expected keys 'model' and 'model_args', train.py:640-650)")
    cfg = config_from_reference_checkpoint(ckpt)
    model = ViT(cfg.model, device="cpu")
    model.load_state_dict(port_state_dict(ckpt["model"], cfg.model), strict=True)
    opt_state = init_fused_adamw(model.named_parameters())
    moments = moment_trees_from_torch(ckpt.get("optimizer") or {}, ckpt["model"], cfg.model)
    if moments is not None:
        mu, nu, count = moments
        opt_state.mu, opt_state.nu, opt_state.count = mu, nu, count
        logger.info("migrated AdamW moments (count=%d)", count)
    else:
        logger.warning("no usable optimizer state in %s — moments start fresh", pt_path)
    generator = torch.Generator()
    generator.manual_seed(cfg.training.seed + 1)
    state = TrainState(model=model, opt_state=opt_state, step=int(ckpt.get("iter_num", 0)),
                       generator=generator, rng=np.array([0, seed & 0xFFFFFFFF], np.uint32))
    metrics = {k: float(v) for k, v in (ckpt.get("metrics") or {}).items() if isinstance(v, (int, float))}
    # the first eval after a relaunch must not overwrite checkpoint_best with a worse model
    trainer_state = {"best_val_loss": metrics["val/loss"]} if "val/loss" in metrics else {}
    path = save_checkpoint(dest, name, state, cfg, metrics, trainer_state)
    logger.info("imported %s → %s (iter %d)", pt_path, path, state.step)
    return path


def export_torch_checkpoint(checkpoint_dir: str | Path, name: str, dest: str | Path) -> Path:
    """Checkpoint ``<checkpoint_dir>/<name>`` → a reference-format ``.pt``
    with every key the reference's save_checkpoint writes (train.py:640-650):
    ``model`` (strict-loadable into the reference ``ViT``), ``optimizer``
    (the moments, loadable into its AdamW), ``model_args``, ``iter_num``,
    ``metrics``, ``config``, both RNG states, ``timestamp`` and ``format``."""
    state, cfg, meta = restore_for_resume(checkpoint_dir, name, device="cpu")
    sd = reference_state_dict(state.model.state_dict(), cfg.model)
    opt = state.opt_state
    out = {
        "model": sd,
        "optimizer": torch_optimizer_state_dict(opt.mu, opt.nu, opt.count, cfg.model, sd, cfg.optimizer),
        "model_args": model_args_from_config(cfg.model),
        "iter_num": int(state.step),
        "metrics": meta.get("metrics", {}),
        "config": cfg.to_dict(),
        "rng_state_pytorch": torch.get_rng_state(),
        "rng_state_numpy": np.random.get_state(),
        "timestamp": time.strftime("%d_%m_%Y-%Hh%Mm"),
        "format": EXPORT_FORMAT,
    }
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, dest)
    logger.info("exported %s/%s → %s (iter %d)", checkpoint_dir, name, dest, int(state.step))
    return dest


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m nvit_tpu_torch.ckpt.torch_interop",
                                     description="Reference .pt checkpoints in and out")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_imp = sub.add_parser("import", help="reference .pt → resumable checkpoint")
    p_imp.add_argument("--pt", required=True, help="path to a reference checkpoint_*.pt")
    p_imp.add_argument("--dest", required=True, help="output checkpoint directory")
    p_imp.add_argument("--name", default="checkpoint_latest")
    p_imp.add_argument("--seed", type=int, default=0)
    p_exp = sub.add_parser("export", help="checkpoint → reference-format .pt")
    p_exp.add_argument("--checkpoint", required=True, help="checkpoint directory")
    p_exp.add_argument("--name", default="checkpoint_best")
    p_exp.add_argument("--dest", required=True, help="output .pt path")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    t0 = time.perf_counter()
    if args.cmd == "import":
        path = import_torch_checkpoint(args.pt, args.dest, args.name, args.seed)
        print(f"imported {args.pt} → {path} in {time.perf_counter() - t0:.1f} s")
    else:
        path = export_torch_checkpoint(args.checkpoint, args.name, args.dest)
        print(f"exported {path} ({path.stat().st_size / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
