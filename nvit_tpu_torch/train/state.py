"""Training state (≙ nvit_tpu/train/state.py:23-56).

``TrainState`` holds the model (its parameters), the optimizer state, the
step, a ``torch.Generator`` for the host's randomness, and ``rng``, the
JAX package's run key (uint32 [2]), which a checkpoint carries bit-exact
both ways (``ckpt/checkpoint.py``); a fresh state's key is the one the JAX
package splits from the same seed (``ckpt.tree.run_key``).  The two
frameworks draw different weights from the same seed, so a fresh state's
weights are the port's own; the tests carry JAX weights across with
``ckpt.convert.state_dict_from_jax``.

Under tensor parallelism or FSDP a state is built whole, from the one seed
or the checkpoint, then cut to the rank's pieces (``shard_state_``), so
every layout starts from the weights of one card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from nvit_tpu_torch.ckpt.tree import run_key
from nvit_tpu_torch.configs import Config
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.parallel.mesh import Mesh
from nvit_tpu_torch.train.optim import FusedAdamWState, init_fused_adamw


@dataclass
class TrainState:
    model: ViT
    opt_state: FusedAdamWState
    step: int  # ≙ Trainer.iter_num
    generator: torch.Generator  # host randomness of the run
    # the JAX package's run key (≙ TrainState.rng); [0, 0] unless given
    rng: np.ndarray = field(default_factory=lambda: np.zeros(2, np.uint32))


def create_train_state(cfg: Config, seed: int | None = None, *, device: torch.device | str) -> TrainState:
    """Fresh weights (init_vit's distributions) and zero moments on ``device``."""
    seed = cfg.training.seed if seed is None else seed
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    model = ViT(cfg.model, device=device).init_weights(g)
    opt_state = init_fused_adamw(model.named_parameters(), cfg.optimizer.moments_dtype)
    rng = torch.Generator()
    rng.manual_seed(seed + 1)
    return TrainState(model=model, opt_state=opt_state, step=0, generator=rng, rng=run_key(seed))


@torch.no_grad()
def shard_state_(state: TrainState, mesh: Mesh) -> TrainState:
    """Keep this rank's pieces of ``state`` (``mesh``'s layout): each trunk
    block's shard (``Block.shard_``: the model axis, and the data axis under
    FSDP) and its parameters' moments alike."""
    if not mesh.sharded:
        return state
    for blk in state.model.transformer["h"]:
        blk.shard_(mesh.model, mesh.data if mesh.fsdp else None)
    for moments in (state.opt_state.mu, state.opt_state.nu):
        for name in moments:
            moments[name] = mesh.take(name, moments[name])
    return state


def compute_dtype_of(cfg: Config) -> torch.dtype | None:
    """bf16 policy: parameters fp32, activations in the compute dtype.
    ``use_amp=False`` or ``dtype=float32`` forces fp32 compute; bf16 needs no
    loss scaling, so there is no GradScaler."""
    if not cfg.system.use_amp:
        return None
    return {"bfloat16": torch.bfloat16, "float16": torch.bfloat16, "float32": None}[cfg.system.dtype]
