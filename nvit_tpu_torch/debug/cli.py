"""Debug / visualization CLI, the smoke test of a model (≙ nvit_tpu/debug/cli.py).

``python -m nvit_tpu_torch.debug`` builds the model of ``load_config()``
(``settings.yaml``, ``.env``, ``NVIT_SECTION__KEY``) with random weights,
runs a batch-256 forward on a fixture image — on the card unless
``system.device`` is ``"cpu"``, as the trainer — logs the shapes, the aux
losses and the parameter count, and writes two figures under
``<data.out_dir>/debug/``: ``patches.png`` (the local patch grid) and, with
the Kohonen SOM, ``kohonen.png`` (each map's BMU counts and node cosine
similarities).  The figures are drawn with PIL, which every host of the
port has; their data come from ``patch_tiles``, ``bmu_counts`` and
``node_cosines``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from nvit_tpu_torch.configs import load_config
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.patch import space_to_depth
from nvit_tpu_torch.models.vit import ViT, kohonen_spec, num_params

logger = logging.getLogger("nvit_tpu_torch.debug")


def fixture_image(size: int = 32, channels: int = 3) -> np.ndarray:
    """[C, size, size] uint8 test image (≙ fixture_image): scikit-learn's
    bundled photo where scikit-learn is installed (center crop,
    nearest-neighbour resize), else a procedural radial + stripe pattern."""
    if channels == 3:
        try:
            from sklearn.datasets import load_sample_images

            photo = load_sample_images().images[0]  # china.jpg, [H, W, 3] uint8
            h, w = photo.shape[:2]
            crop = min(h, w)
            photo = photo[(h - crop) // 2 : (h + crop) // 2, (w - crop) // 2 : (w + crop) // 2]
            sel = (np.arange(size) * crop // size).astype(np.int64)
            return photo[sel][:, sel].transpose(2, 0, 1).astype(np.uint8).copy()
        except ImportError:
            pass
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((channels, size, size), dtype=np.float32)
    for c in range(channels):
        radial = np.hypot(ys - 0.5, xs - 0.5) * 2.0
        stripes = 0.5 + 0.5 * np.sin((xs * 8 + ys * 3 + c / 3) * np.pi)
        img[c] = np.clip(255 * (0.6 * (1 - radial) + 0.4 * stripes), 0, 255)
    return img.astype(np.uint8)


def patch_tiles(img_u8: np.ndarray, patch: int) -> np.ndarray:
    """[C, H, W] uint8 → the local patches as tiles [g·g, p, p, C] uint8, in
    the token order of ``space_to_depth``."""
    c = img_u8.shape[0]
    tokens = space_to_depth(torch.from_numpy(img_u8[None]), patch)[0].numpy()
    return tokens.reshape(-1, c, patch, patch).transpose(0, 2, 3, 1)


def bmu_counts(indices: np.ndarray, spec) -> np.ndarray:
    """A map's BMU indices → activation counts on its m × n grid (fp64; the
    grid's last cells stay 0 when it holds more cells than nodes)."""
    counts = np.bincount(np.asarray(indices).reshape(-1), minlength=spec.num_nodes).astype(np.float64)
    act = np.zeros(spec.m * spec.n)
    act[: len(counts)] = counts
    return act.reshape(spec.m, spec.n)


def node_cosines(nodes: np.ndarray) -> np.ndarray:
    """[N, d] nodes → their [N, N] cosine similarities (fp32)."""
    nodes = np.asarray(nodes, dtype=np.float32)
    norm = nodes / np.maximum(np.linalg.norm(nodes, axis=1, keepdims=True), 1e-8)
    return norm @ norm.T


def _ramp(x: np.ndarray, lo: float, hi: float, colors: list) -> np.ndarray:
    """Values → RGB uint8 along a piecewise-linear ramp of ``colors``."""
    t = np.clip((np.asarray(x, np.float64) - lo) / max(hi - lo, 1e-12), 0, 1) * (len(colors) - 1)
    i = np.minimum(t.astype(int), len(colors) - 2)
    f = (t - i)[..., None]
    c = np.asarray(colors, np.float64)
    return ((1 - f) * c[i] + f * c[i + 1]).round().astype(np.uint8)


_VIRIDIS = [(68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98), (253, 231, 37)]
_COOLWARM = [(59, 76, 192), (221, 221, 221), (180, 4, 38)]


def _panel(rgb: np.ndarray, size: int):
    from PIL import Image

    return Image.fromarray(rgb).resize((size, size), Image.NEAREST)


def save_patch_figure(tiles: np.ndarray, out_path: Path, cell: int = 48) -> None:
    """The g × g tiles, each scaled to ``cell`` px, 2 px apart."""
    from PIL import Image

    g = int(round(len(tiles) ** 0.5))
    fig = Image.new("RGB", (g * (cell + 2), g * (cell + 2)), "white")
    for k, tile in enumerate(tiles):
        fig.paste(_panel(tile, cell), ((k % g) * (cell + 2), (k // g) * (cell + 2)))
    fig.save(out_path)


def save_kohonen_figure(panels: dict[str, tuple[np.ndarray, np.ndarray]], out_path: Path,
                        size: int = 256) -> None:
    """One column a map: its BMU counts (viridis) over its node cosines
    (coolwarm, −1 … 1)."""
    from PIL import Image

    fig = Image.new("RGB", (len(panels) * (size + 8), 2 * (size + 8)), "white")
    for col, (counts, cos) in enumerate(panels.values()):
        fig.paste(_panel(_ramp(counts, counts.min(), counts.max(), _VIRIDIS), size), (col * (size + 8), 0))
        fig.paste(_panel(_ramp(cos, -1.0, 1.0, _COOLWARM), size), (col * (size + 8), size + 8))
    fig.save(out_path)


@torch.no_grad()
def run_debug(model: ViT, img_u8: np.ndarray, batch_size: int, out_dir: Path) -> dict:
    """The forward of ``img_u8`` repeated ``batch_size`` times (bf16 compute,
    no Hebbian step), the logs and the figures → the summary."""
    cfg = model.cfg
    device = next(model.parameters()).device
    out_dir.mkdir(parents=True, exist_ok=True)
    batch = normalize(torch.from_numpy(np.repeat(img_u8[None], batch_size, axis=0)).to(device))
    logger.info("Input batch: %s (%s)", tuple(batch.shape), batch.dtype)
    logits, aux, som_info = model.forward_train(batch, hebbian=False, compute_dtype=torch.bfloat16)
    logger.info("Logits: %s", tuple(logits.shape))
    aux_losses = {k: float(v) for k, v in aux.items()}
    for k, v in aux_losses.items():
        logger.info("aux %s = %.6f", k, v)

    save_patch_figure(patch_tiles(img_u8, cfg.local_patch_size), out_dir / "patches.png")
    logger.info("Wrote %s", out_dir / "patches.png")
    figures = ["patches.png"]
    if cfg.use_kohonen:
        spec = kohonen_spec(cfg)
        panels = {name: (bmu_counts(som_info[f"{name}_indices"].cpu().numpy(), spec),
                         node_cosines(getattr(model, f"{name}_kohonen").nodes.detach().cpu().numpy()))
                  for name in ("local", "global")}
        save_kohonen_figure(panels, out_dir / "kohonen.png")
        logger.info("Wrote %s", out_dir / "kohonen.png")
        figures.append("kohonen.png")
    return {"logits_shape": tuple(logits.shape), "aux_losses": aux_losses,
            "num_params": num_params(model), "figures": [str(out_dir / f) for f in figures]}


def debug_model(batch_size: int = 256, seed: int = 0) -> dict:
    """The smoke test of ``load_config()``'s model with weights from ``seed``
    (≙ debug_model)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(name)s - %(message)s")
    cfg = load_config()
    device = torch.device("cpu" if cfg.system.device == "cpu" else "cuda")
    logger.info("Building model: nvit=%s kohonen=%s d=%d L=%d on %s", cfg.model.use_nvit,
                cfg.model.use_kohonen, cfg.model.n_embd, cfg.model.n_layer, device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    model = ViT(cfg.model, device=device).init_weights(g).eval()
    logger.info("Parameter count: %.3fM", num_params(model) / 1e6)
    img_u8 = fixture_image(cfg.model.image_size, cfg.model.channels)
    return run_debug(model, img_u8, batch_size, Path(cfg.data.out_dir) / "debug")


if __name__ == "__main__":
    debug_model()
