"""The port's AOT serving artifact (``nvit_tpu_torch/ckpt/aot.py``) on the CPU.

One ``export_aot`` per artifact kind, each in a module-scoped fixture, of a
2-layer d = 64 nViT checkpoint with biases and the kernels' path selected
(tests/torch_serving.py):

* symbolic batch (the plain path, as the JAX package exports it) at
  batches 1, 3 and 5, and a batch pinned at 4 (the configured kernels,
  their twins on the CPU), each within rtol 1e-4 / atol 1e-6 of the port's
  ``Predictor`` on the same config (the symbolic artifact's: ``flash_attn``
  off);
* int8 composes: the pinned int8 artifact against ``Predictor(quantize=
  "int8")``, its program holding ``_int_mm`` and no gated-MLP operator;
* the program calls the registered kernel operators;
* the meta and its guards: a foreign format (a JAX ``.aot.json`` among
  them) and another platform are refused;
* ``InferenceService`` pads every request to the pinned batch, refuses a
  larger one naming the pin, and a reload that pins another batch.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nvit_tpu_torch.ckpt import aot
from nvit_tpu_torch.ckpt.checkpoint import restore_params
from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.serve import InferenceService
from tests.torch_serving import tiny_checkpoint

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)
PIN = 4


def images(b: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + b).integers(0, 256, (b, 3, 16, 16), dtype=np.uint8)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The checkpoint and one artifact of each kind: symbolic, pinned at 4,
    pinned at 4 with int8 (through the CLI)."""
    root = tmp_path_factory.mktemp("aot")
    cfg = tiny_checkpoint(root)
    aot.export_aot(root, "checkpoint_best", root / "symbolic", device="cpu")
    aot.export_aot(root, "checkpoint_best", root / "pinned", batch=PIN, device="cpu")
    aot.main(["--checkpoint", str(root), "--dest", str(root / "int8"), "--int8", "--batch", str(PIN),
              "--device", "cpu"])
    return root, cfg


def ops_of(predictor) -> set:
    return {str(n.target) for n in predictor._forward.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("b", [1, 3, 5])
def test_symbolic_artifact_matches_predictor(artifacts, b):
    root, cfg = artifacts
    served = aot.load_aot(root / "symbolic", "checkpoint_best", device="cpu")
    assert served.pinned_batch is None and served.cfg == cfg.model
    sd, _, _ = restore_params(root, "checkpoint_best")
    # the artifact's path: plain attention and MLP
    plain = Predictor(sd, dataclasses.replace(cfg.model, flash_attn=False), device="cpu")
    got = served.predict_probs(images(b))
    assert got.shape == (b, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, plain.predict_probs(images(b)), **TOL)
    assert not any(op.startswith("nvit.") for op in ops_of(served))


def test_pinned_artifact_runs_the_kernel_operators(artifacts):
    root, _ = artifacts
    served = aot.load_aot(root / "pinned", "checkpoint_best", device="cpu")
    assert served.pinned_batch == PIN
    want = Predictor.from_checkpoint(root, device="cpu").predict_probs(images(PIN))
    np.testing.assert_allclose(served.predict_probs(images(PIN)), want, **TOL)
    assert {"nvit.qknorm_attention.default", "nvit.gated_mlp.default"} <= ops_of(served)
    with pytest.raises(ValueError, match="pinned batch is 4, got 3"):
        served.predict_probs(images(3))


def test_int8_artifact_composes(artifacts):
    root, _ = artifacts
    served = aot.load_aot(root / "int8", "checkpoint_best", device="cpu")
    want = Predictor.from_checkpoint(root, device="cpu", quantize="int8").predict_probs(images(PIN))
    np.testing.assert_allclose(served.predict_probs(images(PIN)), want, **TOL)
    ops = ops_of(served)
    assert "aten._int_mm.default" in ops and "nvit.qknorm_attention.default" in ops
    assert "nvit.gated_mlp.default" not in ops  # the int8 gated projection is unfused, as JAX's
    meta = json.loads((root / "int8" / "checkpoint_best.aot.json").read_text())
    assert meta["quantize"] == "int8" and meta["batch"] == PIN
    weights = served._forward.state_dict()
    assert sum(v.dtype == torch.int8 for v in weights.values()) == 4 + 5 + 2 * 6  # every linear


def test_meta_holds_the_jax_fields(artifacts):
    root, cfg = artifacts
    meta = json.loads((root / "symbolic" / "checkpoint_best.aot.json").read_text())
    assert set(meta) == {"format", "model", "quantize", "batch", "attention", "platforms", "num_leaves",
                         "source_iter", "source_metrics"}
    assert meta["format"] == aot.AOT_FORMAT == "nvit_tpu_torch.ckpt.aot.v1"
    assert (meta["batch"], meta["attention"], meta["platforms"], meta["quantize"]) == (None, "plain", ["cpu"], None)
    assert meta["model"] == cfg.to_dict()["model"] and meta["source_iter"] == 0
    pinned = json.loads((root / "pinned" / "checkpoint_best.aot.json").read_text())
    assert (pinned["batch"], pinned["attention"]) == (PIN, "flash")
    assert sorted(p.name for p in (root / "pinned").iterdir()) == ["checkpoint_best.aot.json",
                                                                    "checkpoint_best.aot.pt2"]


def test_load_refuses_foreign_formats_and_platforms(artifacts, tmp_path):
    """A JAX StableHLO artifact's json (format ``nvit_tpu.ckpt.aot.v1``) and
    an export's are refused with JAX's message; a CPU artifact on the card
    asks for a re-export."""
    from nvit_tpu.ckpt.aot import AOT_FORMAT as JAX_AOT_FORMAT

    root, _ = artifacts
    meta = json.loads((root / "pinned" / "checkpoint_best.aot.json").read_text())
    for fmt in (JAX_AOT_FORMAT, "nvit_tpu.ckpt.export.v1"):
        (tmp_path / "x.aot.json").write_text(json.dumps({**meta, "format": fmt}))
        with pytest.raises(ValueError, match=f"not an AOT export: format='{fmt}'"):
            aot.load_aot(tmp_path, "x", device="cpu")
    with pytest.raises(ValueError, match="re-export on the serving platform"):
        aot.load_aot(root / "pinned", "checkpoint_best", device="cuda")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        aot.export_aot(root, "checkpoint_best", tmp_path, quantize="int4", device="cpu")


def test_service_pads_to_the_pinned_batch(artifacts):
    """Every forward runs at the pin (requests of 1 and 3 padded with zeros,
    each row's probabilities those of the unpadded Predictor), a larger batch
    is refused naming the pin, and a reload must keep it."""
    root, _ = artifacts
    served = aot.load_aot(root / "pinned", "checkpoint_best", device="cpu")
    seen = []
    run = served.predict_probs
    served.predict_probs = lambda x: seen.append(len(x)) or run(x)
    service = InferenceService(served, max_batch=64, builder=lambda: served)
    assert service.max_batch == PIN and service._bucket_sizes() == [PIN]
    service.warmup(all_buckets=True)
    want = Predictor.from_checkpoint(root, device="cpu")
    for b in (1, 3):
        got = service.predict(images(b), top_k=2)
        labels, probs = want.predict(images(b), top_k=2)
        assert got["labels"] == labels.tolist()
        np.testing.assert_allclose(got["probs"], probs, **TOL)
    assert set(seen) == {PIN}
    stats = service.stats.snapshot()
    assert stats["padding_overhead"] == pytest.approx(2 * PIN / 4 - 1)  # 8 device rows for 4 images
    with pytest.raises(ValueError, match="exceeds the artifact's pinned batch 4"):
        service.predict(images(5))
    service.reload()
    with pytest.raises(ValueError, match="pins batch None"):
        service.reload(lambda: Predictor.from_checkpoint(root, device="cpu"))
