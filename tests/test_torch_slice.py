"""The port's serving slice against the JAX package, end to end on the CPU.

* blocks and embeddings, plain path, against ``block_apply`` /
  ``cross_attention_apply`` / ``embed_patches``;
* the whole slice: ``nvit-tiny4`` at 2 layers with ``flash_attn=True`` —
  the port's ``Predictor`` (K1/K3 twins on the CPU) against
  ``normalize → vit_apply → softmax`` with the JAX package's Pallas kernels
  forced through the generic interpreter (tests/kernel_force.py), in the
  fp32 and bf16 policies, plus a ``/predict`` round-trip over HTTP;
* the serving layer's HTTP contract;
* the package imports no jax, and the kernel build raises without nvcc.
"""

import http.client
import json
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.configs.schema import Config, ViTConfig
from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu.models.blocks import block_apply, cross_attention_apply
from nvit_tpu.models.vit import embed_patches, vit_apply
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.configs import ViTConfig as PortViTConfig
from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.models.presets import preset
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.serve import InferenceService, _pad_batch, make_handler
from tests.torch_parity import port_config, random_jax_params

torch.set_num_threads(1)


def port_model(params, jax_cfg):
    cfg = port_config(jax_cfg)
    model = ViT(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return model.eval()


def small_cfg(**kw):
    base = dict(image_size=16, n_layer=1, n_head=2, n_embd=64, num_classes=7,
                local_patch_size=4, global_patch_size=8, use_nvit=True, flash_attn=False)
    base.update(kw)
    return ViTConfig(**base)


# fp32: summation order only; bf16: a few bf16 roundings through the chain
TOL = {None: dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=3e-2, atol=3e-2)}
JDT = {None: None, "bf16": jnp.bfloat16}
TDT = {None: None, "bf16": torch.bfloat16}


@pytest.mark.parametrize("policy,bias", [(None, False), ("bf16", False), (None, True)])
def test_embed_blocks_match_jax_plain_path(policy, bias):
    cfg = small_cfg(bias=bias)
    params = random_jax_params(cfg)
    model = port_model(params, cfg)
    img = np.random.default_rng(1).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        lt, gt = model.embed_patches(torch.from_numpy(img), compute_dtype=TDT[policy])
        lj, gj = jax.jit(lambda p, x: embed_patches(p, cfg, x, compute_dtype=JDT[policy]))(
            params, jnp.asarray(img))
        for t_, j_ in ((lt, lj), (gt, gj)):
            np.testing.assert_allclose(t_.float().numpy(), np.asarray(j_, np.float32), **TOL[policy])
        # feed both sides the same (JAX) activations so each module is held alone
        lt, gt = (torch.from_numpy(np.array(x, np.float32)).to(lt.dtype) for x in (lj, gj))
        cross_t = model.cross_attention(lt, gt, compute_dtype=TDT[policy])
        cross_j = jax.jit(lambda p, a, b: cross_attention_apply(p, cfg, a, b, compute_dtype=JDT[policy]))(
            params["cross_attention"], lj, gj)
        np.testing.assert_allclose(cross_t.float().numpy(), np.asarray(cross_j, np.float32), **TOL[policy])
        blk_t = model.transformer["h"][0](lt, compute_dtype=TDT[policy])
        blk_j = jax.jit(lambda p, h: block_apply(p, cfg, h, compute_dtype=JDT[policy]))(
            params["blocks"][0], lj)
        np.testing.assert_allclose(blk_t.float().numpy(), np.asarray(blk_j, np.float32), **TOL[policy])


def test_flash_path_twins_agree_with_plain_path_in_fp32():
    """flash_attn=True on the CPU runs the K1/K3 twins: in fp32 the fused
    math equals the plain chain up to summation order."""
    cfg_plain = small_cfg(n_layer=2)
    cfg_flash = small_cfg(n_layer=2, flash_attn=True)
    params = random_jax_params(cfg_plain)
    img = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32))
    with torch.no_grad():
        plain = port_model(params, cfg_plain)(img)
        flash = port_model(params, cfg_flash)(img)
    torch.testing.assert_close(flash, plain, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ whole slice
def tiny4_cfg():
    kw = preset("nvit-tiny4")
    kw.update(n_layer=2, num_classes=10, flash_attn=True)
    return Config(model=ViTConfig(**kw))


@pytest.fixture(scope="module")
def slice_case():
    """JAX reference probabilities of nvit-tiny4 (2 layers) with the Pallas
    kernels forced, in both policies, computed once for the module."""
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    cfg = tiny4_cfg()
    params = random_jax_params(cfg.model, seed=3)
    params["sz"] = 10 * params["sz"]  # logits of a few units: probabilities far from uniform
    images = np.random.default_rng(4).integers(0, 256, (4, 3, 32, 32), dtype=np.uint8)
    probs = {}
    with force_on_tpu(), generic_interpret_mode():
        for policy in (None, "bf16"):
            def fwd(p, x, dt=JDT[policy]):
                logits = vit_apply(p, cfg.model, jax_normalize(x), compute_dtype=dt).logits
                return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)

            # one jitted program per policy compiles far faster than eager ops
            probs[policy] = np.asarray(jax.jit(fwd)(params, jnp.asarray(images)))
    return cfg, params, images, probs


@pytest.mark.parametrize("policy", [None, "bf16"])
def test_slice_matches_jax_with_kernels(slice_case, policy):
    cfg, params, images, ref = slice_case
    model_cfg = port_config(cfg.model)
    pred = Predictor(state_dict_from_jax(params, model_cfg), model_cfg, device="cpu",
                     compute_dtype=TDT[policy])
    probs = pred.predict_probs(images)
    assert probs.shape == (4, 10) and probs.dtype == np.float32
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    # fp32: summation order only (measured 2.4e-7); bf16: roundings through
    # 2 layers + head, measured 7e-3 at probabilities up to 0.63 — 1e-2 absolute
    tol = dict(rtol=1e-4, atol=1e-5) if policy is None else dict(rtol=0, atol=1e-2)
    np.testing.assert_allclose(probs, ref[policy], **tol)


def _request(addr, method, path, body=None, content_type="application/json"):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    headers = {"Content-Type": content_type} if body is not None else {}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    return resp.status, payload


def serving(service):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def test_predict_round_trip_matches_jax(slice_case):
    cfg, params, images, ref = slice_case
    model_cfg = port_config(cfg.model)
    pred = Predictor(state_dict_from_jax(params, model_cfg), model_cfg, device="cpu",
                     compute_dtype=None)
    service = InferenceService(pred, max_batch=8)
    srv, thread = serving(service)
    try:
        body = json.dumps({"images": images[:3].tolist(), "top_k": 3}).encode()
        status, out = _request(srv.server_address, "POST", "/predict", body)
        assert status == 200, out
        want_idx = np.argsort(-ref[None][:3], axis=-1)[:, :3]
        np.testing.assert_array_equal(out["labels"], want_idx)
        np.testing.assert_allclose(out["probs"], np.take_along_axis(ref[None][:3], want_idx, -1),
                                   rtol=1e-4, atol=1e-5)
        status, out = _request(srv.server_address, "POST", "/predict", images[3].tobytes(),
                               "application/octet-stream")
        assert status == 200 and out["labels"][0][0] == int(np.argmax(ref[None][3]))
        status, health = _request(srv.server_address, "GET", "/healthz")
        assert status == 200 and health["model"]["num_classes"] == 10
        status, stats = _request(srv.server_address, "GET", "/stats")
        assert status == 200 and stats["requests"] == 2 and stats["images"] == 4
        assert stats["padding_overhead"] == pytest.approx(0.25)  # 3 → 4 rows, 1 → 1
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


# ------------------------------------------------------------ serving layer
class _FakePredictor:
    """Stands in for the model: probs are a function of the pixel sum."""

    def __init__(self, fail=False):
        self.cfg = PortViTConfig(image_size=4, n_layer=1, n_head=1, n_embd=8, num_classes=5,
                             local_patch_size=2, global_patch_size=4, use_nvit=True)
        self.fail = fail
        self.batches = []

    def predict_probs(self, images):
        if self.fail:
            raise RuntimeError("device lost")
        self.batches.append(images.shape[0])
        s = images.reshape(images.shape[0], -1).astype(np.float32).sum(-1, keepdims=True)
        logits = np.sin(s + np.arange(5, dtype=np.float32))
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("b,want", [(1, 1), (3, 4), (5, 8), (8, 8)])
def test_pad_batch_to_power_of_two(b, want):
    imgs = np.ones((b, 3, 4, 4), np.uint8)
    padded, real = _pad_batch(imgs, 8)
    assert padded.shape[0] == want and real == b
    assert (padded[b:] == 0).all()


@pytest.mark.parametrize("body,content_type,code", [
    (b"{not json", "application/json", 400),
    (json.dumps([1, 2]).encode(), "application/json", 400),
    (json.dumps({"images": np.zeros((1, 3, 5, 5)).tolist()}).encode(), "application/json", 400),
    (json.dumps({"images": np.zeros((3, 4, 4)).tolist(), "top_k": 9}).encode(), "application/json", 400),
    (json.dumps({"images": np.full((3, 4, 4), 256.0).tolist()}).encode(), "application/json", 400),
    (b"\x00" * 7, "application/octet-stream", 400),
])
def test_bad_requests_are_400(body, content_type, code):
    service = InferenceService(_FakePredictor(), max_batch=4)
    srv, thread = serving(service)
    try:
        status, out = _request(srv.server_address, "POST", "/predict", body, content_type)
        assert status == code and "error" in out
        assert service.stats.snapshot()["errors"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


def test_device_failure_is_500_and_dynamic_batching_coalesces():
    service = InferenceService(_FakePredictor(fail=True), max_batch=4)
    srv, thread = serving(service)
    try:
        body = json.dumps({"images": np.zeros((3, 4, 4)).tolist()}).encode()
        status, out = _request(srv.server_address, "POST", "/predict", body)
        assert status == 500 and "device lost" in out["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)

    fake = _FakePredictor()
    batched = InferenceService(fake, max_batch=8, batch_window_ms=200)
    results = [None] * 4
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (1, 3, 4, 4), dtype=np.uint8) for _ in range(4)]

    def call(i):
        results[i] = batched.predict(imgs[i], top_k=2)

    workers = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    batched.close()
    assert all(not w.is_alive() for w in workers)
    direct = InferenceService(_FakePredictor(), max_batch=8)
    for i in range(4):
        assert results[i] == direct.predict(imgs[i], top_k=2)
    assert sum(fake.batches) >= 4 and len(fake.batches) < 4  # coalesced


def test_reload_swaps_model_and_keeps_geometry():
    service = InferenceService(_FakePredictor(), max_batch=4, builder=_FakePredictor)
    service.reload()
    assert service.stats.snapshot()["reloads"] == 1

    def other_geometry():
        p = _FakePredictor()
        p.cfg = PortViTConfig(image_size=8, n_layer=1, n_head=1, n_embd=8, num_classes=5,
                          local_patch_size=2, global_patch_size=4, use_nvit=True)
        return p

    with pytest.raises(ValueError, match="geometry"):
        service.reload(other_geometry)


# ------------------------------------------------------------ package hygiene
def test_package_imports_no_jax():
    """Neither jax nor the JAX package: the port runs where only PyTorch is."""
    code = (
        "import sys, nvit_tpu_torch, nvit_tpu_torch.serve, nvit_tpu_torch.ckpt.convert, "
        "nvit_tpu_torch.train.trainer, nvit_tpu_torch.train.step, nvit_tpu_torch.train.optim, "
        "nvit_tpu_torch.data.datasets, nvit_tpu_torch.data.pipeline, nvit_tpu_torch.obs.metrics, "
        "nvit_tpu_torch.models.presets, nvit_tpu_torch.models.blocks, nvit_tpu_torch.ops.attention, "
        "nvit_tpu_torch.ops.flash_attention; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nvit_tpu')); "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from nvit_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.find_nvcc() is None
    for name in ("qknorm_attn_fwd", "gated_mlp_fwd", "qknorm_attn_bwd", "gated_mlp_bwd",
                 "flash_attn_fwd", "flash_attn_bwd"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load_library(name)
    assert not (tmp_path / "build").exists()
