"""Shared helpers of the port's serving tests: an HTTP request, a server on
a thread, a stand-in predictor and a tiny checkpoint."""

from __future__ import annotations

import http.client
import json
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np

from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.configs import ViTConfig as PortViTConfig
from nvit_tpu_torch.serve import make_handler
from nvit_tpu_torch.train.state import create_train_state


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


def tiny_checkpoint(out_dir: Path, name: str = "checkpoint_best", **model_kw) -> port_schema.Config:
    """A port checkpoint of a 2-layer d = 64 nViT (16 px, 10 classes, biases,
    the kernels' path selected) with init weights and ``sz`` ten times its
    init, so the probabilities are far from uniform."""
    fields = dict(image_size=16, n_layer=2, n_head=2, n_embd=64, num_classes=10, local_patch_size=4,
                  global_patch_size=8, use_nvit=True, bias=True, flash_attn=True)
    fields.update(model_kw)
    cfg = port_schema.Config(model=port_schema.ViTConfig(**fields))
    state = create_train_state(cfg, device="cpu")
    if cfg.model.use_nvit:
        state.model.sz.data.mul_(10)
    port_ckpt.save_checkpoint(out_dir, name, state, cfg)
    return cfg
