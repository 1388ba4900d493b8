"""nvit_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``nvit_tpu``.

The package mirrors ``nvit_tpu``'s module layout, so each counterpart is easy
to find: ``nvit_tpu/models/blocks.py`` ↔ ``nvit_tpu_torch/models/blocks.py``
and so on.  ``nvit_tpu`` (JAX) stays the reference the port is tested against
(``tests/test_torch_*.py``); this package imports ``torch`` and never ``jax``.

Slice ported so far: the serving path of a non-Kohonen nViT —
``serve.InferenceService`` → ``infer.Predictor`` → ``models.vit.ViT`` — with
the two Pallas kernels that path reaches rewritten by hand in CUDA C++ for
sm_90a (``csrc/``):

* ``ops/flash_attention.py`` — QK-norm flash attention forward (row-max arm);
* ``ops/gated_mlp.py`` — fused gated-MLP forward (no bias).

Each kernel wrapper runs its plain PyTorch twin on CPU tensors and launches
the CUDA kernel (or raises) on CUDA tensors.  Training, checkpoint-file
loading, Kohonen and baseline mode come in later slices (ROADMAP.md).
"""

__version__ = "0.1.0"
