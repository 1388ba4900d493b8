"""nvit_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``nvit_tpu``.

The package mirrors ``nvit_tpu``'s module layout, so each counterpart is easy
to find: ``nvit_tpu/models/blocks.py`` ↔ ``nvit_tpu_torch/models/blocks.py``
and so on.  ``nvit_tpu`` (JAX) stays the reference the port is tested against
(``tests/test_torch_*.py``); this package imports ``torch`` and never ``jax``.

Slices ported so far, for a non-Kohonen nViT:

* serving — ``serve.InferenceService`` → ``infer.Predictor`` →
  ``models.vit.ViT``;
* training — ``train.trainer.Trainer`` → ``train.step.make_train_step`` →
  the forward, loss and backward → ``train.optim``'s fused AdamW + renorm.

The four Pallas kernels those paths reach are rewritten by hand in CUDA C++
for sm_90a (``csrc/``), each forward joined to its backward by a
``torch.autograd.Function``:

* ``ops/flash_attention.py`` — QK-norm flash attention forward (K1) and
  backward (K2), row-max arm;
* ``ops/gated_mlp.py`` — fused gated-MLP forward (K3) and backward (K4), no
  bias.

Each kernel wrapper runs its plain PyTorch twin on CPU tensors and launches
the CUDA kernel (or raises) on CUDA tensors.  Checkpoint files, the CLI,
Kohonen and baseline mode come in later slices (ROADMAP.md).
"""

__version__ = "0.2.0"
