"""nvit_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``nvit_tpu``.

The package mirrors ``nvit_tpu``'s module layout, so each counterpart is easy
to find: ``nvit_tpu/models/blocks.py`` ↔ ``nvit_tpu_torch/models/blocks.py``
and so on.  ``nvit_tpu`` (JAX) stays the reference the port is tested against
(``tests/test_torch_*.py``); this package imports ``torch`` and never ``jax``.

Slices ported so far, for nViT and the baseline ViT (``use_nvit=False``),
with or without biases (``bias: true``, as ``settings.yaml`` runs it) and
the Kohonen SOM (``use_kohonen``: ``som/kohonen.py``, its losses in
``models/losses.py``, the Hebbian update in ``train/step.py``), and with any
``bounded_softmax``:

* serving — ``serve.InferenceService`` → ``infer.Predictor`` →
  ``models.vit.ViT``;
* training — ``train.trainer.Trainer`` → ``train.step.make_train_step`` →
  the forward, loss and backward → ``train.optim``'s fused AdamW + renorm;
* the data path — CIFAR-10/100 files, ImageNet folders, digits and
  synthetic arrays (``data/datasets.py``), their batches on a thread
  (``data/pipeline.py``, the host loader ``data/native.py``), uploaded
  ahead on a side stream (``device_prefetch``), AutoAugment on the device
  (``data/autoaugment.py``), and remat (``models/vit.py``);
* the run's lifecycle — checkpoints in the JAX package's format
  (``ckpt/checkpoint.py``, ``ckpt/tree.py``), resume and ``eval_only``, the
  params-only export (``ckpt/export.py``), ``Predictor.from_checkpoint`` /
  ``from_export``, the config loader (``configs/loader.py``), and the
  command lines ``python -m nvit_tpu_torch``, ``python -m
  nvit_tpu_torch.ckpt.export`` and ``python -m nvit_tpu_torch.serve``.

The Pallas kernels those paths reach are rewritten by hand in CUDA C++ for
sm_90a (``csrc/``), each forward joined to its backward by a
``torch.autograd.Function``:

* ``ops/flash_attention.py`` — QK-norm flash attention forward (K1) and
  backward (K2), their bounded-softmax arm (K5), and the plain flash
  attention of baseline mode, forward (K7) and backward (K8, K9);
* ``ops/gated_mlp.py`` — fused gated-MLP forward (K3) and backward (K4),
  and both with a bias (K6).

K10, the q-sub-tiled QK-norm backward (``ops/flash_attention.py``
``qknorm_attention_bwd_subtiled``), is on neither path: its entry point is
``scripts/attn_bwd_split_bench.py``, the port of the JAX repository's A/B
of it against the integrated backward.

Each kernel wrapper runs its plain PyTorch twin on CPU tensors and launches
the CUDA kernel (or raises) on CUDA tensors.  The entry points run on the
card unless the caller asks for the CPU.  bf16 moments, wandb, int8 and
several cards, among others, come in later slices (ROADMAP.md §1).
"""

__version__ = "0.2.0"
