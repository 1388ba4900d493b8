"""Package entry point: ``python -m nvit_tpu_torch`` (≙ nvit_tpu/__main__.py).

Loads the config — ``settings.yaml`` in the working directory or the
package's own, ``secrets.yaml``, ``.env`` and ``NVIT_SECTION__KEY``
environment overrides (``configs/loader.py``) — and runs
``Trainer(cfg).train()``, or ``validate_only()`` under
``training.eval_only``, on the card unless ``NVIT_SYSTEM__DEVICE=cpu``.
Settings the port has not ported raise ``NotImplementedError`` naming their
ROADMAP.md item; the packaged defaults (CIFAR-100, AutoAugment, remat,
Kohonen) are such settings, and so is ``NVIT_MULTIHOST=1``, so a run names
its dataset and model through the environment::

    NVIT_DATA__DATASET=synthetic NVIT_DATA__AUGMENTATION__AUTO_AUGMENT=false \\
    NVIT_SYSTEM__REMAT=false NVIT_MODEL__USE_KOHONEN=false ... python -m nvit_tpu_torch
"""

from nvit_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
