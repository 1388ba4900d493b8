"""Package entry point: ``python -m nvit_tpu_torch`` (≙ nvit_tpu/__main__.py).

Loads the config — ``settings.yaml`` in the working directory or the
package's own, ``secrets.yaml``, ``.env`` and ``NVIT_SECTION__KEY``
environment overrides (``configs/loader.py``) — and runs
``Trainer(cfg).train()``, or ``validate_only()`` under
``training.eval_only``, on the card unless ``NVIT_SYSTEM__DEVICE=cpu``.
The packaged settings train on CIFAR-100 files in ``data.data_dir``
(``cifar-100-python/``, or its archive beside it; ``data.download=true``
fetches it) with AutoAugment, remat, biases and the Kohonen SOM; the packaged
default runs as it is, and so do the project's three profiles::

    NVIT_DATA__DATA_DIR=./data python -m nvit_tpu_torch
    env $(cat profiles/nvit1_k1.env) NVIT_DATA__DATA_DIR=./data python -m nvit_tpu_torch

Settings the port has not ported raise ``NotImplementedError`` naming their
ROADMAP.md item, ``NVIT_MULTIHOST=1`` among them.
"""

from nvit_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
