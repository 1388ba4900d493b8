"""Package entry point: ``python -m nvit_tpu_torch`` (≙ nvit_tpu/__main__.py).

Loads the config — ``settings.yaml`` in the working directory or the
package's own, ``secrets.yaml``, ``.env`` and ``NVIT_SECTION__KEY``
environment overrides (``configs/loader.py``) — and runs
``Trainer(cfg).train()``, or ``validate_only()`` under
``training.eval_only``, on the card unless ``NVIT_SYSTEM__DEVICE=cpu``.
The packaged settings train on CIFAR-100 files in ``data.data_dir``
(``cifar-100-python/``, or its archive beside it; ``data.download=true``
fetches it) with AutoAugment and remat.  Settings the port has not ported
raise ``NotImplementedError`` naming their ROADMAP.md item: the packaged
default ``use_kohonen: true`` is one, and so is ``NVIT_MULTIHOST=1``.  The
project's profiles without Kohonen run as they are::

    env $(cat profiles/nvit1_k0.env) NVIT_DATA__DATA_DIR=./data python -m nvit_tpu_torch
"""

from nvit_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
