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

Several processes (≙ nvit_tpu/__main__.py; the port runs one process per
card, as the reference's ``torchrun`` did): with several cards visible and
``system.use_ddp`` on, the command re-executes itself under ``python -m
torch.distributed.run --standalone --nproc_per_node=<cards>``, so it trains
on every local card; under ``NVIT_MULTIHOST=1`` with the JAX coordinator
variables (``JAX_COORDINATOR_ADDRESS=host:port``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``) the same command on every host joins one run of
``--nnodes`` hosts.  It also runs under a launcher as it is::

    torchrun --nproc_per_node=2 -m nvit_tpu_torch
    NVIT_SYSTEM__DEVICE=cpu torchrun --nproc_per_node=2 -m nvit_tpu_torch   # gloo

The launched world is the card count; ``system.model_parallel`` carves
the model axis out of it (M consecutive ranks share one model: tensor
parallelism), and ``system.fsdp`` cuts the trunk again over the data ranks
(``parallel/mesh.py``)::

    NVIT_SYSTEM__MODEL_PARALLEL=2 torchrun --nproc_per_node=4 -m nvit_tpu_torch   # data 2 × model 2
    NVIT_SYSTEM__FSDP=true torchrun --nproc_per_node=4 -m nvit_tpu_torch          # data 4, FSDP

Orbax checkpoints, on ROADMAP.md's do-not-port list, raise
``NotImplementedError``.
"""

from nvit_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
