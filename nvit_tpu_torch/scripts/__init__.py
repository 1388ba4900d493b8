"""Scripts of the port (≙ the JAX repository's ``scripts/``), each run as a
module: ``python -m nvit_tpu_torch.scripts.<name>``."""
