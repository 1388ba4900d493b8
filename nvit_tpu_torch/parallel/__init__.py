"""Data parallelism across processes (≙ nvit_tpu/parallel/, its data axis)."""
