"""Checkpoint conversion from the JAX parameter tree."""
