"""Core primitives: norms, the linear casting contract, residual updates."""
