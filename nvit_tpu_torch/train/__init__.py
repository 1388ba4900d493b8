"""Training (≙ nvit_tpu/train): state, step, optimizer and the trainer loop."""
