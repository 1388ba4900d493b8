"""The Kohonen self-organizing map (≙ nvit_tpu/som)."""
