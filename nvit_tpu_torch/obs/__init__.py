"""Observability (≙ nvit_tpu/obs): metric sinks, step timer, memory stats."""
