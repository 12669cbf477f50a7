"""Graph spec and the per-block step (torch twin of brutefir_tpu.graph)."""
