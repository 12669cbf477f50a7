"""Coefficient bank loading (numpy twin of brutefir_tpu.config.coeffs)."""
