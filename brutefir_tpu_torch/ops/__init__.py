"""Device ops: transforms, plain MACs, codec, and the CUDA kernel wrappers."""
