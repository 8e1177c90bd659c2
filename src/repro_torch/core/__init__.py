"""Layout, quantization, rank-key and selection primitives of the port."""
