"""Plain float64 PyTorch reference of the benchmark's bundle adjustment.

It imports nothing of JAX, of the JAX package or of the port, and works
everything out again from the raw BAL arrays the harness hands it."""
