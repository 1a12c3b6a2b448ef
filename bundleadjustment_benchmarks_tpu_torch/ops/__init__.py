"""Per-observation geometry, robust kernels, small linear algebra, CUDA chain."""
