"""PyTorch/CUDA port of the streaming real-time index (see src/repro for
the JAX reference it is held against)."""
