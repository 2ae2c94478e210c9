"""Hand-written CUDA kernels of the port, their plain torch versions and
the device routing between them."""
