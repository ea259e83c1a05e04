"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and the
device dispatch between them."""
