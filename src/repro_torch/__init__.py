"""PyTorch and CUDA port of the submodular MapReduce selection system."""
