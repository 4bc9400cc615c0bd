"""The port's kernels: hand-written CUDA for the card, plain PyTorch
versions beside them for the CPU (``ref``), and the entry points (``ops``)."""
