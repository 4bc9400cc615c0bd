"""The port's kernels: hand-written CUDA for the card, plain PyTorch
versions beside them for the CPU (``ref``), the entry points (``ops``),
and the kernels' gradient, the plain version's backward (``grad``)."""
