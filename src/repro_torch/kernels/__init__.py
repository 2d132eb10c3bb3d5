"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``mxv``), and the torch oracles (``ref``)."""
