"""Hand-written CUDA kernels of the port's main path, their plain
PyTorch versions (``ref``) and the offline pass around them (``ops``)."""
