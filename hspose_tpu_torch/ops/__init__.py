"""Neighbour ops and the CUDA kernels of the port."""
