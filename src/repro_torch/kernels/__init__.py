"""Kernels of the port: hand-written CUDA for Hopper (flash and paged
attention, the grouped expert matmul), each with its plain PyTorch version
(see ``ops``)."""
