"""Attention kernels of the port: hand-written CUDA for Hopper, each with
its plain PyTorch version (see ``ops``)."""
