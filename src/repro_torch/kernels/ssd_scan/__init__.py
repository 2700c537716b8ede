"""Mamba-2 SSD chunk scan: the CUDA kernel, its plain version and the public op."""
