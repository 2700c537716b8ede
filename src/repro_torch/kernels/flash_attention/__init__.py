"""Flash attention: the CUDA kernel, its plain version and the public op."""
