"""RoPE on q and k and the heads-major layout of q, k and v: the CUDA kernel, its plain
version and the public op."""
