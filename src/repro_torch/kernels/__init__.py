"""Hand-written Hopper kernels of the port.

  topk_sim — fused similarity + top-K (replaces the Pallas
             `repro/kernels/topk_sim/kernel.py::topk_sim_pallas`)

Each subpackage ships kernel.py (the CUDA build, binding and launch
wrapper), ref.py (the plain PyTorch version) and ops.py (the public op:
CPU tensors take the plain version, CUDA tensors the kernel). CUDA C++
sources live in `csrc/` and are compiled with nvcc at first use.
"""
