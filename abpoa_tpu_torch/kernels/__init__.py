"""Building the CUDA kernels from csrc/."""
