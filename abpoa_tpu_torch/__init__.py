"""abpoa_tpu_torch: adaptive banded partial-order alignment in PyTorch, with
the banded DP kernel written in CUDA for Hopper (sm_90a).

The counterpart of the JAX package `abpoa_tpu`; module names follow it.
Entry points run on `cuda` unless the caller asks for `cpu`:
`python -m abpoa_tpu_torch reads.fa [--device cuda|cpu]`.
"""
__version__ = "0.1.0"
