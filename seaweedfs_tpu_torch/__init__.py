"""PyTorch/CUDA port of seaweedfs_tpu.

Mirrors the JAX package's layout (ops/, parallel/, storage/erasure_coding/)
and never imports JAX or the JAX package.  Entry points run on the CUDA
device unless the caller passes device="cpu".
"""
