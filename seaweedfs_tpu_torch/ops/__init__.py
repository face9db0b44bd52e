"""Host math and the CUDA kernels of the port."""
