"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``), their
ctypes wrappers (:mod:`.ops`), plain PyTorch versions (:mod:`.ref`) and the
nvcc build (:mod:`.build`)."""
