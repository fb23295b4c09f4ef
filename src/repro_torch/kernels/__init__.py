"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain torch
versions, and the wrappers that pick between them by the tensors' device."""
