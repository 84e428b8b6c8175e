"""Ops: the registry with its platform-override hook, the generic layer
norm and attention ops, and the CUDA kernels that shadow them
(``cuda_kernels``)."""
