"""Ops: the registry with its platform-override hook, the generic ops
(normalization, attention, convolution and pooling, activations,
losses), and the CUDA kernels that shadow them (``cuda_kernels``)."""
