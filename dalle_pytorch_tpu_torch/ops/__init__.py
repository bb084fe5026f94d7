"""Tensor ops of the port: primitives, attention, the transformer stack
(sequential, reversible, Mixture-of-Experts), the threefry sampler bits,
decoding (dense, paged and speculative) and the attention kernels."""
