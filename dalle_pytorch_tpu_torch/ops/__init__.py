"""Tensor ops of the port: primitives, attention, the transformer stack
(sequential, reversible, Mixture-of-Experts), the threefry sampler bits,
decoding and the attention kernels."""
