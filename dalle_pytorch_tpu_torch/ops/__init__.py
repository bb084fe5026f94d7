"""Tensor ops of the port: primitives, attention, the transformer stack,
the threefry sampler bits, decoding and the paged-attention kernel."""
