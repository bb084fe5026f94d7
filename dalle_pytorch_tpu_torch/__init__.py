"""PyTorch/CUDA port of ``dalle_pytorch_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``serve/``, ``compat/``) so each counterpart is
easy to find, and every module names the JAX function it ports. It
imports ``torch``, numpy and the standard library only — never ``jax``
and never ``dalle_pytorch_tpu``.

What is ported so far is the serving main path: a paged-KV
continuous-batching engine (``serve.engine.Engine``) whose per-token KV
read is a hand-written CUDA kernel (``csrc/paged_attention.cu``), the
DALLE/VAE modules it drives, a torch threefry so sampled tokens match
the JAX engine bit for bit, and a bridge from the JAX parameter trees
(``compat.from_jax``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit request they raise
(``device.resolve_device``).
"""
