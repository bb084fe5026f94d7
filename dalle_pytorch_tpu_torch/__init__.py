"""PyTorch/CUDA port of ``dalle_pytorch_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``serve/``, ``compat/``, ``cli/``, ``data/``) so each counterpart is
easy to find, and every module names the JAX function it ports. It
imports ``torch``, numpy and the standard library only — never ``jax``
and never ``dalle_pytorch_tpu``.

What is ported so far: the serving path, a paged-KV continuous-batching
engine (``serve.engine.Engine``) whose per-token KV read is a
hand-written CUDA kernel (``csrc/paged_attention.cu``); one-shot
generation with the CLIP rerank; the training of the three models
(DiscreteVAE, DALLE in its sequential, reversible, MoE and
rematerialised forms, CLIP) on the flash and block-sparse kernels
(``csrc/flash_attention.cu``, ``csrc/block_sparse.cu``) with Adam and an
EMA; a torch threefry so sampled tokens and dropout masks match JAX's
bit for bit; bridges to and from the JAX parameter trees
(``compat.from_jax``, ``compat.to_jax``); checkpoints in the JAX
package's format, byte for byte (``checkpoint``, ``compat.msgpack``);
the data layer (``data``: PNG and PIL's bilinear resize from ``zlib``
and numpy); the training supervisor (``resilience``); and the CLIs
(``cli.train_vae``, ``train_dalle``, ``gen_dalle``, ``train_clip``,
``mix_vae``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit request they raise
(``device.resolve_device``).
"""
