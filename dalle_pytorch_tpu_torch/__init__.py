"""PyTorch/CUDA port of ``dalle_pytorch_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``serve/``, ``compat/``, ``cli/``, ``data/``) so each counterpart is
easy to find, and every module names the JAX function it ports. It
imports ``torch``, numpy and the standard library only — never ``jax``
and never ``dalle_pytorch_tpu``.

What is ported so far: the serving path, the single continuous-batching
engine (``serve.engine.Engine``: dense or paged KV, eviction, the prefix
cache, guided slot pairs, speculative decoding, fencing and live slot
migration, the postprocess worker with CLIP scores) whose paged
per-token KV read is a hand-written CUDA kernel
(``csrc/paged_attention.cu``); the replica set of thread replicas on one
card (``serve.replica.ReplicaSet``: crash and hang failover, drain with
live migration, scale in and out, rolling upgrades, roles) and its
autoscaler (``serve.autoscale``); the HTTP server (``serve.server``,
``cli.serve``, one engine or a replica set); one-shot generation with
the CLIP rerank; the training of the three models (DiscreteVAE, DALLE in
its sequential, reversible, MoE and rematerialised forms, CLIP) on the
flash and block-sparse kernels (``csrc/flash_attention.cu``,
``csrc/block_sparse.cu``) with Adam and an EMA; a torch threefry so
sampled tokens and dropout masks match JAX's bit for bit; bridges to and
from the JAX parameter trees (``compat.from_jax``, ``compat.to_jax``)
and the reference's ``.pth`` state dicts (``compat.torch_import``,
``compat.torch_export``, ``cli.import_torch``); checkpoints in the JAX
package's format, byte for byte (``checkpoint``, ``compat.msgpack``);
the data layer (``data``: PNG at every bit depth and interlace, BMP, and
PIL's bilinear resize from ``zlib`` and numpy; JPEG through libjpeg in
``native``, a ctypes library built with g++ on first use); the debug
guards (``utils.debug``); the training supervisor (``resilience``); and
the CLIs (``cli.train_vae``, ``train_dalle``, ``gen_dalle``,
``train_clip``, ``mix_vae``, ``import_torch``, ``serve``).

The reference's classes come from the package root, as the JAX
package's do: ``from dalle_pytorch_tpu_torch import DALLE, CLIP,
DiscreteVAE`` (and their configs), loaded on first use, so ``import
dalle_pytorch_tpu_torch.ops`` imports no model.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit request they raise
(``device.resolve_device``).
"""

__all__ = [
    "DALLE",
    "CLIP",
    "DiscreteVAE",
    "DALLEConfig",
    "CLIPConfig",
    "VAEConfig",
]

_EXPORTS = {
    "DiscreteVAE": ("dalle_pytorch_tpu_torch.models.vae", "DiscreteVAE"),
    "VAEConfig": ("dalle_pytorch_tpu_torch.models.vae", "VAEConfig"),
    "DALLE": ("dalle_pytorch_tpu_torch.models.dalle", "DALLE"),
    "DALLEConfig": ("dalle_pytorch_tpu_torch.models.dalle", "DALLEConfig"),
    "CLIP": ("dalle_pytorch_tpu_torch.models.clip", "CLIP"),
    "CLIPConfig": ("dalle_pytorch_tpu_torch.models.clip", "CLIPConfig"),
}


def __getattr__(name):
    # lazy: a model class is imported when it is first asked for
    if name in _EXPORTS:
        import importlib
        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
