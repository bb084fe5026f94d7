"""DiscreteVAE, decode half: image tokens -> codebook rows -> conv decoder.

Port of ``dalle_pytorch_tpu/models/vae.py`` (``VAEConfig``,
``decode_embeds`` and ``decode``, ``:39-66,146-225``). The serving path
needs only the decoder; the encoder, Gumbel relaxation and training
loss come with the training slice.

The convolutions run NCHW (torch's layout) internally, but the public
functions keep the JAX package's NHWC images and ``(b, h, w, d)``
embeddings, so tests compare like with like.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from dalle_pytorch_tpu_torch.device import generator, resolve_device
from dalle_pytorch_tpu_torch.ops import core


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    image_size: int = 256
    num_tokens: int = 512
    codebook_dim: int = 512
    num_layers: int = 3
    num_resnet_blocks: int = 0
    hidden_dim: int = 64
    channels: int = 3

    def __post_init__(self):
        if not math.log2(self.image_size).is_integer():
            raise ValueError("image size must be a power of 2")
        if self.num_layers < 1:
            raise ValueError("number of layers must be >= 1")

    @property
    def grid_size(self) -> int:
        return self.image_size // (2 ** self.num_layers)

    @property
    def image_seq_len(self) -> int:
        return self.grid_size ** 2


class ResBlock(nn.Module):
    def __init__(self, chan: int, **kw):
        super().__init__()
        self.c1 = nn.Conv2d(chan, chan, 3, **kw)
        self.c2 = nn.Conv2d(chan, chan, 3, **kw)
        self.c3 = nn.Conv2d(chan, chan, 1, **kw)


class VAEDecoder(nn.Module):
    """The decoder parameters of the JAX ``vae_init`` tree: ``codebook``,
    optional ``dec_stem`` (only with resnet blocks), ``dec_res``,
    ``dec_convs`` (ConvTranspose 4x4 stride 2) and ``dec_out``."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = cfg.num_layers
        self.codebook = nn.Embedding(cfg.num_tokens, cfg.codebook_dim, **kw)
        has_res = cfg.num_resnet_blocks > 0
        dec_chans = [cfg.hidden_dim] * n
        dec_in = dec_chans[0] if has_res else cfg.codebook_dim
        self.dec_stem = (nn.Conv2d(cfg.codebook_dim, dec_chans[0], 1, **kw)
                         if has_res else None)
        self.dec_res = nn.ModuleList(
            ResBlock(dec_chans[0], **kw)
            for _ in range(cfg.num_resnet_blocks))
        self.dec_convs = nn.ModuleList(
            nn.ConvTranspose2d(cin, cout, 4, **kw)
            for cin, cout in zip([dec_in] + dec_chans[:-1], dec_chans))
        self.dec_out = nn.Conv2d(dec_chans[-1], cfg.channels, 1, **kw)


def _resblock(p: ResBlock, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(core.conv2d(p.c1, x, padding=1))
    h = torch.relu(core.conv2d(p.c2, h, padding=1))
    return core.conv2d(p.c3, h) + x


def decode_embeds(vae: VAEDecoder, embeds: torch.Tensor) -> torch.Tensor:
    """embeds (b, h, w, codebook_dim) -> images (b, H, W, C)."""
    x = embeds.permute(0, 3, 1, 2)
    if vae.dec_stem is not None:
        x = core.conv2d(vae.dec_stem, x)
    for p in vae.dec_res:
        x = _resblock(p, x)
    for p in vae.dec_convs:
        x = torch.relu(core.conv2d_transpose(p, x, stride=2, padding=1))
    return core.conv2d(vae.dec_out, x).permute(0, 2, 3, 1)


def decode(vae: VAEDecoder, img_seq: torch.Tensor,
           codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (b, n) -> images (b, H, W, C) over a square grid.
    ``codebook`` overrides the VAE's own table — DALLE owns the tied copy
    (``models/dalle.py``)."""
    table = vae.codebook.weight if codebook is None else codebook
    embeds = table[img_seq]
    b, n, d = embeds.shape
    g = math.isqrt(n)
    if g * g != n:
        raise ValueError(f"image token sequence of {n} is not a square grid")
    return decode_embeds(vae, embeds.reshape(b, g, g, d))


def vae_init(cfg: VAEConfig, seed: int = 0, *, dtype=torch.float32,
             device=None) -> VAEDecoder:
    """A seeded random decoder on ``device`` (the card by default)."""
    device = resolve_device(device)
    vae = VAEDecoder(cfg, device=device, dtype=dtype)
    core.init_params_(vae, generator(seed, device))
    return vae
