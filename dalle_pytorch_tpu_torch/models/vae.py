"""DiscreteVAE: the conv encoder (images -> token logits), the Gumbel-
softmax relaxation over the codebook, and the conv decoder.

Port of ``dalle_pytorch_tpu/models/vae.py`` (``:38-274``): ``VAEConfig``,
``encode_logits``, ``decode_embeds``, ``gumbel_softmax``, ``vae_apply``
(the forward and reconstruction loss the VAE trains on),
``get_codebook_indices`` and ``decode``. ``DiscreteVAE`` holds the whole
JAX ``vae_init`` tree (encoder, codebook, decoder) and is also the JAX OO
facade (``DiscreteVAE(image_size=..., ...)``, ``forward``,
``get_codebook_indices``, ``decode``, the reference's properties);
``VAEEncoder``
(DALLE training tokenises raw images with it, no gradient) and
``VAEDecoder`` (serving) hold one half each. The functions take any
module with the attributes they read, so a ``DiscreteVAE`` goes
wherever either half does.

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
from dalle_pytorch_tpu_torch.ops import core, prng


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    image_size: int = 256
    num_tokens: int = 512
    codebook_dim: int = 512
    num_layers: int = 3
    num_resnet_blocks: int = 0
    hidden_dim: int = 64
    channels: int = 3
    temperature: float = 0.9
    # soft relaxation by default (the reference's gumbel_softmax
    # hard=False); True gives straight-through
    straight_through: bool = False

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
        _build_decoder(self, cfg, dict(device=device, dtype=dtype))


class VAEEncoder(nn.Module):
    """The encoder parameters of the JAX ``vae_init`` tree:
    ``enc_convs`` (Conv 4x4 stride 2), ``enc_res`` and ``enc_out`` (1x1
    conv to ``num_tokens`` logits)."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        _build_encoder(self, cfg, dict(device=device, dtype=dtype))


class DiscreteVAE(nn.Module):
    """The whole JAX ``vae_init`` tree: the encoder's ``enc_convs``,
    ``enc_res`` and ``enc_out``, the ``codebook``, and the decoder's
    ``dec_stem``, ``dec_res``, ``dec_convs`` and ``dec_out``; with the
    reference class's ``forward`` (``vae_apply``), ``get_codebook_indices``,
    ``decode`` and its properties (JAX ``:232-274``).

    Two ways in, one module: ``DiscreteVAE(cfg, device=, dtype=)`` builds
    the parameters uninitialised (``vae_init``, ``compat/from_jax.py``
    fill them); ``DiscreteVAE(**cfg_kwargs, params=, seed=, dtype=,
    device=)`` is the JAX facade's constructor: the config from the
    keywords, then the weights from ``params`` (a JAX ``vae_init`` tree
    as numpy arrays) or seeded at random, on the card unless ``device``
    says otherwise."""

    def __init__(self, cfg: Optional[VAEConfig] = None, *, device=None,
                 dtype=None, params=None, seed: Optional[int] = None,
                 **cfg_kwargs):
        facade = cfg is None
        if facade:
            cfg = VAEConfig(**cfg_kwargs)
            device = resolve_device(device)
            dtype = dtype or torch.float32
        elif cfg_kwargs or params is not None or seed is not None:
            raise TypeError("DiscreteVAE takes a VAEConfig or the "
                            "reference's keywords, not both")
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        _build_encoder(self, cfg, kw)
        _build_decoder(self, cfg, kw)
        if facade:
            if params is None:
                core.init_params_(self, generator(seed or 0, device))
            else:
                from dalle_pytorch_tpu_torch.compat import from_jax
                from_jax.fill_discrete_vae(self, params)

    # the reference class's properties
    @property
    def config(self) -> VAEConfig:
        return self.cfg

    @property
    def image_size(self) -> int:
        return self.cfg.image_size

    @property
    def num_tokens(self) -> int:
        return self.cfg.num_tokens

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    @property
    def temperature(self) -> float:
        return self.cfg.temperature

    def forward(self, images: torch.Tensor,
                rng: Optional[torch.Tensor] = None, **kw):
        return vae_apply(self, images, cfg=self.cfg, rng=rng, **kw)

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        return get_codebook_indices(self, images)

    def decode(self, img_seq: torch.Tensor,
               codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
        return decode(self, img_seq, codebook)


def _build_encoder(m: nn.Module, cfg: VAEConfig, kw: dict) -> None:
    chans = [cfg.channels] + [cfg.hidden_dim] * cfg.num_layers
    m.enc_convs = nn.ModuleList(
        nn.Conv2d(cin, cout, 4, **kw)
        for cin, cout in zip(chans[:-1], chans[1:]))
    m.enc_res = nn.ModuleList(
        ResBlock(chans[-1], **kw) for _ in range(cfg.num_resnet_blocks))
    m.enc_out = nn.Conv2d(chans[-1], cfg.num_tokens, 1, **kw)


def _build_decoder(m: nn.Module, cfg: VAEConfig, kw: dict) -> None:
    n = cfg.num_layers
    m.codebook = nn.Embedding(cfg.num_tokens, cfg.codebook_dim, **kw)
    has_res = cfg.num_resnet_blocks > 0
    dec_chans = [cfg.hidden_dim] * n
    dec_in = dec_chans[0] if has_res else cfg.codebook_dim
    m.dec_stem = (nn.Conv2d(cfg.codebook_dim, dec_chans[0], 1, **kw)
                  if has_res else None)
    m.dec_res = nn.ModuleList(
        ResBlock(dec_chans[0], **kw) for _ in range(cfg.num_resnet_blocks))
    m.dec_convs = nn.ModuleList(
        nn.ConvTranspose2d(cin, cout, 4, **kw)
        for cin, cout in zip([dec_in] + dec_chans[:-1], dec_chans))
    m.dec_out = nn.Conv2d(dec_chans[-1], cfg.channels, 1, **kw)


def _resblock(p: ResBlock, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(core.conv2d(p.c1, x, padding=1))
    h = torch.relu(core.conv2d(p.c2, h, padding=1))
    return core.conv2d(p.c3, h) + x


def encode_logits(enc: VAEEncoder, images: torch.Tensor) -> torch.Tensor:
    """images (b, H, W, C) in [-1, 1] -> logits (b, h, w, num_tokens)."""
    x = images.permute(0, 3, 1, 2)
    for p in enc.enc_convs:
        x = torch.relu(core.conv2d(p, x, stride=2, padding=1))
    for p in enc.enc_res:
        x = _resblock(p, x)
    return core.conv2d(enc.enc_out, x).permute(0, 2, 3, 1)


@torch.no_grad()
def get_codebook_indices(enc: VAEEncoder,
                         images: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) -> (b, image_seq_len) token ids (int64, the index
    dtype of torch; JAX returns int32), argmax over the token axis,
    row-major over the (h, w) grid. No gradient flows (argmax)."""
    logits = encode_logits(enc, images)
    b, h, w, _ = logits.shape
    return logits.argmax(dim=-1).reshape(b, h * w)


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


def gumbel_softmax(key: torch.Tensor, logits: torch.Tensor, tau: float,
                   straight_through: bool = False) -> torch.Tensor:
    """Relaxed one-hot over the last (token) axis: softmax((logits + g) /
    tau) with Gumbel noise g drawn under ``key`` in the logits' dtype
    (``prng.gumbel``, JAX's draw). Straight-through adds
    ``one_hot(argmax) - soft`` with no gradient."""
    g = prng.gumbel(key, logits.shape, logits.dtype,
                    prng.row_offset(logits.shape))
    # tau divides in the logits' dtype, as JAX's weakly typed scalar does
    tau = torch.full((), tau, dtype=logits.dtype, device=logits.device)
    soft = torch.softmax((logits + g) / tau, dim=-1)
    if straight_through:
        hard = torch.nn.functional.one_hot(
            soft.argmax(dim=-1), logits.shape[-1]).to(soft.dtype)
        soft = soft + (hard - soft).detach()
    return soft


def vae_apply(vae: "DiscreteVAE", images: torch.Tensor, *, cfg: VAEConfig,
              rng: Optional[torch.Tensor] = None,
              temperature: Optional[float] = None,
              return_logits: bool = False,
              return_recon_loss: bool = False):
    """Forward (reference ``DiscreteVAE.forward``): images (b, H, W, C)
    -> logits -> Gumbel-softmax under ``rng`` at ``temperature`` (by
    default ``cfg.temperature``) -> codebook mix, one (b*h*w, T) @ (T, d)
    product -> decoder. Returns the reconstruction, the logits with
    ``return_logits``, or the mean squared error with
    ``return_recon_loss``."""
    logits = encode_logits(vae, images)
    if return_logits:
        return logits
    if rng is None:
        raise ValueError("vae_apply needs an explicit PRNG key for the "
                         "Gumbel noise")
    tau = cfg.temperature if temperature is None else temperature
    soft = gumbel_softmax(rng, logits, tau, cfg.straight_through)
    b, h, w, t = soft.shape
    embeds = soft.reshape(b * h * w, t) @ vae.codebook.weight.to(soft.dtype)
    recon = decode_embeds(vae, embeds.reshape(b, h, w, -1))
    if not return_recon_loss:
        return recon
    return (images - recon).square().mean()


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


def discrete_vae_init(cfg: VAEConfig, seed: int = 0, *,
                      dtype=torch.float32, device=None) -> DiscreteVAE:
    """A seeded random whole VAE on ``device`` (the card by default)."""
    device = resolve_device(device)
    vae = DiscreteVAE(cfg, device=device, dtype=dtype)
    core.init_params_(vae, generator(seed, device))
    return vae


def vae_encoder_init(cfg: VAEConfig, seed: int = 0, *,
                     dtype=torch.float32, device=None) -> VAEEncoder:
    """A seeded random encoder on ``device`` (the card by default)."""
    device = resolve_device(device)
    enc = VAEEncoder(cfg, device=device, dtype=dtype)
    core.init_params_(enc, generator(seed, device))
    return enc
