"""CLIP: the dual-encoder contrastive model, and the rerank of generation.

Port of ``dalle_pytorch_tpu/models/clip.py`` (``:37-186``): a text
transformer and a ViT-style patch transformer, each pooled and projected
to an L2-normalised latent, a learned temperature stored before the exp,
the paired scores at inference and the one-directional (text -> image)
InfoNCE loss, which ``parallel/train.py::clip_loss_fn`` trains on.

Both encoders are non-causal, dim_head 64, and by default block-sparse in
the bidirectional layout in every layer (``sparse_attn=True``, the
reference Transformer's default): with ``sparse_impl='pallas'`` each
layer runs kernel K3 with ``causal=False`` (``ops/block_sparse.py``),
the text encoder with its key-padding mask, padded to ``sparse_block``
by ``ops/transformer.py::sparse_fn``. Text pooling is a mask-weighted
mean when a mask is given, a plain mean otherwise; images are NHWC and
the patches keep the reference's (p1, p2, c) feature order, so weights
cross over from JAX (``compat/from_jax.py::clip_from_jax``) as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from dalle_pytorch_tpu_torch.device import generator, resolve_device
from dalle_pytorch_tpu_torch.ops import core
from dalle_pytorch_tpu_torch.ops import transformer as T


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    dim_text: int = 512
    dim_image: int = 512
    dim_latent: int = 512
    num_text_tokens: int = 10000
    text_enc_depth: int = 6
    text_seq_len: int = 256
    text_heads: int = 8
    num_visual_tokens: int = 512
    visual_enc_depth: int = 6
    visual_heads: int = 8
    visual_image_size: int = 256
    visual_patch_size: int = 32
    channels: int = 3
    sparse_attn: bool = True     # the reference Transformer default
    sparse_block: int = 16
    sparse_impl: str = "ref"

    def __post_init__(self):
        if self.visual_image_size % self.visual_patch_size != 0:
            raise ValueError(
                "image dimensions must be divisible by the patch size")

    @property
    def num_patches(self) -> int:
        return (self.visual_image_size // self.visual_patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.visual_patch_size ** 2

    def _enc(self, dim, depth, heads, seq_len) -> T.TransformerConfig:
        return T.TransformerConfig(
            dim=dim, depth=depth, seq_len=seq_len, heads=heads, dim_head=64,
            causal=False, sparse_attn=self.sparse_attn,
            sparse_block=self.sparse_block, sparse_impl=self.sparse_impl)

    @property
    def text_transformer(self) -> T.TransformerConfig:
        return self._enc(self.dim_text, self.text_enc_depth, self.text_heads,
                         self.text_seq_len)

    @property
    def visual_transformer(self) -> T.TransformerConfig:
        return self._enc(self.dim_image, self.visual_enc_depth,
                         self.visual_heads, self.num_patches)


class CLIP(nn.Module):
    """Parameters of the JAX ``clip_init`` tree, as modules, and the JAX
    facade (``models/clip.py:167-186``): ``forward`` is ``clip_apply``.

    ``CLIP(cfg, device=, dtype=)`` builds the parameters uninitialised
    (``clip_init`` and ``compat/from_jax.py`` fill them);
    ``CLIP(**cfg_kwargs, params=, seed=, dtype=, device=)`` takes the
    config from the keywords and the weights from ``params`` (a JAX
    ``clip_init`` tree as numpy arrays) or seeds them, on the card unless
    ``device`` says otherwise."""

    def __init__(self, cfg: Optional[CLIPConfig] = None, *, device=None,
                 dtype=None, params=None, seed: Optional[int] = None,
                 **cfg_kwargs):
        facade = cfg is None
        if facade:
            cfg = CLIPConfig(**cfg_kwargs)
            device = resolve_device(device)
            dtype = dtype or torch.float32
        elif cfg_kwargs or params is not None or seed is not None:
            raise TypeError("CLIP takes a CLIPConfig or the reference's "
                            "keywords, not both")
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.text_emb = nn.Embedding(cfg.num_text_tokens, cfg.dim_text, **kw)
        self.text_pos_emb = nn.Embedding(cfg.text_seq_len, cfg.dim_text, **kw)
        self.text_transformer = T.Transformer(cfg.text_transformer, **kw)
        self.to_text_latent = nn.Linear(cfg.dim_text, cfg.dim_latent,
                                        bias=False, **kw)
        self.to_visual_emb = nn.Linear(cfg.patch_dim, cfg.dim_image, **kw)
        self.visual_pos_emb = nn.Embedding(cfg.num_patches, cfg.dim_image,
                                           **kw)
        self.visual_transformer = T.Transformer(cfg.visual_transformer, **kw)
        self.to_visual_latent = nn.Linear(cfg.dim_image, cfg.dim_latent,
                                          bias=False, **kw)
        # stored before the exp, 1.0 at init (reference :195, :228)
        self.temperature = nn.Parameter(torch.ones((), **kw))
        if facade:
            if params is None:
                core.init_params_(self, generator(seed or 0, device))
            else:
                from dalle_pytorch_tpu_torch.compat import from_jax
                from_jax.fill_clip(self, params)

    @property
    def config(self) -> CLIPConfig:
        return self.cfg

    def forward(self, text: torch.Tensor, images: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None,
                return_loss: bool = False) -> torch.Tensor:
        return clip_apply(self, text, images, text_mask=text_mask,
                          return_loss=return_loss)


def clip_init(cfg: CLIPConfig, seed: int = 0, *, dtype=torch.float32,
              device=None) -> CLIP:
    """A seeded random CLIP on ``device`` (the card by default)."""
    device = resolve_device(device)
    model = CLIP(cfg, device=device, dtype=dtype)
    core.init_params_(model, generator(seed, device))
    return model


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(b, H, W, C) -> (b, num_patches, p * p * C) in the (p1, p2, c)
    feature order."""
    b, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(b, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)              # b, gh, gw, p1, p2, c
    return x.reshape(b, gh * gw, patch * patch * C)


def masked_mean(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over axis 1 of the rows where ``mask`` is True."""
    t = torch.where(mask[:, :, None], t, torch.zeros((), dtype=t.dtype,
                                                     device=t.device))
    return t.sum(dim=1) / mask.sum(dim=1)[:, None]


def _normalize(lat: torch.Tensor) -> torch.Tensor:
    return lat / torch.linalg.vector_norm(lat, dim=-1, keepdim=True)


def encode_text(model: CLIP, text: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, t) token ids (and a (b, t) pad mask) -> (b, dim_latent)."""
    cfg = model.cfg
    x = (model.text_emb.weight[text]
         + model.text_pos_emb.weight[None, :text.shape[1]])
    enc = T.transformer_apply(model.text_transformer, x,
                              cfg=cfg.text_transformer, mask=mask)
    pooled = masked_mean(enc, mask.bool()) if mask is not None \
        else enc.mean(dim=1)
    return _normalize(core.linear(model.to_text_latent, pooled))


def encode_image(model: CLIP, images: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) images -> (b, dim_latent)."""
    cfg = model.cfg
    patches = patchify(images, cfg.visual_patch_size)
    x = core.linear(model.to_visual_emb, patches) \
        + model.visual_pos_emb.weight[None]
    enc = T.transformer_apply(model.visual_transformer, x,
                              cfg=cfg.visual_transformer)
    return _normalize(core.linear(model.to_visual_latent, enc.mean(dim=1)))


def clip_apply(model: CLIP, text: torch.Tensor, images: torch.Tensor, *,
               text_mask: Optional[torch.Tensor] = None,
               return_loss: bool = False) -> torch.Tensor:
    """Paired similarity scores (b,) or, with ``return_loss``, the
    one-directional InfoNCE loss over the in-batch similarity matrix
    (its log-softmax in float32)."""
    tl = encode_text(model, text, text_mask)
    il = encode_image(model, images)
    if not return_loss:
        return torch.einsum("nd,nd->n", tl, il) * torch.exp(
            model.temperature)
    return info_nce(model, tl, il)


def info_nce(model: CLIP, text_latents: torch.Tensor,
             image_latents: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The one-directional InfoNCE loss of text rows against image
    columns, text row ``i`` paired with image ``offset + i`` (a rank's
    rows against every rank's images under dp), over the similarity
    matrix's log-softmax in float32."""
    sim = torch.einsum("id,jd->ij", text_latents, image_latents) * torch.exp(
        model.temperature)
    logp = torch.log_softmax(sim.float(), dim=-1)
    rows = torch.arange(text_latents.shape[0], device=text_latents.device)
    return -logp[rows, offset + rows].mean()
