"""Weight bridge: the JAX package's parameter trees -> the port's modules.

The input is the tree ``dalle_pytorch_tpu.models.dalle.dalle_init`` /
``models.vae.vae_init`` / ``models.clip.clip_init`` produce (or a
checkpoint restores), as nested
dicts and lists of numpy arrays (``jax.device_get`` of the pytree;
bfloat16 leaves arrive as ml_dtypes arrays). The conversions, each exact:

* linear ``w (in, out)`` -> ``nn.Linear.weight (out, in)``;
* the transformer's stacked depth axis -> one ``Layer`` module per layer;
  a MoE layer's ``ff["moe"]`` subtree -> ``ops/moe.py::MoE``: the router
  as a linear, the expert stacks ``w1`` (E, d, 2h) and ``w2`` (E, h, d)
  as they are;
* conv HWIO -> ``nn.Conv2d`` OIHW;
* transposed conv HWIO -> ``nn.ConvTranspose2d`` IOHW with no spatial flip
  (the JAX op is the flipped-kernel dilated convolution, which is
  exactly torch's transposed convolution over the unflipped kernel —
  the same reasoning as ``compat/torch_export.py``);
* ``image_emb`` stays DALLE's own table: it is the tied codebook, and
  the serving path decodes images with it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from dalle_pytorch_tpu_torch.device import resolve_device
from dalle_pytorch_tpu_torch.models import clip as clip_mod
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as vae_mod
from dalle_pytorch_tpu_torch.ops import transformer as T


def to_tensor(a) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) or a tensor (the bfloat16
    leaves ``compat/msgpack.py`` restores) -> tensor, bit-exact."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _set(param: torch.Tensor, value) -> None:
    value = value if isinstance(value, torch.Tensor) else to_tensor(value)
    if value.shape != param.shape:
        raise ValueError(f"shape {tuple(value.shape)} does not fit "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def _linear(m: nn.Linear, p: Mapping) -> None:
    _set(m.weight, to_tensor(p["w"]).T)
    if m.bias is not None:
        _set(m.bias, p["b"])


def _layernorm(m: nn.LayerNorm, p: Mapping) -> None:
    _set(m.weight, p["g"])
    _set(m.bias, p["b"])


def _conv(m: nn.Conv2d, p: Mapping) -> None:
    _set(m.weight, to_tensor(p["w"]).permute(3, 2, 0, 1))      # HWIO->OIHW
    _set(m.bias, p["b"])


def _conv_transpose(m: nn.ConvTranspose2d, p: Mapping) -> None:
    _set(m.weight, to_tensor(p["w"]).permute(2, 3, 0, 1))      # HWIO->IOHW
    _set(m.bias, p["b"])


def _dtype_of(tree: Mapping, *path) -> torch.dtype:
    leaf = tree
    for k in path:
        leaf = leaf[k]
    return to_tensor(leaf).dtype


def _resblocks(ms: nn.ModuleList, ps) -> None:
    for m, p in zip(ms, ps, strict=True):
        _conv(m.c1, p["c1"])
        _conv(m.c2, p["c2"])
        _conv(m.c3, p["c3"])


def _decoder(vae: nn.Module, params: Mapping) -> None:
    _set(vae.codebook.weight, params["codebook"]["w"])
    if vae.dec_stem is not None:
        _conv(vae.dec_stem, params["dec_stem"])
    _resblocks(vae.dec_res, params["dec_res"])
    for m, p in zip(vae.dec_convs, params["dec_convs"], strict=True):
        _conv_transpose(m, p)
    _conv(vae.dec_out, params["dec_out"])


def _encoder(enc: nn.Module, params: Mapping) -> None:
    for m, p in zip(enc.enc_convs, params["enc_convs"], strict=True):
        _conv(m, p)
    _resblocks(enc.enc_res, params["enc_res"])
    _conv(enc.enc_out, params["enc_out"])


@torch.no_grad()
def discrete_vae_from_jax(params: Mapping, cfg: vae_mod.VAEConfig, *,
                          dtype=None, device=None) -> vae_mod.DiscreteVAE:
    """A whole JAX VAE tree (``vae_init``) into the port's
    ``DiscreteVAE``."""
    device = resolve_device(device)
    dtype = dtype or _dtype_of(params, "codebook", "w")
    vae = vae_mod.DiscreteVAE(cfg, device=device, dtype=dtype)
    fill_discrete_vae(vae, params)
    return vae


@torch.no_grad()
def fill_discrete_vae(vae: nn.Module, params: Mapping) -> None:
    """A whole JAX VAE tree into a built ``DiscreteVAE``, in place."""
    _encoder(vae, params)
    _decoder(vae, params)


@torch.no_grad()
def vae_from_jax(params: Mapping, cfg: vae_mod.VAEConfig, *,
                 dtype=None, device=None) -> vae_mod.VAEDecoder:
    """The decoder half of a JAX VAE tree (encoder leaves are ignored)."""
    device = resolve_device(device)
    dtype = dtype or _dtype_of(params, "codebook", "w")
    vae = vae_mod.VAEDecoder(cfg, device=device, dtype=dtype)
    _decoder(vae, params)
    return vae


@torch.no_grad()
def vae_encoder_from_jax(params: Mapping, cfg: vae_mod.VAEConfig, *,
                         dtype=None, device=None) -> vae_mod.VAEEncoder:
    """The encoder half of a JAX VAE tree (decoder leaves are ignored)."""
    device = resolve_device(device)
    dtype = dtype or _dtype_of(params, "enc_out", "w")
    enc = vae_mod.VAEEncoder(cfg, device=device, dtype=dtype)
    _encoder(enc, params)
    return enc


@torch.no_grad()
def dalle_from_jax(params: Mapping, cfg: D.DALLEConfig, *,
                   dtype=None, device=None) -> D.DALLE:
    device = resolve_device(device)
    dtype = dtype or _dtype_of(params, "text_emb", "w")
    model = D.DALLE(cfg, device=device, dtype=dtype)
    fill_dalle(model, params)
    return model


@torch.no_grad()
def fill_dalle(model: D.DALLE, params: Mapping) -> None:
    """A JAX DALLE tree into a built ``DALLE``, in place."""
    _set(model.text_emb.weight, params["text_emb"]["w"])
    _set(model.image_emb.weight, params["image_emb"]["w"])
    _set(model.text_pos_emb.weight, params["text_pos_emb"]["w"])
    _set(model.image_pos_rows.weight, params["image_pos_emb"]["rows"])
    _set(model.image_pos_cols.weight, params["image_pos_emb"]["cols"])
    _transformer(model.transformer, params["transformer"])
    _layernorm(model.logits_ln, params["to_logits"]["ln"])
    _linear(model.logits_proj, params["to_logits"]["proj"])


@torch.no_grad()
def transformer_from_jax(stack: Mapping, cfg: T.TransformerConfig, *,
                         dtype=None, device=None) -> T.Transformer:
    """A bare depth-stacked JAX transformer tree (``transformer_init``)
    into the port's ``Transformer``."""
    device = resolve_device(device)
    dtype = dtype or to_tensor(stack["attn"]["ln"]["g"]).dtype
    model = T.Transformer(cfg, device=device, dtype=dtype)
    _transformer(model, stack)
    return model


def _transformer(model: T.Transformer, stack: Mapping) -> None:
    """A depth-stacked JAX transformer tree into one module per layer."""
    depth = to_tensor(stack["attn"]["ln"]["g"]).shape[0]
    if depth != len(model.layers):
        raise ValueError(f"the tree stacks {depth} layers, the model has "
                         f"{len(model.layers)}")
    at, ff = stack["attn"], stack["ff"]
    for i, layer in enumerate(model.layers):
        _layernorm(layer.attn.ln, {k: v[i] for k, v in at["ln"].items()})
        _linear(layer.attn.qkv, {k: v[i] for k, v in at["qkv"].items()})
        _linear(layer.attn.out, {k: v[i] for k, v in at["out"].items()})
        _layernorm(layer.ff.ln, {k: v[i] for k, v in ff["ln"].items()})
        if "moe" in ff:
            moe = ff["moe"]
            _linear(layer.ff.moe.router,
                    {k: v[i] for k, v in moe["router"].items()})
            _set(layer.ff.moe.w1, to_tensor(moe["w1"][i]))
            _set(layer.ff.moe.w2, to_tensor(moe["w2"][i]))
            continue
        _linear(layer.ff.w1, {k: v[i] for k, v in ff["w1"].items()})
        _linear(layer.ff.w2, {k: v[i] for k, v in ff["w2"].items()})


@torch.no_grad()
def clip_from_jax(params: Mapping, cfg: clip_mod.CLIPConfig, *,
                  dtype=None, device=None) -> clip_mod.CLIP:
    """A JAX CLIP tree (``clip_init``) into the port's ``CLIP``."""
    device = resolve_device(device)
    dtype = dtype or _dtype_of(params, "text_emb", "w")
    model = clip_mod.CLIP(cfg, device=device, dtype=dtype)
    fill_clip(model, params)
    return model


@torch.no_grad()
def fill_clip(model: clip_mod.CLIP, params: Mapping) -> None:
    """A JAX CLIP tree into a built ``CLIP``, in place."""
    _set(model.text_emb.weight, params["text_emb"]["w"])
    _set(model.text_pos_emb.weight, params["text_pos_emb"]["w"])
    _transformer(model.text_transformer, params["text_transformer"])
    _linear(model.to_text_latent, params["to_text_latent"])
    _linear(model.to_visual_emb, params["to_visual_emb"])
    _set(model.visual_pos_emb.weight, params["visual_pos_emb"]["w"])
    _transformer(model.visual_transformer, params["visual_transformer"])
    _linear(model.to_visual_latent, params["to_visual_latent"])
    _set(model.temperature, params["temperature"])
