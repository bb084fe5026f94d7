"""Weight bridge back: the port's modules -> the JAX package's trees.

The inverse of ``compat/from_jax.py``, conversion for conversion:

* ``nn.Linear.weight (out, in)`` -> ``w (in, out)``;
* one ``Layer`` module per layer -> the transformer's stacked depth
  axis; a MoE layer's router -> ``ff["moe"]["router"]["w"]``, its
  expert stacks ``w1``, ``w2`` as they are;
* ``nn.Conv2d`` OIHW -> HWIO, ``nn.ConvTranspose2d`` IOHW -> HWIO;
* DALLE's ``image_emb`` is its own table (the tied codebook).

``tree(model)`` is the tree ``vae_init`` / ``dalle_init`` /
``clip_init`` would hold for the same weights (a reversible DALLE's is
the sequential one's: the two streams share the stack), with its dict
keys sorted as ``jax.tree_util`` keeps them. Leaves are contiguous CPU
tensors in the parameters' dtypes, bfloat16 included, ready for
``compat/msgpack.py``. ``tree(model, values)`` lays out other tensors
keyed by parameter name the same way (Adam's moments, an EMA), and
``named(model, tree)`` reads such a tree back to ``{name: tensor}``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
from torch import nn

from dalle_pytorch_tpu_torch.compat import from_jax, msgpack
from dalle_pytorch_tpu_torch.models import clip as clip_mod
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as vae_mod
from dalle_pytorch_tpu_torch.ops import transformer as T

Get = Callable[[torch.Tensor], torch.Tensor]


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def _linear(m: nn.Linear, get: Get) -> dict:
    out = {"w": _cpu(get(m.weight).T)}
    if m.bias is not None:
        out["b"] = _cpu(get(m.bias))
    return out


def _layernorm(m: nn.LayerNorm, get: Get) -> dict:
    return {"b": _cpu(get(m.bias)), "g": _cpu(get(m.weight))}


def _conv(m: nn.Conv2d, get: Get) -> dict:
    return {"b": _cpu(get(m.bias)),
            "w": _cpu(get(m.weight).permute(2, 3, 1, 0))}      # OIHW->HWIO


def _conv_transpose(m: nn.ConvTranspose2d, get: Get) -> dict:
    return {"b": _cpu(get(m.bias)),
            "w": _cpu(get(m.weight).permute(2, 3, 0, 1))}      # IOHW->HWIO


def _table(m: nn.Embedding, get: Get) -> dict:
    return {"w": _cpu(get(m.weight))}


def _resblocks(ms: nn.ModuleList, get: Get) -> list:
    return [{"c1": _conv(m.c1, get), "c2": _conv(m.c2, get),
             "c3": _conv(m.c3, get)} for m in ms]


def _encoder(m: nn.Module, get: Get) -> dict:
    return {"enc_convs": [_conv(c, get) for c in m.enc_convs],
            "enc_out": _conv(m.enc_out, get),
            "enc_res": _resblocks(m.enc_res, get)}


def _decoder(m: nn.Module, get: Get) -> dict:
    out = {"codebook": _table(m.codebook, get),
           "dec_convs": [_conv_transpose(c, get) for c in m.dec_convs],
           "dec_out": _conv(m.dec_out, get),
           "dec_res": _resblocks(m.dec_res, get)}
    if m.dec_stem is not None:
        out["dec_stem"] = _conv(m.dec_stem, get)
    return out


def _stack(trees: list):
    """Per-layer trees -> one tree with a leading depth axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _transformer(model: T.Transformer, get: Get) -> dict:
    layers = []
    for layer in model.layers:
        ff = {"ln": _layernorm(layer.ff.ln, get)}
        if hasattr(layer.ff, "moe"):
            moe = layer.ff.moe
            ff["moe"] = {"router": _linear(moe.router, get),
                         "w1": _cpu(get(moe.w1)), "w2": _cpu(get(moe.w2))}
        else:
            ff["w1"] = _linear(layer.ff.w1, get)
            ff["w2"] = _linear(layer.ff.w2, get)
        layers.append({"attn": {"ln": _layernorm(layer.attn.ln, get),
                                "out": _linear(layer.attn.out, get),
                                "qkv": _linear(layer.attn.qkv, get)},
                       "ff": ff})
    return _stack(layers)


def _dalle(model: D.DALLE, get: Get) -> dict:
    return {"image_emb": _table(model.image_emb, get),
            "image_pos_emb": {"cols": _cpu(get(model.image_pos_cols.weight)),
                              "rows": _cpu(get(model.image_pos_rows.weight))},
            "text_emb": _table(model.text_emb, get),
            "text_pos_emb": _table(model.text_pos_emb, get),
            "to_logits": {"ln": _layernorm(model.logits_ln, get),
                          "proj": _linear(model.logits_proj, get)},
            "transformer": _transformer(model.transformer, get)}


def _clip(model: clip_mod.CLIP, get: Get) -> dict:
    return {"temperature": _cpu(get(model.temperature)),
            "text_emb": _table(model.text_emb, get),
            "text_pos_emb": _table(model.text_pos_emb, get),
            "text_transformer": _transformer(model.text_transformer, get),
            "to_text_latent": _linear(model.to_text_latent, get),
            "to_visual_emb": _linear(model.to_visual_emb, get),
            "to_visual_latent": _linear(model.to_visual_latent, get),
            "visual_pos_emb": _table(model.visual_pos_emb, get),
            "visual_transformer": _transformer(model.visual_transformer,
                                               get)}


def tree(model: nn.Module, values: Optional[Mapping] = None) -> dict:
    """The JAX parameter tree of ``model`` (a ``DiscreteVAE``,
    ``VAEDecoder``, ``VAEEncoder``, ``DALLE`` or ``CLIP``): its own
    parameters, or ``values[name]`` for each parameter ``name`` of
    ``model.named_parameters()``."""
    if values is None:
        get = lambda p: p                                   # noqa: E731
    else:
        names = {id(p): n for n, p in model.named_parameters()}
        get = lambda p: values[names[id(p)]]               # noqa: E731
    if isinstance(model, D.DALLE):
        out = _dalle(model, get)
    elif isinstance(model, clip_mod.CLIP):
        out = _clip(model, get)
    elif isinstance(model, vae_mod.DiscreteVAE):
        out = {**_encoder(model, get), **_decoder(model, get)}
    elif isinstance(model, vae_mod.VAEDecoder):
        out = _decoder(model, get)
    elif isinstance(model, vae_mod.VAEEncoder):
        out = _encoder(model, get)
    else:
        raise TypeError(f"no JAX tree for {type(model).__name__}")
    return msgpack.sorted_tree(out)


def module(tree_: Mapping, like: nn.Module, *, dtype=None,
           device="cpu") -> nn.Module:
    """A module of ``like``'s kind and config holding ``tree_``'s
    weights (``compat/from_jax.py``)."""
    kw = dict(dtype=dtype, device=device)
    if isinstance(like, D.DALLE):
        return from_jax.dalle_from_jax(tree_, like.cfg, **kw)
    if isinstance(like, clip_mod.CLIP):
        return from_jax.clip_from_jax(tree_, like.cfg, **kw)
    if isinstance(like, vae_mod.DiscreteVAE):
        return from_jax.discrete_vae_from_jax(tree_, like.cfg, **kw)
    raise TypeError(f"no JAX tree for {type(like).__name__}")


def named(model: nn.Module, tree_: Mapping, *,
          dtype=None) -> dict:
    """``{parameter name of model: tensor}`` from a tree laid out as
    ``tree(model)`` (CPU tensors in the tree's dtype, or ``dtype``)."""
    twin = module(tree_, model, dtype=dtype)
    return {n: p.detach() for n, p in twin.named_parameters()}
