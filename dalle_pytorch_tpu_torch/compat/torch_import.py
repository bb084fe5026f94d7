"""Import reference DALLE-pytorch ``.pth`` state dicts.

Port of ``dalle_pytorch_tpu/compat/torch_import.py``: the reference
trains with ``torch.save(model.state_dict(), path)`` (reference
trainVAE.py:119, trainDALLE.py:212), and this module maps its parameter
names and torch layouts onto the JAX-layout trees both packages share
(``compat/from_jax.py`` builds the port's modules from them,
``checkpoint.py`` writes them):

* ``nn.Linear`` weight ``(out, in)`` -> ``w (in, out)``;
* ``nn.Conv2d`` weight ``(O, I, kh, kw)`` -> HWIO ``(kh, kw, I, O)``;
* ``nn.ConvTranspose2d`` weight ``(I, O, kh, kw)`` -> HWIO;
* ``nn.LayerNorm`` weight/bias -> ``g``/``b``;
* the per-layer transformer modules (``layers.layers.{i}.{0,1}``, or
  ``layers.blocks.{i}.{f,g}.net`` from a ``reversible=True`` save) -> the
  stacked depth-major arrays (``_resolve_layer_prefixes``);
* the summed axial image position embedding (``image_pos_emb.weights.
  {0,1}``) -> ``rows``/``cols`` (``_axial_tables``; build the DALLEConfig
  with ``axial_compat='full_image'``).

The trees hold float32 numpy leaves and equal the JAX functions' leaf
for leaf; the config kwargs are inferred from the state dict as JAX
infers them (``_transformer_dims``, ``_dim_head_for``). Only the VAE's
``image_size`` and DALLE's head count cannot be inferred.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# loading + layout primitives
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.pth`` state dict (or a whole saved module's) into plain
    numpy, through ``torch.load(weights_only=True)`` only."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):     # a whole module was saved
        obj = obj.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def _np(sd: Dict[str, np.ndarray], key: str) -> np.ndarray:
    if key not in sd:
        raise KeyError(f"state dict is missing {key!r} — not a reference-"
                       "layout checkpoint?")
    return np.asarray(sd[key], np.float32)


def _linear(sd, prefix: str, bias: bool = True) -> dict:
    p = {"w": _np(sd, prefix + ".weight").T}
    if bias:
        p["b"] = _np(sd, prefix + ".bias")
    return p


def _layernorm(sd, prefix: str) -> dict:
    return {"g": _np(sd, prefix + ".weight"), "b": _np(sd, prefix + ".bias")}


def _conv(sd, prefix: str) -> dict:
    return {"w": _np(sd, prefix + ".weight").transpose(2, 3, 1, 0),
            "b": _np(sd, prefix + ".bias")}


def _conv_transpose(sd, prefix: str) -> dict:
    return {"w": _np(sd, prefix + ".weight").transpose(2, 3, 0, 1),
            "b": _np(sd, prefix + ".bias")}


def _sub(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    pl = len(prefix)
    return {k[pl:]: v for k, v in sd.items() if k.startswith(prefix)}


def _index_count(sd, pattern: str) -> int:
    idx = {int(m.group(1)) for k in sd
           if (m := re.match(pattern, k)) is not None}
    return max(idx) + 1 if idx else 0


def _stack(trees: list):
    """Nested dicts of arrays -> one dict of arrays stacked on a new
    leading axis (``jax.tree.map(np.stack)`` over the layers)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


# ---------------------------------------------------------------------------
# transformer stack
# ---------------------------------------------------------------------------

def _resolve_layer_prefixes(sd, i: int) -> Tuple[str, str]:
    """(attn module prefix, ff module prefix) of layer i under either
    execution engine's naming."""
    seq = f"layers.layers.{i}."
    rev = f"layers.blocks.{i}."
    if any(k.startswith(seq) for k in sd):
        return seq + "0.", seq + "1."
    if any(k.startswith(rev) for k in sd):
        # reversible blocks wrap each branch in Deterministic(.net)
        return rev + "f.net.", rev + "g.net."
    raise KeyError(f"no transformer layer {i} found (checked {seq!r} and "
                   f"{rev!r})")


def _depth(sd) -> int:
    return max(_index_count(sd, r"layers\.layers\.(\d+)\."),
               _index_count(sd, r"layers\.blocks\.(\d+)\."))


def import_transformer(sd: Dict[str, np.ndarray]) -> dict:
    """Transformer params stacked depth-major, from keys relative to the
    reference ``Transformer`` module."""
    depth = _depth(sd)
    if depth == 0:
        raise KeyError("no transformer layers in state dict")
    layers = []
    for i in range(depth):
        attn_p, ff_p = _resolve_layer_prefixes(sd, i)
        layers.append({
            "attn": {
                "ln": _layernorm(sd, attn_p + "norm"),
                "qkv": _linear(sd, attn_p + "fn.to_qkv", bias=False),
                "out": _linear(sd, attn_p + "fn.to_out.0"),
            },
            "ff": {
                "ln": _layernorm(sd, ff_p + "norm"),
                "w1": _linear(sd, ff_p + "fn.net.0"),
                "w2": _linear(sd, ff_p + "fn.net.3"),
            },
        })
    return _stack(layers)


def _transformer_dims(sd) -> Tuple[int, int, int]:
    """(depth, dim, inner_dim) from a transformer-relative state dict."""
    attn_p, _ = _resolve_layer_prefixes(sd, 0)
    qkv = _np(sd, attn_p + "fn.to_qkv.weight")      # (3*inner, dim)
    return _depth(sd), qkv.shape[1], qkv.shape[0] // 3


# ---------------------------------------------------------------------------
# DiscreteVAE
# ---------------------------------------------------------------------------

def _import_resblock(sd, prefix: str) -> dict:
    # ResBlock.net = Conv3x3, ReLU, Conv3x3, ReLU, Conv1x1
    return {"c1": _conv(sd, prefix + "net.0"),
            "c2": _conv(sd, prefix + "net.2"),
            "c3": _conv(sd, prefix + "net.4")}


def import_vae(sd: Dict[str, np.ndarray],
               image_size: int = 256) -> Tuple[dict, dict]:
    """-> (params, config_kwargs). The encoder is L stride-2 convs, R
    resblocks and a 1x1 head; the decoder [a 1x1 stem when R > 0,] R
    resblocks, L transposed convs and a 1x1 head."""
    L = _index_count(sd, r"encoder\.(\d+)\.0\.weight")
    R = sum(1 for k in sd if re.match(r"encoder\.\d+\.net\.0\.weight", k))

    codebook = _np(sd, "codebook.weight")
    params: dict = {"codebook": {"w": codebook}}
    params["enc_convs"] = [_conv(sd, f"encoder.{i}.0") for i in range(L)]
    params["enc_res"] = [_import_resblock(sd, f"encoder.{L + r}.")
                         for r in range(R)]
    params["enc_out"] = _conv(sd, f"encoder.{L + R}")

    off = 0
    if R > 0:
        params["dec_stem"] = _conv(sd, "decoder.0")
        off = 1
    params["dec_res"] = [_import_resblock(sd, f"decoder.{off + r}.")
                         for r in range(R)]
    params["dec_convs"] = [_conv_transpose(sd, f"decoder.{off + R + i}.0")
                           for i in range(L)]
    params["dec_out"] = _conv(sd, f"decoder.{off + R + L}")

    cfg = {
        "image_size": image_size,
        "num_tokens": codebook.shape[0],
        "codebook_dim": codebook.shape[1],
        "num_layers": L,
        "num_resnet_blocks": R,
        "hidden_dim": params["enc_convs"][0]["w"].shape[-1],
        "channels": params["enc_convs"][0]["w"].shape[-2],
    }
    return params, cfg


# ---------------------------------------------------------------------------
# DALLE
# ---------------------------------------------------------------------------

def _axial_tables(sd, prefix: str) -> dict:
    """The summed-mode axial ParameterList -> rows/cols: weights.{i}
    carries axial_shape[i] on axis i+1 with singleton other axes."""
    tables = []
    i = 0
    while f"{prefix}weights.{i}" in sd:
        w = _np(sd, f"{prefix}weights.{i}")
        tables.append(w.reshape(-1, w.shape[-1]))   # squeeze singletons
        i += 1
    if len(tables) != 2:
        raise KeyError(
            f"expected 2 axial tables under {prefix}weights.*, got "
            f"{len(tables)} (concat-mode axial embeddings are not used by "
            "the reference)")
    return {"rows": tables[0], "cols": tables[1]}


def _dim_head_for(inner: int, heads: int) -> int:
    if inner % heads:
        raise ValueError(
            f"heads={heads} does not divide the checkpoint's attention "
            f"inner dim {inner}; pass the head count the checkpoint was "
            "trained with")
    return inner // heads


def import_dalle(sd: Dict[str, np.ndarray], image_size: int = 256,
                 heads: int = 8):
    """-> (dalle_params, vae_params, dalle_cfg_kwargs, vae_cfg_kwargs).

    The reference DALLE state dict embeds its VAE (``vae.*``) and ties
    ``image_emb.weight`` to ``vae.codebook.weight``; both copies land in
    their owners. ``heads`` cannot be inferred from a fused qkv weight:
    pass the checkpoint's (reference default 8); one that does not
    divide the inner dim is refused."""
    vae_sd = _sub(sd, "vae.")
    vae_params, vae_cfg = (import_vae(vae_sd, image_size) if vae_sd
                           else (None, None))

    tsd = _sub(sd, "transformer.")
    depth, dim, inner = _transformer_dims(tsd)
    text_emb = _np(sd, "text_emb.weight")
    params = {
        "text_emb": {"w": text_emb},
        "image_emb": {"w": _np(sd, "image_emb.weight")},
        "text_pos_emb": {"w": _np(sd, "text_pos_emb.weight")},
        "image_pos_emb": _axial_tables(sd, "image_pos_emb."),
        "transformer": import_transformer(tsd),
        "to_logits": {
            "ln": _layernorm(sd, "to_logits.0"),
            "proj": _linear(sd, "to_logits.1"),
        },
    }
    cfg = {
        "dim": dim,
        "depth": depth,
        "num_text_tokens": text_emb.shape[0],
        "text_seq_len": _np(sd, "text_pos_emb.weight").shape[0],
        "dim_head": _dim_head_for(inner, heads),
        "axial_compat": "full_image",
    }
    return params, vae_params, cfg, vae_cfg


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

def import_clip(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """-> (params, config_kwargs) for the reference CLIP."""
    text_t = _sub(sd, "text_transformer.")
    vis_t = _sub(sd, "visual_transformer.")
    t_depth, dim_text, _ = _transformer_dims(text_t)
    v_depth, dim_image, _ = _transformer_dims(vis_t)
    to_vis = _np(sd, "to_visual_embedding.weight")   # (dim_image, patch_dim)
    vis_pos = _np(sd, "visual_pos_emb.weight")
    text_emb = _np(sd, "text_emb.weight")

    params = {
        "text_emb": {"w": text_emb},
        "text_pos_emb": {"w": _np(sd, "text_pos_emb.weight")},
        "text_transformer": import_transformer(text_t),
        "to_text_latent": _linear(sd, "to_text_latent", bias=False),
        "to_visual_emb": _linear(sd, "to_visual_embedding"),
        "visual_pos_emb": {"w": vis_pos},
        "visual_transformer": import_transformer(vis_t),
        "to_visual_latent": _linear(sd, "to_visual_latent", bias=False),
        "temperature": np.asarray(_np(sd, "temperature"), np.float32)
                         .reshape(()),
    }
    patch_dim = to_vis.shape[1]
    num_patches = vis_pos.shape[0]
    # patch_dim = channels * p**2; channels=3 unless indivisible (gray=1)
    channels = 3 if patch_dim % 3 == 0 else 1
    patch = int(round((patch_dim // channels) ** 0.5))
    side = int(round(num_patches ** 0.5))
    cfg = {
        "dim_text": dim_text,
        "dim_image": dim_image,
        "dim_latent": _np(sd, "to_text_latent.weight").shape[0],
        "num_text_tokens": text_emb.shape[0],
        "text_enc_depth": t_depth,
        "text_seq_len": _np(sd, "text_pos_emb.weight").shape[0],
        "visual_enc_depth": v_depth,
        "visual_image_size": side * patch,
        "visual_patch_size": patch,
        "channels": channels,
    }
    return params, cfg
