"""Export to reference-layout torch state dicts.

Port of ``dalle_pytorch_tpu/compat/torch_export.py``, the inverse of
``compat/torch_import.py``: a JAX-layout tree (what ``checkpoint.py``
restores) or one of the port's modules (laid out by ``compat/to_jax.py``)
becomes the reference's key names and tensor layouts, so a model the
port trained loads into the reference with ``load_state_dict``.
``import_*(export_*(tree))`` gives back the tree bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _tree(params):
    """A module -> its JAX-layout tree; a tree as it is."""
    if isinstance(params, nn.Module):
        from dalle_pytorch_tpu_torch.compat import to_jax
        return to_jax.tree(params)
    return params


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):        # bfloat16 leaves restore as such
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _linear(out: Dict[str, np.ndarray], prefix: str, p: dict) -> None:
    if "w_q" in p:
        raise ValueError(
            f"{prefix}: int8-quantized weights cannot be exported — "
            "quantization is lossy and inference-only; export the "
            "full-precision params instead")
    out[prefix + ".weight"] = _t(p["w"]).T
    if "b" in p:
        out[prefix + ".bias"] = _t(p["b"])


def _layernorm(out, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _t(p["g"])
    out[prefix + ".bias"] = _t(p["b"])


def _conv(out, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _t(p["w"]).transpose(3, 2, 0, 1)   # HWIO->OIHW
    out[prefix + ".bias"] = _t(p["b"])


def _conv_transpose(out, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _t(p["w"]).transpose(2, 3, 0, 1)   # HWIO->IOHW
    out[prefix + ".bias"] = _t(p["b"])


def _resblock(out, prefix: str, p: dict) -> None:
    _conv(out, prefix + "net.0", p["c1"])
    _conv(out, prefix + "net.2", p["c2"])
    _conv(out, prefix + "net.4", p["c3"])


def export_vae(params) -> Dict[str, np.ndarray]:
    """VAE tree (or ``DiscreteVAE``) -> reference DiscreteVAE state
    dict."""
    params = _tree(params)
    out: Dict[str, np.ndarray] = {"codebook.weight": _t(
        params["codebook"]["w"])}
    L = len(params["enc_convs"])
    R = len(params["enc_res"])
    for i, p in enumerate(params["enc_convs"]):
        _conv(out, f"encoder.{i}.0", p)
    for r, p in enumerate(params["enc_res"]):
        _resblock(out, f"encoder.{L + r}.", p)
    _conv(out, f"encoder.{L + R}", params["enc_out"])

    off = 1 if "dec_stem" in params else 0
    if off:
        _conv(out, "decoder.0", params["dec_stem"])
    for r, p in enumerate(params["dec_res"]):
        _resblock(out, f"decoder.{off + r}.", p)
    for i, p in enumerate(params["dec_convs"]):
        _conv_transpose(out, f"decoder.{off + R + i}.0", p)
    _conv(out, f"decoder.{off + R + L}", params["dec_out"])
    return out


def _layer(stacked, i: int):
    """Layer i of a depth-stacked tree."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def export_transformer(stacked: dict) -> Dict[str, np.ndarray]:
    """Depth-stacked transformer params -> per-layer reference keys
    (``layers.layers.{i}.{0,1}...``)."""
    out: Dict[str, np.ndarray] = {}
    if "moe" in stacked.get("ff", {}):
        raise ValueError(
            "MoE layers cannot be exported to the reference .pth format "
            "(the reference has no MoE; its FeedForward is a single GEGLU "
            "MLP) — train with moe_experts=0 for torch-compatible export")
    depth = stacked["attn"]["ln"]["g"].shape[0]
    for i in range(depth):
        lp = _layer(stacked, i)
        a = f"layers.layers.{i}.0."
        _layernorm(out, a + "norm", lp["attn"]["ln"])
        _linear(out, a + "fn.to_qkv", lp["attn"]["qkv"])
        _linear(out, a + "fn.to_out.0", lp["attn"]["out"])
        f = f"layers.layers.{i}.1."
        _layernorm(out, f + "norm", lp["ff"]["ln"])
        _linear(out, f + "fn.net.0", lp["ff"]["w1"])
        _linear(out, f + "fn.net.3", lp["ff"]["w2"])
    return out


def export_dalle(params, vae_params=None,
                 image_size: int = 256) -> Dict[str, np.ndarray]:
    """DALLE tree (or module) -> reference state dict. ``vae_params``
    fills the embedded ``vae.*`` subtree; the tied ``image_emb`` /
    codebook takes DALLE's live table."""
    params = _tree(params)
    out: Dict[str, np.ndarray] = {}
    out["text_emb.weight"] = _t(params["text_emb"]["w"])
    out["image_emb.weight"] = _t(params["image_emb"]["w"])
    out["text_pos_emb.weight"] = _t(params["text_pos_emb"]["w"])
    rows = _t(params["image_pos_emb"]["rows"])
    cols = _t(params["image_pos_emb"]["cols"])
    dim = rows.shape[-1]
    out["image_pos_emb.weights.0"] = rows.reshape(1, rows.shape[0], 1, dim)
    out["image_pos_emb.weights.1"] = cols.reshape(1, 1, cols.shape[0], dim)
    for k, v in export_transformer(params["transformer"]).items():
        out[f"transformer.{k}"] = v
    _layernorm(out, "to_logits.0", params["to_logits"]["ln"])
    _linear(out, "to_logits.1", params["to_logits"]["proj"])
    if vae_params is not None:
        vae_sd = export_vae(vae_params)
        # the reference's tie makes vae.codebook the same tensor as
        # image_emb; keep the export consistent with DALLE's copy
        vae_sd["codebook.weight"] = out["image_emb.weight"]
        for k, v in vae_sd.items():
            out[f"vae.{k}"] = v
    return out


def export_clip(params) -> Dict[str, np.ndarray]:
    """CLIP tree (or module) -> reference state dict."""
    params = _tree(params)
    out: Dict[str, np.ndarray] = {}
    out["text_emb.weight"] = _t(params["text_emb"]["w"])
    out["text_pos_emb.weight"] = _t(params["text_pos_emb"]["w"])
    for k, v in export_transformer(params["text_transformer"]).items():
        out[f"text_transformer.{k}"] = v
    _linear(out, "to_text_latent", params["to_text_latent"])
    _linear(out, "to_visual_embedding", params["to_visual_emb"])
    out["visual_pos_emb.weight"] = _t(params["visual_pos_emb"]["w"])
    for k, v in export_transformer(params["visual_transformer"]).items():
        out[f"visual_transformer.{k}"] = v
    _linear(out, "to_visual_latent", params["to_visual_latent"])
    out["temperature"] = _t(params["temperature"]).reshape(())
    return out


def save_torch_state_dict(sd: Dict[str, np.ndarray], path: str) -> None:
    """Write as a torch-loadable ``.pth``."""
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
