"""DALLE: the joint text+image autoregressive transformer.

Port of ``dalle_pytorch_tpu/models/dalle.py``: ``DALLEConfig``, the
embeddings (``embed_prompt``, ``decode_token_embed``, the summed-axial
``image_pos_emb`` in both ``axial_compat`` modes), ``logits_mask``,
``to_logits`` (``:47-244``), the forward and training loss
(``dalle_apply``, ``ce_from_hidden``, ``_nll``, ``_chunked_ce``,
``:290-401``), the samplers ``top_k_filter``, ``top_p_filter`` and
``sample_per_slot`` (``:408-514``, with the engine's guided-pair
arguments ``partner``, ``cfg_scale`` and ``uncond``), the speculative
draft head ``draft_transformer_config`` / ``draft_transformer_params``
(``:247-268``), ``quantize_for_decode`` (``:271``) and one-shot
generation, ``generate_images`` (``:517-664``): the dense KV cache,
classifier-free guidance, int8 caches and the CLIP rerank.

``reversible``, ``remat`` and ``moe_experts`` select the stack's engine
(``ops/transformer.py``): a reversible model's hidden states are the
mean of its two streams, in training and in every decode path, and a MoE
model's training loss adds ``moe_aux_coef`` times the load-balance loss
(JAX ``:331-332``).

Vocabulary layout ``[0, num_text_tokens) text | image | EOS``. The image
embedding is TIED to the VAE codebook: ``dalle_init(vae=...)`` copies
the codebook into ``image_emb``, and the serving path decodes images
through the VAE with DALLE's copy, as the JAX package does.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from dalle_pytorch_tpu_torch.device import generator, resolve_device
from dalle_pytorch_tpu_torch.models import clip as clip_mod
from dalle_pytorch_tpu_torch.models import vae as vae_mod
from dalle_pytorch_tpu_torch.ops import core, prng, quant
from dalle_pytorch_tpu_torch.ops import decode as decode_ops
from dalle_pytorch_tpu_torch.ops import transformer as T


@dataclasses.dataclass(frozen=True)
class DALLEConfig:
    dim: int
    depth: int
    vae: vae_mod.VAEConfig
    num_text_tokens: int = 10000
    text_seq_len: int = 256
    heads: int = 8
    dim_head: int = 64
    reversible: bool = False
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    sparse_attn: Union[bool, Tuple[bool, ...]] = False
    sparse_block: int = 16
    attn_impl: str = "xla"
    # flash backward: 'xla' | 'pallas' (K2a + K2b split) | 'pallas_fused'
    attn_bwd_impl: str = "xla"
    flash_block_q: int = 128
    flash_block_k: int = 128
    # sparse layers: 'ref' | 'windowed' | 'pallas' (kernel K3)
    sparse_impl: str = "ref"
    # MoE FF: 0 = plain GEGLU; > 0 experts a layer, top moe_k; the
    # Switch load-balance loss enters the training loss times
    # moe_aux_coef
    moe_experts: int = 0
    moe_k: int = 2
    moe_aux_coef: float = 1e-2
    scale_mode: str = "dim"
    remat: str = "none"
    # 'grid' factorizes over the token grid; 'full_image' reproduces the
    # reference's (image_size, image_size) table quirk
    axial_compat: str = "grid"
    # 0: CE over the full (b, seq, total_tokens) logits; > 0: the head
    # and CE run over sequence chunks of this size, each recomputed in
    # the backward (torch.utils.checkpoint), so only one chunk's logits
    # are alive at a time
    loss_chunk: int = 0

    def __post_init__(self):
        if self.axial_compat not in ("grid", "full_image"):
            raise ValueError(f"unknown axial_compat {self.axial_compat!r}")
        self.transformer        # validates the stack's options

    @property
    def image_seq_len(self) -> int:
        return self.vae.image_seq_len

    @property
    def num_image_tokens(self) -> int:
        return self.vae.num_tokens

    @property
    def seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    @property
    def total_tokens(self) -> int:
        return self.num_text_tokens + self.num_image_tokens + 1  # + EOS

    @property
    def eos_token_id(self) -> int:
        return self.total_tokens - 1

    @property
    def transformer(self) -> T.TransformerConfig:
        return T.TransformerConfig(
            dim=self.dim, depth=self.depth, seq_len=self.seq_len,
            heads=self.heads, dim_head=self.dim_head, causal=True,
            attn_dropout=self.attn_dropout, ff_dropout=self.ff_dropout,
            reversible=self.reversible, sparse_attn=self.sparse_attn,
            sparse_block=self.sparse_block, attn_impl=self.attn_impl,
            attn_bwd_impl=self.attn_bwd_impl,
            flash_block_q=self.flash_block_q,
            flash_block_k=self.flash_block_k, sparse_impl=self.sparse_impl,
            moe_experts=self.moe_experts, moe_k=self.moe_k,
            scale_mode=self.scale_mode, remat=self.remat)


class DALLE(nn.Module):
    """Parameters of the JAX ``dalle_init`` tree, as modules."""

    def __init__(self, cfg: DALLEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        if cfg.axial_compat == "full_image":
            ax = cfg.vae.image_size
        else:
            ax = cfg.vae.grid_size
        self.text_emb = nn.Embedding(cfg.num_text_tokens, cfg.dim, **kw)
        self.image_emb = nn.Embedding(cfg.num_image_tokens, cfg.dim, **kw)
        self.text_pos_emb = nn.Embedding(cfg.text_seq_len, cfg.dim, **kw)
        self.image_pos_rows = nn.Embedding(ax, cfg.dim, **kw)
        self.image_pos_cols = nn.Embedding(ax, cfg.dim, **kw)
        self.transformer = T.Transformer(cfg.transformer, **kw)
        self.logits_ln = nn.LayerNorm(cfg.dim, **kw)
        self.logits_proj = nn.Linear(cfg.dim, cfg.total_tokens, **kw)


def dalle_init(cfg: DALLEConfig, seed: int = 0, *,
               vae: Optional[vae_mod.VAEDecoder] = None,
               dtype=torch.float32, device=None) -> DALLE:
    """A seeded random DALLE on ``device`` (the card by default). With
    ``vae`` the image embedding is seeded from its codebook (the tie;
    requires ``vae.codebook_dim == dim``)."""
    device = resolve_device(device)
    model = DALLE(cfg, device=device, dtype=dtype)
    core.init_params_(model, generator(seed, device))
    if vae is not None:
        if cfg.vae.codebook_dim != cfg.dim:
            raise ValueError(
                "tied codebook requires vae.codebook_dim == dalle dim "
                f"({cfg.vae.codebook_dim} != {cfg.dim})")
        with torch.no_grad():
            model.image_emb.weight.copy_(vae.codebook.weight)
    return model


# ---------------------------------------------------------------------------
# embeddings / masks / head
# ---------------------------------------------------------------------------

def image_pos_emb(model: DALLE, positions: torch.Tensor) -> torch.Tensor:
    """Summed-axial embedding of flat image positions: 'grid' maps n ->
    (n // g, n % g); 'full_image' maps over the image_size-wide table."""
    width = model.image_pos_cols.weight.shape[0]
    return (model.image_pos_rows.weight[positions // width]
            + model.image_pos_cols.weight[positions % width])


def logits_mask(cfg: DALLEConfig, rows: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """(seq_len, total_tokens) bool, True = FORBIDDEN — or only the
    given ``rows`` of it, ``(len(rows), total_tokens)``, which is what a
    decode step needs (the full table is 15 MB at the north config).
    Row i governs the token predicted there, i.e. token i+1."""
    if rows is None:
        rows = torch.arange(cfg.seq_len, device=device)
    n, t = cfg.seq_len, cfg.total_tokens
    seq = rows[:, None]
    logit = torch.arange(t, device=rows.device)[None, :]
    text_boundary = cfg.text_seq_len - 1
    return (((seq >= text_boundary) & (logit < cfg.num_text_tokens))
            | ((seq < text_boundary) & (logit >= cfg.num_text_tokens))
            | ((seq != (n - 1)) & (logit >= (t - 1))))


def embed_prompt(model: DALLE, text: torch.Tensor,
                 image_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings for [text (b, t)] ++ [image ids (b, n_img)]."""
    t = text.shape[1]
    tok = model.text_emb.weight[text] + model.text_pos_emb.weight[None, :t]
    if image_ids is not None and image_ids.shape[1] > 0:
        pos = torch.arange(image_ids.shape[1], device=image_ids.device)
        img = model.image_emb.weight[image_ids] + image_pos_emb(model,
                                                                pos)[None]
        tok = torch.cat([tok, img], dim=1)
    return tok


def decode_token_embed(model: DALLE, cur_tok: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """Embedding of the token fed at per-slot position ``pos`` (b,) during
    KV-cache decoding. ``cur_tok`` holds image ids WITHOUT the text-vocab
    offset. Ids are clamped into each table so the unselected branch of
    the select stays in range."""
    cfg = model.cfg
    text_e = (model.text_emb.weight[cur_tok.clamp(0, cfg.num_text_tokens - 1)]
              + model.text_pos_emb.weight[pos.clamp(0, cfg.text_seq_len - 1)])
    img_pos = (pos - cfg.text_seq_len).clamp(0, cfg.image_seq_len - 1)
    img_e = (model.image_emb.weight[
        cur_tok.clamp(0, cfg.num_image_tokens - 1)]
        + image_pos_emb(model, img_pos))
    return torch.where((pos < cfg.text_seq_len)[:, None], text_e, img_e)


def to_logits(model: DALLE, h: torch.Tensor) -> torch.Tensor:
    return core.linear(model.logits_proj, core.layernorm(model.logits_ln, h))


def draft_transformer_config(tcfg: T.TransformerConfig,
                             d: int) -> T.TransformerConfig:
    """The speculative draft's config: the first ``d`` layers of the
    target stack, all else unchanged (``sparse_attn`` re-sliced, since
    ``sparse_pattern`` derives from depth)."""
    if not 1 <= d <= tcfg.depth:
        raise ValueError(
            f"draft depth must be in [1, {tcfg.depth}], got {d}")
    return dataclasses.replace(
        tcfg, depth=d, sparse_attn=tuple(tcfg.sparse_pattern[:d]))


def draft_transformer_params(transformer: T.Transformer,
                             d: int) -> T.Transformer:
    """The draft head's weights: the target stack's first ``d`` layers,
    shared, not copied (an early exit through the same logit head and
    sampler, so no extra memory)."""
    out = copy.copy(transformer)
    out._modules = dict(transformer._modules)
    out.layers = transformer.layers[:d]
    return out


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def dalle_apply(model: DALLE, text: torch.Tensor,
                image: Optional[torch.Tensor] = None, *,
                mask: Optional[torch.Tensor] = None,
                vae: Optional[vae_mod.VAEEncoder] = None,
                rng: Optional[torch.Tensor] = None, train: bool = False,
                return_loss: bool = False) -> torch.Tensor:
    """Forward (reference DALLE.forward). ``image`` is token ids
    (b, n_img), raw images (b, H, W, C) tokenised through the frozen VAE
    encoder ``vae`` with no gradient, or None (text-only prefix). ``mask``
    (b, t) covers the text; image positions are always kept. Returns the
    masked logits (b, seq, total_tokens) or the scalar CE loss, plus
    ``moe_aux_coef`` times the MoE load-balance loss in a MoE model. A
    reversible model's logits come from the mean of its two streams."""
    cfg = model.cfg
    image_ids = None
    if image is not None:
        if image.dim() == 4:
            if vae is None:
                raise ValueError("raw images need the VAE encoder to "
                                 "tokenize")
            image_ids = vae_mod.get_codebook_indices(vae, image)
        else:
            image_ids = image
    tokens = embed_prompt(model, text, image_ids)
    seq_len = tokens.shape[1]
    if mask is not None and image_ids is not None:
        pad = torch.ones((mask.shape[0], image_ids.shape[1]),
                         dtype=torch.bool, device=mask.device)
        mask = torch.cat([mask.bool(), pad], dim=1)
    h, aux = T.transformer_apply(model.transformer, tokens,
                                 cfg=cfg.transformer, mask=mask, rng=rng,
                                 train=train, with_aux=True)
    if not return_loss:
        logits = to_logits(model, h)
        forbidden = logits_mask(cfg, device=h.device)[:seq_len]
        return logits.masked_fill(forbidden, core.neg_inf(logits.dtype))
    if image_ids is None:
        raise ValueError("when training, image must be supplied")
    loss = ce_from_hidden(model, h, text, image_ids)
    if cfg.moe_experts:
        loss = loss + cfg.moe_aux_coef * aux
    return loss


def ce_from_hidden(model: DALLE, h: torch.Tensor, text: torch.Tensor,
                   image_ids: torch.Tensor) -> torch.Tensor:
    """Mean CE of the next token: labels [text, image + offset, EOS]
    shifted left, over the masked logits. Honours ``cfg.loss_chunk``."""
    cfg = model.cfg
    eos = torch.full((text.shape[0], 1), cfg.eos_token_id,
                     dtype=torch.long, device=text.device)
    labels = torch.cat([text.long(), image_ids.long() + cfg.num_text_tokens,
                        eos], dim=1)
    targets = labels[:, 1:]                      # predict token i+1 at row i
    if cfg.loss_chunk > 0:
        return _chunked_ce(model, h, targets)
    logits = to_logits(model, h)
    forbidden = logits_mask(cfg, device=h.device)[:h.shape[1]]
    logits = logits.masked_fill(forbidden, core.neg_inf(logits.dtype))
    return _nll(logits, targets).mean()


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[targets] as logsumexp minus the gathered
    logit, in f32; the full log-probability tensor never exists."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0].float()
    return lse - tgt


def _chunked_ce(model: DALLE, h: torch.Tensor,
                targets: torch.Tensor) -> torch.Tensor:
    """The dense CE's math over sequence chunks of ``cfg.loss_chunk``
    rows: each chunk's head, mask and CE run under
    ``torch.utils.checkpoint``, so its (b, chunk, total_tokens) logits
    are recomputed in the backward instead of kept. The forbidden mask
    shapes each chunk's partition function, as in the dense path. A
    short last chunk stands for JAX's zero-weighted padding."""
    cfg = model.cfg
    b, n, _ = h.shape
    chunk = min(cfg.loss_chunk, n)

    def body(hc, tc, rows):
        logits = to_logits(model, hc)
        forbidden = logits_mask(cfg, rows)
        logits = logits.masked_fill(forbidden, core.neg_inf(logits.dtype))
        return _nll(logits, tc).sum()

    total = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        rows = torch.arange(c0, c1, device=h.device)
        total = total + torch.utils.checkpoint.checkpoint(
            body, h[:, c0:c1], targets[:, c0:c1], rows, use_reentrant=False)
    return total / (b * n)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def top_k_filter(logits: torch.Tensor, thres: float) -> torch.Tensor:
    """Keep the top (1-thres)·vocab logits, fill the rest."""
    k = max(int((1 - thres) * logits.shape[-1]), 1)
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, core.neg_inf(logits.dtype))


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter on TEMPERATURE-SCALED logits: keep the smallest
    prefix of descending-probability tokens whose mass reaches ``p``."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {p}")
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    thresh = torch.where(keep_sorted, sorted_logits, float("inf")).amin(
        dim=-1, keepdim=True).to(logits.dtype)
    return logits.masked_fill(logits < thresh, core.neg_inf(logits.dtype))


def sample_per_slot(logits: torch.Tensor, pred_pos: torch.Tensor,
                    keys: torch.Tensor, temp: torch.Tensor,
                    topk_k: torch.Tensor, top_p: torch.Tensor,
                    cfg: DALLEConfig, *,
                    partner: Optional[torch.Tensor] = None,
                    cfg_scale: Optional[torch.Tensor] = None,
                    uncond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot sampling, every knob a (slots,) tensor: forbidden-position
    mask, temperature, top-k OR nucleus (``top_p > 0`` selects nucleus),
    then ``categorical`` under ``fold_in(key, pred_pos)``. Returns ids
    with the text-vocab offset removed at image positions. Both filters
    come off one descending sort, as in the JAX program.

    ``partner``, ``cfg_scale`` and ``uncond`` (each (slots,), together or
    not at all) fold classifier-free guidance in: a guided request holds
    a cond/uncond slot pair, each the other's ``partner`` (self
    elsewhere). A cond slot with ``cfg_scale > 0`` samples image
    positions from ``l_u + cfg_scale * (l_c - l_u)``, mixed in float32
    on the masked logits before the temperature, as ``generate_images``
    mixes; its uncond partner takes the cond slot's drawn token, so the
    pair's caches stay in step. With every scale 0 both are identities."""
    forbidden = logits_mask(cfg, pred_pos - 1)
    lg = logits.masked_fill(forbidden, core.neg_inf(logits.dtype))
    if partner is not None:
        l_self = lg.float()
        l_pair = lg[partner.long()].float()
        # on a cond slot the partner IS the uncond stream
        mix = (l_pair + cfg_scale[:, None] * (l_self - l_pair)).to(lg.dtype)
        guided_img = ((cfg_scale > 0) & ~uncond
                      & (pred_pos >= cfg.text_seq_len))
        lg = torch.where(guided_img[:, None], mix, lg)
    lg = lg / temp[:, None]         # f32 temp promotes bf16 logits, as JAX

    sorted_desc = torch.sort(lg, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, (topk_k - 1).long()[:, None])
    by_k = lg.masked_fill(lg < kth, core.neg_inf(lg.dtype))

    probs = torch.softmax(sorted_desc.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    thresh = torch.where(keep_sorted, sorted_desc, float("inf")).amin(
        dim=-1, keepdim=True).to(lg.dtype)
    by_p = lg.masked_fill(lg < thresh, core.neg_inf(lg.dtype))

    lg = torch.where((top_p > 0)[:, None], by_p, by_k)
    raw = prng.categorical(prng.fold_in(keys, pred_pos), lg)
    if partner is not None:
        # the uncond slot takes its cond partner's drawn token
        raw = torch.where((cfg_scale > 0) & uncond, raw[partner.long()], raw)
    return torch.where(pred_pos >= cfg.text_seq_len,
                       raw - cfg.num_text_tokens, raw)


# ---------------------------------------------------------------------------
# int8 weights and one-shot generation
# ---------------------------------------------------------------------------

def quantize_for_decode(model: DALLE) -> DALLE:
    """A copy of ``model`` with the transformer's linears and the
    vocabulary head in int8 (``ops/quant.py``); the embedding tables, the
    layernorms and the tied codebook stay in their stored dtype.
    Inference only."""
    out = copy.copy(model)
    out._modules = dict(model._modules)
    out.transformer = quant.quantize_module_int8(model.transformer)
    out.logits_proj = quant.quantize_module_int8(model.logits_proj)
    return out


@torch.no_grad()
def sample_tokens(model: DALLE, text: torch.Tensor, *, rng: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  filter_thres: float = 0.5, top_p: float = 0.0,
                  temperature: float = 1.0, guidance: float = 0.0,
                  quantize_cache: bool = False):
    """The sampling loop of ``generate_images``, one decode step per item:
    yields the (rows,) token fed at each position t0 .. seq_len - 1
    (image ids without the text-vocab offset; rows = 2b under guidance,
    the conditional stream first), then runs that position's step. The
    options are ``generate_images``'."""
    cfg = model.cfg
    b, t0 = text.shape
    dev = text.device
    rng = rng.to(dev)
    total_len = cfg.seq_len
    tcfg = cfg.transformer
    guided = guidance > 0
    if guided:
        text = torch.cat([text, torch.zeros_like(text)])
        if mask is not None:
            mask = torch.cat([mask, torch.ones_like(mask)])
    rows = text.shape[0]

    h, cache = decode_ops.prefill(model.transformer, embed_prompt(model, text),
                                  cfg=tcfg, total_len=total_len,
                                  prompt_mask=mask,
                                  quantize_cache=quantize_cache)
    key_mask = decode_ops._full_key_mask(mask, rows, t0, total_len, dev)
    uncond_rows = torch.arange(rows, device=dev) >= b

    def sample(logits: torch.Tensor, pred_pos: int) -> torch.Tensor:
        forbidden = logits_mask(cfg, torch.tensor([pred_pos - 1],
                                                  device=dev))
        lg = logits.masked_fill(forbidden, core.neg_inf(logits.dtype))
        is_image = pred_pos >= cfg.text_seq_len
        if guided:
            l_c, l_u = lg[:b].float(), lg[b:].float()
            lg = (l_u + guidance * (l_c - l_u) if is_image
                  else l_c).to(lg.dtype)
        # a Python float divides in the logits' dtype, as JAX's weakly
        # typed scalar does
        lg = lg / torch.tensor(temperature, dtype=lg.dtype, device=dev)
        lg = (top_p_filter(lg, top_p) if top_p > 0
              else top_k_filter(lg, filter_thres))
        raw = prng.categorical(prng.fold_in(rng, pred_pos), lg)
        if guided:
            raw = raw.repeat(2)          # both streams take the same token
        return raw - cfg.num_text_tokens if is_image else raw

    cur = sample(to_logits(model, h[:, -1]), t0)
    for pos in range(t0, total_len):
        if guided and pos < cfg.text_seq_len:
            cur = torch.where(uncond_rows, 0, cur)   # the null stream: PAD
        yield cur
        x = decode_token_embed(model, cur, torch.full((rows,), pos,
                                                      device=dev))
        h_tok = decode_ops.decode_step(model.transformer, x, pos, cache,
                                       cfg=tcfg, key_mask=key_mask)
        if pos + 1 < total_len:      # the token past the end is never used
            cur = sample(to_logits(model, h_tok), pos + 1)


@torch.no_grad()
def generate_images(model: DALLE, vae: vae_mod.VAEDecoder,
                    text: torch.Tensor, *, rng: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    filter_thres: float = 0.5, top_p: float = 0.0,
                    temperature: float = 1.0, guidance: float = 0.0,
                    clip=None, return_img_seq: bool = False,
                    quantize_cache: bool = False):
    """Sample the image tokens of ``text`` (b, t0) autoregressively over a
    dense KV cache and decode them through the VAE with DALLE's tied
    codebook (``images`` (b, H, W, C)). ``rng`` is a (2,) key; position
    p's draw uses ``fold_in(rng, p)`` over the whole batch at once, as
    JAX's one call does.

    Per step the forbidden logits are filled, the ``temperature`` divide
    (in the logits' dtype) comes first, then nucleus (``top_p > 0``) or
    top-k (``filter_thres``) filtering. Prompts shorter than the text span
    complete it first; ``mask`` (b, t0) marks their pad positions.
    ``guidance > 0`` adds the unconditional stream (the all-PAD caption,
    all-True mask) in the batch: image tokens sample from
    ``l_u + guidance * (l_c - l_u)`` mixed in float32 against the
    ``-finfo.max`` fill, both streams take the same token, and the null
    stream keeps PAD at text positions. ``quantize_cache`` stores the
    cache int8. With ``clip`` (a ``models/clip.py::CLIP``) returns
    (images, CLIP scores of the sampled captions against the images);
    with ``return_img_seq`` (images, image token ids)."""
    cfg = model.cfg
    if clip is not None and clip.cfg.num_text_tokens < cfg.num_text_tokens:
        # the rerank would gather out-of-range text ids: fail before the
        # sampling loop
        raise ValueError(
            f"CLIP num_text_tokens ({clip.cfg.num_text_tokens}) < "
            f"DALLE num_text_tokens ({cfg.num_text_tokens}): the rerank "
            f"would gather out-of-range text ids; train CLIP with a vocab "
            f"covering the DALLE's")
    toks = list(sample_tokens(model, text, rng=rng, mask=mask,
                              filter_thres=filter_thres, top_p=top_p,
                              temperature=temperature, guidance=guidance,
                              quantize_cache=quantize_cache))
    b = text.shape[0]
    full = torch.cat([text, torch.stack(toks, dim=1)[:b].to(text.dtype)],
                     dim=1)                      # the conditional stream
    img_seq = full[:, -cfg.image_seq_len:]
    images = vae_mod.decode(vae, img_seq, codebook=model.image_emb.weight)
    if return_img_seq:
        return images, img_seq
    if clip is not None:
        scores = clip_mod.clip_apply(clip, full[:, :cfg.text_seq_len],
                                     images)
        return images, scores
    return images
