"""Text -> image generation CLI — the reference genDALLE.py, on the card.

Port of ``dalle_pytorch_tpu/cli/gen_dalle.py`` (``main`` ``:119-225``),
with its flags and defaults: the DALLE checkpoint
``{models_dir}/{name}_dalle-{dalle_epoch}`` and the VAE its
``meta.vae_checkpoint`` names (either package's), the training
vocabulary (``{name}-vocab.json``, or rebuilt from ``--captions_only``),
the caption UNPADDED unless ``--pad_prompt`` (the reference's quirk: the
model completes the text positions first), ``--use_ema``, ``--quantize
int8|int8_kv``, ``--guidance``, ``--top_p``, ``--filter_thres``,
``--temperature``, the CLIP rerank (``--clip_name``, ``--scores_json``)
and a timestamped PNG grid. Sampling is ``models/dalle.py::
generate_images``: the dense KV-cache loop, which launches none of the
port's kernels (its CLIP rerank runs K3 with ``sparse_impl='pallas'``);
with the same checkpoint and ``--seed`` the tokens are JAX's.

Run: python -m dalle_pytorch_tpu_torch.cli.gen_dalle "a caption" \
        --name test --dalle_epoch 99
``main(argv, device="cpu")`` runs on the CPU; the card is the default.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from dalle_pytorch_tpu_torch import checkpoint as ckpt
from dalle_pytorch_tpu_torch.cli.common import ema_as, say
from dalle_pytorch_tpu_torch.compat import from_jax, to_jax
from dalle_pytorch_tpu_torch.data.captions import read_captions_only
from dalle_pytorch_tpu_torch.data.images import save_image_grid
from dalle_pytorch_tpu_torch.data.vocabulary import Vocabulary
from dalle_pytorch_tpu_torch.device import resolve_device
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.ops import prng


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="generate images from text (PyTorch port of "
                    "DALLE-pytorch)")
    p.add_argument("caption", type=str, help="input text")
    p.add_argument("--name", type=str, default="test",
                   help="DALLE experiment name (as given to train_dalle)")
    p.add_argument("--dalle_epoch", type=int, default=0)
    p.add_argument("--models_dir", type=str, default="./models")
    p.add_argument("--results_dir", type=str, default="./results")
    p.add_argument("--vocab", type=str, default="",
                   help="vocab JSON (default: {models_dir}/{name}-vocab.json)")
    p.add_argument("--captions_only", type=str, default="",
                   help="rebuild vocab from this corpus instead")
    p.add_argument("--num_images", type=int, default=1,
                   help="images to sample for the caption")
    p.add_argument("--filter_thres", type=float, default=0.5)

    def _top_p(v):
        v = float(v)
        if not 0.0 <= v <= 1.0:
            raise argparse.ArgumentTypeError(
                f"--top_p must be in [0, 1], got {v}")
        return v

    p.add_argument("--top_p", type=_top_p, default=0.0,
                   help="nucleus sampling mass in (0, 1] (0 = the top-k "
                        "filter of --filter_thres)")
    p.add_argument("--temperature", type=float, default=1.0)

    def _guidance(v):
        v = float(v)
        if v < 0:
            raise argparse.ArgumentTypeError(
                f"--guidance must be >= 0, got {v}")
        return v

    p.add_argument("--guidance", type=_guidance, default=0.0,
                   help="classifier-free guidance scale (0 = off); train "
                        "with --caption_drop first")
    p.add_argument("--pad_prompt", action="store_true",
                   help="pad the prompt to text_seq_len instead of the "
                        "reference's unpadded text-completion mode")
    p.add_argument("--clip_name", type=str, default="",
                   help="CLIP checkpoint name for reranking")
    p.add_argument("--clip_epoch", type=int, default=0)
    p.add_argument("--scores_json", type=str, default="",
                   help="append a JSONL record {caption, guidance, scores, "
                        "mean_score} per run (requires --clip_name)")
    p.add_argument("--use_ema", action="store_true",
                   help="sample from the checkpoint's EMA weights; errors "
                        "if the DALLE checkpoint has none (a CLIP without "
                        "one reranks with its raw weights)")
    p.add_argument("--quantize", choices=("none", "int8", "int8_kv"),
                   default="none",
                   help="int8: int8 transformer linears and vocabulary "
                        "head; int8_kv: an int8 KV cache as well")
    p.add_argument("--seed", type=int, default=0)
    return p


def load_vocab(args) -> Vocabulary:
    if args.captions_only:
        return Vocabulary.from_captions(read_captions_only(
            args.captions_only))
    path = args.vocab or os.path.join(args.models_dir,
                                      f"{args.name}-vocab.json")
    return Vocabulary.load(path)


def _ema_weights(model, path: str) -> bool:
    """Load the checkpoint's EMA into ``model``, cast to its parameters'
    dtypes (``ema_as``); False when the checkpoint has none."""
    tree = ckpt.restore_ema(path)
    if tree is None:
        return False
    ema = to_jax.named(model, tree, dtype=torch.float32)
    model.load_state_dict(ema_as(ema, model), strict=False)
    return True


def main(argv=None, *, device=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.scores_json and not args.clip_name:
        parser.error("--scores_json needs --clip_name (the scores come "
                     "from the CLIP rerank)")
    device = resolve_device(device)

    dalle_path = ckpt.ckpt_path(args.models_dir, f"{args.name}_dalle",
                                args.dalle_epoch)
    params, manifest = ckpt.restore_params(dalle_path)
    cfg = ckpt.dalle_config_from_manifest(manifest)
    vae_path = manifest["meta"].get("vae_checkpoint")
    if not vae_path or not os.path.isdir(vae_path):
        raise FileNotFoundError(
            f"DALLE checkpoint {dalle_path} does not point at a VAE "
            "checkpoint (meta.vae_checkpoint)")
    vae_params, vae_manifest = ckpt.restore_params(vae_path)
    vae = from_jax.vae_from_jax(vae_params,
                                ckpt.vae_config_from_manifest(vae_manifest),
                                device=device)
    model = from_jax.dalle_from_jax(params, cfg, device=device)
    if args.use_ema:
        if not _ema_weights(model, dalle_path):
            raise FileNotFoundError(
                f"{dalle_path} has no EMA weights — train with --ema_decay "
                "to sample from an EMA")
        say("sampling from EMA weights")
    if args.quantize in ("int8", "int8_kv"):
        model = D.quantize_for_decode(model)

    vocab = load_vocab(args)
    say(args.caption)
    codes = vocab.encode(args.caption,
                         pad_to=cfg.text_seq_len if args.pad_prompt
                         else None)
    say(codes)
    text = torch.tensor([codes] * args.num_images, dtype=torch.int32,
                        device=device)

    clip = None
    if args.clip_name:
        clip_path = ckpt.ckpt_path(args.models_dir, args.clip_name,
                                   args.clip_epoch)
        clip_params, clip_manifest = ckpt.restore_params(clip_path)
        clip = from_jax.clip_from_jax(
            clip_params, ckpt.clip_config_from_manifest(clip_manifest),
            device=device)
        if args.use_ema:
            say("reranking with CLIP EMA weights"
                if _ema_weights(clip, clip_path) else
                "note: CLIP checkpoint has no EMA weights; reranking with "
                "raw weights")

    out = D.generate_images(model, vae, text,
                            rng=prng.prng_key(args.seed, device=device),
                            filter_thres=args.filter_thres, top_p=args.top_p,
                            guidance=args.guidance,
                            temperature=args.temperature,
                            quantize_cache=args.quantize == "int8_kv",
                            clip=clip)

    if clip is not None:
        images, scores = out
        scores = scores.float().cpu().numpy()
        order = np.argsort(-scores)                 # best first
        images = images.float().cpu().numpy()[order]
        say("clip scores (sorted):", scores[order])
        if args.scores_json:
            rec = {"caption": args.caption, "guidance": args.guidance,
                   "scores": [float(s) for s in scores[order]],
                   "mean_score": float(np.mean(scores))}
            os.makedirs(os.path.dirname(
                os.path.abspath(args.scores_json)), exist_ok=True)
            with open(args.scores_json, "a") as f:
                f.write(json.dumps(rec) + "\n")
            say(f"appended scores to {args.scores_json}")
    else:
        images = out

    ts = int(time.time())
    say(args.caption, ts)
    path = os.path.join(
        args.results_dir,
        f"gendalle{args.name}_epoch_{args.dalle_epoch}-{ts}.png")
    save_image_grid(images, path, nrow=min(args.num_images, 8))
    say(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
