"""Codebook-mixing demo CLI — the reference mixVAEcuda.py, on the card.

Port of ``dalle_pytorch_tpu/cli/mix_vae.py``: load a trained VAE
checkpoint (either package's), encode image batches to token grids, give
each of the first ``--mix_rows`` grids the bottom half of its batch
neighbour's (``codes[i, half:] = codes[(i+1) % k, half:]``), decode, and
save [input | recon | mixed] grids.

Run: python -m dalle_pytorch_tpu_torch.cli.mix_vae --vaename vae \
        --load_epoch 99
``main(argv, device="cpu")`` runs on the CPU; the card is the default.
"""

from __future__ import annotations

import argparse
import os

import torch

from dalle_pytorch_tpu_torch import checkpoint as ckpt
from dalle_pytorch_tpu_torch.cli.common import say
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.data.images import (ImageFolderDataset,
                                                 save_image_grid)
from dalle_pytorch_tpu_torch.device import resolve_device
from dalle_pytorch_tpu_torch.models import vae as V


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="codebook mixing demo (PyTorch port of DALLE-pytorch)")
    p.add_argument("--vaename", type=str, default="vae")
    p.add_argument("--load_epoch", type=int, default=0)
    p.add_argument("--models_dir", type=str, default="./models")
    p.add_argument("--dataPath", type=str, default="./imagedata")
    p.add_argument("--imageSize", type=int, default=256)
    p.add_argument("--batchSize", type=int, default=12)
    p.add_argument("--out_dir", type=str, default="./mixed")
    p.add_argument("--mix_rows", type=int, default=8,
                   help="leading batch rows that swap halves (reference "
                        "uses 8)")
    p.add_argument("--max_batches", type=int, default=0,
                   help="stop after N batches (0 = whole epoch)")
    p.add_argument("--seed", type=int, default=0)
    return p


@torch.no_grad()
def mix(vae, images: torch.Tensor, k: int, half: int):
    """(recon, mixed): the first ``k`` token grids take their neighbour's
    bottom half (a roll by -1 over the batch) before decoding."""
    codes = V.get_codebook_indices(vae, images)
    recon = V.decode(vae, codes)
    head = codes[:k]
    swapped = torch.cat([head[:, :half],
                         torch.roll(head[:, half:], -1, dims=0)], dim=1)
    mixed = V.decode(vae, torch.cat([swapped, codes[k:]], dim=0))
    return recon, mixed


def main(argv=None, *, device=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(device)

    path = ckpt.ckpt_path(args.models_dir, args.vaename, args.load_epoch)
    params, manifest = ckpt.restore_params(path)
    cfg = ckpt.vae_config_from_manifest(manifest)
    vae = from_jax.discrete_vae_from_jax(params, cfg, device=device)

    k = min(args.mix_rows, args.batchSize)
    dataset = ImageFolderDataset(args.dataPath, args.imageSize,
                                 args.batchSize, shuffle=True,
                                 seed=args.seed, drop_last=False)
    os.makedirs(args.out_dir, exist_ok=True)

    for batch_idx, images in enumerate(dataset):
        if args.max_batches and batch_idx >= args.max_batches:
            break
        images = torch.from_numpy(images).to(device)
        recon, mixed = mix(vae, images, k, cfg.image_seq_len // 2)
        grid = torch.cat([images[:k], recon[:k].float(), mixed[:k].float()])
        out = os.path.join(
            args.out_dir, f"mixed_epoch_{args.load_epoch}_{batch_idx}.png")
        save_image_grid(grid, out, nrow=k)
        say(f"saved {out}")


if __name__ == "__main__":
    main()
