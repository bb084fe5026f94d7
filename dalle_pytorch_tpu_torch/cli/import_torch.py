"""Convert a reference DALLE-pytorch ``.pth`` into a checkpoint, and back.

Port of ``dalle_pytorch_tpu/cli/import_torch.py`` (``build_parser``
``:37``, ``main`` ``:59``), with its kinds and flags. A ``.pth`` written
by the reference's ``torch.save(model.state_dict())`` becomes a
checkpoint directory the port's (and the JAX package's) train_vae,
train_dalle, gen_dalle and mix_vae read; for the same ``.pth`` the
directory is byte for byte the JAX CLI's (``compat/torch_import.py``
gives the same trees, ``checkpoint.py`` writes flax's bytes):

    python -m dalle_pytorch_tpu_torch.cli.import_torch vae trained.pth \
        --out ./models/vae-99 [--image_size 256]

    python -m dalle_pytorch_tpu_torch.cli.import_torch dalle dalle.pth \
        --out ./models/dalle-0 [--heads 8] [--vae_out ./models/vae-0]

The export-* kinds run the other direction: a checkpoint directory
becomes a reference-layout ``.pth`` (``compat/torch_export.py``):

    python -m dalle_pytorch_tpu_torch.cli.import_torch export-vae out.pth \
        --out ./models/vae-99

Host code only: nothing runs on the card.
"""

from __future__ import annotations

import argparse

from dalle_pytorch_tpu_torch import checkpoint as ckpt
from dalle_pytorch_tpu_torch.compat import torch_export, torch_import


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="import a reference DALLE-pytorch .pth checkpoint")
    p.add_argument("kind", choices=["vae", "dalle", "clip",
                                    "export-vae", "export-dalle",
                                    "export-clip"])
    p.add_argument("pth", help="torch state_dict path (the OUTPUT for "
                               "export-* kinds)")
    p.add_argument("--out", required=True,
                   help="checkpoint directory (output for imports, INPUT "
                        "for export-* kinds)")
    p.add_argument("--image_size", type=int, default=256,
                   help="VAE training image size (not stored in weights)")
    p.add_argument("--heads", type=int, default=8,
                   help="attention heads (not inferable from weights)")
    p.add_argument("--epoch", type=int, default=0,
                   help="epoch number recorded in the checkpoint")
    p.add_argument("--vae_out", default="",
                   help="dalle only: also write the embedded VAE here")
    return p


def _export(args) -> None:
    params, manifest = ckpt.restore_params(args.out)
    kind = args.kind.removeprefix("export-")
    if manifest.get("kind") not in (kind, "model"):
        raise SystemExit(f"checkpoint {args.out} is kind="
                         f"{manifest.get('kind')!r}, expected {kind!r}")
    if kind == "vae":
        sd = torch_export.export_vae(params)
    elif kind == "clip":
        sd = torch_export.export_clip(params)
    else:
        vae_path = manifest.get("meta", {}).get("vae_checkpoint")
        vae_params = None
        if vae_path:
            vae_params, _ = ckpt.restore_params(vae_path)
        sd = torch_export.export_dalle(params, vae_params)
    torch_export.save_torch_state_dict(sd, args.pth)
    print(f"wrote reference-layout state dict {args.pth} "
          f"({len(sd)} tensors)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.kind.startswith("export-"):
        _export(args)
        return

    from dalle_pytorch_tpu_torch.models.vae import VAEConfig
    sd = torch_import.load_torch_state_dict(args.pth)
    meta = {"imported_from": args.pth, "epoch": args.epoch}

    if args.kind == "vae":
        params, cfg_kw = torch_import.import_vae(sd,
                                                 image_size=args.image_size)
        path = ckpt.save(args.out, params, step=args.epoch,
                         config=VAEConfig(**cfg_kw), kind="vae", meta=meta)
        print(f"wrote VAE checkpoint {path} "
              f"({cfg_kw['num_tokens']} tokens, {cfg_kw['num_layers']} "
              "layers)")
        return

    if args.kind == "dalle":
        from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig
        try:
            params, vae_params, cfg_kw, vae_cfg_kw = \
                torch_import.import_dalle(sd, image_size=args.image_size,
                                          heads=args.heads)
        except ValueError as e:           # --heads doesn't divide inner dim
            raise SystemExit(str(e))
        if vae_params is None:
            raise SystemExit("this .pth has no embedded vae.* weights; "
                             "import the VAE separately")
        cfg = DALLEConfig(vae=VAEConfig(**vae_cfg_kw), heads=args.heads,
                          **cfg_kw)
        path = ckpt.save(args.out, params, step=args.epoch, config=cfg,
                         kind="dalle", meta=meta)
        print(f"wrote DALLE checkpoint {path} (dim {cfg.dim}, depth "
              f"{cfg.depth})")
        if args.vae_out:
            vpath = ckpt.save(args.vae_out, vae_params, step=args.epoch,
                              config=VAEConfig(**vae_cfg_kw), kind="vae",
                              meta=meta)
            print(f"wrote embedded VAE checkpoint {vpath}")
        return

    from dalle_pytorch_tpu_torch.models.clip import CLIPConfig
    params, cfg_kw = torch_import.import_clip(sd)
    cfg = CLIPConfig(text_heads=args.heads, visual_heads=args.heads,
                     **cfg_kw)
    path = ckpt.save(args.out, params, step=args.epoch, config=cfg,
                     kind="clip", meta=meta)
    print(f"wrote CLIP checkpoint {path}")


if __name__ == "__main__":
    main()
