"""CLIP training CLI — contrastive text/image training for the reranker.

Port of ``dalle_pytorch_tpu/cli/train_clip.py``, with its flags and
defaults: the data contract of ``train_dalle`` (captions corpus,
``path : caption`` pairs, image folder), the reference's one-directional
(text -> image) InfoNCE with a learned temperature
(``parallel/train.py::clip_loss_fn``), the caption padding mask, Adam,
the EMA and per-epoch checkpoints ``{name}-{epoch}`` that ``gen_dalle
--clip_name`` reranks with. ``--sparse_impl``'s default is the model
config's, ``'ref'``, as in JAX (the CLI has no flag for it); the sparse
encoders run K3 when a config asks for ``'pallas'``. Across processes
(``cli/common.py::setup_run``) each rank reads the pairs of its ``dp``
coordinate and the step is data parallel over the whole batch's
similarity matrix; the primary rank writes the checkpoints.

Run: python -m dalle_pytorch_tpu_torch.cli.train_clip --dataPath ./imagedata
``main(argv, device="cpu")`` runs on the CPU; the card is the default.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dalle_pytorch_tpu_torch import checkpoint as ckpt
from dalle_pytorch_tpu_torch.cli.common import (LoopState, add_common_args,
                                                load_caption_dataset,
                                                make_ema, make_optimizer,
                                                make_supervisor, plan_resume,
                                                resolve_schedule,
                                                restore_rollback,
                                                run_supervised_loop,
                                                save_checkpoint, say,
                                                setup_run, step_rng)
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.data.images import load_image_batch
from dalle_pytorch_tpu_torch.models import clip as C
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.parallel.train import (clip_loss_fn,
                                                    make_train_step,
                                                    setup_sharded)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="train CLIP (PyTorch port of DALLE-pytorch)")
    add_common_args(p, default_batch=32)
    p.add_argument("--dataPath", type=str, default="./imagedata")
    p.add_argument("--imageSize", type=int, default=256)
    p.add_argument("--captions_only", type=str,
                   default="od-captionsonly.txt")
    p.add_argument("--captions", type=str, default="od-captions.txt")
    p.add_argument("--load_clip", type=str, default="",
                   help="checkpoint path or name to continue training")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--dim_text", type=int, default=512)
    p.add_argument("--dim_image", type=int, default=512)
    p.add_argument("--dim_latent", type=int, default=512)
    p.add_argument("--num_text_tokens", type=int, default=10000)
    p.add_argument("--text_seq_len", type=int, default=256)
    p.add_argument("--text_enc_depth", type=int, default=6)
    p.add_argument("--text_heads", type=int, default=8)
    p.add_argument("--visual_enc_depth", type=int, default=6)
    p.add_argument("--visual_heads", type=int, default=8)
    p.add_argument("--visual_patch_size", type=int, default=32)
    p.add_argument("--dense", action="store_true",
                   help="dense attention (default mirrors the reference "
                        "Transformer default sparse_attn=True)")
    p.add_argument("--param_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.set_defaults(name="clip")
    return p


def main(argv=None, *, device=None):
    args = build_parser().parse_args(argv)
    device, mesh, metrics, profiler = setup_run(args, unit_name="pairs",
                                                device=device)

    cfg = C.CLIPConfig(
        dim_text=args.dim_text, dim_image=args.dim_image,
        dim_latent=args.dim_latent, num_text_tokens=args.num_text_tokens,
        text_seq_len=args.text_seq_len, text_enc_depth=args.text_enc_depth,
        text_heads=args.text_heads, visual_enc_depth=args.visual_enc_depth,
        visual_heads=args.visual_heads, visual_image_size=args.imageSize,
        visual_patch_size=args.visual_patch_size,
        sparse_attn=not args.dense)

    vocab, dataset = load_caption_dataset(args, mesh)
    key = prng.prng_key(args.seed, device=device)

    plan = plan_resume(args, args.name, explicit=args.load_clip,
                       steps_per_epoch=len(dataset))
    start_epoch = plan["start_epoch"] if plan else args.start_epoch
    resume_path = plan["path"] if plan else None
    sched = resolve_schedule(args, steps_per_epoch=len(dataset),
                             start_epoch=start_epoch,
                             resume_meta=plan["meta"] if plan else None)
    if resume_path:
        params, manifest = ckpt.restore_params(resume_path)
        cfg = ckpt.clip_config_from_manifest(manifest)
        model = from_jax.clip_from_jax(params, cfg, device=device)
        say(f"resumed CLIP from {resume_path}")
        if plan["mid_epoch"]:
            metrics.resilience("resume", checkpoint=resume_path,
                               epoch=start_epoch,
                               step_in_epoch=plan["step_in_epoch"],
                               records_in_epoch=plan["skip_batches"],
                               global_step=plan["global_step"])
    else:
        model = C.clip_init(cfg, seed=args.seed, device=device,
                            dtype=getattr(torch, args.param_dtype))
    optimizer = make_optimizer(args, model.parameters(), schedule=sched)
    if resume_path:
        ckpt.restore_opt_state(resume_path, optimizer, model)
    setup_sharded(model, optimizer, mesh)
    step = make_train_step(clip_loss_fn(mesh), optimizer,
                           grad_accum=args.grad_accum, mesh=mesh)
    ema, ema_update = make_ema(args, model, resume_path or "")

    def load_batch(item):
        paths, toks = item
        images = load_image_batch(paths, args.dataPath, args.imageSize)
        return {"text": toks, "images": images,
                "mask": np.asarray(toks) != 0}          # PAD = 0

    state = LoopState(epoch=start_epoch,
                      global_step=plan["global_step"] if plan else 0)

    def ema_meta():
        return {"ema_decay": args.ema_decay} if ema is not None else {}

    def save_state(path):
        return save_checkpoint(
            path, model, optimizer, ema, mesh=mesh, step=state.global_step,
            config=cfg, kind="clip",
            meta={"epoch": state.epoch, "step_in_epoch": state.epoch_i,
                  "global_step": state.global_step,
                  "records_in_epoch": state.records_in_epoch,
                  "train_loss": state.train_loss,
                  "n_batches": state.n_batches, "lr_schedule": sched,
                  **ema_meta()})

    sup = make_supervisor(args, metrics, args.name, save_state)
    if resume_path:
        sup.register_checkpoint(resume_path)

    def train_step(batch, state):
        batch = sup.pre_step(state.global_step, batch)
        loss = step(model, batch, step_rng(key, state.global_step))
        if ema is not None:
            ema_update(ema, model)
        return loss, None

    def on_rollback(state):
        restore_rollback(sup, model, optimizer, ema, mesh)

    def on_epoch_end(state, avg):
        epoch = state.epoch
        path = save_checkpoint(
            ckpt.ckpt_path(args.models_dir, args.name, epoch), model,
            optimizer, ema, mesh=mesh, step=epoch, config=cfg, kind="clip",
            meta={"epoch": epoch, "avg_loss": avg,
                  "global_step": state.global_step, "lr_schedule": sched,
                  **ema_meta()})
        metrics.event(event="checkpoint", path=path, epoch=epoch,
                      avg_loss=avg)
        return path

    run_supervised_loop(
        args, sup=sup, metrics=metrics, profiler=profiler, dataset=dataset,
        plan=plan, state=state, train_step=train_step,
        on_rollback=on_rollback, on_epoch_end=on_epoch_end, device=device,
        transform=load_batch, units_of=lambda item: args.batchSize,
        unit_name="pairs")


if __name__ == "__main__":
    main()
