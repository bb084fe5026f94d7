"""DiscreteVAE training CLI — the reference trainVAE.py, on the card.

Port of ``dalle_pytorch_tpu/cli/train_vae.py``, with its flags and
defaults: Adam, loss = smooth_l1 + mse (``parallel/train.py::
vae_loss_fn(smooth_l1=True)``), the optional per-step weight clamp
(``--clip``), the per-epoch temperature decay ``0.7 ** (1/len(loader))``
(``--tempsched``, resumed from the checkpoint's ``meta.temperature``),
per-epoch [input | recon | decode(argmax codes)] grids, and per-epoch
checkpoints under ``{models_dir}/{name}-{epoch}`` that the JAX package
reads as its own. Batches are decoded on the prefetch thread and copied
to the device there. Across processes (``cli/common.py::setup_run``)
each rank reads the image files of its ``dp`` coordinate and the step
is data parallel; the primary rank writes the grids and checkpoints.

Run: python -m dalle_pytorch_tpu_torch.cli.train_vae --dataPath ./imagedata
``main(argv, device="cpu")`` runs on the CPU; the card is the default.
"""

from __future__ import annotations

import argparse
import os

import torch

from dalle_pytorch_tpu_torch import checkpoint as ckpt
from dalle_pytorch_tpu_torch.cli.common import (LoopState, add_common_args,
                                                make_ema, make_optimizer,
                                                make_supervisor, plan_resume,
                                                resolve_schedule,
                                                restore_rollback,
                                                run_supervised_loop,
                                                save_checkpoint, say,
                                                setup_run, step_rng)
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.data.images import (ImageFolderDataset,
                                                 save_image_grid)
from dalle_pytorch_tpu_torch.models import vae as V
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.data.prefetch import shard_for_host
from dalle_pytorch_tpu_torch.parallel.multihost import is_primary
from dalle_pytorch_tpu_torch.parallel.train import (make_train_step,
                                                    setup_sharded,
                                                    vae_loss_fn)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="train DiscreteVAE (PyTorch port of DALLE-pytorch)")
    add_common_args(p, default_batch=24)
    p.add_argument("--dataPath", type=str, default="./imagedata",
                   help="path to image folder (default: ./imagedata)")
    p.add_argument("--imageSize", type=int, default=256)
    p.add_argument("--tempsched", action="store_true", default=False,
                   help="use temperature scheduling")
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--loadVAE", type=str, default="",
                   help="checkpoint path (or name with --start_epoch) to "
                        "continue training")
    p.add_argument("--clip", type=float, default=0,
                   help="clamp weights to [-clip, clip], 0 = off")
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--num_tokens", type=int, default=2048)
    p.add_argument("--codebook_dim", type=int, default=256)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--num_resnet_blocks", type=int, default=0)
    p.add_argument("--straight_through", action="store_true")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over this many microbatches "
                        "per optimizer step (batchSize must divide)")
    p.add_argument("--param_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="dtype for NEW runs' params (resumed runs keep the "
                        "checkpoint's dtype)")
    p.set_defaults(name="vae")
    return p


def make_step(cfg: V.VAEConfig, optimizer, clip: float,
              grad_accum: int = 1, mesh=None):
    """``step(vae, batch{'images', 'temperature'}, rng) -> loss``: the
    training scripts' loss at the batch's temperature, one Adam update
    (scaled by an optional ``batch['lr_scale']``), then the optional
    weight clamp to [-clip, clip]."""

    def loss_fn(vae, batch, rng):
        return vae_loss_fn(cfg, smooth_l1=True,
                           temperature=batch["temperature"])(vae, batch, rng)

    train_step = make_train_step(loss_fn, optimizer, grad_accum=grad_accum,
                                 mesh=mesh)

    def step(vae, batch, rng):
        loss = train_step(vae, batch, rng)
        if clip > 0:
            with torch.no_grad():
                for p in vae.parameters():
                    p.clamp_(-clip, clip)
        return loss

    return step


def main(argv=None, *, device=None):
    args = build_parser().parse_args(argv)
    device, mesh, metrics, profiler = setup_run(args, unit_name="images",
                                                device=device)

    cfg = V.VAEConfig(
        image_size=args.imageSize, num_tokens=args.num_tokens,
        codebook_dim=args.codebook_dim, num_layers=args.num_layers,
        num_resnet_blocks=args.num_resnet_blocks,
        hidden_dim=args.hidden_dim, temperature=args.temperature,
        straight_through=args.straight_through)

    dataset = ImageFolderDataset(args.dataPath, args.imageSize,
                                 args.batchSize, shuffle=True,
                                 seed=args.seed)
    # each rank reads its dp coordinate's slice of the files
    dataset.files = list(shard_for_host(dataset.files, mesh=mesh))
    key = prng.prng_key(args.seed, device=device)

    temperature = args.temperature
    # the resume point before the optimizer: the cosine horizon covers
    # the completed epochs too
    plan = plan_resume(args, args.name, explicit=args.loadVAE,
                       steps_per_epoch=len(dataset))
    start_epoch = plan["start_epoch"] if plan else args.start_epoch
    resume_path = plan["path"] if plan else None
    sched = resolve_schedule(args, steps_per_epoch=len(dataset),
                             start_epoch=start_epoch,
                             resume_meta=plan["meta"] if plan else None)
    if resume_path:
        params, manifest = ckpt.restore_params(resume_path)
        cfg = ckpt.vae_config_from_manifest(manifest)
        vae = from_jax.discrete_vae_from_jax(params, cfg, device=device)
        temperature = manifest["meta"].get("temperature", temperature)
        say(f"resumed VAE from {resume_path}")
        if plan["mid_epoch"]:
            metrics.resilience("resume", checkpoint=resume_path,
                               epoch=start_epoch,
                               step_in_epoch=plan["step_in_epoch"],
                               records_in_epoch=plan["skip_batches"],
                               global_step=plan["global_step"])
    else:
        vae = V.discrete_vae_init(cfg, seed=args.seed, device=device,
                                  dtype=getattr(torch, args.param_dtype))
    optimizer = make_optimizer(args, vae.parameters(), schedule=sched)
    if resume_path:
        ckpt.restore_opt_state(resume_path, optimizer, vae)
    setup_sharded(vae, optimizer, mesh)
    step = make_step(cfg, optimizer, args.clip, grad_accum=args.grad_accum,
                     mesh=mesh)
    ema, ema_update = make_ema(args, vae, resume_path or "")

    dk = 0.7 ** (1.0 / max(len(dataset), 1))
    if args.tempsched:
        say("Scale Factor:", dk)

    state = LoopState(epoch=start_epoch,
                      global_step=plan["global_step"] if plan else 0)

    def ema_meta():
        return {"ema_decay": args.ema_decay} if ema is not None else {}

    def save_state(path):
        """The whole mid-epoch training state: weights, optimizer, EMA,
        schedule and the loop's position and accumulators."""
        return save_checkpoint(
            path, vae, optimizer, ema, mesh=mesh, step=state.global_step,
            config=cfg, kind="vae",
            meta={"temperature": temperature, "epoch": state.epoch,
                  "step_in_epoch": state.epoch_i,
                  "global_step": state.global_step,
                  "records_in_epoch": state.records_in_epoch,
                  "train_loss": state.train_loss,
                  "n_batches": state.n_batches, "lr_schedule": sched,
                  **ema_meta()})

    sup = make_supervisor(args, metrics, args.name, save_state)
    if resume_path:
        # the checkpoint just restored is a valid rollback anchor
        sup.register_checkpoint(resume_path)

    def train_step(images, state):
        batch = sup.pre_step(state.global_step,
                             {"images": images, "temperature": temperature})
        loss = step(vae, batch, step_rng(key, state.global_step))
        if ema is not None:
            ema_update(ema, vae)
        return loss, batch

    def on_rollback(state):
        restore_rollback(sup, vae, optimizer, ema, mesh)

    def on_epoch_end(state, avg):
        nonlocal temperature
        epoch = state.epoch
        if args.tempsched:
            temperature *= dk
            say("Current temperature: ", temperature)

        # the epoch's recon grid (input | recon | argmax decode), first 8;
        # a resume landing on the epoch boundary has no batch in hand
        if state.last is not None and is_primary():
            k = min(8, args.batchSize)
            imgs = state.last["images"][:k]
            with torch.no_grad():
                recons = V.vae_apply(vae, imgs, cfg=cfg,
                                     rng=prng.fold_in(key, epoch),
                                     temperature=temperature)
                decoded = V.decode(vae, V.get_codebook_indices(vae, imgs))
            grid = torch.cat([imgs.float(), recons.float(),
                              decoded.float()])
            save_image_grid(grid, os.path.join(
                args.results_dir, f"{args.name}_epoch_{epoch}.png"),
                nrow=k)

        path = save_checkpoint(
            ckpt.ckpt_path(args.models_dir, args.name, epoch), vae,
            optimizer, ema, mesh=mesh, step=epoch, config=cfg, kind="vae",
            meta={"temperature": temperature, "epoch": epoch,
                  "avg_loss": avg, "global_step": state.global_step,
                  "lr_schedule": sched, **ema_meta()})
        metrics.event(event="checkpoint", path=path, epoch=epoch,
                      avg_loss=avg, temperature=temperature)
        return path

    run_supervised_loop(
        args, sup=sup, metrics=metrics, profiler=profiler, dataset=dataset,
        plan=plan, state=state, train_step=train_step,
        on_rollback=on_rollback, on_epoch_end=on_epoch_end, device=device,
        units_of=lambda images: images.shape[0], unit_name="images",
        avg_fmt=".8f")


if __name__ == "__main__":
    main()
