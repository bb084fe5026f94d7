"""DALLE training CLI — the reference trainDALLE.py, on the card.

Port of ``dalle_pytorch_tpu/cli/train_dalle.py`` (``main`` ``:151-364``),
with its flags and defaults: the VAE restored from its checkpoint
(``{models_dir}/{vaename}-{vae_epoch}``, written by either package's
``train_vae``), a fresh DALLE with its image embedding tied to the VAE's
codebook, the vocabulary built from the captions-only corpus and saved
as ``{name}-vocab.json``, (image, padded caption) minibatches with an
all-True text mask, images tokenised by the frozen VAE encoder outside
the step, ``--caption_drop`` (a null caption drawn per sample with
``bernoulli(fold_in(rng, 0x0CFD))``, JAX's mask bit for bit), Adam, the
EMA, per-epoch checkpoints ``{name}_dalle-{epoch}`` and a sample grid
every ``--sample_every`` epochs through ``generate_images``.

``--attn_impl flash`` runs the flash forward kernel (K1) and
``--attn_bwd_impl pallas`` / ``pallas_fused`` its split (K2a, K2b) or
fused backward kernels; ``--sparse_attn --sparse_impl pallas`` the
block-sparse kernel (K3).

Across processes (``--coordinator``/``--num_processes``/``--process_id``
or torchrun's environment; ``cli/common.py::setup_run``) each rank reads
the caption pairs of its ``dp`` coordinate and trains on the mesh:
``--sp`` splits the sequence (``parallel/sequence.py``, ring or Ulysses
by ``--sp_impl``), ``--pp`` the layers into stages
(``parallel/pipeline.py``, ``--pp_microbatches``), the rest is data
parallel; the primary rank writes the checkpoints, the vocabulary and
the samples. ``--caption_drop`` is refused with ``--sp``/``--pp``, as in
JAX.

Run: python -m dalle_pytorch_tpu_torch.cli.train_dalle --dataPath \
        ./imagedata --captions_only od-captionsonly.txt --captions \
        od-captions.txt
``main(argv, device="cpu")`` runs on the CPU; the card is the default.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

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
from dalle_pytorch_tpu_torch.data.images import (load_image_batch,
                                                 save_image_grid)
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as V
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.parallel.mesh import shard_batch
from dalle_pytorch_tpu_torch.parallel.multihost import fetch_local, is_primary
from dalle_pytorch_tpu_torch.parallel.pipeline import (pp_dalle_loss_fn,
                                                       pp_param_specs)
from dalle_pytorch_tpu_torch.parallel.sequence import sp_dalle_loss_fn
from dalle_pytorch_tpu_torch.parallel.train import (make_train_step,
                                                    setup_sharded)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="train DALLE (PyTorch port of DALLE-pytorch)")
    add_common_args(p, default_batch=24)
    p.add_argument("--dataPath", type=str, default="./imagedata")
    p.add_argument("--imageSize", type=int, default=256)
    p.add_argument("--captions_only", type=str,
                   default="od-captionsonly.txt",
                   help="captions corpus, one per line (builds the vocab)")
    p.add_argument("--captions", type=str, default="od-captions.txt",
                   help="'filename : caption' pairs file")
    p.add_argument("--vaename", type=str, default="vae",
                   help="VAE checkpoint experiment name")
    p.add_argument("--vae_epoch", type=int, default=0,
                   help="VAE checkpoint epoch to load")
    p.add_argument("--load_dalle", type=str, default="",
                   help="DALLE checkpoint (path or name) to continue from")
    p.add_argument("--sample_every", type=int, default=1,
                   help="generate a sample grid every N epochs (0 = never)")
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--dim_head", type=int, default=64)
    p.add_argument("--num_text_tokens", type=int, default=10000)
    p.add_argument("--text_seq_len", type=int, default=256)

    def _prob(v):
        v = float(v)
        if not 0.0 <= v <= 1.0:
            raise argparse.ArgumentTypeError(
                f"must be a probability in [0, 1], got {v}")
        return v

    p.add_argument("--caption_drop", type=_prob, default=0.0,
                   help="per-sample probability of replacing the caption "
                        "with the all-PAD null caption during training — "
                        "enables classifier-free guidance at generation "
                        "time (gen_dalle --guidance)")
    p.add_argument("--attn_dropout", type=float, default=0.1)
    p.add_argument("--ff_dropout", type=float, default=0.1)
    p.add_argument("--reversible", action="store_true")
    p.add_argument("--sparse_attn", action="store_true",
                   help="alternate sparse/dense attention layers")
    p.add_argument("--attn_impl", type=str, default="xla",
                   choices=["xla", "flash"],
                   help="'flash' runs the flash forward kernel K1")
    p.add_argument("--attn_bwd_impl", type=str, default="xla",
                   choices=["xla", "pallas", "pallas_fused"],
                   help="flash backward: the plain blockwise one, the "
                        "split kernels (K2a dq, K2b dk/dv) or the fused "
                        "kernel")
    p.add_argument("--sparse_impl", type=str, default="windowed",
                   choices=["ref", "windowed", "pallas"],
                   help="'pallas' runs the block-sparse kernel K3")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="replace every FF with a top-k MoE of this many "
                        "experts (0 = plain GEGLU)")
    p.add_argument("--moe_k", type=int, default=2)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over this many microbatches "
                        "per optimizer step (batchSize must divide)")
    p.add_argument("--sp", type=int, default=0,
                   help="sequence-parallel mesh axis size (ranks split "
                        "dp x sp; the token axis shards over sp with ring "
                        "or Ulysses attention; dropout uses per-position "
                        "keys)")
    p.add_argument("--sp_impl", default="ring", choices=["ring", "ulysses"])
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline-parallel stage count (ranks split dp x "
                        "pp; depth/pp consecutive layers per stage, GPipe "
                        "microbatching)")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="microbatches per pipeline step (default = --pp)")
    p.add_argument("--param_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="dtype for NEW runs' params (resumed runs keep "
                        "the checkpoint's dtype)")
    p.add_argument("--loss_chunk", type=int, default=0,
                   help="stream the CE head over sequence chunks of this "
                        "size (0 = dense)")
    p.add_argument("--remat", default="none",
                   choices=["none", "save_ln", "dots", "full"],
                   help="recompute parts of each layer in the backward "
                        "instead of keeping them")
    p.set_defaults(name="test")
    return p


def caption_dropped(text: torch.Tensor, rng: torch.Tensor,
                    p: float) -> torch.Tensor:
    """``text`` with each row replaced by the all-PAD null caption with
    probability ``p``, drawn as JAX's step draws it."""
    shape = (text.shape[0], 1)
    drop = prng.bernoulli(prng.fold_in(rng, 0x0CFD), p, shape,
                          prng.row_offset(shape))
    return torch.where(drop, torch.zeros_like(text), text)


def main(argv=None, *, device=None):
    args = build_parser().parse_args(argv)
    if args.caption_drop > 0 and (args.sp > 1 or args.pp > 1):
        raise SystemExit("--caption_drop is supported on the dense path "
                         "only (not --sp/--pp)")
    device, mesh, metrics, profiler = setup_run(args, device=device)

    # the VAE (frozen tokenizer and decoder): the cross-CLI contract
    vae_path = ckpt.ckpt_path(args.models_dir, args.vaename, args.vae_epoch)
    say(f"loading VAE from {vae_path}")
    vae_params, vae_manifest = ckpt.restore_params(vae_path)
    vae_cfg = ckpt.vae_config_from_manifest(vae_manifest)
    vae = from_jax.discrete_vae_from_jax(vae_params, vae_cfg, device=device)
    vae.requires_grad_(False)

    sparse = (True, False) * (args.depth // 2) if args.sparse_attn else False
    cfg = D.DALLEConfig(
        dim=args.dim, depth=args.depth, vae=vae_cfg,
        num_text_tokens=args.num_text_tokens,
        text_seq_len=args.text_seq_len, heads=args.heads,
        dim_head=args.dim_head, reversible=args.reversible,
        attn_dropout=args.attn_dropout, ff_dropout=args.ff_dropout,
        sparse_attn=sparse, attn_impl=args.attn_impl,
        attn_bwd_impl=args.attn_bwd_impl,
        moe_experts=args.moe_experts, moe_k=args.moe_k,
        sparse_impl=args.sparse_impl, loss_chunk=args.loss_chunk,
        remat=args.remat)

    # data first: the cosine schedule's default horizon is the requested
    # run length, n_epochs x steps/epoch
    vocab, dataset = load_caption_dataset(args, mesh)
    key = prng.prng_key(args.seed, device=device)

    ckpt_name = f"{args.name}_dalle"
    explicit = ""
    if args.load_dalle:
        explicit = args.load_dalle if os.path.isdir(args.load_dalle) \
            else f"{args.load_dalle}_dalle"
    plan = plan_resume(args, ckpt_name, explicit=explicit,
                       steps_per_epoch=len(dataset))
    start_epoch = plan["start_epoch"] if plan else args.start_epoch
    resume_path = plan["path"] if plan else None
    sched = resolve_schedule(args, steps_per_epoch=len(dataset),
                             start_epoch=start_epoch,
                             resume_meta=plan["meta"] if plan else None)
    if resume_path:
        params, manifest = ckpt.restore_params(resume_path)
        # remat changes no parameter and no number: the flag applies on
        # resume too
        cfg = dataclasses.replace(ckpt.dalle_config_from_manifest(manifest),
                                  remat=args.remat)
        model = from_jax.dalle_from_jax(params, cfg, device=device)
        say(f"resumed DALLE from {resume_path}")
        if plan["mid_epoch"]:
            metrics.resilience("resume", checkpoint=resume_path,
                               epoch=start_epoch,
                               step_in_epoch=plan["step_in_epoch"],
                               records_in_epoch=plan["skip_batches"],
                               global_step=plan["global_step"])
    else:
        # the image embedding tied to the VAE codebook
        model = D.dalle_init(cfg, seed=args.seed, vae=vae, device=device,
                             dtype=getattr(torch, args.param_dtype))
    optimizer = make_optimizer(args, model.parameters(), schedule=sched)
    if resume_path:
        ckpt.restore_opt_state(resume_path, optimizer, model)
    param_specs = None
    if args.pp > 1:
        # each stage stores only its depth/pp layers (plus the embeddings
        # and the head, held on every stage)
        if cfg.depth % args.pp:
            raise SystemExit(f"--pp {args.pp} must divide depth {cfg.depth}")
        param_specs = pp_param_specs(model)
    setup_sharded(model, optimizer, mesh, param_specs)

    def load_batch(item):
        paths, toks = item
        images = load_image_batch(paths, args.dataPath, args.imageSize)
        return {"text": toks, "images": images}

    caption_drop = args.caption_drop

    def loss_fn(model, batch, rng):
        # the all-True mask of the reference's training call; image ids
        # are computed before the step
        text = batch["text"]
        if caption_drop > 0:
            text = caption_dropped(text, rng, caption_drop)
        return D.dalle_apply(model, text, batch["image"],
                             mask=torch.ones_like(text, dtype=torch.bool),
                             rng=rng, train=True, return_loss=True)

    if args.sp > 1:
        loss_fn = sp_dalle_loss_fn(mesh, impl=args.sp_impl)
    elif args.pp > 1:
        loss_fn = pp_dalle_loss_fn(
            mesh, num_microbatches=args.pp_microbatches or None)
    step = make_train_step(loss_fn, optimizer, grad_accum=args.grad_accum,
                           mesh=mesh, param_specs=param_specs)
    ema, ema_update = make_ema(args, model, resume_path or "")

    state = LoopState(epoch=start_epoch,
                      global_step=plan["global_step"] if plan else 0)

    def ema_meta():
        return {"ema_decay": args.ema_decay} if ema is not None else {}

    def save_state(path):
        return save_checkpoint(
            path, model, optimizer, ema, mesh=mesh, param_specs=param_specs,
            step=state.global_step, config=cfg, kind="dalle",
            meta={"epoch": state.epoch, "step_in_epoch": state.epoch_i,
                  "global_step": state.global_step,
                  "records_in_epoch": state.records_in_epoch,
                  "train_loss": state.train_loss,
                  "n_batches": state.n_batches, "vae_checkpoint": vae_path,
                  "vocab_words": len(vocab), "lr_schedule": sched,
                  **ema_meta()})

    sup = make_supervisor(args, metrics, ckpt_name, save_state)
    if resume_path:
        sup.register_checkpoint(resume_path)

    def train_step(hosted, state):
        image_ids = V.get_codebook_indices(vae, hosted["images"])
        # each rank read its own rows (load_caption_dataset)
        batch = shard_batch(mesh, {"text": hosted["text"],
                                   "image": image_ids}, local=True)
        batch = sup.pre_step(state.global_step, batch)
        loss = step(model, batch, step_rng(key, state.global_step))
        if ema is not None:
            ema_update(ema, model)
        return loss, batch["text"]

    def on_rollback(state):
        restore_rollback(sup, model, optimizer, ema, mesh, param_specs)

    def on_epoch_end(state, avg):
        epoch = state.epoch
        path = save_checkpoint(
            ckpt.ckpt_path(args.models_dir, ckpt_name, epoch), model,
            optimizer, ema, mesh=mesh, param_specs=param_specs, step=epoch,
            config=cfg, kind="dalle",
            meta={"epoch": epoch, "avg_loss": avg,
                  "global_step": state.global_step,
                  "vae_checkpoint": vae_path, "vocab_words": len(vocab),
                  "lr_schedule": sched, **ema_meta()})
        metrics.event(event="checkpoint", path=path, epoch=epoch,
                      avg_loss=avg)

        if args.sample_every and (epoch + 1) % args.sample_every == 0 \
                and state.last is not None:
            # sample from the last minibatch's captions, gathered over dp;
            # a resume landing on the epoch boundary has no batch in hand.
            # A pipeline's stages hold part of the stack: the samples need
            # it whole, so they are skipped under --pp
            texts = torch.as_tensor(fetch_local(state.last,
                                                mesh.group("dp")))
            if is_primary() and args.pp <= 1:
                k = min(4, texts.shape[0])
                images = D.generate_images(
                    model, vae, texts[:k].to(device),
                    rng=prng.fold_in(key, 10_000 + epoch))
                out = os.path.join(args.results_dir,
                                   f"{args.name}_dalle_epoch_{epoch}.png")
                save_image_grid(images, out, nrow=k)
                metrics.event(event="sample", path=out, epoch=epoch)
        return path

    run_supervised_loop(
        args, sup=sup, metrics=metrics, profiler=profiler, dataset=dataset,
        plan=plan, state=state, train_step=train_step,
        on_rollback=on_rollback, on_epoch_end=on_epoch_end, device=device,
        transform=load_batch,
        units_of=lambda item: args.batchSize * cfg.seq_len)


if __name__ == "__main__":
    main()
