"""Serving CLI: the continuous-batching engine behind an HTTP front end,
on the card.

Port of ``dalle_pytorch_tpu/cli/serve.py`` (``build_parser`` ``:31-371``,
flag for flag with the same defaults; ``main`` ``:382-587``). The
checkpoints load as ``gen_dalle`` loads them: the DALLE checkpoint
``{models_dir}/{name}_dalle-{dalle_epoch}`` (either package's) and the
VAE its ``meta.vae_checkpoint`` names, ``--use_ema``, ``--quantize
int8|int8_kv``, the vocabulary (``{name}-vocab.json`` or
``--captions_only``) and an optional ``--clip_name`` CLIP that scores
every image. Then ``serve/server.py``'s ``InferenceServer`` starts on one
engine and ``serve_http`` answers until Ctrl-C.

The fleet flags (more than one replica, replica roles, a device mesh,
process isolation, the socket transport and its workers, the autoscaler,
the gateway, its cells and tenants) end in ``SystemExit``: the port
serves one engine on one device (ROADMAP.md queue 1 items 5 and 6).

Run: python -m dalle_pytorch_tpu_torch.cli.serve --name test \\
        --dalle_epoch 99 --kv paged --paged_attn kernel --port 8000
Then: curl -s localhost:8000/generate -d '{"caption": "a flower"}'
      curl -s localhost:8000/stats
``main(argv, device="cpu")`` serves from the CPU; the card is the default.
"""

from __future__ import annotations

import argparse
import os

from dalle_pytorch_tpu_torch import checkpoint as ckpt
from dalle_pytorch_tpu_torch.cli.common import say
from dalle_pytorch_tpu_torch.cli.gen_dalle import _ema_weights
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.data.captions import read_captions_only
from dalle_pytorch_tpu_torch.data.vocabulary import Vocabulary
from dalle_pytorch_tpu_torch.device import resolve_device
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.utils.metrics import MetricsLogger

FLEET = ("ROADMAP.md queue 1 items 5 (the fleet tier) and 6 "
         "(parallel/ on torch.distributed)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="serve text->image generation (continuous batching; "
                    "PyTorch port of DALLE-pytorch)")
    a = p.add_argument
    a("--name", type=str, default="test",
      help="DALLE experiment name (as given to train_dalle)")
    a("--dalle_epoch", type=int, default=0)
    a("--models_dir", type=str, default="./models")
    a("--vocab", type=str, default="",
      help="vocab JSON (default: {models_dir}/{name}-vocab.json)")
    a("--captions_only", type=str, default="",
      help="rebuild vocab from this corpus instead")
    a("--clip_name", type=str, default="",
      help="CLIP checkpoint name for result scoring")
    a("--clip_epoch", type=int, default=0)
    a("--use_ema", action="store_true",
      help="serve the checkpoint's EMA weights")
    a("--quantize", choices=("none", "int8", "int8_kv"), default="none",
      help="int8 transformer/head weights; int8_kv also stores the KV "
           "cache int8")
    a("--num_slots", type=int, default=4,
      help="decode slots: the fixed batch every decode step advances")
    a("--chunk_steps", type=int, default=8,
      help="decode steps a chunk (K): the host reads the emitted tokens "
           "once per K steps, and a finishing request waits up to K-1 "
           "extra steps")
    a("--prefill_buckets", type=str, default="",
      help="comma list of prompt-length buckets admission pads up to "
           "(must end at text_seq_len); default: powers of two")
    a("--kv", choices=("dense", "paged"), default="dense",
      help="KV layout: 'dense' holds num_slots x seq_len rows; 'paged' a "
           "shared page pool through per-slot block tables")
    a("--page_size", type=int, default=0,
      help="rows per KV page (paged; 0 = 16)")
    a("--paged_attn", choices=("gather", "kernel"), default="gather",
      help="paged K/V read: 'gather' through a dense view (the oracle), "
           "'kernel' in place through kernel K4 (page_size a multiple "
           "of 8)")
    a("--sparse_reads", action="store_true",
      help="sparse layers read only their visible pages (K4's visible "
           "walk; --kv paged and a model with sparse layers)")
    a("--speculative", type=int, default=0,
      help="draft-and-verify with k tokens a round (0 = off)")
    a("--draft_layers", type=int, default=0,
      help="draft depth for --speculative (0 = depth/2)")
    a("--prefix_cache", action="store_true",
      help="share prompt pages across requests, copy-on-write (--kv "
           "paged)")
    a("--cfg_scale", type=float, default=0.0,
      help="default classifier-free guidance scale for requests that "
           "carry none (0 = unguided); a guided request runs a cond/"
           "uncond slot pair")
    a("--num_pages", type=int, default=0,
      help="pages in the pool incl. the trash page (paged; 0 = num_slots "
           "x ceil(seq_len/page_size) + 1); fewer evict")
    a("--replicas", type=int, default=1,
      help="engine replicas (not in the port: one engine)")
    a("--replica_roles", type=str, default="",
      help="per-replica roles (not in the port)")
    a("--mesh_devices", type=int, default=1,
      help="devices per engine (not in the port: one device)")
    a("--worker_ckpt", type=str, default=None,
      help="socket-transport workers' checkpoint (not in the port)")
    a("--isolation", choices=("thread", "process"), default="thread",
      help="replica isolation ('process' is not in the port)")
    a("--transport", choices=("pipe", "socket"), default="pipe",
      help="process-isolation transport ('socket' is not in the port)")
    a("--worker_endpoint", type=str, default="127.0.0.1:0",
      help="socket-transport listener (not in the port)")
    a("--worker_cmd", type=str, default=None,
      help="socket-transport worker launcher (not in the port)")
    a("--attach_token", type=str, default=None,
      help="socket-transport HELLO token (not in the port)")
    a("--child_rss_limit_mb", type=int, default=0,
      help="process-isolation child RSS limit (not in the port)")
    a("--heartbeat_s", type=float, default=5.0,
      help="replica hang detection (replicas > 1 only)")
    a("--queue_depth", type=int, default=64,
      help="bounded admission queue; submissions past it get a "
           "structured 429")
    a("--preview_every", type=int, default=0,
      help="progressive previews for streamed requests: every N "
           "harvested chunks the postprocess worker decodes the image-"
           "token prefix into a 'preview' SSE frame (0 = tokens only)")
    a("--stream_max_events", type=int, default=256,
      help="per-stream event ring: a consumer this far behind sheds its "
           "oldest token/preview events (a typed 'overflow' event names "
           "the gap)")
    a("--admin_token", type=str, default="",
      help="bearer token of POST /admin/scale and /admin/profile "
           "(default: generated and printed)")
    a("--max_replicas", type=int, default=0,
      help="runtime scale-out cap (not in the port)")
    a("--min_replicas", type=int, default=0,
      help="autoscaler floor (not in the port)")
    a("--autoscale", action="store_true",
      help="the load-driven autoscaler (not in the port)")
    a("--autoscale_high", type=float, default=0.85,
      help="autoscaler: occupancy that scales out")
    a("--autoscale_low", type=float, default=0.25,
      help="autoscaler: occupancy that scales in")
    a("--autoscale_cooldown_s", type=float, default=10.0,
      help="autoscaler: silence after a scale action")
    a("--autoscale_interval_s", type=float, default=1.0,
      help="autoscaler: seconds between ticks")
    a("--gateway", action="store_true",
      help="the multi-cell gateway (not in the port)")
    a("--cells", type=int, default=2,
      help="gateway cells (not in the port)")
    a("--tenants", type=str, default="",
      help="gateway tenant JSON (not in the port)")
    a("--host", type=str, default="127.0.0.1")
    a("--port", type=int, default=8000)
    a("--metrics", type=str, default="",
      help="JSONL metrics file (engine stats + structured serve events)")
    a("--profile_dir", type=str, default="",
      help="default directory of POST /admin/profile: a torch.profiler "
           "capture of the next K decode chunks (Chrome trace); a "
           "capture in flight is a typed 409")
    a("--log_every", type=int, default=50,
      help="emit an engine-stats record every N decode steps")
    a("--init_deadline_s", type=float, default=300.0,
      help="bound each device-claim attempt (0 = unbounded), with "
           "backoff+jitter retries")
    a("--init_retries", type=int, default=3)
    return p


def refuse_fleet(args) -> None:
    """``SystemExit`` naming every fleet flag given."""
    defaults = build_parser().parse_args([])
    bad = [flag for flag, on in (
        ("--replicas", args.replicas > 1),
        ("--replica_roles", bool(args.replica_roles)),
        ("--mesh_devices", args.mesh_devices > 1),
        ("--isolation process", args.isolation == "process"),
        ("--transport socket", args.transport == "socket"),
        ("--worker_ckpt", args.worker_ckpt is not None),
        ("--worker_endpoint",
         args.worker_endpoint != defaults.worker_endpoint),
        ("--worker_cmd", args.worker_cmd is not None),
        ("--attach_token", args.attach_token is not None),
        ("--child_rss_limit_mb", args.child_rss_limit_mb > 0),
        ("--autoscale", args.autoscale),
        ("--max_replicas", args.max_replicas > 1),
        ("--min_replicas", args.min_replicas > 0),
        ("--gateway", args.gateway),
        ("--cells", args.cells != defaults.cells),
        ("--tenants", bool(args.tenants))) if on]
    if bad:
        raise SystemExit(
            f"{', '.join(bad)}: not in the PyTorch port yet — it serves "
            f"one engine on one device; see {FLEET}")


def load_vocab(args) -> Vocabulary:
    if args.captions_only:
        return Vocabulary.from_captions(read_captions_only(
            args.captions_only))
    path = args.vocab or os.path.join(args.models_dir,
                                      f"{args.name}-vocab.json")
    return Vocabulary.load(path)


def main(argv=None, *, device=None):
    args = build_parser().parse_args(argv)
    refuse_fleet(args)
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
                "to serve an EMA")
        say("serving EMA weights")
    if args.quantize in ("int8", "int8_kv"):
        model = D.quantize_for_decode(model)

    clip = None
    if args.clip_name:
        clip_path = ckpt.ckpt_path(args.models_dir, args.clip_name,
                                   args.clip_epoch)
        clip_params, clip_manifest = ckpt.restore_params(clip_path)
        clip = from_jax.clip_from_jax(
            clip_params, ckpt.clip_config_from_manifest(clip_manifest),
            device=device)

    vocab = load_vocab(args)
    metrics = MetricsLogger(args.metrics) if args.metrics else None

    from dalle_pytorch_tpu_torch.serve.server import (InferenceServer,
                                                      serve_http)
    buckets = None
    if args.prefill_buckets:
        try:
            buckets = [int(b) for b in args.prefill_buckets.split(",")]
        except ValueError:
            raise SystemExit(f"--prefill_buckets must be comma-separated "
                             f"ints, got {args.prefill_buckets!r}")
    server = InferenceServer(
        model, vae, clip=clip, num_slots=args.num_slots,
        queue_depth=args.queue_depth, chunk_steps=args.chunk_steps,
        prefill_buckets=buckets,
        quantize_cache=args.quantize == "int8_kv",
        kv=args.kv, page_size=args.page_size, num_pages=args.num_pages,
        paged_attn=args.paged_attn, sparse_reads=args.sparse_reads,
        speculative=args.speculative, draft_layers=args.draft_layers,
        prefix_cache=args.prefix_cache,
        default_cfg_scale=args.cfg_scale,
        preview_every=args.preview_every,
        stream_max_events=args.stream_max_events,
        weights_version=f"{args.name}_dalle@{args.dalle_epoch}",
        admin_token=args.admin_token or None,
        metrics=metrics, log_every=args.log_every, encode=vocab.encode,
        profile_dir=args.profile_dir or None,
        init_deadline_s=args.init_deadline_s,
        init_retries=args.init_retries, device=device).start()

    kv_desc = args.kv if args.kv == "dense" \
        else f"{args.kv}/{args.paged_attn}" \
        + ("/sparse_reads" if args.sparse_reads else "") \
        + ("/prefix_cache" if args.prefix_cache else "")
    if args.speculative:
        kv_desc += (f", speculative k={args.speculative}"
                    f"/d={args.draft_layers or 'depth/2'}")
    if args.cfg_scale > 0:
        kv_desc += f", cfg_scale={args.cfg_scale:g}"
    say(f"serving {dalle_path} on http://{args.host}:{args.port} "
        f"({device}, {args.num_slots} slots, K={args.chunk_steps}, "
        f"kv={kv_desc}, queue {args.queue_depth})")
    prof_desc = (f"; POST /admin/profile -> {args.profile_dir}"
                 if args.profile_dir else "")
    say(f"observability: GET /metrics (Prometheus exposition), "
        f"GET /debug/events (flight recorder), per-request trace "
        f"summaries on every result{prof_desc}; admin token "
        f"{server.admin_token}")
    serve_http(server, args.host, args.port)
    return server


if __name__ == "__main__":
    main()
