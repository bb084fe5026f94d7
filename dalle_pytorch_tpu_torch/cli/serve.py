"""Serving CLI: the continuous-batching engine behind an HTTP front end,
on the card.

Port of ``dalle_pytorch_tpu/cli/serve.py`` (``build_parser`` ``:31-371``,
flag for flag with the same defaults; ``main`` ``:382-587``). The
checkpoints load as ``gen_dalle`` loads them: the DALLE checkpoint
``{models_dir}/{name}_dalle-{dalle_epoch}`` (either package's) and the
VAE its ``meta.vae_checkpoint`` names, ``--use_ema``, ``--quantize
int8|int8_kv``, the vocabulary (``{name}-vocab.json`` or
``--captions_only``) and an optional ``--clip_name`` CLIP that scores
every image. Then ``serve/server.py``'s ``InferenceServer`` starts, on
one engine or, with ``--replicas N`` (or ``--autoscale``, or
``--max_replicas`` room to grow), on a replica set (``--replica_roles``,
``--heartbeat_s``, ``--min_replicas``, ``--autoscale_*``) of thread
replicas on the one card or, with ``--isolation process``, of child
processes (``--child_rss_limit_mb``): over pipes, or with ``--transport
socket`` dialing back to ``--worker_endpoint`` with ``--attach_token``,
spawned, started by ``--worker_cmd`` or by hand (``--worker_cmd ''``),
optionally loading ``--worker_ckpt`` themselves. ``serve_http`` answers
until Ctrl-C. ``POST /admin/scale`` reshapes a set; its ``upgrade`` op
loads a checkpoint path the way startup loaded the first (``--use_ema``,
``--quantize``), or hands the path to ``--worker_ckpt`` workers.

``--gateway`` builds ``--cells`` such servers (each with the
``--replicas``, ``--isolation`` and ``--transport`` given) behind one
``serve/gateway.py::Gateway``: prefix-affine routing, the tenants of the
``--tenants`` JSON (API keys, rate and page quotas, weighted-fair
queueing, hedge tiers; reloaded by ``POST /admin/tenants``), hedged sends
and cell-down replay; ``serve_gateway_http`` answers. It does not take
``--autoscale``. ``--mesh_devices m`` serves each engine from a mesh of
m devices (``serve/mesh_engine.py``): one engine over the first m cards,
or, with ``--replicas``, each replica a slice of m cards; the DALLE then
loads on the CPU, and each card holds only its shards.

Run: python -m dalle_pytorch_tpu_torch.cli.serve --name test \\
        --dalle_epoch 99 --kv paged --paged_attn kernel --replicas 2 \\
        --isolation process --port 8000
Then: curl -s localhost:8000/generate -d '{"caption": "a flower"}'
      curl -s localhost:8000/stats
A gateway: ... --gateway --cells 2 --tenants tenants.json, then
      curl -s localhost:8000/generate -H 'X-API-Key: KEY' \
           -d '{"codes": [1, 2, 3], "seed": 7}'
A worker started by hand on a ``--transport socket`` server (it prints
the endpoint and token): DALLE_WORKER_TOKEN=<token> python -m \\
dalle_pytorch_tpu_torch.serve.worker --connect HOST:PORT --index N.
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
      help="engine replicas behind one queue, with failover, drain and "
           "live migration: threads on the one card, or child processes "
           "(--isolation process)")
    a("--replica_roles", type=str, default="",
      help="comma list of per-replica roles (prefill, decode, both; "
           "--kv paged)")
    a("--mesh_devices", type=int, default=1,
      help="devices per engine: above 1 one engine spans that many "
           "cards (layers split by depth, the KV pool by heads, tokens "
           "byte-identical to one card's); with --replicas each replica "
           "is a slice of that many cards (replica i gets cards "
           "[i*m, (i+1)*m)); --paged_attn kernel is refused")
    a("--worker_ckpt", type=str, default=None,
      help="socket transport: the workers' spec carries this checkpoint "
           "path ('latest:<models_dir>:<name>' for the newest valid "
           "epoch) instead of the weights; each worker validates and "
           "loads it, then applies --use_ema/--quantize (a bad one: "
           "exit 5 on /healthz)")
    a("--isolation", choices=("thread", "process"), default="thread",
      help="replica isolation (--replicas > 1): 'thread' = replicas in "
           "this process; 'process' = each replica's engine in a spawned "
           "child with its own CUDA context, so a segfault, an OOM kill "
           "or kill -9 of one costs latency on the requests it held "
           "(replayed on a survivor, same tokens), never the server")
    a("--transport", choices=("pipe", "socket"), default="pipe",
      help="process replicas' frames: 'pipe' to spawned children; "
           "'socket' = workers dial back to this server's listener with "
           "an authenticated HELLO (remote workers)")
    a("--worker_endpoint", type=str, default="127.0.0.1:0",
      help="socket transport: HOST:PORT the worker listener binds (port "
           "0 = ephemeral; printed at startup)")
    a("--worker_cmd", type=str, default=None,
      help="socket transport: launcher command a replica, with "
           "{endpoint}, {index} and {token} (the token is also in "
           "DALLE_WORKER_TOKEN); '' launches nothing and waits for "
           "workers started by hand; default: spawn local children "
           "that dial back")
    a("--attach_token", type=str, default=None,
      help="socket transport: the HELLO token (default: generated and "
           "printed)")
    a("--child_rss_limit_mb", type=int, default=0,
      help="process isolation: a child past this RSS exits 137 and is "
           "fenced and replayed like any child death (0 = no limit)")
    a("--heartbeat_s", type=float, default=5.0,
      help="replica hang detection: a replica whose loop is silent this "
           "long is fenced and its requests replay (replica sets only)")
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
      help="runtime scale-out cap of POST /admin/scale and the "
           "autoscaler (0 = --replicas)")
    a("--min_replicas", type=int, default=0,
      help="autoscaler floor (0 = --replicas)")
    a("--autoscale", action="store_true",
      help="the load-driven autoscaler (needs --max_replicas > "
           "--replicas)")
    a("--autoscale_high", type=float, default=0.85,
      help="autoscaler: occupancy that scales out")
    a("--autoscale_low", type=float, default=0.25,
      help="autoscaler: occupancy that scales in")
    a("--autoscale_cooldown_s", type=float, default=10.0,
      help="autoscaler: silence after a scale action")
    a("--autoscale_interval_s", type=float, default=1.0,
      help="autoscaler: seconds between ticks")
    a("--gateway", action="store_true",
      help="the multi-cell gateway: --cells servers (each with the "
           "--replicas/--isolation/--kv/... given here) behind one HTTP "
           "surface with prefix-affine routing, per-tenant quotas, "
           "weighted-fair queueing, hedged sends and cell-down replay")
    a("--cells", type=int, default=2,
      help="gateway mode: the number of cells (each a full server)")
    a("--tenants", type=str, default="",
      help="gateway mode: the tenant JSON (a list of {name, key, weight, "
           "rps, image_tokens_per_s, max_pages, tier, hedge_s}), "
           "reloaded by the authenticated POST /admin/tenants; empty = "
           "the anonymous tenant (no keys, no quotas)")
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


def load_vocab(args) -> Vocabulary:
    if args.captions_only:
        return Vocabulary.from_captions(read_captions_only(
            args.captions_only))
    path = args.vocab or os.path.join(args.models_dir,
                                      f"{args.name}-vocab.json")
    return Vocabulary.load(path)


def load_dalle(path: str, args, device):
    """A DALLE checkpoint (either package's) as the served model: its
    EMA with ``--use_ema``, int8 weights with ``--quantize``. Startup
    loads with it, and so does ``POST /admin/scale``'s upgrade."""
    params, manifest = ckpt.restore_params(path)
    model = from_jax.dalle_from_jax(
        params, ckpt.dalle_config_from_manifest(manifest), device=device)
    if args.use_ema and not _ema_weights(model, path):
        raise FileNotFoundError(
            f"{path} has no EMA weights — train with --ema_decay to serve "
            "an EMA")
    if args.quantize in ("int8", "int8_kv"):
        model = D.quantize_for_decode(model)
    return model, manifest


def main(argv=None, *, device=None):
    args = build_parser().parse_args(argv)
    autoscale = None
    if args.autoscale:
        from dalle_pytorch_tpu_torch.serve.autoscale import AutoscalePolicy
        if args.max_replicas <= args.replicas:
            raise SystemExit(
                "--autoscale needs --max_replicas > --replicas "
                "(headroom for the scaler to grow into)")
        autoscale = AutoscalePolicy(
            min_replicas=args.min_replicas or args.replicas,
            max_replicas=args.max_replicas,
            high_occupancy=args.autoscale_high,
            low_occupancy=args.autoscale_low,
            cooldown_s=args.autoscale_cooldown_s,
            interval_s=args.autoscale_interval_s)
    if args.gateway and args.autoscale:
        raise SystemExit(
            "--gateway does not compose with --autoscale: each cell would "
            "need its own policy; run cells directly to autoscale them")
    device = resolve_device(device)

    dalle_path = ckpt.ckpt_path(args.models_dir, f"{args.name}_dalle",
                                args.dalle_epoch)
    # a mesh places its shards from a host copy: no card holds it whole
    model_device = "cpu" if args.mesh_devices > 1 else device
    model, manifest = load_dalle(dalle_path, args, model_device)
    cfg = model.cfg
    if args.use_ema:
        say("serving EMA weights")
    vae_path = manifest["meta"].get("vae_checkpoint")
    if not vae_path or not os.path.isdir(vae_path):
        raise FileNotFoundError(
            f"DALLE checkpoint {dalle_path} does not point at a VAE "
            "checkpoint (meta.vae_checkpoint)")
    vae_params, vae_manifest = ckpt.restore_params(vae_path)
    vae = from_jax.vae_from_jax(vae_params,
                                ckpt.vae_config_from_manifest(vae_manifest),
                                device=device)

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
    def build_server():
        return InferenceServer(
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
            replicas=args.replicas, mesh_devices=args.mesh_devices,
            replica_roles=(args.replica_roles.split(",")
                           if args.replica_roles else None),
            weights_version=f"{args.name}_dalle@{args.dalle_epoch}",
            # 0 means no growth past --replicas, never "uncapped": every
            # replica holds its own KV pool
            max_replicas=args.max_replicas or args.replicas,
            autoscale=autoscale,
            load_weights=lambda path: load_dalle(path, args,
                                                 model_device)[0],
            heartbeat_s=args.heartbeat_s,
            isolation=args.isolation,
            child_rss_limit_mb=args.child_rss_limit_mb,
            transport=args.transport, worker_endpoint=args.worker_endpoint,
            worker_cmd=args.worker_cmd, attach_token=args.attach_token,
            worker_ckpt=args.worker_ckpt,
            # checkpoint-path workers re-apply the parent's transforms after
            # their own load, so every replica serves the same weights
            worker_use_ema=bool(args.worker_ckpt) and args.use_ema,
            worker_quantize=args.quantize if args.worker_ckpt else "none",
            admin_token=args.admin_token or None,
            metrics=metrics, log_every=args.log_every, encode=vocab.encode,
            profile_dir=args.profile_dir or None,
            init_deadline_s=args.init_deadline_s,
            init_retries=args.init_retries, device=device).start()

    if args.gateway:
        return serve_gateway(args, build_server, cfg)
    server = build_server()
    kv_desc = args.kv if args.kv == "dense" \
        else f"{args.kv}/{args.paged_attn}" \
        + ("/sparse_reads" if args.sparse_reads else "") \
        + ("/prefix_cache" if args.prefix_cache else "")
    if args.speculative:
        kv_desc += (f", speculative k={args.speculative}"
                    f"/d={args.draft_layers or 'depth/2'}")
    if args.cfg_scale > 0:
        kv_desc += f", cfg_scale={args.cfg_scale:g}"
    iso_desc = args.isolation if args.transport == "pipe" \
        else f"{args.isolation}/{args.transport}"
    if args.replica_roles:
        iso_desc += f" [{args.replica_roles}]"
    mesh_desc = "" if args.mesh_devices <= 1 \
        else f" x {args.mesh_devices}-device mesh"
    say(f"serving {dalle_path} on http://{args.host}:{args.port} "
        f"({device}, {args.replicas} {iso_desc} replica(s){mesh_desc} x "
        f"{args.num_slots} slots, K={args.chunk_steps}, kv={kv_desc}, "
        f"queue {args.queue_depth})")
    if args.transport == "socket" and server._is_set:
        listener = server.engine.listener
        say(f"worker endpoint {listener.advertise_endpoint} — attach a "
            f"worker with: DALLE_WORKER_TOKEN={listener.token} python -m "
            f"dalle_pytorch_tpu_torch.serve.worker --connect "
            f"{listener.advertise_endpoint} --index N")
    prof_desc = (f"; POST /admin/profile -> {args.profile_dir}"
                 if args.profile_dir else "")
    say(f"observability: GET /metrics (Prometheus exposition), "
        f"GET /debug/events (flight recorder), per-request trace "
        f"summaries on every result{prof_desc}; admin token "
        f"{server.admin_token}")
    if server._is_set:
        auto_desc = "" if autoscale is None \
            else (f", autoscaler {autoscale.min_replicas}.."
                  f"{autoscale.max_replicas}")
        say(f"admin: POST /admin/scale (add, remove, drain, undrain, "
            f"upgrade, status), max_replicas "
            f"{server.engine.max_replicas}{auto_desc}")
    serve_http(server, args.host, args.port)
    return server


def serve_gateway(args, build_server, cfg):
    """``--gateway``: ``--cells`` servers from ``build_server`` behind one
    ``Gateway`` over HTTP (``serve_gateway_http``, until Ctrl-C); returns
    the gateway."""
    from dalle_pytorch_tpu_torch.serve.gateway import (Gateway,
                                                       serve_gateway_http)
    from dalle_pytorch_tpu_torch.serve.kv_pool import pages_for
    from dalle_pytorch_tpu_torch.serve.tenancy import TenantTable
    n_cells = max(args.cells, 1)
    cells = [build_server() for _ in range(n_cells)]
    tenants = TenantTable.from_file(args.tenants) if args.tenants else None
    gw = Gateway(
        cells, tenants=tenants, cfg=cfg,
        model_version=f"{args.name}_dalle@{args.dalle_epoch}",
        quantized=args.quantize == "int8_kv",
        queue_depth=args.queue_depth,
        max_prompt_len=cfg.text_seq_len,
        # a request's worst-case page residency, its whole sequence: the
        # unit the tenants' page budgets meter (dense cells alike)
        pages_per_request=pages_for(cfg.seq_len, args.page_size or 16),
        admin_token=args.admin_token or None).start()
    tenant_desc = (f", tenants {tenants.names()}" if tenants is not None
                   else ", anonymous tenant")
    iso_desc = args.isolation if args.transport == "pipe" \
        else f"{args.isolation}/{args.transport}"
    say(f"gateway over {n_cells} cells ({args.replicas} {iso_desc} "
        f"replica(s) x {args.num_slots} slots each) on "
        f"http://{args.host}:{args.port}{tenant_desc}")
    say(f"admin: POST /admin/tenants with Authorization: Bearer "
        f"{gw.admin_token} reloads the tenant table; GET /stats /metrics "
        f"/tenants /healthz for the fleet")
    serve_gateway_http(gw, args.host, args.port)
    return gw


if __name__ == "__main__":
    main()
