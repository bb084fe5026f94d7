"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``dalle_pytorch_tpu_torch``) and nothing of JAX, at the
full width of the repo's north DALLE configuration (``bench.py``
``build_cfg(tiny=False)``: dim 512, depth 12, 8 heads of 64, text 256 +
image 1024 tokens, VAE 256 px / 2048 codes) with seeded random weights:

1. build  — compile every CUDA kernel from ``csrc/`` with nvcc (sm_90a);
   print the card's name and power limit;
2. kernel — paged-attention kernel K4 against its plain PyTorch version
   at the serving shapes (8 slots, 8 heads, dh 64, page 16, L 1280),
   ragged positions including 0, 1, 15, 16, 17 and 1279, random data in
   every page including the trash page: float32 (TF32 off) to 1e-5,
   bfloat16 pages to 1e-2, int8 pages to rtol 1e-5 / atol 1e-4 (the
   unnormalised acc relative to its summands' magnitude, m, l and
   acc / l directly); timed with CUDA events beside the byte bound;
3. decode — one full-width float32 decode step through the kernel
   against the dense gather (``paged_view`` + ``_gather_read``): h_out
   to 1e-4, then 64 greedy steps with identical tokens;
4. engine — the bfloat16 serving engine end to end on 6 requests
   (prompt lengths 1, 17 and 256; top-k, top-p 0.9 and one greedy):
   every result ok with 1024 image tokens in [0, 2048) and a finite
   (256, 256, 3) image; K4 launched depth x decode steps times; every
   page back on the free list; a re-run request gives identical tokens;
   then the six requests run again (same tokens), and a torch.profiler
   window over a few steady chunks, beside an unprofiled window with the
   same slots live, says where a decode step's time goes (device time
   per step, K4's share, the device's idle share).

Each phase prints one JSON line; the kernel table and the card line
follow, and the last line is ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA card: without one it exits 2 before doing anything.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # H100 SXM, float32 outside tensor cores


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(prof) -> dict:
    """{kernel name: (device us, launches)} from a torch.profiler run."""
    kernels = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        old_us, old_n = kernels.get(e.key, (0.0, 0))
        kernels[e.key] = (old_us + float(us), old_n + e.count)
    return kernels


def north_cfg():
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    vcfg = V.VAEConfig(image_size=256, num_tokens=2048, codebook_dim=512,
                       num_layers=3, hidden_dim=64)
    return D.DALLEConfig(dim=512, depth=12, vae=vcfg, num_text_tokens=10000,
                         text_seq_len=256, heads=8, dim_head=64)


def phase_build() -> str:
    from dalle_pytorch_tpu_torch.ops import build
    t0 = time.perf_counter()
    libs = {name: build.build(name) for name in build.SOURCES}
    emit(phase="build", ok=True, seconds=time.perf_counter() - t0,
         libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()})
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


def kernel_inputs(dtype, page_size=16, slots=8, heads=8, dh=64,
                  L=1280, seed=0):
    """North serving shapes: the engine's fully provisioned pool (8 slots
    x 80 pages + trash), one distinct page run per slot, ragged pos."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mp = L // page_size
    P = slots * mp + 1
    dev = "cuda"
    pos = torch.tensor([0, 1, 15, 16, 17, 1279, 640, 1000][:slots],
                       dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    bt = perm.reshape(slots, mp).to(torch.int32)
    need = (pos.long() + page_size - 1) // page_size
    cols = torch.arange(mp, device=dev)[None, :]
    bt = torch.where(cols < need[:, None], bt, 0)        # unmapped -> trash
    j = torch.arange(L, device=dev)
    allowed = j[None, :] < pos[:, None].long()
    allowed[5, 3] = False                                 # padded rows
    allowed[7, :5] = False
    q = torch.randn((slots, heads, dh), generator=g, device=dev)
    shape = (P, heads, page_size, dh)
    if dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        ksc = 0.01 + 0.09 * torch.rand(shape[:-1], generator=g, device=dev)
        vsc = 0.01 + 0.09 * torch.rand(shape[:-1], generator=g, device=dev)
        return (q.to(torch.bfloat16), kp, vp, bt, pos, allowed,
                {"k_scales": ksc, "v_scales": vsc})
    kp = torch.randn(shape, generator=g, device=dev).to(dtype)
    vp = torch.randn(shape, generator=g, device=dev).to(dtype)
    return q.to(dtype), kp, vp, bt, pos, allowed, {}


def bound_ms(q, kp, bt, pos, allowed, scales) -> tuple:
    """Least time for one call: the bytes it must move (walked pages of K
    and V, their scales, q, the mask, tables and outputs) over HBM rate,
    against its float32 multiply-adds over the CUDA-core rate."""
    b, heads, dh = q.shape
    ps = kp.shape[2]
    rows = int(((pos.long() + ps - 1) // ps * ps).sum())
    kv = 2 * rows * heads * dh * kp.element_size()
    if scales:
        kv += 2 * rows * heads * 4
    io = (q.numel() * q.element_size() + allowed.numel() + bt.numel() * 4
          + pos.numel() * 4 + b * heads * (dh + 2) * 4)
    t_bytes = (kv + io) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * rows * heads * dh / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k4_device_us(fn, iters: int = 50):
    """K4's device time per launch from torch.profiler: the kernel alone,
    without the wrapper's host work or the gaps between launches that the
    CUDA-event time of back-to-back calls includes."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    k4 = [(us, n) for k, (us, n) in device_kernels(prof).items()
          if "paged_decode" in k]
    n = sum(c for _, c in k4)
    return sum(us for us, _ in k4) / n if n else "not measured"


def phase_kernel() -> dict:
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    scale = 512 ** -0.5
    cases = {"float32": (torch.float32, 1e-5, 1e-5),
             "bfloat16": (torch.bfloat16, 1e-2, 1e-2),
             "int8": (torch.int8, 1e-5, 1e-4)}
    results = {}
    for name, (dtype, rtol, atol) in cases.items():
        q, kp, vp, bt, pos, allowed, sc = kernel_inputs(dtype)
        kw = dict(scale=scale, **sc)
        got = PA.paged_decode_attention(q, kp, vp, bt, pos, allowed, **kw)
        want = PA.paged_decode_attention_plain(q, kp, vp, bt, pos, allowed,
                                               **kw)
        # the unnormalised acc sums up to 1279 signed terms in another
        # order than the plain version, so its error scales with the
        # summands' magnitude sum_j p_j |v_j|, not with the (cancelling)
        # sum itself: acc is held to rtol of that magnitude; m, l and the
        # normalised output acc / l to the plain rtol/atol
        mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), bt, pos,
                                              allowed, **kw)[0]
        torch.cuda.synchronize()
        err = float((got[0] - want[0]).abs().max())
        check(bool(((got[0] - want[0]).abs() <= rtol * mag + atol).all()),
              f"K4 {name}: acc differs from the plain version (max abs "
              f"{err:.3e})")
        live = want[2] > 0
        out_k = got[0][live] / got[2][live][:, None]
        out_p = want[0][live] / want[2][live][:, None]
        for a, b, what in ((got[1], want[1], "m"), (got[2], want[2], "l"),
                           (out_k, out_p, "acc / l")):
            ok = torch.allclose(a, b, rtol=rtol, atol=atol)
            check(ok, f"K4 {name}: {what} differs from the plain version "
                      f"(max abs {float((a - b).abs().max()):.3e})")
            err = max(err, float((a - b).abs().max()))
        check(float(got[1][0, 0]) == PA.FILL and float(got[2][0].abs().max())
              == 0.0 and float(got[0][0].abs().max()) == 0.0,
              f"K4 {name}: the pos-0 slot must return (0, FILL, 0)")
        ms = cuda_ms(lambda: PA.paged_decode_attention(
            q, kp, vp, bt, pos, allowed, **kw), iters=200)
        device_us = k4_device_us(lambda: PA.paged_decode_attention(
            q, kp, vp, bt, pos, allowed, **kw))
        plain = cuda_ms(lambda: PA.paged_decode_attention_plain(
            q, kp, vp, bt, pos, allowed, **kw), iters=50)
        bms, by = bound_ms(q, kp, bt, pos, allowed, sc)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                         "bound_ms": bms, "bound_by": by,
                         "us_per_launch": ms * 1e3,
                         "device_us_per_launch": device_us,
                         "plain_us": plain * 1e3, "bound_us": bms * 1e3}
        emit(phase="kernel", case=name, ok=True, rtol=rtol, atol=atol,
             **results[name])
    return results


def phase_decode() -> None:
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    cfg = north_cfg()
    tcfg = cfg.transformer
    model = D.dalle_init(cfg, seed=1, dtype=torch.float32)
    slots, ps, L = 8, 16, cfg.seq_len
    mp = L // ps
    P = slots * mp + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    shape = (tcfg.depth, P, tcfg.heads, ps, tcfg.dim_head)
    pool = {"k": torch.randn(shape, generator=g, device="cuda"),
            "v": torch.randn(shape, generator=g, device="cuda")}
    oracle = {k: v.clone() for k, v in pool.items()}
    bt = (torch.arange(P - 1, device="cuda") + 1).reshape(slots, mp) \
        .to(torch.int32)
    pos = torch.tensor([0, 1, 15, 16, 17, 300, 640, 1000],
                       dtype=torch.int32, device="cuda")
    key_mask = torch.ones((slots, L), dtype=torch.bool, device="cuda")
    active = torch.ones((slots,), dtype=torch.bool, device="cuda")
    tok = torch.randint(0, cfg.num_text_tokens, (slots,), generator=g,
                        device="cuda").to(torch.int32)
    kw = dict(cfg=tcfg, key_mask=key_mask, active=active)
    worst = 0.0
    with torch.no_grad():
        for step in range(64):
            x = D.decode_token_embed(model, tok, pos)
            h_k = decode_ops.decode_step_paged(model.transformer, x, pos,
                                               pool, bt, **kw)
            h_g = decode_ops.decode_step_paged(model.transformer, x, pos,
                                               oracle, bt,
                                               attn_impl="gather", **kw)
            if step == 0:
                check(torch.allclose(h_k, h_g, rtol=1e-4, atol=1e-4),
                      f"decode step: kernel h_out differs from the gather "
                      f"oracle (max abs "
                      f"{float((h_k - h_g).abs().max()):.3e})")
            worst = max(worst, float((h_k - h_g).abs().max()))
            forbid = D.logits_mask(cfg, pos)
            t_k = D.to_logits(model, h_k).masked_fill(forbid, -math.inf) \
                .argmax(-1)
            t_g = D.to_logits(model, h_g).masked_fill(forbid, -math.inf) \
                .argmax(-1)
            check(torch.equal(t_k, t_g),
                  f"decode step {step}: greedy tokens differ")
            tok = torch.where(pos + 1 >= cfg.text_seq_len,
                              t_k - cfg.num_text_tokens, t_k) \
                .to(torch.int32)
            pos = pos + 1
    emit(phase="decode", ok=True, steps=64, slots=slots,
         max_abs_h_diff=worst)


def profile_window(engine, chunks: int) -> dict:
    """``chunks`` chunks timed without the profiler, then the next
    ``chunks`` under torch.profiler, with the same slots live in both.
    Gives device kernel time per step (all kernels, and K4's share), the
    wall per step of each window, and the device's idle share against
    the unprofiled wall (the profiler's own host cost inflates the
    profiled wall, so the idle share inside that window is only an upper
    bound). Device time the profiler cannot see is reported as not
    measured."""
    from torch.profiler import ProfilerActivity, profile
    live = engine.active_slots()
    first_step = engine.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        engine.step_once()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(chunks):
            engine.step_once()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    check(engine.active_slots() == live, "a slot finished inside a "
          "profiled window")
    steps = chunks * engine.chunk_steps
    kernels = device_kernels(prof)
    total_us = sum(us for us, _ in kernels.values())
    out = {"steps": steps, "live_slots": live, "first_step": first_step,
           "wall_ms_per_step": plain_wall_ms / steps,
           "wall_ms_per_step_profiled": wall_ms / steps}
    if total_us <= 0:
        out["device_ms_per_step"] = "not measured"
        return out
    k4 = [(us, n) for k, (us, n) in kernels.items() if "paged_decode" in k]
    k4_us = sum(us for us, _ in k4)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    device_ms = total_us / 1e3 / steps
    out.update(device_ms_per_step=device_ms,
               k4_ms_per_step=k4_us / 1e3 / steps,
               k4_us_per_launch=k4_us / max(1, sum(n for _, n in k4)),
               k4_share_of_device=k4_us / total_us,
               device_idle_share=max(0.0, 1 - device_ms
                                     / out["wall_ms_per_step"]),
               device_idle_share_profiled=max(0.0, 1 - total_us / 1e3
                                              / wall_ms),
               kernels_launched_per_step=sum(
                   n for _, n in kernels.values()) / steps,
               top_kernels_ms_per_step={k[:60]: us / 1e3 / steps
                                        for k, (us, _) in top})
    return out


def profile_decode(engine, queue, reqs, want_tokens, chunks: int = 4,
                   late_chunk: int = 110) -> dict:
    """Where a steady decode step's time goes, with the main run's
    requests in flight: they are submitted again and admitted by one
    step, and a ``profile_window`` is taken early (after two steady
    chunks) and late (from chunk ``late_chunk``, every slot still live
    at a long position), since K4's work grows with the positions. The
    re-run must give every request's tokens again."""
    handles = [queue.submit(r) for r in reqs]
    base = engine.decode_steps          # a slot's pos is its prompt length
    for _ in range(3):                  # plus the steps since admission
        engine.step_once()
    early = profile_window(engine, chunks)
    for _ in range(late_chunk - 3 - 2 * chunks):
        engine.step_once()
    late = profile_window(engine, chunks)
    for w in (early, late):
        w["first_step"] -= base
    engine.run_until_idle()
    for h, want in zip(handles, want_tokens):
        res = h.result(timeout=0)
        check(res.ok and list(res.tokens) == list(want),
              f"re-run request {res.request_id} gave other tokens")
    return {"early": early, "late": late}


def phase_engine() -> dict:
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    cfg = north_cfg()
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(5)

    def prompt(n):
        return tuple(int(t) for t in torch.randint(
            1, cfg.num_text_tokens, (n,), generator=g))

    top_p = S.SamplingParams(top_p=0.9)
    greedy = S.SamplingParams(filter_thres=1.0)
    reqs = [S.Request(prompt(1), seed=10), S.Request(prompt(17), seed=11),
            S.Request(prompt(256), seed=12),
            S.Request(prompt(1), seed=13, sampling=top_p),
            S.Request(prompt(17), seed=14, sampling=greedy),
            S.Request(prompt(256), seed=15, sampling=top_p)]

    post = PostProcessor(vae, model)
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8,
                    page_size=16, complete=post)
    check(engine.num_pages == 1 + 8 * 80, "pool must be 1 + 8*80 pages")
    handles = [queue.submit(r) for r in reqs]
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.paged_decode_attention.launches
    results = [h.result(timeout=0) for h in handles]
    for r, res in zip(reqs, results):
        check(res.ok, f"request {res.request_id}: {res.status} "
                      f"{res.reason}")
        toks = torch.as_tensor(res.tokens)
        check(toks.shape == (cfg.image_seq_len,)
              and int(toks.min()) >= 0
              and int(toks.max()) < cfg.num_image_tokens,
              f"request {res.request_id}: bad image tokens")
        img = torch.as_tensor(res.image)
        check(img.shape == (256, 256, 3) and bool(torch.isfinite(img).all()),
              f"request {res.request_id}: bad image {tuple(img.shape)}")
        check(list(res.text_tokens[:len(r.codes)]) == list(r.codes),
              f"request {res.request_id}: text span lost its prompt")
    check(launches == cfg.depth * engine.decode_steps,
          f"K4 launched {launches} times, expected depth x decode steps = "
          f"{cfg.depth * engine.decode_steps}")
    check(engine.alloc.in_use == 0, f"{engine.alloc.in_use} pages leaked")
    stats = engine.stats()
    # tokens_decoded counts every sampled position, text span included;
    # users receive the image tokens
    image_tokens = len(reqs) * cfg.image_seq_len

    # replay: the same request alone gives the same tokens
    again = queue.submit(reqs[2])
    engine.run_until_idle()
    check(again.result(timeout=0).ok and list(again.result().tokens)
          == list(results[2].tokens), "re-run request gave other tokens")
    check(engine.alloc.in_use == 0, "pages leaked after the re-run")
    prof = profile_decode(engine, queue, reqs,
                          [res.tokens for res in results])
    check(engine.alloc.in_use == 0, "pages leaked after the profiled run")

    # prefill: the 256 bucket's two-row group, as admission runs it
    text = torch.randint(1, cfg.num_text_tokens, (2, 256), device="cuda")
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: decode_ops.prefill(
            model.transformer, D.embed_prompt(model, text),
            cfg=cfg.transformer), iters=10, warmup=2)
        vae_ms = cuda_ms(lambda: post.decode(results[0].tokens), iters=10,
                         warmup=2)
    record = dict(phase="engine", ok=True, requests=len(reqs),
                  wall_s=wall, decode_steps=stats["decode_steps"],
                  ms_per_decode_step=wall * 1e3 / stats["decode_steps"],
                  tokens_per_s=stats["tokens_decoded"] / wall,
                  tokens_decoded=stats["tokens_decoded"],
                  image_tokens_per_s=image_tokens / wall,
                  image_tokens=image_tokens,
                  harvests=stats["harvests"],
                  prefill_runs=stats["prefill_runs"],
                  pages_peak=stats["pages_peak"],
                  prefill_ms_bucket256_2rows=prefill_ms,
                  vae_ms_per_image=vae_ms, k4_launches=launches,
                  profile=prof)
    emit(**record)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_build()
    kernel = phase_kernel()
    phase_decode()
    engine = phase_engine()
    main_case = kernel["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": engine["k4_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
