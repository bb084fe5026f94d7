"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``dalle_pytorch_tpu_torch``) and nothing of JAX, at the
full width of the repo's north DALLE configuration (``bench.py``
``build_cfg(tiny=False)``: dim 512, depth 12, 8 heads of 64, text 256 +
image 1024 tokens, VAE 256 px / 2048 codes) with seeded random weights:

1. build  — compile every CUDA kernel from ``csrc/`` with nvcc (sm_90a),
   one nvcc per source, all at once; print the ``-Xptxas -v`` lines
   (registers, shared memory, spills) of the tensor-core kernels (K1,
   K2b split, K3) and of K4's dh-64 bodies, and the card's name and
   power limit;
2. kernel — paged-attention kernel K4 against its plain PyTorch version
   at the serving shapes (8 slots, 8 heads, dh 64, page 16, L 1280),
   ragged positions including 0, 1, 15, 16, 17 and 1279, random data in
   every page including the trash page: float32 (TF32 off) to 1e-5,
   bfloat16 pages to 1e-2, int8 pages to rtol 1e-5 / atol 1e-4 (the
   unnormalised acc relative to its summands' magnitude, m, l and
   acc / l directly); the pos-0 slot's (0, FILL, 0) exactly, through
   the split walk (one long slot across five blocks beside short ones);
   timed with CUDA events beside the byte bound;
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
   per step, K4's share, the device's idle share);
5. flash  — the flash kernels K1 (forward: out, m, l), K2a (dq) and K2b
   (dk, dv; split and fused mode) against their plain PyTorch versions
   at the north training shapes (b 8, h 8, n 1280, d 64, causal,
   scale 512 ** -0.5), in bfloat16 and float32 (TF32 off), with the
   all-True mask training uses and with a text-padding mask (fully padded
   query rows included): float32 to rtol/atol 2e-4, bfloat16 to 2e-2,
   l to rtol/atol 1e-4 (see ``flash_tolerances``); each record names
   the body that ran for each call (tensor cores: bfloat16 K1 and K2b
   split; CUDA cores: the rest), from the kernels the profiler saw;
   timed with CUDA events and torch.profiler beside the plain version,
   the bound, and ``F.scaled_dot_product_attention`` (its forward, and
   its backward alone) as the library yardstick at the all-True mask;
6. train  — the north config's training step (bfloat16 params, batch 8,
   ``loss_chunk`` 256, flash attention with the split kernel backward,
   dropout 0.1, Adam lr 1e-4): random 256 px images through the VAE
   encoder to ids, then ``make_train_step`` for 6 steps with finite
   losses, K1, K2a and K2b each launched depth x steps times; ms per
   step, tokens per second and a profiler window (device time per step,
   K1's and K2's shares, kernels per step, idle share). Then at depth 2,
   full width, float32, one step's loss and every parameter's gradient
   under 'pallas' and 'pallas_fused' against the plain blockwise 'xla'
   backward: loss to rtol 1e-5, each gradient to 1e-4 of its largest
   element (f32 sums in other orders, and the fused dq's atomics);
7. sparse_kernels — the block-sparse kernel K3 (out, m, l) against its
   plain version at the north training shapes (b 8, h 8, n 1280, d 64,
   block 16, causal, scale 512 ** -0.5), bfloat16 (tensor cores) and
   float32 (CUDA cores), all-True and text-padding masks, with the flash
   tolerances; timed beside the plain version, the bound and
   ``F.scaled_dot_product_attention`` with the layout as a boolean mask
   (CUDA events and device time). The static and the blockwise backward
   against autograd through ``sparse_attention_ref`` in float32, each
   gradient to 2e-4 of its largest element. K4's visible walk against
   its plain version and against the prefix walk over the same fully
   masked rows at the serving shapes (8 heads, dh 64, page 16, L 1280),
   positions 0, 1, 15, 16, 17, 63, 64, 65 and 1279, in float32, bfloat16
   and int8 pages, with K4's tolerances; timed beside its byte bound;
8. sparse_train — the block-sparse north config at full depth (BASELINE
   config 4: depth 64, ``sparse_attn=(True, False) * 32``,
   ``sparse_impl='pallas'``, dense layers on the flash kernels with the
   split backward; bfloat16, batch 8, ``loss_chunk`` 256, dropout 0, Adam
   lr 1e-4) for 6 steps: finite losses, K3, K1, K2a and K2b each launched
   32 x steps times; ms per step, tokens per second, peak memory, a
   profiler window (K3's and K1 + K2's shares) and the plain sparse
   backward's time. Then at depth 2, full width, float32: loss and every
   gradient with 'pallas' against 'ref', as the ``train`` phase holds
   them;
9. sparse_engine — the north width with the sparse pattern at depth 12:
   one float32 decode step with sparse reads through K4's visible walk
   against the trimmed-gather oracle (h_out to 1e-4), then 64 greedy
   steps with identical tokens, identical with sparse reads off too;
   then the bfloat16 engine with ``sparse_reads=True`` on the six
   requests of the ``engine`` phase: every result ok, K4's visible walk
   and its prefix walk each launched 6 x decode steps times, every page
   freed, and the ``engine`` phase's profile windows.

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
BF16_FLOPS = 989e12              # H100 SXM, bf16 tensor cores, dense


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


def top_kernels(kernels: dict, steps: int, n: int = 8,
                width: int = 90) -> dict:
    """The ``n`` kernels with the most device time, ms per step, names
    cut to ``width`` characters (kernels whose cut names coincide are
    summed, not overwritten)."""
    out = {}
    for k, (us, _) in kernels.items():
        out[k[:width]] = out.get(k[:width], 0.0) + us / 1e3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])


KERNEL_CLASSES = (("flash", ("flash_fwd", "flash_bwd")),
                  ("block_sparse", ("block_sparse_fwd",)),
                  ("paged_decode", ("paged_decode",)),
                  ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
                  ("elementwise", ("elementwise",)),
                  ("reduce", ("reduce",)))


def kernel_classes(kernels: dict, steps: int) -> dict:
    """Device ms per step by kind of kernel, by name: the port's own
    kernels, matrix products, elementwise passes, reductions, the rest."""
    out = {name: 0.0 for name, _ in KERNEL_CLASSES}
    out["other"] = 0.0
    for k, (us, _) in kernels.items():
        kind = next((name for name, keys in KERNEL_CLASSES
                     if any(key in k for key in keys)), "other")
        out[kind] += us / 1e3 / steps
    return out


def north_cfg():
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    vcfg = V.VAEConfig(image_size=256, num_tokens=2048, codebook_dim=512,
                       num_layers=3, hidden_dim=64)
    return D.DALLEConfig(dim=512, depth=12, vae=vcfg, num_text_tokens=10000,
                         text_seq_len=256, heads=8, dim_head=64)


def ptxas_lines(log: str, part: str) -> dict:
    """{kernel: its ``-Xptxas -v`` lines (stack, spills; registers, shared
    memory)} for the kernels whose (mangled) name holds ``part``."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if part in line else None
        elif name and ("spill" in line or "Used" in line):
            out.setdefault(name, []).append(line.strip())
    return out


def phase_build() -> str:
    from dalle_pytorch_tpu_torch.ops import build
    t0 = time.perf_counter()
    libs = build.build_all()
    emit(phase="build", ok=True, seconds=time.perf_counter() - t0,
         libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()},
         wgmma_ptxas=ptxas_lines(build.build_log("flash_attention"),
                                 "wgmma"),
         block_sparse_ptxas=ptxas_lines(build.build_log("block_sparse"),
                                        "wgmma"),
         paged_ptxas=ptxas_lines(build.build_log("paged_attention"),
                                 "Li64E"))
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


def walk_bound(q, kp, pages: int, list_bytes: int, scales) -> tuple:
    """Least ms of one K4 launch that walks ``pages`` pages in all: what
    the walk reads once each (K and V of the walked rows with their
    scales, by ``paged_attention.kv_row_bytes``; the allowed byte of each
    walked row; the block-table entry of each walked page; q; the
    per-slot walk lengths and lists, ``list_bytes``) and writes (acc, m,
    l) over HBM rate, against its float32 multiply-adds over the
    CUDA-core rate."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    b, heads, dh = q.shape
    rows = pages * kp.shape[2]
    kv = rows * heads * PA.kv_row_bytes(dh, kp.element_size(), bool(scales))
    io = (q.numel() * q.element_size() + rows + pages * 4 + list_bytes
          + b * heads * (dh + 2) * 4)
    t_bytes = (kv + io) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * rows * heads * dh / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(q, kp, pos, scales) -> tuple:
    """``walk_bound`` of the prefix walk: ``ceil(pos / page_size)`` pages
    a slot, its length read from ``pos``."""
    ps = kp.shape[2]
    pages = int(((pos.long() + ps - 1) // ps).sum())
    return walk_bound(q, kp, pages, pos.numel() * 4, scales)


def named_device_us(fn, name: str, iters: int = 20, warm: int = 4,
                    attempts: int = 3):
    """Device time per launch of the kernels whose name holds ``name``,
    from torch.profiler sessions opened with ``warm`` launches (see
    ``flash_device_us``); "not measured" if no session records one."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warm + iters):
                fn()
            torch.cuda.synchronize()
        hits = [(us, n) for k, (us, n) in device_kernels(prof).items()
                if name in k]
        n = sum(c for _, c in hits)
        if n:
            return sum(us for us, _ in hits) / n
    return "not measured"


def partials_held(what: str, got, want, mag, rtol, atol) -> float:
    """K4's (acc, m, l) against the plain version's; returns the max abs
    error. The unnormalised acc sums up to 1279 signed terms in another
    order, so its error scales with the summands' magnitude
    ``mag`` = sum_j p_j |v_j|, not with the (cancelling) sum itself: acc
    is held to rtol of that magnitude; m, l and the normalised output
    acc / l to rtol/atol directly."""
    err = float((got[0] - want[0]).abs().max())
    check(bool(((got[0] - want[0]).abs() <= rtol * mag + atol).all()),
          f"{what}: acc differs from the plain version (max abs "
          f"{err:.3e})")
    live = want[2] > 0
    out_k = got[0][live] / got[2][live][:, None]
    out_p = want[0][live] / want[2][live][:, None]
    for a, b, name in ((got[1], want[1], "m"), (got[2], want[2], "l"),
                       (out_k, out_p, "acc / l")):
        check(torch.allclose(a, b, rtol=rtol, atol=atol),
              f"{what}: {name} differs from the plain version (max abs "
              f"{float((a - b).abs().max()):.3e})")
        err = max(err, float((a - b).abs().max()))
    return err


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
        mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), bt, pos,
                                              allowed, **kw)[0]
        torch.cuda.synchronize()
        err = partials_held(f"K4 {name}", got, want, mag, rtol, atol)
        check(float(got[1][0, 0]) == PA.FILL and float(got[2][0].abs().max())
              == 0.0 and float(got[0][0].abs().max()) == 0.0,
              f"K4 {name}: the pos-0 slot must return (0, FILL, 0)")
        ms = cuda_ms(lambda: PA.paged_decode_attention(
            q, kp, vp, bt, pos, allowed, **kw), iters=200)
        device_us = named_device_us(lambda: PA.paged_decode_attention(
            q, kp, vp, bt, pos, allowed, **kw), "paged_decode_kernel",
            iters=50)
        plain = cuda_ms(lambda: PA.paged_decode_attention_plain(
            q, kp, vp, bt, pos, allowed, **kw), iters=50)
        bms, by = bound_ms(q, kp, pos, sc)
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
    vis = [(us, n) for k, (us, n) in kernels.items()
           if "paged_decode_visible" in k]
    vis_us = sum(us for us, _ in vis)
    device_ms = total_us / 1e3 / steps
    out.update(device_ms_per_step=device_ms,
               k4_ms_per_step=k4_us / 1e3 / steps,
               k4_us_per_launch=k4_us / max(1, sum(n for _, n in k4)),
               k4_share_of_device=k4_us / total_us,
               k4_visible_ms_per_step=vis_us / 1e3 / steps,
               k4_visible_share_of_device=vis_us / total_us,
               k4_prefix_share_of_device=(k4_us - vis_us) / total_us,
               device_idle_share=max(0.0, 1 - device_ms
                                     / out["wall_ms_per_step"]),
               device_idle_share_profiled=max(0.0, 1 - total_us / 1e3
                                              / wall_ms),
               kernels_launched_per_step=sum(
                   n for _, n in kernels.values()) / steps,
               top_kernels_ms_per_step=top_kernels(kernels, steps),
               kinds_ms_per_step=kernel_classes(kernels, steps))
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


def engine_requests(cfg) -> list:
    """Six requests: prompt lengths 1, 17 and 256, top-k, top-p 0.9 and
    one greedy."""
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    g = torch.Generator().manual_seed(5)

    def prompt(n):
        return tuple(int(t) for t in torch.randint(
            1, cfg.num_text_tokens, (n,), generator=g))

    top_p = S.SamplingParams(top_p=0.9)
    greedy = S.SamplingParams(filter_thres=1.0)
    return [S.Request(prompt(1), seed=10), S.Request(prompt(17), seed=11),
            S.Request(prompt(256), seed=12),
            S.Request(prompt(1), seed=13, sampling=top_p),
            S.Request(prompt(17), seed=14, sampling=greedy),
            S.Request(prompt(256), seed=15, sampling=top_p)]


def check_engine_results(cfg, reqs, results) -> None:
    """Every result ok, with image_seq_len tokens in [0, image vocab), a
    finite (256, 256, 3) image and its prompt at the head of the text."""
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
    reqs = engine_requests(cfg)
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
    check_engine_results(cfg, reqs, results)
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


# -- flash attention: K1, K2a, K2b --------------------------------------------

FLASH_SCALE = 512 ** -0.5        # the north config's dim ** -0.5


def flash_tolerances(dtype) -> tuple:
    """(rtol, atol) of the kernels' outputs against the plain versions:
    float32 2e-4 (both accumulate in f32, over 1,280 terms in another
    order; the fused dq adds its shares with atomics in an order that
    changes from run to run); bfloat16 2e-2 (one bf16 rounding of the
    output, 2^-8 relative, on either side)."""
    return (2e-4, 2e-4) if dtype == torch.float32 else (2e-2, 2e-2)


def flash_inputs(dtype, masked: bool, b=8, h=8, n=1280, d=64, seed=0):
    """North training shapes. ``masked``: text padding as DALLE batches
    carry it (text lengths 1..256 of the 256 text positions; image
    positions always kept), so padded text rows are fully padded query
    rows; otherwise the all-True mask ``train_dalle`` builds."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, n, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
    if masked:
        for i, t in enumerate((1, 17, 64, 100, 200, 255, 256, 30)[:b]):
            mask[i, t:256] = False
    return q, k, v, do, mask


def flash_bound(kind: str, dtype, b, h, n, d) -> tuple:
    """(least ms, 'bytes' | 'operations') of one causal call: the tile
    products over the causal pairs only (what this data needs) at the
    peak rate of the inputs' type, against each input read once and each
    output written once at the HBM rate."""
    pairs = n * (n + 1) // 2 * b * h
    products = {"fwd": 2, "dq": 3, "dkv": 4, "fused": 5}[kind]
    flops = 2 * d * pairs * products
    elems = b * h * n * d
    isz = torch.tensor([], dtype=dtype).element_size()
    rows = b * h * n * 4                       # one f32 per row
    nbytes = {"fwd": 4 * elems * isz + 2 * rows,
              "dq": 5 * elems * isz + 3 * rows,
              "dkv": 6 * elems * isz + 3 * rows,
              "fused": 6 * elems * isz + 3 * rows + 4 * elems}[kind]
    nbytes += b * n                            # the mask
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# which device kernels each flash call may launch, as (name part,
# template part): bfloat16 K1 and K2b split run the tensor-core bodies
# (``*_wgmma_kernel``), every other call a CUDA-core body
FLASH_KERNELS = {"fwd": (("flash_fwd_wgmma_kernel", ""),
                         ("flash_fwd_kernel", "")),
                 "dq": (("flash_bwd_dq_kernel", ""),),
                 "dkv": (("flash_bwd_dkv_wgmma_kernel", ""),
                         ("flash_bwd_dkv_kernel", "false>")),
                 "fused": (("flash_bwd_dkv_kernel", "true>"),)}


def is_flash_kernel(kind: str, name: str) -> bool:
    return any(part in name and variant in name
               for part, variant in FLASH_KERNELS[kind])


def flash_body(names) -> str:
    """Which body the kernels ``names`` are: tensor cores or CUDA cores."""
    if not names:
        return "not measured"
    return ("tensor cores (wgmma)" if any("wgmma" in k for k in names)
            else "CUDA cores")


def flash_device_us(calls: dict, iters: int = 8, warm: int = 4,
                    attempts: int = 3) -> tuple:
    """Each flash kernel's device time per launch from torch.profiler,
    averaged over the launches a session recorded, and the names of the
    kernels recorded for each call. A profiler session now and then
    comes back without the records of its first few milliseconds, so
    each session opens with ``warm`` launches of every call before
    ``iters`` more of each, and the calls still unmeasured are profiled
    again, up to ``attempts`` sessions; what is still missing is
    reported as not measured."""
    from torch.profiler import ProfilerActivity, profile
    out = {kind: "not measured" for kind in calls}
    names = {kind: [] for kind in calls}
    for _ in range(attempts):
        todo = [kind for kind, us in out.items() if isinstance(us, str)]
        if not todo:
            break
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warm):
                for kind in todo:
                    calls[kind][0]()
            for kind in todo:
                for _ in range(iters):
                    calls[kind][0]()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        for kind in todo:
            hits = [(k, us, n) for k, (us, n) in kernels.items()
                    if is_flash_kernel(kind, k)]
            n = sum(c for _, _, c in hits)
            if n:
                out[kind] = sum(us for _, us, _ in hits) / n
                names[kind] = [k for k, _, _ in hits]
    return out, names


def all_device_us(fn, iters: int = 10, warm: int = 3,
                  attempts: int = 3) -> float:
    """Device time of every kernel ``fn`` launches, per call, from
    torch.profiler: the session's total over the launch count of the
    call's longest kernel (one a call), so records a session drops at
    its start drop from both. A session that records nothing is tried
    again, up to ``attempts``; then "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warm + iters):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        if kernels:
            _, calls = max(kernels.values())
            return sum(us for us, _ in kernels.values()) / calls
    return "not measured"


def held(what: str, got, want, rtol, atol) -> float:
    """Checks got against want elementwise; returns the max abs error."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    worst = float(err.max())
    check(ok, f"{what} differs from its plain version (max abs "
              f"{worst:.3e}, rtol {rtol}, atol {atol})")
    return worst


def flash_case(dtype, masked: bool, timed: bool) -> dict:
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    q, k, v, do, mask = flash_inputs(dtype, masked)
    b, h, n, d = q.shape
    name = f"{str(dtype).split('.')[-1]}/{'pad' if masked else 'all_true'}"
    rtol, atol = flash_tolerances(dtype)
    kw = dict(scale=FLASH_SCALE, causal=True, mask=mask)
    out, m, l = FA.flash_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
    errs = {"fwd": held(f"K1 {name} out", out, out_p, rtol, atol)}
    errs["fwd_m"] = held(f"K1 {name} m", m, m_p, rtol, atol)
    errs["fwd_l"] = held(f"K1 {name} l", l, l_p, 1e-4, 1e-4)
    dstat = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, m_p, l_p, dstat)
    dq_p = FA.flash_attention_bwd_dq_plain(*args, **kw)
    dk_p, dv_p, dq32_p = FA.flash_attention_bwd_dkv_plain(*args, with_dq=True,
                                                          **kw)
    dq = FA.flash_attention_bwd_dq(*args, **kw)
    errs["dq"] = held(f"K2a {name} dq", dq, dq_p, rtol, atol)
    dk, dv, _ = FA.flash_attention_bwd_dkv(*args, **kw)
    errs["dkv"] = max(held(f"K2b split {name} dk", dk, dk_p, rtol, atol),
                      held(f"K2b split {name} dv", dv, dv_p, rtol, atol))
    dk, dv, dq32 = FA.flash_attention_bwd_dkv(*args, with_dq=True, **kw)
    errs["fused"] = max(
        held(f"K2b fused {name} dk", dk, dk_p, rtol, atol),
        held(f"K2b fused {name} dv", dv, dv_p, rtol, atol),
        held(f"K2b fused {name} dq", dq32, dq32_p, rtol, atol))
    torch.cuda.synchronize()
    del dq_p, dk_p, dv_p, dq32_p
    record = {"case": name, "rtol": rtol, "atol": atol, "max_abs_err": errs}
    calls = {
        "fwd": (lambda: FA.flash_attention_fwd(q, k, v, **kw),
                lambda: FA.flash_attention_fwd_plain(q, k, v, **kw)),
        "dq": (lambda: FA.flash_attention_bwd_dq(*args, **kw),
               lambda: FA.flash_attention_bwd_dq_plain(*args, **kw)),
        "dkv": (lambda: FA.flash_attention_bwd_dkv(*args, **kw),
                lambda: FA.flash_attention_bwd_dkv_plain(*args, **kw)),
        "fused": (lambda: FA.flash_attention_bwd_dkv(*args, with_dq=True,
                                                     **kw),
                  lambda: FA.flash_attention_bwd_dkv_plain(
                      *args, with_dq=True, **kw)),
    }
    device_us, names = flash_device_us(calls, *((8, 4) if timed else (1, 1)))
    record["bodies"] = {kind: flash_body(k) for kind, k in names.items()}
    if not timed:
        return record
    for kind, (kernel, plain) in calls.items():
        bms, by = flash_bound(kind, dtype, b, h, n, d)
        record[kind] = {
            "ms": cuda_ms(kernel, iters=20, warmup=2),
            "device_us_per_launch": device_us[kind],
            "plain_ms": cuda_ms(plain, iters=3, warmup=1),
            "bound_ms": bms, "bound_by": by}
    # the library yardstick: one PyTorch call computing the same function
    # (causal, no padding) — timed here, used nowhere in the port. Its
    # backward is timed alone: one forward kept with its graph, then only
    # torch.autograd.grad, again and again
    import torch.nn.functional as F
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, is_causal=True, scale=FLASH_SCALE)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                       scale=FLASH_SCALE)
    sdpa_bwd = lambda: torch.autograd.grad(   # noqa: E731
        o, leaves, do, retain_graph=True)
    record["library"] = {
        "sdpa_fwd_ms": cuda_ms(sdpa, iters=20, warmup=2),
        "sdpa_fwd_device_us": all_device_us(sdpa),
        "sdpa_bwd_ms": cuda_ms(sdpa_bwd, iters=20, warmup=2),
        "sdpa_bwd_device_us": all_device_us(sdpa_bwd)}
    return record


def phase_flash() -> dict:
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for masked in (False, True):
            rec = flash_case(dtype, masked, timed=not masked)
            results[rec["case"]] = rec
            emit(phase="flash", ok=True, **rec)
    return results


# -- training -----------------------------------------------------------------

def train_cfg(**kw):
    import dataclasses
    base = dict(attn_impl="flash", attn_bwd_impl="pallas", attn_dropout=0.1,
                ff_dropout=0.1, loss_chunk=256)
    base.update(kw)
    return dataclasses.replace(north_cfg(), **base)


def train_batch(cfg, b=8, seed=9) -> dict:
    """Random text ids, the all-True text mask ``train_dalle`` builds, and
    random images in [-1, 1), made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    size = cfg.vae.image_size
    return {"text": torch.randint(1, cfg.num_text_tokens,
                                  (b, cfg.text_seq_len), generator=g,
                                  device="cuda"),
            "mask": torch.ones((b, cfg.text_seq_len), dtype=torch.bool,
                               device="cuda"),
            "image": torch.rand((b, size, size, 3), generator=g,
                                device="cuda") * 2 - 1}


def flash_counts(reset: bool = False) -> dict:
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    fns = {"k1": FA.flash_attention_fwd, "k2a": FA.flash_attention_bwd_dq,
           "k2b": FA.flash_attention_bwd_dkv}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def train_profile(step, model, batch, key, steps: int = 2) -> dict:
    """``steps`` steps unprofiled, then ``steps`` under torch.profiler:
    device time per step (all kernels; K1's and K2's shares), kernels
    launched per step, the wall per step of each window, and the device's
    idle share against the unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(model, batch, key(100 + i))
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / steps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(model, batch, key(200 + i))
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = device_kernels(prof)
    total_us = sum(us for us, _ in kernels.values())
    out = {"steps": steps, "wall_ms_per_step": plain_wall,
           "wall_ms_per_step_profiled": wall}
    if total_us <= 0:
        out["device_ms_per_step"] = "not measured"
        return out

    def share(kind):
        return sum(us for k, (us, _) in kernels.items()
                   if is_flash_kernel(kind, k))

    k1, k2a, k2b = (share(k) for k in ("fwd", "dq", "dkv"))
    k3 = sum(us for k, (us, _) in kernels.items() if "block_sparse_fwd" in k)
    device_ms = total_us / 1e3 / steps
    out.update(device_ms_per_step=device_ms,
               k3_ms_per_step=k3 / 1e3 / steps,
               k3_share_of_device=k3 / total_us,
               k1_ms_per_step=k1 / 1e3 / steps,
               k2a_ms_per_step=k2a / 1e3 / steps,
               k2b_ms_per_step=k2b / 1e3 / steps,
               k1_share_of_device=k1 / total_us,
               k2_share_of_device=(k2a + k2b) / total_us,
               kernels_launched_per_step=sum(
                   n for _, n in kernels.values()) / steps,
               device_idle_share=max(0.0, 1 - device_ms / plain_wall),
               device_idle_share_profiled=max(0.0, 1 - device_ms / wall),
               top_kernels_ms_per_step=top_kernels(kernels, steps, n=12),
               kinds_ms_per_step=kernel_classes(kernels, steps))
    return out


def train_grads_agree(batch) -> dict:
    """Depth 2, full width, float32: one step's loss and every gradient
    under the kernel backwards against the plain blockwise one."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    enc = V.vae_encoder_init(north_cfg().vae, seed=7, dtype=torch.float32)
    key = prng.prng_key(5, device="cuda")
    got = {}
    for impl in ("xla", "pallas", "pallas_fused"):
        model = D.dalle_init(train_cfg(depth=2, attn_bwd_impl=impl), seed=8,
                             dtype=torch.float32)
        loss = dalle_loss_fn(enc)(model, batch, key)
        loss.backward()
        got[impl] = (float(loss.detach()), {n: p.grad for n, p in
                                   model.named_parameters()})
    ref_loss, ref = got["xla"]
    worst = {}
    for impl in ("pallas", "pallas_fused"):
        loss, grads = got[impl]
        check(math.isfinite(loss) and abs(loss - ref_loss)
              <= 1e-5 * abs(ref_loss),
              f"train {impl}: loss {loss} against xla {ref_loss}")
        rel = 0.0
        for name, g in grads.items():
            scale_ = float(ref[name].abs().max())
            err = float((g - ref[name]).abs().max())
            check(err <= 1e-4 * max(scale_, 1e-30),
                  f"train {impl}: grad {name} differs from xla (max abs "
                  f"{err:.3e}, largest {scale_:.3e})")
            rel = max(rel, err / max(scale_, 1e-30))
        worst[impl] = {"loss": loss, "max_grad_err_of_largest": rel}
    worst["xla_loss"] = ref_loss
    return worst


def phase_train() -> dict:
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer, step_rng
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import (dalle_loss_fn,
                                                         make_train_step)
    cfg = train_cfg()
    enc = V.vae_encoder_init(cfg.vae, seed=7, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=6, dtype=torch.bfloat16)
    args = types.SimpleNamespace(lr=1e-4, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)
    step = make_train_step(dalle_loss_fn(enc),
                           make_optimizer(args, model.parameters()))
    batch = train_batch(cfg)
    root = prng.prng_key(0, device="cuda")

    def key(i):
        return step_rng(root, i)

    steps, warmup = 6, 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_counts(reset=True)
    losses = [step(model, batch, key(i)) for i in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(model, batch, key(i)) for i in range(warmup, steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - warmup)
    counts = flash_counts()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    for k, n in counts.items():
        check(n == cfg.depth * steps, f"{k} launched {n} times, expected "
                                      f"depth x steps = {cfg.depth * steps}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = batch["text"].shape[0] * cfg.seq_len
    prof = train_profile(step, model, batch, key)
    # one dropout keep-mask of each shape the step draws (attention output,
    # GEGLU hidden): threefry in int64, 2 x depth masks a step
    b, n = batch["text"].shape[0], cfg.seq_len
    mask_ms = {name: cuda_ms(lambda shape=shape: prng.bernoulli(
        key(0), 0.9, shape), iters=5, warmup=1)
        for name, shape in (("attn", (b, n, cfg.dim)),
                            ("ff", (b, n, cfg.dim * 4)))}
    mask_ms["per_step"] = cfg.depth * (mask_ms["attn"] + mask_ms["ff"])
    del model, step
    torch.cuda.empty_cache()
    agree = train_grads_agree(batch)
    record = dict(phase="train", ok=True, steps=steps, losses=losses,
                  ms_per_step=ms, tokens_per_step=tokens,
                  tokens_per_s=tokens / ms * 1e3, peak_mem_gib=peak_gib,
                  launches=counts, profile=prof, dropout_mask_ms=mask_ms,
                  depth2_f32=agree)
    emit(**record)
    return record


# -- block-sparse attention: K3, and K4's visible walk ------------------------

SPARSE_BLOCK = 16


def sparse_layout(n, device="cuda"):
    """(n, n) bool: the pairs K3 computes (layout and causal triangle)."""
    from dalle_pytorch_tpu_torch.ops import sparse as SP
    return SP.structural_mask(n, SPARSE_BLOCK, device=device)


def sparse_bound(dtype, b, h, n, d, pairs) -> tuple:
    """(least ms, 'bytes' | 'operations') of one K3 call: the products
    over the layout's allowed pairs (what this data needs) at the peak
    rate of the inputs' type, against q, k, v and the key mask read once
    and out, m and l written once at the HBM rate."""
    flops = 4 * d * pairs * b * h
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * h * n * d * isz + 2 * b * h * n * 4 + b * n
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sparse_case(dtype, masked: bool, timed: bool) -> dict:
    import torch.nn.functional as F
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    q, k, v, _, mask = flash_inputs(dtype, masked)
    b, h, n, d = q.shape
    name = f"{str(dtype).split('.')[-1]}/{'pad' if masked else 'all_true'}"
    rtol, atol = flash_tolerances(dtype)
    kw = dict(scale=FLASH_SCALE, causal=True, block=SPARSE_BLOCK, mask=mask)
    out, m, l = BS.block_sparse_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = BS.block_sparse_attention_fwd_plain(q, k, v, **kw)
    errs = {"out": held(f"K3 {name} out", out, out_p, rtol, atol),
            "m": held(f"K3 {name} m", m, m_p, rtol, atol),
            "l": held(f"K3 {name} l", l, l_p, 1e-4, 1e-4)}
    record = {"case": name, "rtol": rtol, "atol": atol, "max_abs_err": errs}
    if not timed:
        return record
    layout = sparse_layout(n)
    pairs = int(layout.sum())
    bms, by = sparse_bound(dtype, b, h, n, d, pairs)
    # the library yardstick: SDPA with the layout as a boolean mask is the
    # same function at the all-True key mask
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, attn_mask=layout, scale=FLASH_SCALE)
    record.update(
        allowed_pairs_per_bh=pairs,
        ms=cuda_ms(lambda: BS.block_sparse_attention_fwd(q, k, v, **kw),
                   iters=50, warmup=5),
        device_us_per_launch=named_device_us(
            lambda: BS.block_sparse_attention_fwd(q, k, v, **kw),
            "block_sparse_fwd"),
        plain_ms=cuda_ms(lambda: BS.block_sparse_attention_fwd_plain(
            q, k, v, **kw), iters=3, warmup=1),
        bound_ms=bms, bound_by=by,
        sdpa_masked_ms=cuda_ms(sdpa, iters=20, warmup=2),
        sdpa_masked_device_us=all_device_us(sdpa),
        sdpa_max_abs_diff=float((sdpa().float() - out.float()).abs().max()))
    return record


def sparse_bwd_check() -> dict:
    """Both backward routes at the north shapes in float32, with pad
    keys: the autograd Function against autograd through
    ``sparse_attention_ref``; each gradient to 2e-4 of its largest
    element (f32 sums in another order)."""
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import sparse as SP
    q, k, v, do, mask = flash_inputs(torch.float32, True)
    kw = dict(scale=FLASH_SCALE, causal=True, block=SPARSE_BLOCK, mask=mask)

    def grads(fn, **extra):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, **kw, **extra)
        return torch.autograd.grad(out, leaves, do)

    want = grads(SP.sparse_attention_ref)
    out = {}
    n = q.shape[2]
    for route, tile in (("static", 128), ("blockwise", 96)):
        static = (BS._static_tile_schedule(tile, tile, SPARSE_BLOCK,
                                           4 * SPARSE_BLOCK, (0,), True)
                  == [0] and n % tile == 0 and n > tile)
        check(static == (route == "static"), f"tile {tile} does not take "
              f"the {route} backward at n {n}")
        got = grads(BS.block_sparse_attention, block_q=tile, block_k=tile)
        worst = 0.0
        for g, w, what in zip(got, want, "qkv"):
            largest = float(w.abs().max())
            err = float((g - w).abs().max())
            check(err <= 2e-4 * largest, f"K3 {route} backward: d{what} "
                  f"differs from autograd of the oracle (max abs "
                  f"{err:.3e}, largest {largest:.3e})")
            worst = max(worst, err / largest)
        out[route] = {"tile": tile, "max_grad_err_of_largest": worst}
    return out


def visible_inputs(dtype, page_size=16, heads=8, dh=64, L=1280, seed=0):
    """Serving shapes, one slot per position of interest, every slot's
    pages mapped in random order; the mask is a sparse layer's (causal
    and its layout row), so the prefix walk over the same rows sees the
    same keys."""
    from dalle_pytorch_tpu_torch.ops import sparse as SP
    pos = torch.tensor([0, 1, 15, 16, 17, 63, 64, 65, 1279],
                       dtype=torch.int32, device="cuda")
    slots = len(pos)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mp = L // page_size
    P = slots * mp + 1
    bt = (torch.randperm(P - 1, generator=g, device="cuda") + 1) \
        .reshape(slots, mp).to(torch.int32)
    vis, _, ccnt = (torch.from_numpy(a.copy()).to("cuda") for a in
                    SP.visible_pages_causal(L, page_size, SPARSE_BLOCK))
    p = pos.long()
    allowed = (torch.arange(L, device="cuda")[None] < pos[:, None]) \
        & sparse_layout(L)[p]
    allowed[4, 3] = False                                # a padded row
    q = torch.randn((slots, heads, dh), generator=g, device="cuda")
    shape = (P, heads, page_size, dh)
    sc = {}
    if dtype == torch.int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        sc = {name: 0.01 + 0.09 * torch.rand(shape[:-1], generator=g,
                                             device="cuda")
              for name in ("k_scales", "v_scales")}
        q = q.to(torch.bfloat16)
    else:
        kp, vp = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                  for _ in range(2))
        q = q.to(dtype)
    walk = {"visible": vis[p], "visible_cnt": ccnt[p]}
    return (q, kp, vp, bt, pos, allowed), sc, walk


def visible_bound(q, kp, walk, scales) -> tuple:
    """``walk_bound`` of the visible walk: the listed pages, their count
    and list entries read from ``visible_cnt`` and ``visible`` (the
    walk reads no ``pos``)."""
    pages = int(walk["visible_cnt"].sum())
    return walk_bound(q, kp, pages, (walk["visible_cnt"].numel() + pages) * 4,
                      scales)


def visible_case(name, dtype, rtol, atol) -> dict:
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    args, sc, walk = visible_inputs(dtype)
    kw = dict(scale=FLASH_SCALE, **sc)
    got = PA.paged_decode_attention(*args, **kw, **walk)
    prefix = PA.paged_decode_attention(*args, **kw)
    want = PA.paged_decode_attention_plain(*args, **kw, **walk)
    mag = PA.paged_decode_attention_plain(args[0], args[1], args[2].abs(),
                                          *args[3:], **kw, **walk)[0]
    torch.cuda.synchronize()
    err = partials_held(f"K4 visible {name}", got, want, mag, rtol, atol)
    # the prefix walk over the same fully masked rows is the same function
    partials_held(f"K4 prefix walk, {name} sparse rows", prefix, want, mag,
                  rtol, atol)
    check(float(got[1][0, 0]) == PA.FILL
          and float(got[2][0].abs().max()) == 0.0,
          f"K4 visible {name}: the pos-0 slot must return (0, FILL, 0)")
    bms, by = visible_bound(args[0], args[1], walk, sc)
    return {"max_abs_err": err, "rtol": rtol, "atol": atol,
            "pages_walked": int(walk["visible_cnt"].sum()),
            "ms": cuda_ms(lambda: PA.paged_decode_attention(*args, **kw,
                                                             **walk),
                          iters=200),
            "device_us_per_launch": named_device_us(
                lambda: PA.paged_decode_attention(*args, **kw, **walk),
                "paged_decode_visible", iters=50),
            "prefix_walk_ms": cuda_ms(lambda: PA.paged_decode_attention(
                *args, **kw), iters=200),
            "plain_ms": cuda_ms(lambda: PA.paged_decode_attention_plain(
                *args, **kw, **walk), iters=50),
            "bound_ms": bms, "bound_by": by}


def phase_sparse_kernels() -> dict:
    results = {"k3": {}, "k4_visible": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for masked in (False, True):
            rec = sparse_case(dtype, masked, timed=not masked)
            results["k3"][rec["case"]] = rec
            emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    results["k3_backward"] = sparse_bwd_check()
    emit(phase="sparse_kernels", kernel="K3 backward", ok=True,
         **results["k3_backward"])
    for name, (dtype, rtol, atol) in {
            "float32": (torch.float32, 1e-5, 1e-5),
            "bfloat16": (torch.bfloat16, 1e-2, 1e-2),
            "int8": (torch.int8, 1e-5, 1e-4)}.items():
        rec = visible_case(name, dtype, rtol, atol)
        results["k4_visible"][name] = rec
        emit(phase="sparse_kernels", kernel="K4 visible", case=name, ok=True,
             **rec)
    return results


def sparse_counts(reset: bool = False) -> dict:
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    if reset:
        BS.block_sparse_attention_fwd.launches = 0
    return {"k3": BS.block_sparse_attention_fwd.launches,
            **flash_counts(reset)}


def sparse_train_cfg(**kw):
    """BASELINE config 4 (``bench.py::build_cfg(tiny=False, depth=64,
    sparse=True)``) with the flash kernels on its dense layers; dropout
    stays 0, as build_cfg leaves it."""
    import dataclasses
    depth = kw.pop("depth", 64)
    base = dict(depth=depth, sparse_attn=(True, False) * (depth // 2),
                sparse_impl="pallas", attn_impl="flash",
                attn_bwd_impl="pallas", loss_chunk=256)
    base.update(kw)
    return dataclasses.replace(north_cfg(), **base)


def sparse_grads_agree(batch) -> dict:
    """Depth 2, full width, float32: one step's loss and every gradient
    with K3 ('pallas') against the dense oracle ('ref')."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    enc = V.vae_encoder_init(north_cfg().vae, seed=7, dtype=torch.float32)
    key = prng.prng_key(5, device="cuda")
    got = {}
    for impl in ("ref", "pallas"):
        model = D.dalle_init(sparse_train_cfg(depth=2, sparse_impl=impl),
                             seed=8, dtype=torch.float32)
        loss = dalle_loss_fn(enc)(model, batch, key)
        loss.backward()
        got[impl] = (float(loss.detach()), {n: p.grad for n, p in
                                            model.named_parameters()})
    ref_loss, ref = got["ref"]
    loss, grads = got["pallas"]
    check(math.isfinite(loss) and abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
          f"sparse train: loss {loss} against ref {ref_loss}")
    rel = 0.0
    for name, g in grads.items():
        largest = float(ref[name].abs().max())
        err = float((g - ref[name]).abs().max())
        check(err <= 1e-4 * max(largest, 1e-30),
              f"sparse train: grad {name} differs from ref (max abs "
              f"{err:.3e}, largest {largest:.3e})")
        rel = max(rel, err / max(largest, 1e-30))
    return {"loss": loss, "ref_loss": ref_loss, "max_grad_err_of_largest": rel}


def phase_sparse_train() -> dict:
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer, step_rng
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import (dalle_loss_fn,
                                                         make_train_step)
    cfg = sparse_train_cfg()
    n_sparse = sum(cfg.transformer.sparse_pattern)
    enc = V.vae_encoder_init(cfg.vae, seed=7, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=6, dtype=torch.bfloat16)
    args = types.SimpleNamespace(lr=1e-4, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)
    step = make_train_step(dalle_loss_fn(enc),
                           make_optimizer(args, model.parameters()))
    batch = train_batch(cfg)
    root = prng.prng_key(0, device="cuda")

    def key(i):
        return step_rng(root, i)

    steps, warmup = 6, 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse_counts(reset=True)
    losses = [step(model, batch, key(i)) for i in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(model, batch, key(i)) for i in range(warmup, steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - warmup)
    counts = sparse_counts()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"sparse train losses "
                                                 f"{losses}")
    for k, n in counts.items():
        want = n_sparse * steps if k == "k3" else \
            (cfg.depth - n_sparse) * steps
        check(n == want, f"{k} launched {n} times, expected {want}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = batch["text"].shape[0] * cfg.seq_len
    prof = train_profile(step, model, batch, key)
    del model, step
    torch.cuda.empty_cache()
    # the plain sparse backward (static route) of one layer, north shapes
    q, k, v, do, mask = flash_inputs(torch.bfloat16, False)
    out, m, l = BS.block_sparse_attention_fwd(
        q, k, v, scale=FLASH_SCALE, causal=True, block=SPARSE_BLOCK,
        mask=mask)
    bwd_ms = cuda_ms(lambda: BS.block_sparse_attention_bwd(
        q, k, v, mask, do, out, (m, l), scale=FLASH_SCALE, causal=True,
        block=SPARSE_BLOCK, num_local_blocks=4, global_blocks=(0,), bq=128,
        bk=128), iters=5, warmup=1)
    del q, k, v, do, out, m, l
    agree = sparse_grads_agree(batch)
    record = dict(phase="sparse_train", ok=True, depth=cfg.depth,
                  sparse_layers=n_sparse, steps=steps, losses=losses,
                  ms_per_step=ms, tokens_per_step=tokens,
                  tokens_per_s=tokens / ms * 1e3, peak_mem_gib=peak_gib,
                  launches=counts, profile=prof,
                  plain_sparse_bwd_ms_per_layer=bwd_ms,
                  plain_sparse_bwd_ms_per_step=bwd_ms * n_sparse,
                  depth2_f32=agree)
    emit(**record)
    return record


def sparse_serve_cfg():
    import dataclasses
    return dataclasses.replace(north_cfg(), sparse_attn=(True, False) * 6)


def sparse_decode_check() -> dict:
    """Float32, full width: the sparse-reads step through K4's visible
    walk against the trimmed-gather oracle, then 64 greedy steps with
    identical tokens from the kernel and gather sparse reads and from
    the sparse-reads-off step (prefix walk under the layout mask)."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    cfg = sparse_serve_cfg()
    tcfg = cfg.transformer
    model = D.dalle_init(cfg, seed=1, dtype=torch.float32)
    slots, ps, L = 8, 16, cfg.seq_len
    mp = -(-L // ps)
    P = slots * mp + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    shape = (tcfg.depth, P, tcfg.heads, ps, tcfg.dim_head)
    pool = {"k": torch.randn(shape, generator=g, device="cuda"),
            "v": torch.randn(shape, generator=g, device="cuda")}
    pools = {name: {k: v.clone() for k, v in pool.items()}
             for name in ("kernel", "gather", "off")}
    del pool
    bt = (torch.arange(P - 1, device="cuda") + 1).reshape(slots, mp) \
        .to(torch.int32)
    pos = torch.tensor([0, 1, 15, 16, 17, 300, 640, 1000],
                       dtype=torch.int32, device="cuda")
    key_mask = torch.ones((slots, L), dtype=torch.bool, device="cuda")
    active = torch.ones((slots,), dtype=torch.bool, device="cuda")
    tok = torch.randint(0, cfg.num_text_tokens, (slots,), generator=g,
                        device="cuda").to(torch.int32)
    kw = dict(cfg=tcfg, key_mask=key_mask, active=active)
    modes = {"kernel": dict(sparse_reads=True),
             "gather": dict(sparse_reads=True, attn_impl="gather"),
             "off": dict()}
    worst = 0.0
    with torch.no_grad():
        for step in range(64):
            x = D.decode_token_embed(model, tok, pos)
            hs = {name: decode_ops.decode_step_paged(
                model.transformer, x, pos, pools[name], bt, **kw, **mode)
                for name, mode in modes.items()}
            if step == 0:
                check(torch.allclose(hs["kernel"], hs["gather"], rtol=1e-4,
                                     atol=1e-4),
                      f"sparse decode: kernel h_out differs from the "
                      f"gather oracle (max abs "
                      f"{float((hs['kernel'] - hs['gather']).abs().max()):.3e})")
            worst = max(worst, float((hs["kernel"] - hs["gather"]).abs()
                                     .max()))
            forbid = D.logits_mask(cfg, pos)
            toks = {name: D.to_logits(model, h).masked_fill(
                forbid, -math.inf).argmax(-1) for name, h in hs.items()}
            check(torch.equal(toks["kernel"], toks["gather"])
                  and torch.equal(toks["kernel"], toks["off"]),
                  f"sparse decode step {step}: greedy tokens differ")
            t_k = toks["kernel"]
            tok = torch.where(pos + 1 >= cfg.text_seq_len,
                              t_k - cfg.num_text_tokens, t_k) \
                .to(torch.int32)
            pos = pos + 1
    return {"steps": 64, "slots": slots, "max_abs_h_diff": worst}


def phase_sparse_engine() -> dict:
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    decode = sparse_decode_check()
    cfg = sparse_serve_cfg()
    n_sparse = sum(cfg.transformer.sparse_pattern)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    reqs = engine_requests(cfg)
    post = PostProcessor(vae, model)
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8, page_size=16,
                    sparse_reads=True, complete=post)
    handles = [queue.submit(r) for r in reqs]
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    PA.paged_decode_attention.visible_launches = 0
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"visible": PA.paged_decode_attention.visible_launches,
                "prefix": PA.paged_decode_attention.launches}
    results = [h.result(timeout=0) for h in handles]
    check_engine_results(cfg, reqs, results)
    steps = engine.decode_steps
    check(launches["visible"] == n_sparse * steps
          and launches["prefix"] == (cfg.depth - n_sparse) * steps,
          f"K4 launched {launches} times over {steps} decode steps, "
          f"expected {n_sparse} x steps of each walk")
    check(engine.alloc.in_use == 0, f"{engine.alloc.in_use} pages leaked")
    stats = engine.stats()
    image_tokens = len(reqs) * cfg.image_seq_len
    prof = profile_decode(engine, queue, reqs,
                          [res.tokens for res in results])
    check(engine.alloc.in_use == 0, "pages leaked after the profiled run")
    record = dict(phase="sparse_engine", ok=True, decode_f32=decode,
                  requests=len(reqs), wall_s=wall, decode_steps=steps,
                  ms_per_decode_step=wall * 1e3 / steps,
                  tokens_per_s=stats["tokens_decoded"] / wall,
                  image_tokens_per_s=image_tokens / wall,
                  harvests=stats["harvests"], pages_peak=stats["pages_peak"],
                  kv_read_bytes_per_token=stats["kv_read_bytes_per_token"],
                  kv_read_bytes_per_token_dense_reads=stats[
                      "kv_read_bytes_per_token_dense_reads"],
                  k4_launches=launches, profile=prof)
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
    flash = phase_flash()
    train = phase_train()
    sparse = phase_sparse_kernels()
    sparse_train = phase_sparse_train()
    sparse_engine = phase_sparse_engine()
    main_case = kernel["bfloat16"]
    rows = [{
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
        "library_ms": None}]
    # the flash kernels at the training main path's case: bfloat16, the
    # all-True mask; K2b as the split mode the main path launches
    fc = flash["bfloat16/all_true"]
    lib = fc["library"]
    for name, kind, line, count, library_ms in (
            ("flash_attention_fwd", "fwd", 88, "k1", lib["sdpa_fwd_ms"]),
            ("flash_attention_bwd_dq", "dq", 322, "k2a", None),
            ("flash_attention_bwd_dkv", "dkv", 367, "k2b",
             lib["sdpa_bwd_ms"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"dalle_pytorch_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][count],
            "max_abs_err": fc["max_abs_err"][kind],
            "ms": fc[kind]["ms"], "plain_ms": fc[kind]["plain_ms"],
            "bound_ms": fc[kind]["bound_ms"],
            "bound_by": fc[kind]["bound_by"], "library_ms": library_ms})
    # K3 at the sparse training path's case (bfloat16, all-True mask), and
    # K4's visible walk at the serving case (bfloat16 pages)
    k3 = sparse["k3"]["bfloat16/all_true"]
    vis = sparse["k4_visible"]["bfloat16"]
    rows += [{
        "name": "block_sparse_attention_fwd", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": sparse_train["launches"]["k3"],
        "max_abs_err": max(k3["max_abs_err"].values()),
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["sdpa_masked_ms"]}, {
        "name": "paged_decode_attention_visible", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": sparse_engine["k4_launches"]["visible"],
        "max_abs_err": vis["max_abs_err"], "ms": vis["ms"],
        "plain_ms": vis["plain_ms"], "bound_ms": vis["bound_ms"],
        "bound_by": vis["bound_by"], "library_ms": None}]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
