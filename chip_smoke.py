"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``dalle_pytorch_tpu_torch``) and nothing of JAX, at the
full width of the repo's north DALLE configuration (``bench.py``
``build_cfg(tiny=False)``: dim 512, depth 12, 8 heads of 64, text 256 +
image 1024 tokens, VAE 256 px / 2048 codes) with seeded random weights:

1. build  — compile every CUDA kernel from ``csrc/`` with nvcc (sm_90a),
   one nvcc per source, all at once; print the ``-Xptxas -v`` lines
   (registers, shared memory, spills) of the tensor-core kernels (K1,
   K2a, K2b split, K3; narrow and wide), of K4's dh-64 bodies and of the
   wide bodies (d above 128), and the card's name and power limit;
2. kernel — paged-attention kernel K4 against its plain PyTorch version
   at the serving shapes (8 slots, 8 heads, dh 64, page 16, L 1280),
   ragged positions including 0, 1, 15, 16, 17 and 1279, random data in
   every page including the trash page: float32 (TF32 off) to 1e-5,
   bfloat16 pages to 1e-2, int8 pages to rtol 1e-5 / atol 1e-4 (the
   unnormalised acc relative to its summands' magnitude, m, l and
   acc / l directly); the pos-0 slot's (0, FILL, 0) exactly, through
   the split walk (one long slot across five blocks beside short ones);
   timed with CUDA events beside the byte bound; then, untimed, dh 48
   (the dh-64 body reading rows at stride 48) in bfloat16 and int8, and
   dh 160, 192 and 256 in bfloat16 and int8 on the wide split body (the
   narrow body compiled for dh 256, rows at stride dh below it), the
   profiler naming it for every case; dh 256 timed at 8 slots x 2 heads
   (the wide serving shape) and 8 heads, beside the bound, the plain
   version and the CUDA-core wide body it replaced (held first);
3. decode — one full-width float32 decode step through the kernel
   against the dense gather (``paged_view`` + ``_gather_read``): h_out
   to 1e-4, then 64 greedy steps with identical tokens;
4. engine — the bfloat16 serving engine end to end at ``SERVE_DEPTH``
   (2: the ``engine``, ``sparse_engine``, ``wide_engine`` and
   ``rev_decode`` engines and ``import``'s model are cut from depth 12
   to keep the smoke's time, their float32 step checks are not) on 6
   requests
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
   the bfloat16 gradients dq, dk and dv to atol 0.05 x their RMS where
   that is tighter (``grad_atol``), l to rtol/atol 1e-4; each
   record gives each output's RMS and the least atol it needed, and
   names the kernel that ran for each call, from the kernels the
   profiler saw, which must be the one ``FA.kernel_body`` names
   (bfloat16 K1, K2a and K2b, split and fused, on the tensor cores up to
   d 128 and, on the wide tensor-core bodies, at d 192 and 256; the rest
   on CUDA cores). Then, untimed, d 16 and 48 at b 2, h 2, n 300
   (zero-padded to the kernels' 64 by the wrappers), and d 192 and 320
   (the wide bodies) with both masks; then the wide bodies timed at
   b 8, h 2, n 1280, d 256 (the north width as heads=2, dim_head=256).
   Each case is
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
7. wide_train — the same step at the north width split as heads=2,
   dim_head=256 (``WIDE_TRAIN``), dropout 0: 6 steps with finite
   losses, K1, K2a and K2b each launched depth x steps = 72 times, the
   profile naming the kernels that ran (the wide tensor-core bodies of
   K1, K2a and K2b split, none of the CUDA-core ones); ms per step,
   tokens per second, device ms, each kernel's ms per step, the idle
   share and peak memory. Then a depth-2 copy in bfloat16: loss and
   every gradient with 'pallas' against the plain blockwise 'xla'
   backward, to 2e-2 (of each gradient's largest element);
8. fused_train — the ``train`` phase's step with the fused single-pass
   backward (``attn_bwd_impl='pallas_fused'``) and dropout 0, at the
   north width as it is (8 heads of 64) and split as heads=2,
   dim_head=256: 6 steps each with finite losses, K1 and fused K2b each
   launched depth x steps = 72 times and K2a never, the profile naming
   the fused tensor-core bodies; ms per step, tokens per second, device
   ms, each kernel's ms per step, the idle share and peak memory. Then a
   depth-2 copy in bfloat16 at each width: loss and every gradient with
   'pallas_fused' against 'xla', to 2e-2 (of each gradient's largest
   element);
9. sparse_kernels — the block-sparse kernel K3 (out, m, l) against its
   plain version at the north training shapes (b 8, h 8, n 1280, d 64,
   block 16, causal, scale 512 ** -0.5), bfloat16 (tensor cores) and
   float32 (CUDA cores), all-True and text-padding masks, with the flash
   tolerances, and untimed at d 16 and 48 (b 2, h 2, n 300) and at d
   192 and 320 (the wide bodies: bfloat16 at d 192 on the tensor cores),
   with the wide tensor-core body timed at b 8, h 2, n 1280, d 256, each
   call's kernel named by the profiler as ``BS.kernel_body`` names it;
   then ``causal=False`` at the CLIP encoders' shapes (b 8,
   h 8, d 64: n 256 with caption padding, n 64), bfloat16 timed. Timed
   cases stand beside the plain version, the bound and
   ``F.scaled_dot_product_attention`` with the layout as a boolean mask
   (CUDA events and device time). The static and the blockwise backward
   against autograd through ``sparse_attention_ref`` in float32, each
   gradient to 2e-4 of its largest element. K4's visible walk against
   its plain version and against the prefix walk over the same fully
   masked rows at the serving shapes (8 heads, dh 64, page 16, L 1280),
   positions 0, 1, 15, 16, 17, 63, 64, 65 and 1279, in float32, bfloat16
   and int8 pages, with K4's tolerances; timed beside its byte bound; and
   in bfloat16 and int8 at 2 heads of 256 on the wide split body's
   visible twin (named by the profiler), beside the CUDA-core wide body;
10. sparse_train — the block-sparse north config at full depth (BASELINE
   config 4: depth 64, ``sparse_attn=(True, False) * 32``,
   ``sparse_impl='pallas'``, dense layers on the flash kernels with the
   split backward; bfloat16, batch 8, ``loss_chunk`` 256, dropout 0, Adam
   lr 1e-4) for 6 steps: finite losses, K3, K1, K2a and K2b each launched
   32 x steps times; ms per step, tokens per second, peak memory, a
   profiler window (K3's and K1 + K2's shares) and the plain sparse
   backward's time. Then at depth 2, full width, float32: loss and every
   gradient with 'pallas' against 'ref', as the ``train`` phase holds
   them;
11. wide_sparse_train — the same step at the width split as heads=2,
   dim_head=256 (``WIDE_SPARSE``): 6 steps with finite, falling losses,
   K3 launched 32 x steps times and K1, K2a and K2b 32 x steps each, the
   profile naming exactly their wide tensor-core bodies, each at most 32
   launches a step (none of the CUDA-core wide bodies); ms per step,
   tokens per second, device ms, each kernel's ms per step, the idle
   share and peak memory. Then a depth-2 copy in bfloat16: loss and
   every gradient with K3 and the split kernel backward against the same
   model on the kernels' plain versions: loss to 2e-2, each gradient to
   1e-2 of its norm;
12. sparse_engine — the north width with the sparse pattern at depth 12:
   one float32 decode step with sparse reads through K4's visible walk
   against the trimmed-gather oracle (h_out to 1e-4), then 64 greedy
   steps with identical tokens, identical with sparse reads off too;
   then the bfloat16 engine with ``sparse_reads=True`` on the six
   requests of the ``engine`` phase: every result ok, K4's visible walk
   and its prefix walk each launched 6 x decode steps times, every page
   freed, and the ``engine`` phase's profile windows;
13. wide_engine — serving at the north width split as heads=2,
   dim_head=256 (``WIDE_SERVE``), depth 12: one bfloat16 decode step
   through K4's wide split body against the gather oracle with bf16 and
   int8 caches (h_out to 2e-2 of its norm); at ``SERVE_DEPTH`` the
   bfloat16 engine on the
   six requests of the ``engine`` phase with profile windows early and
   late inside the run (ms a step, tokens/s, device ms, K4 ms and us a
   launch, idle share): every result ok, K4 launched depth x decode
   steps times, the profiles naming only the wide split body, every page
   freed, a re-run request with the same tokens; then the sparse pattern
   at the same width with ``sparse_reads=True`` on three requests: each
   walk's launches, and the profiles naming the wide split body of both;
14. generate — one-shot generation (``generate_images``) at the north
   width. A float32 dense-cache decode step against the paged path's
   gather oracle on the same 17-token prompt (h_out to 1e-4, then 64
   greedy steps with identical tokens); the reference CLIP at its
   published defaults (dim 512, 6 + 6 layers of 8 heads, text 256, 256
   px in 32 px patches, ``sparse_impl='pallas'``: K3 with causal=False
   in every layer) against ``'ref'`` on the same captions and images,
   float32 to 1e-4 and bfloat16 to atol 1e-2, K3 launched 12 times a
   call; then, in bfloat16 at depth 2 (``GENERATE_DEPTH``, cut from 12
   for the smoke's time), 4 full 256-token prompts with
   guidance 3.0, and int8 weights (``quantize_for_decode``) with an int8 cache on
   17-token prompts with top-p 0.9: 1024 image ids each in [0, 2048),
   finite (256, 256, 3) images, finite CLIP rerank scores with K3
   launched 12 times, the same tokens from a re-run with the same key;
   wall seconds a call, ms a decode step, images a second, and a
   profiler window of 16 guided steps (device ms and kernels a step,
   the device's idle share).

The rest of training, each phase at full width on seeded random weights,
bfloat16 parameters, batch 8, Adam lr 1e-4, 6 steps of which the first
is a warm-up (``slice_train``): finite losses, each kernel's launches a
step checked, wall ms a step, tokens or images a second, peak memory
and a profile window (device ms a step, the idle share):

15. vae_train — BASELINE config 1 (``bench.py::bench_vae``: the
   DiscreteVAE at 256 px, 2,048 codes of 256, 3 layers, hidden 128),
   the training scripts' Huber + mse loss, an EMA at decay 0.999 after
   every step (float32, moving); no attention kernel; the Gumbel noise's
   ms a step;
16. rev_train — BASELINE config 3 (``build_cfg(depth=12,
   reversible=True)``, flash with the split backward, ``loss_chunk``
   256): K1 24 launches a step (the backward recomputes each layer's
   attention), K2a and K2b 12; peak memory beside 2 steps of the same
   config with ``reversible=False``; at depth 2 with dropout 0.1, the
   loss and every gradient with the kernels against their plain versions
   (``kernels_vs_plain``: in float32 to 1e-4 of each gradient's norm; in
   bfloat16 each gradient's distance from a float32 copy at most twice
   the plain bf16 path's, or 1e-2 of its norm);
17. rev_decode — the same config decoding: one float32 step through K4
   against the gather oracle (h_out to 1e-4) and 64 greedy steps with
   identical tokens (the two-stream loop), then the bfloat16 engine on
   one 17-token request to its 1,024 image tokens, K4 launched depth x
   decode steps times, every page freed;
18. moe_train — ``bench.py::bench_moe`` (depth 12, every FF a top-2 MoE
   of 8 experts): K1, K2a and K2b 12 a step; the load-balance loss
   finite and positive, the loss equal to the CE plus ``moe_aux_coef``
   times it;
19. clip_train — ``CLIPConfig()``'s defaults with ``sparse_impl='pallas'``
   and padded captions: K3 (``causal=False``) 12 launches a step; at 2 +
   2 layers the kernels against their plain versions, as ``rev_train``;
20. remat — the ``train`` phase's config at dropout 0 for 2 steps under
   each of 'none', 'save_ln', 'dots' and 'full': the first loss
   identical, the second within 1e-3, peak memory per mode, K1 12, 12,
   24 and 24 launches a step; at depth 2, each mode's gradients against
   'none''s with the kernels, to 1e-2 of each norm.

The entry points a user calls, through ``main(argv)``:

21. cli — 16 PNGs at 256 px written by the port's encoder and read back
   equal (decode ms an image, and of a file using every row filter);
   ``train_vae`` one epoch of 2 steps at batch 8 on the north VAE (256
   px, 2,048 codes of 512, 3 layers, hidden 64); ``train_dalle`` at the
   north width (``CLI_DALLE``: flash with the split kernel backward,
   bfloat16, ``loss_chunk`` 256, dropout 0.1, an EMA at 0.999) for 2
   epochs of 2 steps, K1, K2a and K2b each launched 12 times a step, ms
   a step from its own metrics beside the ``train`` phase's; the same
   run in two legs (epoch 0, then ``--auto_resume``) whose checkpoint
   payloads (parameters, Adam state, EMA) equal the uninterrupted run's
   byte for byte; the checkpoint's bytes, the msgpack codec's read and
   write rates; ``gen_dalle`` of 2 images from the epoch-1 checkpoint,
   its grid PNG 260 x 518 x 3; each CLI's wall seconds and peak memory.

The single engine's serving features and reference weights:

22. serve_features — 8 requests (prompts of 1, 17 and 256 tokens, two
   pairs sharing a prompt, two guided at cfg_scale 3.0, priorities 0 and
   1, top-k, top-p 0.9 and greedy) at the north width in bfloat16 on 8
   slots, K = 8, page 16, through three engines: A, the paged kernel
   engine with the prefix cache on a pool cut to four sequences
   (``FEATURE_PAGES``), so eviction fires, and the postprocess worker
   scoring every image through a seeded ``CLIPConfig()`` CLIP (K3
   non-causal); B, the same with ``speculative=4``, ``draft_layers=6``
   (K4 once per draft and verify offset: rounds x (6 x 6 + 12 x 4)
   launches, and K4 held against its plain version at a verify offset's
   row mask on the run's live state); C, ``kv='dense'`` through the
   gather (no K4). The checks: evicted >= 1, prefix_hits >= 2,
   cfg_pairs == 2, no page leaks, the index's clear() returning every
   page, K4's launch counts, the worker's scores against ``clip_apply``,
   an injected failure as ``status='error'``; then A, B and C in float32
   at depth 4 must give identical tokens (at bfloat16 depth 12 the share
   of identical tokens and the first divergences are printed). ms a step
   or round, image tokens/s, acceptance, the prefill ms warm admission
   saves, the pool's peak, the pages a guided pair holds over an
   unguided request's, evictions and a profiled window's idle share;
23. import — a seeded reference-layout DALLE ``state_dict`` at the north
   width through ``import_torch dalle``, ``gen_dalle`` (one image on the
   card) and ``import_torch export-dalle``: every tensor back bit for
   bit; the seconds of each.

Each phase prints one JSON line; the kernel table and the card line
follow, and the last line is ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA card: without one it exits 2 before doing anything.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
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


PHASE_SECONDS: dict = {}


def timed(phase, *args):
    """Run ``phase(*args)`` and keep its wall seconds under its name."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[phase.__name__] = time.perf_counter() - t0
    return out


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


# depth of the earlier serving phases' engines (``engine``,
# ``sparse_engine``, ``wide_engine``, ``rev_decode``; their float32 step
# checks keep full depth) and of ``import``'s model, cut from 12 to keep
# the smoke's time with the ``serve_features`` phase, which serves at
# depth 12; their steps are host-bound, a fixed cost plus a share per
# layer
SERVE_DEPTH = 2


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
                                 "Li64E"),
         wide_ptxas={name: ptxas_lines(build.build_log(name), "wide")
                     for name in build.SOURCES})
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


def kernel_inputs(dtype, page_size=16, slots=8, heads=8, dh=64,
                  L=1280, seed=0, positions=(0, 1, 15, 16, 17, 1279, 640,
                                             1000)):
    """North serving shapes: the engine's fully provisioned pool (8 slots
    x 80 pages + trash), one distinct page run per slot, ragged pos."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mp = L // page_size
    P = slots * mp + 1
    dev = "cuda"
    pos = torch.tensor(positions[:slots], dtype=torch.int32, device=dev)
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


# the __global__ of a profiler's kernel name (namespace and template
# arguments cut): K4's (as PA.kernel_body names them) and K3's
K4_NAME = r"(paged_decode\w*?_kernel)<"
K3_NAME = r"(block_sparse_\w+?_kernel)<"


def launched_bodies(fn, pattern: str, calls: int = 12,
                    attempts: int = 3) -> list:
    """The ``__global__`` functions (``pattern``'s group) that ``calls``
    profiled calls of ``fn`` ran. A session that records none (one may
    drop the records of its first milliseconds) is tried again, up to
    ``attempts``; then []."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = sorted({f for k in device_kernels(prof)
                        for f in re.findall(pattern, k)})
        if names:
            return names
    return []


@contextlib.contextmanager
def k4_cuda_core_route():
    """K4's bfloat16 and int8 calls above dh 128 sent back to the
    CUDA-core wide body, at its own split size: the "before" of the wide
    split body, timed in the same run."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    wide_split = PA.wide_split
    PA.wide_split = lambda kv_dtype, dh: False
    try:
        yield
    finally:
        PA.wide_split = wide_split


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
    # a head dim between the compiled widths: the dh-64 body, rows read
    # at stride 48, lanes past 48 zero
    for name in ("bfloat16", "int8"):
        dtype, rtol, atol = cases[name]
        q, kp, vp, bt, pos, allowed, sc = kernel_inputs(dtype, dh=48)
        kw = dict(scale=scale, **sc)
        got = PA.paged_decode_attention(q, kp, vp, bt, pos, allowed, **kw)
        want = PA.paged_decode_attention_plain(q, kp, vp, bt, pos, allowed,
                                               **kw)
        mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), bt, pos,
                                              allowed, **kw)[0]
        torch.cuda.synchronize()
        check(got[0].shape == (8, 8, 48), f"K4 {name} dh 48: acc shape "
                                          f"{tuple(got[0].shape)}")
        err = partials_held(f"K4 {name} dh 48", got, want, mag, rtol, atol)
        results[f"{name}/dh48"] = {"max_abs_err": err}
        emit(phase="kernel", case=f"{name}/dh48", ok=True, rtol=rtol,
             atol=atol, max_abs_err=err)
    # heads above 128: bfloat16 and int8 pages on the wide split body
    # (dh 160 and 192 at stride dh), its prefix walk split into runs of
    # WIDE_SPLIT_ROWS rows; timed at dh 256 with 2 heads (the wide serving
    # shape, heads=2, dim_head=256) and 8 (8 slots x 8 heads), beside the
    # CUDA-core wide body it replaces
    for dh, heads in ((160, 8), (192, 8), (256, 8), (256, 2)):
        for name in ("bfloat16", "int8"):
            dtype, rtol, atol = cases[name]
            key = f"{name}/dh{dh}" + ("" if heads == 8 else f"/h{heads}")
            rec = wide_case(key, dtype, rtol, atol, dh, heads,
                            timed=dh == 256)
            results[key] = rec
            emit(phase="kernel", case=key, ok=True, rtol=rtol, atol=atol,
                 **rec)
    return results


def wide_case(key, dtype, rtol, atol, dh: int, heads: int,
              timed: bool) -> dict:
    """K4's prefix walk at 128 < dh <= 256 on the serving shapes of
    ``kernel_inputs``, against its plain version with K4's tolerances,
    the pos-0 slot's (0, FILL, 0) exactly, the kernel the profiler saw
    the one ``PA.kernel_body`` names (the wide split body); timed: CUDA
    events and profiler device us a launch beside the bound and the
    plain version, and the CUDA-core wide body's the same way, held
    first to the same tolerances."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    q, kp, vp, bt, pos, allowed, sc = kernel_inputs(dtype, heads=heads,
                                                    dh=dh)
    kw = dict(scale=512 ** -0.5, **sc)
    call = lambda: PA.paged_decode_attention(   # noqa: E731
        q, kp, vp, bt, pos, allowed, **kw)
    plain = lambda: PA.paged_decode_attention_plain(   # noqa: E731
        q, kp, vp, bt, pos, allowed, **kw)
    got, want = call(), plain()
    mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), bt, pos, allowed,
                                          **kw)[0]
    torch.cuda.synchronize()
    check(got[0].shape == (8, heads, dh), f"K4 {key}: acc shape "
                                          f"{tuple(got[0].shape)}")
    err = partials_held(f"K4 {key}", got, want, mag, rtol, atol)
    check(float(got[1][0, 0]) == PA.FILL and float(got[2][0].abs().max())
          == 0.0 and float(got[0][0].abs().max()) == 0.0,
          f"K4 {key}: the pos-0 slot must return (0, FILL, 0)")
    body = PA.kernel_body(kp.dtype, dh)
    ran = launched_bodies(call, K4_NAME)
    check(ran == [body] and PA.wide_split(kp.dtype, dh),
          f"K4 {key}: ran {ran}, not [{body}]")
    rec = {"max_abs_err": err, "body": body}
    if not timed:
        return rec
    bms, by = bound_ms(q, kp, pos, sc)
    ms = cuda_ms(call, iters=200)
    rec.update(ms=ms, us_per_launch=ms * 1e3,
               device_us_per_launch=named_device_us(call, body + "<",
                                                    iters=50),
               plain_ms=cuda_ms(plain, iters=20), bound_ms=bms, bound_by=by,
               bound_us=bms * 1e3)
    rec["plain_us"] = rec["plain_ms"] * 1e3
    with k4_cuda_core_route():
        old = "paged_decode_wide_kernel"
        ran = launched_bodies(call, K4_NAME)
        check(ran == [old], f"K4 {key}: the CUDA-core route ran {ran}")
        rec["cuda_core_max_abs_err"] = partials_held(
            f"K4 {key} CUDA-core body", call(), want, mag, rtol, atol)
        rec["cuda_core_us_per_launch"] = cuda_ms(call, iters=100) * 1e3
        rec["cuda_core_device_us_per_launch"] = named_device_us(
            call, old + "<", iters=50)
    return rec


def phase_decode() -> None:
    emit(phase="decode", ok=True, **paged_decode_check(north_cfg()))


def paged_decode_check(cfg) -> dict:
    """One float32 decode step of ``cfg`` at 8 ragged slots through K4
    against the gather oracle (h_out to 1e-4), then 64 greedy steps with
    identical tokens, each path writing its own pool."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
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
    return {"steps": 64, "slots": slots, "max_abs_h_diff": worst}


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
               k4_bodies=sorted({f for k in kernels
                                 for f in re.findall(K4_NAME, k)}),
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
    prof = profile_run(engine, chunks, late_chunk)
    for h, want in zip(handles, want_tokens):
        res = h.result(timeout=0)
        check(res.ok and list(res.tokens) == list(want),
              f"re-run request {res.request_id} gave other tokens")
    return prof


def profile_run(engine, chunks: int = 4, late_chunk: int = 110) -> dict:
    """The engine's submitted requests run to their end, admitted by the
    first step, with a ``profile_window`` early (after two steady
    chunks) and late (from chunk ``late_chunk``)."""
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
    import dataclasses
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    reqs = engine_requests(cfg)
    post = PostProcessor(vae, model)
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8, kv="paged",
                    page_size=16, paged_attn="kernel", complete=post)
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
# heads above 128 (the wide bodies): the untimed head dims, and the timed
# shape: the north width split as heads=2, dim_head=256 (bench.py
# build_cfg takes heads * dim_head = 512), batch 8, causal
WIDE_DIMS = (192, 320)
WIDE_TIMED = dict(b=8, h=2, n=1280, d=256)


def flash_tolerances(dtype) -> tuple:
    """(rtol, atol) of the kernels' outputs against the plain versions:
    float32 2e-4 (both accumulate in f32, over 1,280 terms in another
    order; the fused dq adds its shares with atomics in an order that
    changes from run to run); bfloat16 2e-2 (one bf16 rounding of the
    output, 2^-8 relative, on either side). The bfloat16 gradients take
    a tighter atol: ``grad_atol``."""
    return (2e-4, 2e-4) if dtype == torch.float32 else (2e-2, 2e-2)


# a bfloat16 gradient's atol as a share of its own RMS. At the north
# shapes a typical |dq| (and |dk|) is 0.35 / sqrt(row), under 0.02 past
# row 300, so the 2e-2 floor alone passes a key tile left out of the
# late rows' sums (chip_flash_variants.py's planted fault); what is left
# of the error past rtol x |want| is a few bf16 roundings of single
# terms, 0.4 % of the RMS at most at the north shapes
BF16_GRAD_ATOL_OF_RMS = 0.05


def rms(t) -> float:
    return float(t.float().square().mean().sqrt())


def grad_atol(dtype, want, atol) -> float:
    """The atol a gradient ``want`` is held to: bfloat16's ``atol``
    tightened to ``BF16_GRAD_ATOL_OF_RMS`` x RMS(want); float32's as it
    is."""
    if dtype != torch.bfloat16:
        return atol
    return min(atol, BF16_GRAD_ATOL_OF_RMS * rms(want))


def atol_needed(got, want, rtol) -> float:
    """The least atol at which ``got`` holds against ``want`` at rtol."""
    excess = ((got.float() - want.float()).abs()
              - rtol * want.float().abs()).max()
    return max(float(excess), 0.0)


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
# template part); ``FA.kernel_body`` names the one each call runs
FLASH_KERNELS = {"fwd": (("flash_fwd_wgmma_kernel", ""),
                         ("flash_fwd_kernel", ""),
                         ("flash_fwd_wide_wgmma_kernel", ""),
                         ("flash_fwd_wide_kernel", "")),
                 "dq": (("flash_bwd_dq_wgmma_kernel", ""),
                        ("flash_bwd_dq_kernel", ""),
                        ("flash_bwd_dq_wide_wgmma_kernel", ""),
                        ("flash_bwd_dq_wide_kernel", "")),
                 "dkv": (("flash_bwd_dkv_wgmma_kernel", ""),
                         ("flash_bwd_dkv_kernel", "false>"),
                         ("flash_bwd_dkv_wide_wgmma_kernel", ""),
                         ("flash_bwd_dkv_wide_kernel", "false>")),
                 "fused": (("flash_bwd_fused_wgmma_kernel", ""),
                           ("flash_bwd_dkv_kernel", "true>"),
                           ("flash_bwd_fused_wide_wgmma_kernel", ""),
                           ("flash_bwd_dkv_wide_kernel", "true>"))}


def is_flash_kernel(kind: str, name: str) -> bool:
    return any(part in name and variant in name
               for part, variant in FLASH_KERNELS[kind])


def flash_body(names) -> list:
    """The ``__global__`` functions of the profiler's kernel names
    ``names`` (namespace and template arguments cut), as
    ``FA.kernel_body`` names them; [] when none was recorded."""
    return sorted({fn for k in names
                   for fn in re.findall(r"(flash_\w+?_kernel)<", k)})


def flash_bodies(kernels: dict) -> dict:
    """{K1 'fwd', K2a 'dq', K2b split 'dkv', K2b fused 'fused': the flash
    functions a profile ``kernels`` recorded for it}."""
    return {kind: flash_body(k for k in kernels if is_flash_kernel(kind, k))
            for kind in ("fwd", "dq", "dkv", "fused")}


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


def case_name(dtype, masked: bool, d: int) -> str:
    name = f"{str(dtype).split('.')[-1]}/{'pad' if masked else 'all_true'}"
    return name if d == 64 else f"{name}/d{d}"


def flash_case(dtype, masked: bool, timed: bool, **shape) -> dict:
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    q, k, v, do, mask = flash_inputs(dtype, masked, **shape)
    b, h, n, d = q.shape
    name = case_name(dtype, masked, d)
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
    gatol = {"dq": grad_atol(dtype, dq_p, atol),
             "dk": grad_atol(dtype, dk_p, atol),
             "dv": grad_atol(dtype, dv_p, atol)}
    dq = FA.flash_attention_bwd_dq(*args, **kw)
    errs["dq"] = held(f"K2a {name} dq", dq, dq_p, rtol, gatol["dq"])
    dk, dv, _ = FA.flash_attention_bwd_dkv(*args, **kw)
    errs["dkv"] = max(
        held(f"K2b split {name} dk", dk, dk_p, rtol, gatol["dk"]),
        held(f"K2b split {name} dv", dv, dv_p, rtol, gatol["dv"]))
    # how tight each output's atol is: its RMS, and the least atol at which
    # it holds at rtol
    wants = {"fwd": out_p, "dq": dq_p, "dk": dk_p, "dv": dv_p}
    gots = {"fwd": out, "dq": dq, "dk": dk, "dv": dv}
    tight = {kind: {"rms": rms(want),
                    "atol_needed": atol_needed(gots[kind], want, rtol)}
             for kind, want in wants.items()}
    dk, dv, dq32 = FA.flash_attention_bwd_dkv(*args, with_dq=True, **kw)
    errs["fused"] = max(
        held(f"K2b fused {name} dk", dk, dk_p, rtol, gatol["dk"]),
        held(f"K2b fused {name} dv", dv, dv_p, rtol, gatol["dv"]),
        held(f"K2b fused {name} dq", dq32, dq32_p, rtol, gatol["dq"]))
    torch.cuda.synchronize()
    del dq_p, dk_p, dv_p, dq32_p
    record = {"case": name, "rtol": rtol, "atol": atol, "grad_atol": gatol,
              "max_abs_err": errs, "tightness": tight}
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
    # every call runs the body the dispatch names: bfloat16 K1, K2a and
    # K2b (split and fused) on the tensor cores up to d 128, K1 and K2b at
    # d 192 and 256 (the wide tensor-core bodies); the rest on CUDA cores
    # ([]: the profiler recorded none of the call's launches)
    for kind in calls:
        want = FA.kernel_body(kind, dtype, d)
        check(record["bodies"][kind] in ([want], []),
              f"{name}: {kind} ran {record['bodies'][kind]}, not {want}")
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
    # head dims the wrappers pad to the kernels' 64, with text padding
    for d in (16, 48):
        for dtype in (torch.bfloat16, torch.float32):
            rec = flash_case(dtype, True, timed=False, b=2, h=2, n=300, d=d)
            results[rec["case"]] = rec
            emit(phase="flash", ok=True, **rec)
    # heads above 128: the wide bodies, untimed at d 192 and 320, then
    # timed at the north width split as heads=2, dim_head=256
    for d in WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for masked in (False, True):
                rec = flash_case(dtype, masked, timed=False, b=2, h=2,
                                 n=300, d=d)
                results[rec["case"]] = rec
                emit(phase="flash", ok=True, **rec)
    rec = flash_case(torch.bfloat16, False, timed=True, **WIDE_TIMED)
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

    k1, k2a, k2b, fused = (share(k) for k in ("fwd", "dq", "dkv", "fused"))
    k3 = sum(us for k, (us, _) in kernels.items() if "block_sparse_fwd" in k)
    device_ms = total_us / 1e3 / steps
    out.update(device_ms_per_step=device_ms,
               k3_ms_per_step=k3 / 1e3 / steps,
               k3_share_of_device=k3 / total_us,
               k1_ms_per_step=k1 / 1e3 / steps,
               k2a_ms_per_step=k2a / 1e3 / steps,
               k2b_ms_per_step=k2b / 1e3 / steps,
               k2b_fused_ms_per_step=fused / 1e3 / steps,
               k1_share_of_device=k1 / total_us,
               k2_share_of_device=(k2a + k2b + fused) / total_us,
               kernels_launched_per_step=sum(
                   n for _, n in kernels.values()) / steps,
               device_idle_share=max(0.0, 1 - device_ms / plain_wall),
               device_idle_share_profiled=max(0.0, 1 - device_ms / wall),
               top_kernels_ms_per_step=top_kernels(kernels, steps, n=12),
               kinds_ms_per_step=kernel_classes(kernels, steps),
               flash_bodies=flash_bodies(kernels),
               body_launches_per_step=body_launches(kernels, steps))
    return out


def body_launches(kernels: dict, steps: int) -> dict:
    """{``__global__`` function of the port's flash and block-sparse
    kernels (as ``kernel_body`` names it): launches per step} of a
    profile ``kernels`` over ``steps`` steps."""
    out = {}
    for k, (_, n) in kernels.items():
        for fn in set(re.findall(r"((?:flash|block_sparse)_\w+?_kernel)<",
                                 k)):
            out[fn] = out.get(fn, 0) + n / steps
    return out


def train_grads_agree(batch, dtype=torch.float32,
                      impls=("pallas", "pallas_fused"), **cfg_kw) -> dict:
    """Depth 2, full width: one step's loss and every gradient under the
    kernel backwards ``impls`` against the plain blockwise one ('xla'),
    which shares the forward (K1). float32: loss to rtol 1e-5, each
    gradient to 1e-4 of its largest element (f32 sums in other orders,
    and the fused dq's atomics); bfloat16: both to 2e-2, the flash
    kernels' bf16 tolerance (each side rounds p, ds and every gradient
    to bf16 at its own places in the sums)."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    loss_rtol, grad_rtol = (1e-5, 1e-4) if dtype == torch.float32 else \
        (2e-2, 2e-2)
    enc = V.vae_encoder_init(north_cfg().vae, seed=7, dtype=dtype)
    key = prng.prng_key(5, device="cuda")
    got = {}
    for impl in ("xla",) + tuple(impls):
        model = D.dalle_init(train_cfg(depth=2, attn_bwd_impl=impl,
                                       **cfg_kw), seed=8, dtype=dtype)
        loss = dalle_loss_fn(enc)(model, batch, key)
        loss.backward()
        got[impl] = (float(loss.detach()), {n: p.grad.float() for n, p in
                                   model.named_parameters()})
        del model
    ref_loss, ref = got["xla"]
    worst = {}
    for impl in impls:
        loss, grads = got[impl]
        check(math.isfinite(loss) and abs(loss - ref_loss)
              <= loss_rtol * abs(ref_loss),
              f"train {impl}: loss {loss} against xla {ref_loss}")
        rel = 0.0
        for name, g in grads.items():
            scale_ = float(ref[name].abs().max())
            err = float((g - ref[name]).abs().max())
            check(err <= grad_rtol * max(scale_, 1e-30),
                  f"train {impl}: grad {name} differs from xla (max abs "
                  f"{err:.3e}, largest {scale_:.3e})")
            rel = max(rel, err / max(scale_, 1e-30))
        worst[impl] = {"loss": loss, "max_grad_err_of_largest": rel}
    worst["xla_loss"] = ref_loss
    worst["tolerance"] = {"loss_rtol": loss_rtol,
                          "grad_of_largest": grad_rtol}
    return worst


def train_run(cfg, phase: str, steps: int = 6, warmup: int = 1) -> tuple:
    """``steps`` training steps of ``cfg`` (bfloat16 params, the smoke's
    batch, Adam lr 1e-4 through ``make_train_step``), the first a
    warm-up: finite losses, K1 and K2b each launched depth x steps times,
    K2a as often under the split backward and never under the fused one
    (``attn_bwd_impl='pallas_fused'``, where K2b's count is of fused
    launches); then a profile window. Returns (record, batch, key)."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer, step_rng
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import (dalle_loss_fn,
                                                         make_train_step)
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
    check(all(math.isfinite(x) for x in losses), f"{phase} losses {losses}")
    fused = cfg.attn_bwd_impl == "pallas_fused"
    for k, n in counts.items():
        want = 0 if fused and k == "k2a" else cfg.depth * steps
        check(n == want, f"{phase}: {k} launched {n} times, expected "
                         f"{want} (depth {cfg.depth}, {steps} steps, "
                         f"{cfg.attn_bwd_impl})")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = batch["text"].shape[0] * cfg.seq_len
    prof = train_profile(step, model, batch, key)
    del model, step
    torch.cuda.empty_cache()
    record = dict(phase=phase, ok=True, steps=steps, losses=losses,
                  ms_per_step=ms, tokens_per_step=tokens,
                  tokens_per_s=tokens / ms * 1e3, peak_mem_gib=peak_gib,
                  launches=counts, profile=prof)
    return record, batch, key


def phase_train() -> dict:
    from dalle_pytorch_tpu_torch.ops import prng
    cfg = train_cfg()
    record, batch, key = train_run(cfg, "train")
    # one dropout keep-mask of each shape the step draws (attention output,
    # GEGLU hidden): threefry in int64, 2 x depth masks a step
    b, n = batch["text"].shape[0], cfg.seq_len
    mask_ms = {name: cuda_ms(lambda shape=shape: prng.bernoulli(
        key(0), 0.9, shape), iters=5, warmup=1)
        for name, shape in (("attn", (b, n, cfg.dim)),
                            ("ff", (b, n, cfg.dim * 4)))}
    mask_ms["per_step"] = cfg.depth * (mask_ms["attn"] + mask_ms["ff"])
    record.update(dropout_mask_ms=mask_ms, depth2_f32=train_grads_agree(batch))
    emit(**record)
    return record


# the north width split as heads=2, dim_head=256 (``bench.py::build_cfg``
# takes heads * dim_head = 512), dropout 0 (the JAX DALLEConfig default)
WIDE_TRAIN = dict(heads=2, dim_head=256, attn_dropout=0.0, ff_dropout=0.0)


def phase_wide_train() -> dict:
    """The ``train`` phase's step at ``WIDE_TRAIN``: K1, K2a and K2b split
    on the wide tensor-core bodies, each launched depth x steps times and
    named in the profile (none of the CUDA-core wide bodies); then a
    depth-2 copy in bfloat16, where those bodies run, against the plain
    blockwise backward."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    cfg = train_cfg(**WIDE_TRAIN)
    record, batch, _ = train_run(cfg, "wide_train")
    bodies = record["profile"].get("flash_bodies", {})
    for kind in ("fwd", "dq", "dkv"):
        want = [FA.kernel_body(kind, torch.bfloat16, cfg.dim_head)]
        check(bodies.get(kind) == want,
              f"wide_train: {kind} ran {bodies.get(kind)}, not {want}")
    record["depth2_bf16"] = train_grads_agree(batch, dtype=torch.bfloat16,
                                              impls=("pallas",),
                                              **WIDE_TRAIN)
    emit(**record)
    return record


# the fused single-pass backward at the north width and at WIDE_TRAIN's
# split, dropout 0 (the JAX DALLEConfig default) at both
FUSED_WIDTHS = {"north": dict(attn_dropout=0.0, ff_dropout=0.0),
                "wide": WIDE_TRAIN}


def phase_fused_train() -> dict:
    """The ``train`` phase's step under ``attn_bwd_impl='pallas_fused'``
    at both widths of ``FUSED_WIDTHS``: K1 and fused K2b on their
    tensor-core bodies, each launched depth x steps times and named in
    the profile, K2a never launched; then a depth-2 copy in bfloat16
    against the plain blockwise backward."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    records = {}
    for width, kw in FUSED_WIDTHS.items():
        cfg = train_cfg(attn_bwd_impl="pallas_fused", **kw)
        record, batch, _ = train_run(cfg, f"fused_train/{width}")
        bodies = record["profile"].get("flash_bodies", {})
        for kind in ("fwd", "fused"):
            want = [FA.kernel_body(kind, torch.bfloat16, cfg.dim_head)]
            check(bodies.get(kind) == want, f"fused_train/{width}: {kind} "
                                            f"ran {bodies.get(kind)}, not "
                                            f"{want}")
        for kind in ("dq", "dkv"):
            check(not bodies.get(kind), f"fused_train/{width}: {kind} ran "
                                        f"{bodies.get(kind)}")
        record["depth2_bf16"] = train_grads_agree(
            batch, dtype=torch.bfloat16, impls=("pallas_fused",), **kw)
        emit(**record)
        records[width] = record
    return records


# -- block-sparse attention: K3, and K4's visible walk ------------------------

SPARSE_BLOCK = 16


def sparse_layout(n, device="cuda", causal=True):
    """(n, n) bool: the pairs K3 computes (layout and causal triangle)."""
    from dalle_pytorch_tpu_torch.ops import sparse as SP
    return SP.structural_mask(n, SPARSE_BLOCK, causal=causal, device=device)


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


def sparse_case(dtype, masked: bool, timed: bool, causal: bool = True,
                **shape) -> dict:
    import torch.nn.functional as F
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    q, k, v, _, mask = flash_inputs(dtype, masked, **shape)
    b, h, n, d = q.shape
    name = case_name(dtype, masked, d)
    if not causal:
        name = f"{name}/noncausal/n{n}"
    rtol, atol = flash_tolerances(dtype)
    kw = dict(scale=FLASH_SCALE, causal=causal, block=SPARSE_BLOCK,
              mask=mask)
    out, m, l = BS.block_sparse_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = BS.block_sparse_attention_fwd_plain(q, k, v, **kw)
    errs = {"out": held(f"K3 {name} out", out, out_p, rtol, atol),
            "m": held(f"K3 {name} m", m, m_p, rtol, atol),
            "l": held(f"K3 {name} l", l, l_p, 1e-4, 1e-4)}
    record = {"case": name, "rtol": rtol, "atol": atol, "max_abs_err": errs,
              "atol_needed": atol_needed(out, out_p, rtol)}
    # the call runs the body the dispatch names (bfloat16 on the tensor
    # cores up to d 128 and at 192 and 256; the rest on CUDA cores; []:
    # the profiler recorded none of its launches)
    record["body"] = sparse_bodies(
        lambda: BS.block_sparse_attention_fwd(q, k, v, **kw))
    want = BS.kernel_body(dtype, d)
    check(record["body"] in ([want], []),
          f"K3 {name} ran {record['body']}, not {want}")
    if not timed:
        return record
    layout = sparse_layout(n, causal=causal)
    pairs = int(layout.sum())
    bms, by = sparse_bound(dtype, b, h, n, d, pairs)
    # the library yardstick: SDPA with the layout (and the pad keys) as a
    # boolean mask is the same function while every row sees a live key
    # (key 0, in the global block, is live in every case here)
    allowed = layout if not masked else layout & mask[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, attn_mask=allowed, scale=FLASH_SCALE)
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


def sparse_bodies(fn, calls: int = 12, attempts: int = 3) -> list:
    """The K3 ``__global__`` functions that ``calls`` profiled calls of
    ``fn`` ran (as ``BS.kernel_body`` names them)."""
    return launched_bodies(fn, K3_NAME, calls, attempts)


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


def visible_case(name, dtype, rtol, atol, heads=8, dh=64) -> dict:
    """K4's visible walk at ``visible_inputs``' shapes against its plain
    version, and the prefix walk over the same rows, with K4's
    tolerances; timed beside its bound. Above dh 128 the profiler must
    name the wide split body, and the CUDA-core wide body it replaces is
    held and timed too."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    args, sc, walk = visible_inputs(dtype, heads=heads, dh=dh)
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
    call = lambda: PA.paged_decode_attention(*args, **kw,   # noqa: E731
                                             **walk)
    body = PA.kernel_body(args[1].dtype, dh, visible=True)
    rec = {"max_abs_err": err, "rtol": rtol, "atol": atol,
           "pages_walked": int(walk["visible_cnt"].sum()),
           "ms": cuda_ms(call, iters=200),
           "device_us_per_launch": named_device_us(call, body + "<",
                                                   iters=50),
           "prefix_walk_ms": cuda_ms(lambda: PA.paged_decode_attention(
               *args, **kw), iters=200),
           "plain_ms": cuda_ms(lambda: PA.paged_decode_attention_plain(
               *args, **kw, **walk), iters=50),
           "bound_ms": bms, "bound_by": by}
    if dh > 128:
        ran = launched_bodies(call, K4_NAME)
        check(ran == [body], f"K4 visible {name}: ran {ran}, not [{body}]")
        rec["body"] = body
        with k4_cuda_core_route():
            rec["cuda_core_max_abs_err"] = partials_held(
                f"K4 visible {name} CUDA-core body", call(), want, mag,
                rtol, atol)
            rec["cuda_core_device_us_per_launch"] = named_device_us(
                call, "paged_decode_wide_kernel<", iters=50)
    return rec


def phase_sparse_kernels() -> dict:
    results = {"k3": {}, "k4_visible": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for masked in (False, True):
            rec = sparse_case(dtype, masked, timed=not masked)
            results["k3"][rec["case"]] = rec
            emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    for d in (16, 48):               # padded to the kernel's 64
        for dtype in (torch.bfloat16, torch.float32):
            rec = sparse_case(dtype, True, timed=False, b=2, h=2, n=300, d=d)
            results["k3"][rec["case"]] = rec
            emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    # heads above 128: the wide body, untimed at d 192 and 320, timed at
    # heads=2, dim_head=256
    for d in WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for masked in (False, True):
                rec = sparse_case(dtype, masked, timed=False, b=2, h=2,
                                  n=300, d=d)
                results["k3"][rec["case"]] = rec
                emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    rec = sparse_case(torch.bfloat16, False, timed=True, **WIDE_TIMED)
    results["k3"][rec["case"]] = rec
    emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    # causal=False at the CLIP encoders' shapes: the text encoder's 256
    # tokens with caption padding, the visual encoder's 64 patches
    for n, masked in ((256, True), (64, False)):
        for dtype in (torch.bfloat16, torch.float32):
            rec = sparse_case(dtype, masked, timed=dtype == torch.bfloat16,
                              causal=False, b=8, h=8, n=n, d=64)
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
        if dtype == torch.float32:
            continue
        # the wide serving width, heads=2, dim_head=256: the wide split
        # body's visible twin
        key = f"{name}/dh256/h2"
        rec = visible_case(key, dtype, rtol, atol, heads=2, dh=256)
        results["k4_visible"][key] = rec
        emit(phase="sparse_kernels", kernel="K4 visible", case=key, ok=True,
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


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the attention modules call the plain PyTorch
    versions of K1, K2a, K2b and K3 in place of their kernel wrappers,
    also on CUDA tensors: the yardstick of a kernel path in its own dtype
    (no kernel launches, so no launch counts)."""
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    swaps = ((FA, "flash_attention_fwd", FA.flash_attention_fwd_plain),
             (FA, "flash_attention_bwd_dq", FA.flash_attention_bwd_dq_plain),
             (FA, "flash_attention_bwd_dkv",
              FA.flash_attention_bwd_dkv_plain),
             (BS, "block_sparse_attention_fwd",
              BS.block_sparse_attention_fwd_plain))
    kept = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, kept):
            setattr(mod, name, fn)


def sparse_grads_agree(batch, dtype=torch.float32, **cfg_kw) -> dict:
    """Depth 2, full width: one step's loss and every gradient with the
    kernels (K3 'pallas', the dense layer's flash kernels with the split
    backward) against a yardstick. float32: the dense oracle ('ref'),
    loss to rtol 1e-5, each gradient to 1e-4 of its largest element.
    bfloat16: the same model on the kernels' plain versions
    (``plain_kernels``; the 'ref' oracle rounds its scores and softmax to
    bf16 and is no yardstick there), loss to rtol 2e-2 and each gradient
    to 1e-2 of its norm (relative Frobenius error). The largest element
    is no yardstick in bf16 here: the embedding gradients, summed over
    the batch's positions in bf16, differ between the kernels and the
    plain versions by 2-3 bf16 roundings of their largest element (2-2.4 %
    of it, at either width, with K3 or the flash kernels alone swapped),
    while a kernel fault (a tile left out, a wrong mask) moves many
    elements and so the norm. Both measures are recorded."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    f32 = dtype == torch.float32
    loss_rtol, grad_rtol = (1e-5, 1e-4) if f32 else (2e-2, 1e-2)
    enc = V.vae_encoder_init(north_cfg().vae, seed=7, dtype=dtype)
    key = prng.prng_key(5, device="cuda")
    got = {}
    for run in ("ref", "pallas"):
        impl = "ref" if run == "ref" and f32 else "pallas"
        model = D.dalle_init(sparse_train_cfg(depth=2, sparse_impl=impl,
                                              **cfg_kw),
                             seed=8, dtype=dtype)
        plain = run == "ref" and not f32
        before = sparse_counts()
        with plain_kernels() if plain else contextlib.nullcontext():
            loss = dalle_loss_fn(enc)(model, batch, key)
            loss.backward()
        check(not plain or sparse_counts() == before,
              f"sparse train: the plain run launched kernels "
              f"({before} -> {sparse_counts()})")
        got[run] = (float(loss.detach()), {n: p.grad.float() for n, p in
                                           model.named_parameters()})
        del model
    ref_loss, ref = got["ref"]
    loss, grads = got["pallas"]
    check(math.isfinite(loss)
          and abs(loss - ref_loss) <= loss_rtol * abs(ref_loss),
          f"sparse train: loss {loss} against ref {ref_loss}")
    rel = rel_norm = 0.0
    for name, g in grads.items():
        largest = float(ref[name].abs().max())
        err = float((g - ref[name]).abs().max())
        err_norm = float((g - ref[name]).norm()) / max(
            float(ref[name].norm()), 1e-30)
        if f32:
            check(err <= grad_rtol * max(largest, 1e-30),
                  f"sparse train: grad {name} differs from ref (max abs "
                  f"{err:.3e}, largest {largest:.3e})")
        else:
            check(err_norm <= grad_rtol,
                  f"sparse train: grad {name} differs from the plain "
                  f"versions' by {err_norm:.3e} of its norm")
        rel = max(rel, err / max(largest, 1e-30))
        rel_norm = max(rel_norm, err_norm)
    return {"loss": loss, "ref_loss": ref_loss, "max_grad_err_of_largest": rel,
            "max_grad_err_of_norm": rel_norm,
            "tolerance": {"loss_rtol": loss_rtol,
                          "grad_of_largest" if f32 else "grad_of_norm":
                              grad_rtol}}


def sparse_train_run(cfg, phase: str) -> tuple:
    """6 training steps of the block-sparse ``cfg`` (bfloat16 params, the
    smoke's batch, Adam lr 1e-4), the first a warm-up: finite losses, K3
    launched once a sparse layer and K1, K2a and K2b once a dense layer
    each step; then a profile window. Returns (record, batch)."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer, step_rng
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import (dalle_loss_fn,
                                                         make_train_step)
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
    check(all(math.isfinite(x) for x in losses), f"{phase} losses {losses}")
    for k, n in counts.items():
        want = n_sparse * steps if k == "k3" else \
            (cfg.depth - n_sparse) * steps
        check(n == want, f"{phase}: {k} launched {n} times, expected {want}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = batch["text"].shape[0] * cfg.seq_len
    prof = train_profile(step, model, batch, key)
    del model, step
    torch.cuda.empty_cache()
    record = dict(phase=phase, ok=True, depth=cfg.depth,
                  heads=cfg.heads, dim_head=cfg.dim_head,
                  sparse_layers=n_sparse, steps=steps, losses=losses,
                  ms_per_step=ms, tokens_per_step=tokens,
                  tokens_per_s=tokens / ms * 1e3, peak_mem_gib=peak_gib,
                  launches=counts, profile=prof)
    return record, batch


def phase_sparse_train() -> dict:
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    cfg = sparse_train_cfg()
    record, batch = sparse_train_run(cfg, "sparse_train")
    n_sparse = record["sparse_layers"]
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
    record.update(plain_sparse_bwd_ms_per_layer=bwd_ms,
                  plain_sparse_bwd_ms_per_step=bwd_ms * n_sparse,
                  depth2_f32=sparse_grads_agree(batch))
    emit(**record)
    return record


# the block-sparse config's width split as heads=2, dim_head=256, as
# WIDE_TRAIN splits the dense one
WIDE_SPARSE = dict(heads=2, dim_head=256)


def phase_wide_sparse_train() -> dict:
    """The ``sparse_train`` phase's step at ``WIDE_SPARSE``: K3 on its
    wide tensor-core body in the 32 sparse layers, K1, K2a and K2b split
    on theirs in the 32 dense ones, each launched 32 x steps times and
    named in the profile, none of the CUDA-core wide bodies; then a
    depth-2 copy in bfloat16 against the same model on the kernels' plain
    versions."""
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    cfg = sparse_train_cfg(**WIDE_SPARSE)
    record, batch = sparse_train_run(cfg, "wide_sparse_train")
    n_sparse = record["sparse_layers"]
    prof = record["profile"]
    ran = prof.get("body_launches_per_step", {})
    want = {BS.kernel_body(torch.bfloat16, cfg.dim_head): n_sparse}
    for kind in ("fwd", "dq", "dkv"):
        want[FA.kernel_body(kind, torch.bfloat16, cfg.dim_head)] = \
            cfg.depth - n_sparse
    # the profile names exactly these bodies, each at most its launches a
    # step (a session may drop the records of its first milliseconds; the
    # wrappers' counts above are exact)
    check(set(ran) == set(want), f"wide_sparse_train ran {sorted(ran)}, "
                                 f"not {sorted(want)}")
    for body, n in want.items():
        check(0 < ran[body] <= n, f"wide_sparse_train: {body} {ran[body]} "
                                  f"launches a step, expected {n}")
    losses = record["losses"]
    check(losses[-1] < losses[0], f"wide_sparse_train: losses {losses} do "
                                  f"not fall")
    record["depth2_bf16"] = sparse_grads_agree(batch, dtype=torch.bfloat16,
                                               **WIDE_SPARSE)
    emit(**record)
    return record


def sparse_serve_cfg(depth: int = 12):
    import dataclasses
    return dataclasses.replace(north_cfg(), depth=depth,
                               sparse_attn=(True, False) * (depth // 2))


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
    cfg = sparse_serve_cfg(SERVE_DEPTH)
    n_sparse = sum(cfg.transformer.sparse_pattern)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    reqs = engine_requests(cfg)
    post = PostProcessor(vae, model)
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8, kv="paged",
                    page_size=16, paged_attn="kernel", sparse_reads=True,
                    complete=post)
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


# -- serving at heads=2, dim_head=256: K4's wide split body -------------------

WIDE_SERVE = dict(heads=2, dim_head=256)


def wide_serve_cfg(**kw):
    import dataclasses
    return dataclasses.replace(north_cfg(), **WIDE_SERVE, **kw)


def wide_decode_check() -> dict:
    """bfloat16, full width at ``WIDE_SERVE``: one ``decode_step_paged``
    through K4 (the wide split body) against the gather oracle
    (``attn_impl='gather'``), with random bf16 pages and with the same
    rows as an int8 cache (quantized per row as the engine quantizes
    them), at the ``decode`` phase's positions. h_out is held to 2e-2 of
    its norm (relative Frobenius error): the oracle's scores and softmax
    are bf16 (``_gather_read`` computes in q's dtype) where the kernel's
    are f32, and every layer rounds its activations to bf16 on both
    sides, so the two differ by a few bf16 roundings (2^-8 relative
    each) compounded over the 12 layers, not by one. K4 must launch once
    a layer on the wide split body."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    cfg = wide_serve_cfg()
    tcfg = cfg.transformer
    model = D.dalle_init(cfg, seed=1, dtype=torch.bfloat16)
    slots, ps, L = 8, 16, cfg.seq_len
    mp = -(-L // ps)
    P = slots * mp + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    shape = (tcfg.depth, P, tcfg.heads, ps, tcfg.dim_head)
    bf16 = {n: torch.randn(shape, generator=g, device="cuda")
            .to(torch.bfloat16) for n in ("k", "v")}
    # the same rows quantized as the engine's int8 cache holds them
    pools = {"bfloat16": bf16,
             "int8": decode_ops._rows(bf16["k"], bf16["v"], True)}
    bt = (torch.arange(P - 1, device="cuda") + 1).reshape(slots, mp) \
        .to(torch.int32)
    pos = torch.tensor([0, 1, 15, 16, 17, 300, 640, 1000],
                       dtype=torch.int32, device="cuda")
    key_mask = torch.ones((slots, L), dtype=torch.bool, device="cuda")
    active = torch.ones((slots,), dtype=torch.bool, device="cuda")
    tok = torch.randint(0, cfg.num_text_tokens, (slots,), generator=g,
                        device="cuda").to(torch.int32)
    kw = dict(cfg=tcfg, key_mask=key_mask, active=active)
    out = {}
    with torch.no_grad():
        x = D.decode_token_embed(model, tok, pos)
        for name, pool in pools.items():
            oracle = {k: v.clone() for k, v in pool.items()}
            before = PA.paged_decode_attention.launches
            step = lambda: decode_ops.decode_step_paged(   # noqa: E731
                model.transformer, x, pos, pool, bt, **kw)
            h_k = step()
            launched = PA.paged_decode_attention.launches - before
            h_g = decode_ops.decode_step_paged(model.transformer, x, pos,
                                               oracle, bt,
                                               attn_impl="gather", **kw)
            torch.cuda.synchronize()
            rel = float((h_k.float() - h_g.float()).norm()
                        / h_g.float().norm())
            check(launched == tcfg.depth and rel <= 2e-2
                  and bool(torch.isfinite(h_k).all()),
                  f"wide decode step ({name} cache): K4 launched {launched}"
                  f" times, h_out off the gather oracle by {rel:.3e} of "
                  f"its norm")
            body = PA.kernel_body(pool["k"].dtype, tcfg.dim_head)
            ran = launched_bodies(step, K4_NAME, calls=2)
            check(ran == [body], f"wide decode step ({name} cache): K4 "
                                 f"ran {ran}, not [{body}]")
            out[name] = {"h_out_rel_err": rel, "rel_tol": 2e-2,
                         "max_abs_h_diff": float((h_k.float() - h_g.float())
                                                 .abs().max()),
                         "body": body}
    return out


def serve_wide(cfg, reqs, sparse_reads: bool) -> dict:
    """The bfloat16 engine at ``cfg`` on ``reqs`` (8 slots, K = 8, page
    16), profiled early and late inside its one run: every result ok,
    each walk's K4 launches (the visible walk in the sparse layers, the
    prefix walk in the others) = its layers x decode steps, every page
    freed, and the profiles naming the wide split body of each walk that
    ran, nothing else of K4."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    n_sparse = sum(cfg.transformer.sparse_pattern) if sparse_reads else 0
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    post = PostProcessor(vae, model)
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8, kv="paged",
                    page_size=16, paged_attn="kernel",
                    sparse_reads=sparse_reads, complete=post)
    check(engine.num_pages == 1 + 8 * 80, "pool must be 1 + 8*80 pages")
    handles = [queue.submit(r) for r in reqs]
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    PA.paged_decode_attention.visible_launches = 0
    t0 = time.perf_counter()
    prof = profile_run(engine)
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
          f"expected {n_sparse} visible and {cfg.depth - n_sparse} prefix "
          f"walks a step")
    check(engine.alloc.in_use == 0, f"{engine.alloc.in_use} pages leaked")
    want = sorted(PA.kernel_body(engine.pool["k"].dtype, cfg.dim_head, vis)
                  for vis, n in ((True, n_sparse),
                                 (False, cfg.depth - n_sparse)) if n)
    for name, window in prof.items():
        check(window.get("k4_bodies") == want,
              f"{name} window: K4 ran {window.get('k4_bodies')}, not {want}")
    stats = engine.stats()
    return dict(requests=len(reqs), wall_s=wall, decode_steps=steps,
                ms_per_decode_step=wall * 1e3 / steps,
                tokens_per_s=stats["tokens_decoded"] / wall,
                image_tokens_per_s=len(reqs) * cfg.image_seq_len / wall,
                harvests=stats["harvests"], pages_peak=stats["pages_peak"],
                kv_read_bytes_per_token=stats["kv_read_bytes_per_token"],
                k4_launches=launches, k4_bodies=want, profile=prof,
                tokens=[list(r.tokens) for r in results], engine=engine,
                queue=queue)


def phase_wide_engine() -> dict:
    """Serving at ``WIDE_SERVE`` (the north width as heads=2,
    dim_head=256): the bf16 decode check at full depth, then, at
    ``SERVE_DEPTH``, the engine on the six requests of the
    ``engine`` phase (the wall includes its two profile windows), a
    re-run of the 256-token request alone with the same tokens, every
    page freed; then with the sparse pattern and ``sparse_reads=True`` on
    three of them (prompts of 1, 17 and 256 tokens; no re-run, to keep
    the smoke's time)."""
    record = {"decode_bf16": wide_decode_check()}
    emit(phase="wide_engine", check="decode_bf16", ok=True,
         **record["decode_bf16"])
    cfg = wide_serve_cfg(depth=SERVE_DEPTH)
    reqs = engine_requests(cfg)
    dense = serve_wide(cfg, reqs, sparse_reads=False)
    engine, queue = dense.pop("engine"), dense.pop("queue")
    again = queue.submit(reqs[2])
    engine.run_until_idle()
    check(again.result(timeout=0).ok and list(again.result().tokens)
          == dense["tokens"][2], "wide engine: re-run request gave other "
                                 "tokens")
    check(engine.alloc.in_use == 0, "pages leaked after the re-run")
    del dense["tokens"], engine, queue
    record["dense"] = dense
    emit(phase="wide_engine", engine="dense", ok=True, **dense)
    scfg = wide_serve_cfg(depth=SERVE_DEPTH,
                          sparse_attn=(True, False) * (SERVE_DEPTH // 2))
    sparse = serve_wide(scfg, engine_requests(scfg)[:3], sparse_reads=True)
    for k in ("engine", "queue", "tokens"):
        sparse.pop(k)
    record["sparse_reads"] = sparse
    emit(phase="wide_engine", engine="sparse_reads", ok=True, **sparse)
    return record


# -- one-shot generation: dense KV decode, guidance, int8, the CLIP rerank ---

def dense_decode_check() -> dict:
    """The dense-cache decode step against the paged path's gather oracle
    (``decode_step_paged`` with ``attn_impl='gather'``, which reads
    through ``paged_view``) at full width in float32: a 17-token prompt
    prefilled into the dense cache, the same rows laid out as a page
    pool, one step's h_out to 1e-4, then 64 greedy steps with identical
    tokens, each cache written by its own path."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    cfg = north_cfg()
    tcfg = cfg.transformer
    model = D.dalle_init(cfg, seed=1, dtype=torch.float32)
    rows, t0, L, ps = 4, 17, cfg.seq_len, 16
    mp = L // ps
    g = torch.Generator(device="cuda").manual_seed(6)
    text = torch.randint(1, cfg.num_text_tokens, (rows, t0), generator=g,
                         device="cuda")

    def as_pages(buf):
        """(depth, rows, heads, L, dh) -> (depth, 1 + rows * mp, heads,
        ps, dh): slot i's rows on pages 1 + i * mp ..., trash page 0."""
        d_, r_, hh, _, dh = buf.shape
        pages = buf.reshape(d_, r_, hh, mp, ps, dh).permute(0, 1, 3, 2, 4, 5)
        pages = pages.reshape(d_, r_ * mp, hh, ps, dh)
        return torch.cat([torch.zeros_like(pages[:, :1]), pages], dim=1)

    worst = 0.0
    with torch.no_grad():
        h, cache = decode_ops.prefill(model.transformer,
                                      D.embed_prompt(model, text), cfg=tcfg,
                                      total_len=L)
        pool = {k: as_pages(v) for k, v in cache.items()}
        bt = (torch.arange(rows * mp, device="cuda") + 1).reshape(rows, mp) \
            .to(torch.int32)
        key_mask = decode_ops._full_key_mask(None, rows, t0, L, "cuda")
        active = torch.ones((rows,), dtype=torch.bool, device="cuda")

        def greedy(hh, pos):
            forbid = D.logits_mask(cfg, torch.full((rows,), pos - 1,
                                                   device="cuda"))
            t = D.to_logits(model, hh).masked_fill(forbid, -math.inf) \
                .argmax(-1)
            return torch.where(t >= cfg.num_text_tokens,
                               t - cfg.num_text_tokens, t)

        tok = greedy(h[:, -1], t0)
        for step in range(64):
            pos = t0 + step
            posv = torch.full((rows,), pos, dtype=torch.int32, device="cuda")
            x = D.decode_token_embed(model, tok, posv)
            h_d = decode_ops.decode_step(model.transformer, x, pos, cache,
                                         cfg=tcfg, key_mask=key_mask)
            h_p = decode_ops.decode_step_paged(
                model.transformer, x, posv, pool, bt, cfg=tcfg,
                key_mask=key_mask, active=active, attn_impl="gather")
            if step == 0:
                check(torch.allclose(h_d, h_p, rtol=1e-4, atol=1e-4),
                      f"dense decode step differs from the paged gather "
                      f"oracle (max abs {float((h_d - h_p).abs().max()):.3e})")
            worst = max(worst, float((h_d - h_p).abs().max()))
            t_d, t_p = greedy(h_d, pos + 1), greedy(h_p, pos + 1)
            check(torch.equal(t_d, t_p),
                  f"dense decode step {step}: greedy tokens differ")
            tok = t_d
    return {"steps": 64, "rows": rows, "prompt_len": t0,
            "max_abs_h_diff": worst}


def clip_check(clip, g) -> dict:
    """CLIP scores with K3 (``sparse_impl='pallas'``, causal=False in all
    12 layers) against the dense layout oracle (``'ref'``) on the same
    captions and images, at the reference's published widths: the
    rerank's call (no mask) and one with caption padding. float32 to
    rtol/atol 1e-4 (f32 sums in other orders); bfloat16 to atol 1e-2,
    a few bf16 roundings (2^-8 relative) of scores bounded by exp(1):
    twelve layers round on either side, in other places. K3 must launch
    12 times a call."""
    import copy
    import dataclasses
    from dalle_pytorch_tpu_torch.models import clip as C
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    cfg = clip.cfg
    text = torch.randint(1, cfg.num_text_tokens, (4, cfg.text_seq_len),
                         generator=g, device="cuda")
    mask = torch.arange(cfg.text_seq_len, device="cuda")[None] < \
        torch.tensor([[17], [256], [1], [100]], device="cuda")
    size = cfg.visual_image_size
    images = torch.rand((4, size, size, 3), generator=g, device="cuda") * 2 \
        - 1
    out = {}
    for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-4)),
                       (torch.bfloat16, dict(rtol=0.0, atol=1e-2))):
        model = clip if dtype == torch.bfloat16 else C.clip_init(
            cfg, seed=7, dtype=torch.float32)
        ref = copy.copy(model)
        ref.cfg = dataclasses.replace(cfg, sparse_impl="ref")
        name = str(dtype).split(".")[-1]
        with torch.no_grad():
            for case, m in (("rerank", None), ("padded", mask)):
                before = BS.block_sparse_attention_fwd.launches
                got = C.clip_apply(model, text, images.to(dtype),
                                   text_mask=m)
                torch.cuda.synchronize()
                launched = BS.block_sparse_attention_fwd.launches - before
                want = C.clip_apply(ref, text, images.to(dtype), text_mask=m)
                err = float((got.float() - want.float()).abs().max())
                check(launched == 12, f"CLIP {name} {case}: K3 launched "
                                      f"{launched} times, not 12")
                check(bool(torch.isfinite(got).all()) and torch.allclose(
                    got.float(), want.float(), **tol),
                    f"CLIP {name} {case}: K3 scores differ from 'ref' (max "
                    f"abs {err:.3e})")
                out[f"{name}/{case}"] = {"max_abs_err": err, **tol,
                                         "scores": got.float().tolist()}
    return out


def generate_profile(model, text, key, opts, window=(300, 16)) -> tuple:
    """``sample_tokens`` (``generate_images``' loop) run to its end with
    the same options: its tokens, and from step ``window[0]`` on,
    ``window[1]`` steps timed without the profiler, then as many under
    torch.profiler (device ms, kernels per step, the device's idle share
    against the unprofiled wall)."""
    from torch.profiler import ProfilerActivity, profile
    from dalle_pytorch_tpu_torch.models import dalle as D
    start, n = window
    prof = profile(activities=[ProfilerActivity.CUDA])
    toks, marks = [], {}
    for i, tok in enumerate(D.sample_tokens(model, text, rng=key, **opts)):
        toks.append(tok)
        if i in (start, start + n, start + 2 * n):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
            if i == start + n:
                prof.start()
            elif i == start + 2 * n:
                prof.stop()
    wall_ms = (marks[start + n] - marks[start]) * 1e3 / n
    kernels = device_kernels(prof)
    total_us = sum(us for us, _ in kernels.values())
    rec = {"first_step": start, "steps": n, "wall_ms_per_step": wall_ms,
           "wall_ms_per_step_profiled":
               (marks[start + 2 * n] - marks[start + n]) * 1e3 / n}
    if total_us <= 0:
        rec["device_ms_per_step"] = "not measured"
    else:
        device_ms = total_us / 1e3 / n
        rec.update(device_ms_per_step=device_ms,
                   device_idle_share=max(0.0, 1 - device_ms / wall_ms),
                   kernels_launched_per_step=sum(
                       c for _, c in kernels.values()) / n,
                   top_kernels_ms_per_step=top_kernels(kernels, n),
                   kinds_ms_per_step=kernel_classes(kernels, n))
    return torch.stack(toks, dim=1), rec


# depth of the ``generate`` phase's sampling model, cut from 12 to keep
# the smoke's time with the ``serve_features`` phase (the step is
# host-bound, about linear in depth)
GENERATE_DEPTH = 2


def phase_generate() -> dict:
    """One-shot generation at the north width (its sampling model at
    ``GENERATE_DEPTH``): the dense decode check, the CLIP check, then
    ``generate_images`` twice: 4 full 256-token
    prompts with guidance 3.0, and int8 weights with an int8 cache on 17
    tokens with top-p 0.9. Each: a run returning the image ids (ids in
    [0, 2048), finite images), a run with the CLIP rerank (K3 12 times,
    finite scores, the same images), and ``sample_tokens`` with the same
    key again (identical ids; the guided run's profile window)."""
    from dalle_pytorch_tpu_torch.models import clip as C
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    import dataclasses
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import prng
    record = {"dense_decode": dense_decode_check()}
    emit(phase="generate", check="dense_decode", ok=True,
         **record["dense_decode"])
    cfg = dataclasses.replace(north_cfg(), depth=GENERATE_DEPTH)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    # the reference CLIP at its published defaults, K3 in every layer
    clip = C.clip_init(C.CLIPConfig(sparse_impl="pallas"), seed=7,
                       dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(8)
    record["clip"] = clip_check(clip, g)
    emit(phase="generate", check="clip", ok=True, **record["clip"])
    runs = {
        "guided": (model, torch.randint(1, cfg.num_text_tokens, (4, 256),
                                        generator=g, device="cuda"),
                   dict(guidance=3.0)),
        "int8": (D.quantize_for_decode(model),
                 torch.randint(1, cfg.num_text_tokens, (4, 17), generator=g,
                               device="cuda"),
                 dict(top_p=0.9, quantize_cache=True)),
    }
    k3_launches = 0
    for name, (m, text, opts) in runs.items():
        key = prng.prng_key(11, device="cuda")
        b, t0 = text.shape
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        images, img_seq = D.generate_images(m, vae, text, rng=key,
                                            return_img_seq=True, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        check(img_seq.shape == (b, cfg.image_seq_len)
              and int(img_seq.min()) >= 0
              and int(img_seq.max()) < cfg.num_image_tokens,
              f"generate {name}: bad image tokens")
        size = cfg.vae.image_size
        check(images.shape == (b, size, size, 3)
              and bool(torch.isfinite(images).all()),
              f"generate {name}: bad images {tuple(images.shape)}")
        # the main path with the rerank: K3's count from 0
        BS.block_sparse_attention_fwd.launches = 0
        t_start = time.perf_counter()
        images_r, scores = D.generate_images(m, vae, text, rng=key,
                                             clip=clip, **opts)
        torch.cuda.synchronize()
        wall_rerank = time.perf_counter() - t_start
        launched = BS.block_sparse_attention_fwd.launches
        k3_launches += launched
        check(launched == 12, f"generate {name}: K3 launched {launched} "
                              f"times in the rerank, not 12")
        check(scores.shape == (b,) and bool(torch.isfinite(scores).all()),
              f"generate {name}: bad CLIP scores")
        image_diff = float((images_r.float() - images.float()).abs().max())
        check(image_diff <= 1e-2, f"generate {name}: the rerank run's "
                                  f"images differ by {image_diff:.3e}")
        window = (300, 16) if name == "guided" else None
        if window:
            toks, prof = generate_profile(m, text, key, opts, window)
        else:
            toks = torch.stack(list(D.sample_tokens(m, text, rng=key,
                                                    **opts)), dim=1)
            prof = None
        check(torch.equal(toks[:b, -cfg.image_seq_len:], img_seq),
              f"generate {name}: a re-run with the same key gave other "
              f"tokens")
        steps = cfg.seq_len - t0
        rec = {"prompts": b, "prompt_len": t0, **opts,
               "rows": b * (2 if opts.get("guidance", 0) > 0 else 1),
               "wall_s_per_call": wall, "wall_s_with_rerank": wall_rerank,
               "decode_steps": steps, "ms_per_decode_step": wall * 1e3 / steps,
               "images_per_s": b / wall, "k3_launches_rerank": launched,
               "scores": scores.float().tolist(),
               "rerank_image_max_abs_diff": image_diff}
        if prof is not None:
            rec["profile"] = prof
        record[name] = rec
        emit(phase="generate", run=name, ok=True, **rec)
    record["k3_launches"] = k3_launches
    return record


# -- the rest of training: VAE, reversible, MoE, CLIP, remat ------------------

def slice_optimizer(model):
    """Adam lr 1e-4, constant, no clip: the smoke's optimizer."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer
    args = types.SimpleNamespace(lr=1e-4, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)
    return make_optimizer(args, model.parameters())


def slice_train(phase: str, model, loss_fn, batch, want: dict, units: int,
                steps: int = 6, warmup: int = 1, after=None,
                profile: bool = True) -> dict:
    """``steps`` steps of ``make_train_step(loss_fn)`` under Adam lr 1e-4
    on ``model``, the first ``warmup`` untimed: finite losses, and each
    kernel's launches a step (K1, K2a, K2b, K3) equal to ``want``. Wall ms
    a step, ``units`` (tokens or images) a step and a second, peak
    memory, and a profile window (``train_profile``: device ms a step,
    the idle share). ``after(model)`` runs after every step (the EMA)."""
    from dalle_pytorch_tpu_torch.cli.common import step_rng
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import make_train_step
    train_step = make_train_step(loss_fn, slice_optimizer(model))

    def step(m, b, k):
        loss = train_step(m, b, k)
        if after is not None:
            after(m)
        return loss

    root = prng.prng_key(0, device="cuda")

    def key(i):
        return step_rng(root, i)

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
    check(all(math.isfinite(x) for x in losses), f"{phase} losses {losses}")
    per_step = {k: n / steps for k, n in counts.items()}
    for k, n in want.items():
        check(per_step[k] == n, f"{phase}: {k} launched {per_step[k]} "
                                f"times a step, expected {n}")
    record = dict(phase=phase, ok=True, steps=steps, losses=losses,
                  ms_per_step=ms, units_per_step=units,
                  units_per_s=units / ms * 1e3,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  launches=counts, launches_per_step=per_step)
    if profile:
        record["profile"] = train_profile(step, model, batch, key)
    return record


def kernels_vs_plain(what: str, make_model, loss_fn, batch, key,
                     dtype=torch.bfloat16) -> dict:
    """One step's loss and every gradient of ``make_model(dtype)`` with
    the kernels against the same weights on the kernels' plain versions
    (``plain_kernels``). float32: loss to rtol 1e-5, each gradient to
    1e-4 of its norm (relative Frobenius error). bfloat16: both bf16
    paths are also held against a float32 copy of the same weights on
    the plain versions, the truth: the loss to rtol 2e-2 of the plain
    bf16 loss, and each gradient tensor's error to the truth at most
    twice the plain bf16 path's own error, or 1e-2 of its norm where
    that is larger; the same for all gradients together (one vector),
    which is where a scalar's gradient is held. A fixed share of the
    norm is no yardstick for every bf16 gradient: CLIP's temperature
    gradient (the mean diagonal similarity minus its softmax-weighted
    mean) and its patch-embedding bias (a sum over 512 patch rows) come
    from terms that nearly cancel, and there the plain bf16 path misses
    the truth by percents as well; a scalar's error is one draw of that
    rounding noise (the temperature's: 9.8 % with the kernels, 4.3 % on
    the plain versions, on the H100), so it is recorded, and float32
    holds it to 1e-4. The kernel run must launch kernels and the plain
    ones none."""
    import copy
    f32 = dtype == torch.float32
    base = make_model(dtype)
    runs = (("plain", dtype), ("kernels", dtype)) + \
        ((("truth", torch.float32),) if not f32 else ())
    got = {}
    for run, dt in runs:
        model = copy.deepcopy(base).to(dt)
        b_ = {k: v.to(dt) if v.is_floating_point() else v
              for k, v in batch.items()}
        before = sparse_counts()
        with contextlib.nullcontext() if run == "kernels" else \
                plain_kernels():
            loss = loss_fn(model, b_, key)
            loss.backward()
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in sparse_counts().items()}
        check((run == "kernels") == (sum(ran.values()) > 0),
              f"{what}: the {run} run launched {ran}")
        got[run] = (float(loss.detach()), {n: p.grad.float() for n, p in
                                           model.named_parameters()}, ran)
        del model
    ref_loss, plain, _ = got["plain"]
    loss, grads, ran = got["kernels"]
    loss_rtol = 1e-5 if f32 else 2e-2
    check(math.isfinite(loss)
          and abs(loss - ref_loss) <= loss_rtol * abs(ref_loss),
          f"{what}: loss {loss} against the plain versions' {ref_loss}")

    def rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    def flat(gs):
        return torch.cat([g.reshape(-1) for g in gs.values()])

    worst = worst_plain = 0.0
    scalars = {}
    for name, g in grads.items():
        if f32:
            err, tol = rel(g, plain[name]), 1e-4
        else:
            truth = got["truth"][1][name]
            err, err_plain = rel(g, truth), rel(plain[name], truth)
            if g.dim() == 0:
                scalars[name] = {"err": err, "plain_err": err_plain}
                continue
            tol = max(2 * err_plain, 1e-2)
            worst_plain = max(worst_plain, err_plain)
        check(err <= tol, f"{what}: grad {name} off by {err:.3e} of its "
                          f"norm (allowed {tol:.3e})")
        worst = max(worst, err)
    out = {"dtype": str(dtype).split(".")[-1], "loss": loss,
           "plain_loss": ref_loss, "kernel_launches": ran}
    if f32:
        out.update(max_grad_err_of_norm=worst,
                   tolerance={"loss_rtol": 1e-5, "grad_of_norm": 1e-4})
        return out
    truth = flat(got["truth"][1])
    err_all, plain_all = rel(flat(grads), truth), rel(flat(plain), truth)
    check(err_all <= max(2 * plain_all, 1e-2),
          f"{what}: the gradients off by {err_all:.3e} of their norm "
          f"(plain {plain_all:.3e})")
    out.update(truth_loss=got["truth"][0], max_grad_err_to_f32=worst,
               plain_max_grad_err_to_f32=worst_plain,
               all_grads_err_to_f32=err_all,
               plain_all_grads_err_to_f32=plain_all,
               scalar_grads_err_to_f32=scalars,
               tolerance={"loss_rtol": 2e-2,
                          "grad_to_f32": "max(2 x plain's, 1e-2)"})
    return out


def id_batch(cfg, b=8, seed=9) -> dict:
    """Random text ids with padded tails (rows 1 and 3), the text mask and
    random image ids, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.ones((b, cfg.text_seq_len), dtype=torch.bool, device="cuda")
    mask[1, 200:] = False
    mask[3, 17:] = False
    return {"text": torch.randint(1, cfg.num_text_tokens,
                                  (b, cfg.text_seq_len), generator=g,
                                  device="cuda"),
            "mask": mask,
            "image": torch.randint(0, cfg.num_image_tokens,
                                   (b, cfg.image_seq_len), generator=g,
                                   device="cuda")}


def no_kernels() -> dict:
    return {"k1": 0, "k2a": 0, "k2b": 0, "k3": 0}


# BASELINE config 1 (``bench.py::bench_vae``)
VAE_TRAIN = dict(image_size=256, num_tokens=2048, codebook_dim=256,
                 num_layers=3, hidden_dim=128)


def phase_vae_train() -> dict:
    """BASELINE config 1 (``bench.py::bench_vae``): the DiscreteVAE at 256
    px, 2,048 codes of 256, 3 layers, hidden 128, bfloat16, batch 8, the
    training scripts' loss (``vae_loss_fn(smooth_l1=True)``: Huber +
    mse), Adam lr 1e-4, an EMA at decay 0.999 updated after every step:
    6 steps with finite losses, no attention kernel, the float32 EMA
    moving; and the Gumbel noise's ms a step (one (8, 32, 32, 2048)
    bfloat16 draw through the int64 threefry)."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_ema
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import vae_loss_fn
    cfg = V.VAEConfig(**VAE_TRAIN)
    vae = V.discrete_vae_init(cfg, seed=21, dtype=torch.bfloat16)
    ema, update = make_ema(types.SimpleNamespace(ema_decay=0.999), vae)
    start = {n: e.clone() for n, e in ema.items()}
    g = torch.Generator(device="cuda").manual_seed(22)
    size = cfg.image_size
    images = (torch.rand((8, size, size, 3), generator=g, device="cuda") * 2
              - 1).to(torch.bfloat16)
    record = slice_train("vae_train", vae, vae_loss_fn(cfg, smooth_l1=True),
                         {"images": images}, no_kernels(), units=8,
                         after=lambda m: update(ema, m))
    moved = max(float((ema[n] - start[n]).abs().max()) for n in ema)
    check(all(e.dtype == torch.float32 for e in ema.values())
          and moved > 0, f"vae_train: the EMA did not move ({moved})")
    shape = (8, cfg.grid_size, cfg.grid_size, cfg.num_tokens)
    key = prng.prng_key(3, device="cuda")
    noise_ms = cuda_ms(lambda: prng.gumbel(key, shape, torch.bfloat16),
                       iters=5, warmup=1)
    record.update(images_per_s=record["units_per_s"], ema_max_move=moved,
                  ema_dtype="float32", gumbel_noise_shape=list(shape),
                  gumbel_noise_ms_per_step=noise_ms,
                  gumbel_share_of_step=noise_ms / record["ms_per_step"])
    emit(**record)
    return record


def rev_cfg(**kw):
    """BASELINE config 3 (``bench.py::build_cfg(depth=12,
    reversible=True)``) on the flash kernels with the split backward,
    ``loss_chunk`` 256, dropout 0 (build_cfg's)."""
    return train_cfg(**{**dict(reversible=True, attn_dropout=0.0,
                               ff_dropout=0.0), **kw})


def phase_rev_train() -> dict:
    """The reversible DALLE: 6 steps with finite losses, K1 launched 24
    times a step (the forward and the backward's recompute, 2 x depth),
    K2a and K2b 12 each; peak memory beside 2 steps of the same config
    with ``reversible=False``; then at depth 2 with dropout 0.1, the
    kernels against their plain versions (``kernels_vs_plain``) in
    bfloat16 and float32."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    cfg = rev_cfg()
    batch = id_batch(cfg)
    model = D.dalle_init(cfg, seed=31, dtype=torch.bfloat16)
    d = cfg.depth
    record = slice_train("rev_train", model, dalle_loss_fn(), batch,
                         {"k1": 2 * d, "k2a": d, "k2b": d, "k3": 0},
                         units=8 * cfg.seq_len)
    del model
    torch.cuda.empty_cache()
    seq = D.dalle_init(rev_cfg(reversible=False), seed=31,
                       dtype=torch.bfloat16)
    seq_rec = slice_train("rev_train/sequential", seq, dalle_loss_fn(),
                          batch, {"k1": d, "k2a": d, "k2b": d, "k3": 0},
                          units=8 * cfg.seq_len, steps=2, profile=False)
    del seq
    torch.cuda.empty_cache()
    key = prng.prng_key(5, device="cuda")
    depth2 = {}
    for dtype in (torch.bfloat16, torch.float32):
        c2 = rev_cfg(depth=2, attn_dropout=0.1, ff_dropout=0.1)
        depth2[str(dtype).split(".")[-1]] = kernels_vs_plain(
            "rev_train depth 2",
            lambda dt, c2=c2: D.dalle_init(c2, seed=32, dtype=dt),
            dalle_loss_fn(), batch, key, dtype=dtype)
    record.update(tokens_per_s=record["units_per_s"],
                  sequential={k: seq_rec[k] for k in (
                      "ms_per_step", "peak_mem_gib", "launches_per_step",
                      "losses")},
                  peak_mem_ratio_rev_to_seq=record["peak_mem_gib"]
                  / seq_rec["peak_mem_gib"],
                  depth2=depth2)
    emit(**record)
    return record


def phase_rev_decode() -> dict:
    """Decoding the reversible config: one float32 step at depth 12
    through K4 against the gather oracle and 64 greedy steps
    (``paged_decode_check``: the two-stream layer loop, K/V from x2);
    then the bfloat16 engine at ``SERVE_DEPTH`` on one request (17-token
    prompt) to its
    1,024 image tokens: ok, K4 launched depth x decode steps times, every
    page freed."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    import dataclasses
    step = paged_decode_check(dataclasses.replace(north_cfg(),
                                                  reversible=True))
    cfg = dataclasses.replace(north_cfg(), reversible=True,
                              depth=SERVE_DEPTH)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=33, vae=vae, dtype=torch.bfloat16)
    req = engine_requests(cfg)[1]
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8, kv="paged",
                    page_size=16, paged_attn="kernel",
                    complete=PostProcessor(vae, model))
    handle = queue.submit(req)
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.paged_decode_attention.launches
    res = handle.result(timeout=0)
    check_engine_results(cfg, [req], [res])
    check(launches == cfg.depth * engine.decode_steps,
          f"rev_decode: K4 launched {launches} times, expected depth x "
          f"decode steps = {cfg.depth * engine.decode_steps}")
    check(engine.alloc.in_use == 0,
          f"rev_decode: {engine.alloc.in_use} pages leaked")
    record = dict(phase="rev_decode", ok=True, f32_step=step,
                  engine_wall_s=wall, decode_steps=engine.decode_steps,
                  ms_per_decode_step=wall * 1e3 / engine.decode_steps,
                  image_tokens=len(res.tokens),
                  image_tokens_per_s=len(res.tokens) / wall,
                  k4_launches=launches)
    emit(**record)
    return record


def phase_moe_train() -> dict:
    """``bench.py::bench_moe``: the north width at depth 12 with every FF
    a top-2 MoE of 8 experts, flash with the split backward,
    ``loss_chunk`` 256, dropout 0: 6 steps with finite losses, K1, K2a
    and K2b 12 launches a step each; the load-balance loss finite and
    positive, and the training loss equal to the CE plus
    ``moe_aux_coef * aux``."""
    import dataclasses
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.ops import transformer as T
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    cfg = dataclasses.replace(train_cfg(attn_dropout=0.0, ff_dropout=0.0),
                              moe_experts=8)
    batch = id_batch(cfg)
    model = D.dalle_init(cfg, seed=41, dtype=torch.bfloat16)
    d = cfg.depth
    record = slice_train("moe_train", model, dalle_loss_fn(), batch,
                         {"k1": d, "k2a": d, "k2b": d, "k3": 0},
                         units=8 * cfg.seq_len)
    key = prng.prng_key(7, device="cuda")
    with torch.no_grad():
        loss = float(D.dalle_apply(model, batch["text"], batch["image"],
                                   mask=batch["mask"], rng=key, train=True,
                                   return_loss=True))
        tokens = D.embed_prompt(model, batch["text"], batch["image"])
        mask = torch.cat([batch["mask"], torch.ones_like(batch["image"],
                                                         dtype=torch.bool)],
                         dim=1)
        h, aux = T.transformer_apply(model.transformer, tokens,
                                     cfg=cfg.transformer, mask=mask, rng=key,
                                     train=True, with_aux=True)
        ce = float(D.ce_from_hidden(model, h, batch["text"], batch["image"]))
    aux = float(aux)
    check(math.isfinite(aux) and aux > 0, f"moe_train: aux loss {aux}")
    check(abs(loss - (ce + cfg.moe_aux_coef * aux)) <= 1e-5 * abs(loss),
          f"moe_train: loss {loss} is not ce {ce} + {cfg.moe_aux_coef} x "
          f"aux {aux}")
    del model
    torch.cuda.empty_cache()
    record.update(tokens_per_s=record["units_per_s"], aux_loss=aux, ce=ce,
                  loss_with_aux=loss, moe_aux_coef=cfg.moe_aux_coef,
                  experts=cfg.moe_experts, k=cfg.moe_k)
    emit(**record)
    return record


def clip_batch(cfg, b=8, seed=51) -> dict:
    """Captions with padded tails of several lengths, and images in
    [-1, 1), made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.tensor([256, 17, 1, 100, 255, 64, 200, 3],
                           device="cuda")[:b]
    size = cfg.visual_image_size
    return {"text": torch.randint(1, cfg.num_text_tokens,
                                  (b, cfg.text_seq_len), generator=g,
                                  device="cuda"),
            "mask": torch.arange(cfg.text_seq_len, device="cuda")[None]
            < lengths[:, None],
            "images": torch.rand((b, size, size, 3), generator=g,
                                 device="cuda") * 2 - 1}


# the reference CLIP's published defaults, K3 in every layer
CLIP_TRAIN = dict(sparse_impl="pallas")


def phase_clip_train() -> dict:
    """CLIP at ``CLIPConfig()``'s defaults (512 wide, 6 + 6 layers of 8
    heads, text 256, 64 patches of 32 px) with ``sparse_impl='pallas'``,
    bfloat16, batch 8 with padded captions: 6 steps with finite losses,
    K3 (``causal=False``) 12 launches a step, the forward of each layer
    (its backward is the plain blockwise one); then at depth 2 + 2 the
    kernels against their plain versions in bfloat16 and float32."""
    import dataclasses
    from dalle_pytorch_tpu_torch.models import clip as C
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import clip_loss_fn
    cfg = C.CLIPConfig(**CLIP_TRAIN)
    batch = clip_batch(cfg)
    model = C.clip_init(cfg, seed=52, dtype=torch.bfloat16)
    layers = cfg.text_enc_depth + cfg.visual_enc_depth
    record = slice_train("clip_train", model, clip_loss_fn(), {
        **batch, "images": batch["images"].to(torch.bfloat16)},
        {"k1": 0, "k2a": 0, "k2b": 0, "k3": layers}, units=8)
    del model
    torch.cuda.empty_cache()
    c2 = dataclasses.replace(cfg, text_enc_depth=2, visual_enc_depth=2)
    key = prng.prng_key(0, device="cuda")
    depth2 = {}
    for dtype in (torch.bfloat16, torch.float32):
        depth2[str(dtype).split(".")[-1]] = kernels_vs_plain(
            "clip_train depth 2",
            lambda dt: C.clip_init(c2, seed=53, dtype=dt),
            clip_loss_fn(), {**batch, "images": batch["images"].to(dtype)},
            key, dtype=dtype)
    record.update(images_per_s=record["units_per_s"], depth2=depth2)
    emit(**record)
    return record


# K1 launches a step per layer under each remat mode
REMAT_K1 = {"none": 1, "save_ln": 1, "dots": 2, "full": 2}


def phase_remat() -> dict:
    """The north ``train_cfg`` at dropout 0 under each remat mode: 2 steps
    from the same weights, the first step's loss identical across modes
    and the second's within 1e-3 relative of 'none''s, peak memory per
    mode, and K1's launches a step (``REMAT_K1``: 'dots' and 'full'
    recompute it in the backward; K2a and K2b once a layer in every
    mode); then at depth 2, each mode's gradients with the kernels
    against 'none''s, each to 1e-2 of its norm."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    batch = id_batch(north_cfg())
    key = prng.prng_key(5, device="cuda")
    modes, grads2, runs = {}, {}, {}
    for mode, k1 in REMAT_K1.items():
        cfg = train_cfg(remat=mode, attn_dropout=0.0, ff_dropout=0.0)
        model = D.dalle_init(cfg, seed=61, dtype=torch.bfloat16)
        d = cfg.depth
        rec = slice_train(f"remat/{mode}", model, dalle_loss_fn(), batch,
                          {"k1": k1 * d, "k2a": d, "k2b": d, "k3": 0},
                          units=8 * cfg.seq_len, steps=2, warmup=1,
                          profile=False)
        del model
        torch.cuda.empty_cache()
        runs[mode] = rec
        modes[mode] = {k: rec[k] for k in ("losses", "ms_per_step",
                                           "peak_mem_gib",
                                           "launches_per_step")}
        m2 = D.dalle_init(train_cfg(depth=2, remat=mode, attn_dropout=0.0,
                                    ff_dropout=0.0), seed=62,
                          dtype=torch.bfloat16)
        dalle_loss_fn()(m2, batch, key).backward()
        grads2[mode] = {n: p.grad.float() for n, p in m2.named_parameters()}
        del m2
    base = modes["none"]["losses"]
    worst = {}
    for mode, rec in modes.items():
        check(rec["losses"][0] == base[0],
              f"remat {mode}: first loss {rec['losses'][0]} != {base[0]}")
        check(abs(rec["losses"][1] - base[1]) <= 1e-3 * abs(base[1]),
              f"remat {mode}: second loss {rec['losses'][1]} against "
              f"{base[1]}")
        err = max(float((g - grads2["none"][n]).norm())
                  / max(float(grads2["none"][n].norm()), 1e-30)
                  for n, g in grads2[mode].items())
        check(err <= 1e-2, f"remat {mode}: depth-2 gradients differ from "
                           f"'none' by {err:.3e} of a norm")
        worst[mode] = err
    launches = {k: sum(rec["launches"][k] for rec in runs.values())
                for k in ("k1", "k2a", "k2b")}
    record = dict(phase="remat", ok=True, modes=modes,
                  depth2_max_grad_err_of_norm=worst, launches=launches)
    emit(**record)
    return record


# -- the CLIs: checkpoints, data and the training and generation entry points -

# the north config's VAE and DALLE as the CLIs' flags (``north_cfg``): codes
# of 512 so DALLE's image embedding ties to the codebook; bfloat16 params
# and ``loss_chunk`` 256 as the ``train`` phase's step
CLI_IMAGES = 16
CLI_VAE = ["--imageSize", "256", "--num_tokens", "2048", "--codebook_dim",
           "512", "--num_layers", "3", "--hidden_dim", "64"]
CLI_DALLE = ["--imageSize", "256", "--dim", "512", "--depth", "12",
             "--heads", "8", "--dim_head", "64", "--text_seq_len", "256",
             "--num_text_tokens", "10000", "--attn_impl", "flash",
             "--attn_bwd_impl", "pallas", "--param_dtype", "bfloat16",
             "--loss_chunk", "256", "--sample_every", "0"]
CLI_WORDS = ("red blue green gray small large square circle striped dotted "
             "bright dark a the on under beside of with and").split()


def cli_data(root: str, seed: int = 0) -> dict:
    """``CLI_IMAGES`` 256 px PNGs written by the port's encoder (smooth
    ramps plus seeded noise) under ``{root}/imagedata/0``, a captions
    corpus and its ``name : caption`` pairs; each image read back with
    the port's decoder must equal what was written. Returns the decode ms
    an image of these files, and of one written with every row filter
    (Sub, Average and Paeth chain along each row: the decoder's slow
    path)."""
    import numpy as np
    from dalle_pytorch_tpu_torch.data import images as I
    rng = np.random.default_rng(seed)
    folder = os.path.join(root, "imagedata", "0")
    os.makedirs(folder)
    ramp = np.linspace(0, 255, 256)
    written = {}
    for i in range(CLI_IMAGES):
        img = np.stack([ramp[None, :].repeat(256, 0),
                        ramp[:, None].repeat(256, 1),
                        np.full((256, 256), 16.0 * i)], axis=-1)
        img = np.clip(img + rng.normal(0, 24, img.shape), 0, 255)
        written[f"img{i:02d}.png"] = img.astype(np.uint8)
    for name, img in written.items():
        with open(os.path.join(folder, name), "wb") as f:
            f.write(I.encode_png(img))
    t0 = time.perf_counter()
    for name, img in written.items():
        check(np.array_equal(I.read_image(os.path.join(folder, name)), img),
              f"cli: {name} does not decode to the pixels written")
    plain_ms = (time.perf_counter() - t0) * 1e3 / len(written)
    filtered = I.encode_png(written["img00.png"],
                            filters=[r % 5 for r in range(256)])
    t0 = time.perf_counter()
    check(np.array_equal(I.decode_png(filtered), written["img00.png"]),
          "cli: the every-filter PNG does not decode to its pixels")
    filtered_ms = (time.perf_counter() - t0) * 1e3
    captions = [" ".join(rng.choice(CLI_WORDS,
                                    size=int(rng.integers(4, 12))))
                for _ in written]
    written_caption = captions[0]
    with open(os.path.join(root, "only.txt"), "w") as f:
        f.write("".join(c + "\n" for c in captions))
    with open(os.path.join(root, "pairs.txt"), "w") as f:
        f.write("".join(f"{n} : {c}\n" for n, c in zip(written, captions)))
    return {"png_decode_ms_per_image": plain_ms,
            "png_decode_ms_every_filter": filtered_ms,
            "png_bytes_per_image": os.path.getsize(
                os.path.join(folder, "img00.png")),
            "caption": written_caption}


def cli_flag(argv: list, name: str) -> int:
    return int(argv[argv.index(name) + 1])


def cli_step_ms(metrics_path: str, tokens_per_step: int) -> list:
    """ms a step from the CLI's own ``MetricsLogger`` records (tokens a
    second, one record a step at ``--log_interval 1``)."""
    out = []
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("tokens_per_sec"):
                out.append(tokens_per_step / rec["tokens_per_sec"] * 1e3)
    return out


def cli_codec(path: str) -> dict:
    """The msgpack codec's write and read rates on a checkpoint's params
    payload (host memory only: the tree is already on the host)."""
    from dalle_pytorch_tpu_torch.compat import msgpack
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    tree = msgpack.unpackb(data)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = msgpack.packb(tree)
    write_s = time.perf_counter() - t0
    check(again == data, "cli: the codec does not write back the bytes it "
                         "read")
    mb = len(data) / 1e6
    return {"params_mb": mb, "read_mb_per_s": mb / read_s,
            "write_mb_per_s": mb / write_s}


def phase_cli(train: dict) -> dict:
    """The port's CLIs through ``main(argv)`` at the north width, in a
    temporary directory removed afterwards: ``cli_data``'s 16 PNGs;
    ``train_vae`` for one epoch of 2 steps at batch 8 (the north VAE);
    ``train_dalle`` at the north width (``CLI_DALLE``: flash with the
    split kernel backward, bfloat16, dropout 0.1, an EMA) for 2 epochs of
    2 steps, K1, K2a and K2b each launched 12 times a step; the same run
    again in two legs (epoch 0, then ``--auto_resume`` for epoch 1) whose
    parameters, Adam state and EMA must equal the uninterrupted run's bit
    for bit; then ``gen_dalle`` from the epoch-1 checkpoint, 2 images,
    seed 5, its caption from the corpus, whose grid PNG must decode to
    260 x 518 x 3."""
    import shutil
    import tempfile
    from dalle_pytorch_tpu_torch import checkpoint as C
    from dalle_pytorch_tpu_torch.cli import gen_dalle, train_dalle, train_vae
    from dalle_pytorch_tpu_torch.data import images as I
    root = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    try:
        record = dict(phase="cli", ok=True, **cli_data(root))
        common = ["--dataPath", os.path.join(root, "imagedata"),
                  "--batchSize", "8", "--log_interval", "1", "--seed", "3"]

        def run(name, main, argv):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            main(argv)
            torch.cuda.synchronize()
            record.setdefault("wall_s", {})[name] = time.perf_counter() - t0

        def dirs(sub):
            return ["--models_dir", os.path.join(root, sub, "models"),
                    "--results_dir", os.path.join(root, sub, "results"),
                    "--metrics", os.path.join(root, sub, "metrics.jsonl")]

        run("train_vae", train_vae.main, common + CLI_VAE + dirs("a") + [
            "--n_epochs", "1"])
        vae_dir = os.path.join(root, "b", "models")
        shutil.copytree(os.path.join(root, "a", "models"), vae_dir)
        dalle = common + CLI_DALLE + [
            "--captions_only", os.path.join(root, "only.txt"),
            "--captions", os.path.join(root, "pairs.txt"), "--name", "north",
            "--ema_decay", "0.999"]
        torch.cuda.reset_peak_memory_stats()
        flash_counts(reset=True)
        run("train_dalle", train_dalle.main, dalle + dirs("a") + [
            "--n_epochs", "2"])
        launches = flash_counts()
        steps = 2 * (CLI_IMAGES // 8)
        depth = cli_flag(CLI_DALLE, "--depth")
        for k, n in launches.items():
            check(n == depth * steps, f"cli: {k} launched {n} times in "
                                      f"{steps} steps, expected "
                                      f"{depth * steps}")
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        record["launches"] = launches
        record["launches_per_step"] = {k: n / steps for k, n in
                                       launches.items()}
        size = cli_flag(CLI_VAE, "--imageSize")
        grid = size // 2 ** cli_flag(CLI_VAE, "--num_layers")
        tokens = 8 * (cli_flag(CLI_DALLE, "--text_seq_len") + grid * grid)
        ms = cli_step_ms(os.path.join(root, "a", "metrics.jsonl"), tokens)
        record["train_dalle_ms_per_step"] = ms
        record["train_phase_ms_per_step"] = train["ms_per_step"]

        # the same run in two legs: epoch 0, then --auto_resume
        run("train_dalle_leg0", train_dalle.main, dalle + dirs("b") + [
            "--n_epochs", "1"])
        run("train_dalle_leg1", train_dalle.main, dalle + dirs("b") + [
            "--n_epochs", "1", "--auto_resume"])
        whole = os.path.join(root, "a", "models", "north_dalle-1")
        legs = os.path.join(root, "b", "models", "north_dalle-1")
        same = {}
        for fname in (C.PARAMS, C.OPT_STATE, C.EMA):
            with open(os.path.join(whole, fname), "rb") as f, \
                    open(os.path.join(legs, fname), "rb") as g:
                same[fname] = f.read() == g.read()
        if not all(same.values()):
            from dalle_pytorch_tpu_torch.compat import msgpack

            def leaves(t):
                if isinstance(t, dict):
                    for v in t.values():
                        yield from leaves(v)
                elif isinstance(t, list):
                    for v in t:
                        yield from leaves(v)
                else:
                    yield torch.as_tensor(t).float()

            diffs = {}
            for fname in same:
                with open(os.path.join(whole, fname), "rb") as f, \
                        open(os.path.join(legs, fname), "rb") as g:
                    a = msgpack.unpackb(f.read())
                    b = msgpack.unpackb(g.read())
                diffs[fname] = max(float((x - y).abs().max()) for x, y in
                                   zip(leaves(a), leaves(b)))
            record["resume_max_abs_diff"] = diffs
        check(all(same.values()), f"cli: the resumed run's payloads differ "
                                  f"from the uninterrupted run's: {same}, "
                                  f"{record.get('resume_max_abs_diff')}")
        record["resume_bit_equal"] = same
        manifest = C.load_manifest(whole)
        record["checkpoint_bytes"] = {k: v["bytes"] for k, v in
                                      manifest["payloads"].items()}
        t0 = time.perf_counter()
        C.restore_params(whole)
        record["restore_params_s"] = time.perf_counter() - t0
        record["codec"] = cli_codec(whole)

        run("gen_dalle", gen_dalle.main, [
            record.pop("caption"), "--name", "north",
            "--dalle_epoch", "1", "--num_images", "2", "--seed", "5",
            "--models_dir", os.path.join(root, "a", "models"),
            "--results_dir", os.path.join(root, "a", "gen")])
        (png,) = os.listdir(os.path.join(root, "a", "gen"))
        img = I.read_image(os.path.join(root, "a", "gen", png))
        want = (size + 4, 2 * size + 6, 3)       # 2 images, padding 2
        check(img.shape == want, f"cli: the grid is {img.shape}, not {want}")
        record["gen_grid_shape"] = list(img.shape)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(**record)
    return record


# -- the single engine's serving features ------------------------------------

# a pool of four full sequences (80 pages of 16) and the trash page, under
# the 8 slots' 640: the growing slots run it dry and eviction must fire
FEATURE_PAGES = 1 + 4 * 80
FEATURE_ENGINE = dict(num_slots=8, chunk_steps=8, kv="paged", page_size=16,
                      paged_attn="kernel", prefix_cache=True,
                      num_pages=FEATURE_PAGES)
SPEC_K, SPEC_DRAFT = 4, 6
# the float32 runs that must give identical tokens: depth 4, a 2-layer draft
IDENTITY_DEPTH, IDENTITY_DRAFT = 4, 2


def feature_requests(cfg) -> list:
    """Eight requests: prompts of 1, 17 and 256 tokens; two pairs that
    share a prompt (17 and 256 tokens: prefix hits); two guided at
    cfg_scale 3.0 at priority 0, both of 17 tokens (their null captions
    are one prefix entry), one sharing its prompt with an unguided
    request; the rest at priority 1 (eviction takes them first); top-k,
    top-p 0.9 and greedy sampling."""
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    g = torch.Generator().manual_seed(6)

    def prompt(n):
        return tuple(int(t) for t in torch.randint(
            1, cfg.num_text_tokens, (n,), generator=g))

    p1, p17a, p17b, p17c, p256 = (prompt(1), prompt(17), prompt(17),
                                  prompt(17), prompt(256))
    top_p = S.SamplingParams(top_p=0.9)
    greedy = S.SamplingParams(filter_thres=1.0)
    return [S.Request(p17b, seed=30, cfg_scale=3.0),
            S.Request(p17c, seed=31, cfg_scale=3.0, sampling=top_p),
            S.Request(p17b, seed=32, priority=1, sampling=greedy),
            S.Request(p17a, seed=33, priority=1),
            S.Request(p17a, seed=34, priority=1, sampling=top_p),
            S.Request(p256, seed=35, priority=1),
            S.Request(p256, seed=36, priority=1, sampling=greedy),
            S.Request(prompt(1), seed=37, priority=1)]


def pair_page_ratio(engine, samples: list):
    """Wrap ``engine._complete`` to record, as each request completes, the
    pages its slots hold (both slots of a guided pair), a page mapped by
    r owners counting 1/r: its share of the pool's residency."""
    orig = engine._complete

    def complete(i, slot, now):
        slots = [i] + ([slot.pair] if slot.pair is not None else [])
        own = sum(1 / engine.alloc.refcount(p) for j in slots
                  for p in engine._slot_pages[j])
        samples.append((slot.pair is not None, len(slot.handle.request.codes),
                        own))
        orig(i, slot, now)

    engine._complete = complete


def idle_window(engine, chunks: int = 2) -> dict:
    """``chunks`` engine steps under torch.profiler (synchronised at both
    ends): device kernel ms a step, and the idle share against the
    window's own wall (an upper bound: the profiler's host cost is in
    that wall; ``run_summary`` takes it against the run's)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(chunks):
            engine.step_once()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = chunks * engine.chunk_steps
    kernels = device_kernels(prof)
    total_us = sum(us for us, _ in kernels.values())
    if total_us <= 0:
        return {"steps": steps, "device_ms_per_step": "not measured"}
    k4_us = sum(us for k, (us, _) in kernels.items() if "paged_decode" in k)
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": total_us / 1e3 / steps,
            "k4_ms_per_step": k4_us / 1e3 / steps,
            "device_idle_share_profiled": max(0.0,
                                              1 - total_us / 1e3 / wall_ms),
            "kernels_launched_per_step": sum(
                n for _, n in kernels.values()) / steps}


def feature_run(model, reqs, window: int = 0, post=None, probe=None,
                time_admissions: bool = False, **kw) -> dict:
    """One engine over ``reqs`` to the end: the results, wall seconds, K4
    launches (counted from 0 here), stats and counters; with ``window``
    a profiled window from that many steps in, after which ``probe(engine)``
    runs on the live state (its time left out of the wall, its launches
    out of the count). ``time_admissions`` synchronises the card around
    each admission to time it, so a run that gives a wall leaves it off."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    queue = S.RequestQueue(max_prompt_len=model.cfg.text_seq_len)
    engine = Engine(model, queue, complete=None if post is None
                    else post.submit, time_admissions=time_admissions,
                    **kw)
    pairs = []
    if engine.kv == "paged":
        pair_page_ratio(engine, pairs)
    handles = [queue.submit(r) for r in reqs]
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    prof = probed = None
    probe_s = 0.0
    if window:
        for _ in range(window):
            engine.step_once()
        prof = idle_window(engine)
        if probe is not None:
            t_probe = time.perf_counter()
            launches = PA.paged_decode_attention.launches
            probed = probe(engine)
            PA.paged_decode_attention.launches = launches
            probe_s = time.perf_counter() - t_probe
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - probe_s
    launches = PA.paged_decode_attention.launches
    if post is not None:
        post.close()
    results = [h.result(timeout=60) for h in handles]
    for r in results:
        check(r.ok, f"request {r.request_id}: {r.status} {r.reason}")
    return {"engine": engine, "results": results, "wall_s": wall,
            "k4_launches": launches, "stats": engine.stats(),
            "counters": engine.counters(), "profile": prof,
            "pair_pages": pairs, "probe": probed}


def token_agreement(a: list, b: list) -> dict:
    """Share of equal image tokens between two runs' results, and each
    request's first diverging position (None where identical)."""
    same = total = 0
    first = []
    for x, y in zip(a, b):
        x, y = list(x.tokens), list(y.tokens)
        same += sum(u == v for u, v in zip(x, y))
        total += len(x)
        diff = [i for i, (u, v) in enumerate(zip(x, y)) if u != v]
        first.append(diff[0] if diff else None)
    return {"identical_share": same / total, "first_divergence": first}


def run_summary(cfg, run: dict) -> dict:
    steps = run["stats"]["decode_steps"]
    image_tokens = len(run["results"]) * cfg.image_seq_len
    st = run["stats"]
    out = {"wall_s": run["wall_s"], "decode_steps": steps,
           "ms_per_decode_step": run["wall_s"] * 1e3 / steps,
           "image_tokens_per_s": image_tokens / run["wall_s"],
           "k4_launches": run["k4_launches"], "profile": run["profile"],
           "counters": run["counters"]}
    for key in ("pages_peak", "evicted", "prefix_hits", "prefill_p50_ms",
                "warm_admit_p50_ms", "spec_acceptance_rate",
                "spec_tokens_per_round", "spec_rounds"):
        if key in st:
            out[key] = st[key]
    prof = run["profile"]
    if prof and isinstance(prof.get("device_ms_per_step"), float):
        # against the run's own wall a step: the profiled window's wall
        # carries the profiler's host cost
        out["device_idle_share"] = max(
            0.0, 1 - prof["device_ms_per_step"] / out["ms_per_decode_step"])
    if "prefill_p50_ms" in st:
        out["prefill_ms_saved_by_warm_admission"] = \
            st["prefill_p50_ms"] - st["warm_admit_p50_ms"]
    pairs = run["pair_pages"]
    guided = [own for pair, _, own in pairs if pair]
    plain = [own for pair, _, own in pairs if not pair]
    if guided and plain:
        out["pair_pages_over_unguided"] = (sum(guided) / len(guided)) / (
            sum(plain) / len(plain))
    return out


def check_feature_run(cfg, name: str, run: dict, reqs) -> None:
    """Every result ok, ``image_seq_len`` ids in range, every page back
    except what the prefix index holds, and the index's ``clear()``
    returns those."""
    for r, res in zip(reqs, run["results"]):
        toks = torch.as_tensor(res.tokens)
        check(toks.shape == (cfg.image_seq_len,) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.num_image_tokens,
              f"{name}: request {res.request_id}: bad image tokens")
        check(list(res.text_tokens[:len(r.codes)]) == list(r.codes),
              f"{name}: request {res.request_id}: text lost its prompt")
    engine = run["engine"]
    if engine.kv != "paged":
        return
    held = engine.prefix.pages_held if engine.prefix is not None else 0
    check(engine.alloc.in_use == held, f"{name}: {engine.alloc.in_use} "
          f"pages in use, the index holds {held}: pages leaked")
    if engine.prefix is not None:
        engine.prefix.clear()
        check(engine.alloc.in_use == 0, f"{name}: the index's clear() left "
              f"{engine.alloc.in_use} pages")


def spec_k4_case(engine, dtype=torch.bfloat16, offset: int = 2) -> dict:
    """K4 as the verify launches it, on the run's live state: the pool's
    layer 0, the block tables and chunk-start positions of the engine
    mid-run, the row mask of offset ``offset`` (``_chunk_masks``), random
    queries; held against the plain version with the ``kernel`` phase's
    bfloat16 tolerances, timed beside it and the byte bound."""
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    cfg = engine.cfg.transformer
    pool = engine.pool
    kp, vp = pool["k"][0], pool["v"][0]
    pos = engine.pos.clone()
    bt = engine.block_tables
    allowed = decode_ops._chunk_masks(cfg, pos, engine.key_mask,
                                      SPEC_K)[0][:, offset].contiguous()
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((pos.numel(), cfg.heads, cfg.dim_head), generator=g,
                    device="cuda").to(dtype)
    args = (q, kp, vp, bt, pos, allowed)
    scale = cfg.scale
    got = PA.paged_decode_attention(*args, scale=scale)
    want = PA.paged_decode_attention_plain(*args, scale=scale)
    mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), bt, pos, allowed,
                                          scale=scale)[0]
    err = partials_held("spec K4", got, want, mag, 1e-2, 1e-2)
    ms = cuda_ms(lambda: PA.paged_decode_attention(*args, scale=scale),
                 iters=50)
    plain_ms = cuda_ms(lambda: PA.paged_decode_attention_plain(
        *args, scale=scale), iters=10, warmup=2)
    bound, by = bound_ms(q, kp, pos, None)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by,
            "positions": [int(p) for p in pos.tolist()]}


def phase_serve_features() -> dict:
    """The single engine's serving features at the north width (bfloat16,
    depth 12, seeded weights; 8 slots, K = 8, page 16) on
    ``feature_requests``:

    A. ``kv='paged'``, ``paged_attn='kernel'``, ``prefix_cache=True``, the
       pool cut to ``FEATURE_PAGES`` so that eviction fires, with the
       postprocess worker scoring every image through a seeded
       ``CLIPConfig()`` CLIP (K3 without the causal constraint, 12
       launches an image): every handle completes, evicted >= 1,
       prefix_hits >= 2, cfg_pairs == 2, no page leaks and the index's
       clear() returns every page it held, K4 launched depth x decode
       steps; each score equals a synchronous ``clip_apply`` of the same
       image and caption to rtol/atol 1e-2 (bfloat16: a few roundings of
       2^-8 relative on scores bounded by exp(1)); an injected failure
       comes back as ``status='error'``;
    B. the same with ``speculative=4``, ``draft_layers=6``: K4 launched
       rounds x (6 x 6 + 12 x 4), the acceptance, K4 held against its
       plain version at one verify offset's row mask on the run's state;
    C. ``kv='dense'`` (gather reads, no K4).
    A's wall includes the worker's VAE decode and CLIP scoring on the same
    card; its profiled window (after 40 chunks, 320 decode steps) comes
    before any request completes, so that window is the engine's alone.
    Then A, B (2-layer draft) and C again in float32 at depth 4, whose
    tokens must be identical; the float32 A alone times its admissions
    (cold prefill against warm admission), so no bfloat16 wall carries
    their synchronisations; at bfloat16 depth 12 the share of identical
    tokens and the first diverging positions of B and C against A are
    printed, not checked."""
    import dataclasses
    from dalle_pytorch_tpu_torch.models import clip as CL
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    cfg = north_cfg()
    reqs = feature_requests(cfg)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    clip = CL.clip_init(CL.CLIPConfig(sparse_impl="pallas"), seed=7,
                        dtype=torch.bfloat16)
    record = dict(phase="serve_features", ok=True, requests=len(reqs),
                  num_pages=FEATURE_PAGES)

    # A: the eager engine with the prefix cache, eviction and the worker
    post = PostProcessor(vae, model, clip=clip).start()
    BS.block_sparse_attention_fwd.launches = 0
    a = feature_run(model, reqs, window=40, post=post, **FEATURE_ENGINE)
    k3 = BS.block_sparse_attention_fwd.launches
    check_feature_run(cfg, "A", a, reqs)
    st = a["stats"]
    check(st["evicted"] >= 1, f"A: no eviction ({st['evicted']})")
    check(st["prefix_hits"] >= 2, f"A: {st['prefix_hits']} prefix hits")
    check(st["cfg_pairs"] == 2, f"A: cfg_pairs {st['cfg_pairs']}, not 2")
    check(a["k4_launches"] == cfg.depth * st["decode_steps"],
          f"A: K4 launched {a['k4_launches']} times, not depth x "
          f"{st['decode_steps']} decode steps")
    check(k3 == 12 * len(reqs), f"A: K3 launched {k3} times for "
          f"{len(reqs)} CLIP scores, not 12 each")
    score_err = 0.0
    with torch.no_grad():
        for res in a["results"]:
            check(res.clip_score is not None and math.isfinite(res.clip_score)
                  and res.image.shape == (256, 256, 3),
                  f"A: request {res.request_id} has no image or score")
            img = torch.as_tensor(res.image, device="cuda")
            text = torch.as_tensor(res.text_tokens, device="cuda").long()
            want = float(CL.clip_apply(clip, text[None],
                                       img.to(torch.bfloat16)[None])[0])
            score_err = max(score_err, abs(res.clip_score - want))
            check(abs(res.clip_score - want) <= 1e-2 + 1e-2 * abs(want),
                  f"A: worker score {res.clip_score} != clip_apply {want}")
    post = PostProcessor(vae, model, clip=clip).start()
    bad = S.RequestHandle(reqs[0])
    post.submit(bad, S.Result(status=S.OK, request_id=99, tokens=None))
    post.close()
    check(bad.result(timeout=30).status == S.ERROR,
          "an injected postprocess failure did not come back as an error")
    record["A"] = run_summary(cfg, a)
    record["A"].update(k3_launches=k3, clip_score_max_abs_err=score_err,
                       clip_scores=[r.clip_score for r in a["results"]])

    # B: speculation through K4, one walk per draft and verify offset
    b = feature_run(model, reqs, window=20, probe=spec_k4_case,
                    speculative=SPEC_K, draft_layers=SPEC_DRAFT,
                    **FEATURE_ENGINE)
    check_feature_run(cfg, "B", b, reqs)
    rounds = b["stats"]["decode_steps"]
    per_round = SPEC_DRAFT * SPEC_K * (SPEC_K - 1) // 2 + cfg.depth * SPEC_K
    check(b["k4_launches"] == rounds * per_round,
          f"B: K4 launched {b['k4_launches']} times, not {rounds} rounds x "
          f"{per_round}")
    record["B"] = run_summary(cfg, b)
    record["B"].update(k4_launches_per_round=per_round,
                       k4_at_verify_offset=b["probe"])
    record["B_vs_A"] = token_agreement(b["results"], a["results"])

    # C: the dense slot cache through the gather read
    c = feature_run(model, reqs, window=40, num_slots=8, chunk_steps=8,
                    kv="dense")
    check_feature_run(cfg, "C", c, reqs)
    check(c["k4_launches"] == 0, "C: the dense engine launched K4")
    record["C"] = run_summary(cfg, c)
    record["C_vs_A"] = token_agreement(c["results"], a["results"])

    # float32 at depth 4: tokens identical across A, B and C
    del model, a, b, c
    fcfg = dataclasses.replace(cfg, depth=IDENTITY_DEPTH)
    fvae = V.vae_init(fcfg.vae, seed=3)
    fmodel = D.dalle_init(fcfg, seed=4, vae=fvae)
    fa = feature_run(fmodel, reqs, time_admissions=True, **FEATURE_ENGINE)
    fb = feature_run(fmodel, reqs, speculative=SPEC_K,
                     draft_layers=IDENTITY_DRAFT, **FEATURE_ENGINE)
    fc = feature_run(fmodel, reqs, num_slots=8, chunk_steps=8, kv="dense")
    ident = {}
    for name, run in (("B", fb), ("C", fc)):
        agree = token_agreement(run["results"], fa["results"])
        ident[name] = agree
        check(agree["identical_share"] == 1.0,
              f"float32 depth {IDENTITY_DEPTH}: {name}'s tokens differ from "
              f"A's: {agree}")
    record["float32_identity"] = {
        "depth": IDENTITY_DEPTH, "draft_layers": IDENTITY_DRAFT,
        "evicted": fa["stats"]["evicted"],
        "prefill_p50_ms": fa["stats"]["prefill_p50_ms"],
        "warm_admit_p50_ms": fa["stats"]["warm_admit_p50_ms"],
        "prefill_ms_saved_by_warm_admission":
            fa["stats"]["prefill_p50_ms"] - fa["stats"]["warm_admit_p50_ms"],
        "spec_tokens_per_round": fb["stats"]["spec_tokens_per_round"],
        "wall_s": {"A": fa["wall_s"], "B": fb["wall_s"], "C": fc["wall_s"]},
        **ident}
    emit(**record)
    return record


def reference_state_dict(cfg, seed: int = 11) -> dict:
    """A reference-layout DALLE ``state_dict`` (the reference's key names
    and torch layouts: ``transformer.layers.layers.{i}.{0,1}``, the
    summed axial table over (image_size, image_size), the embedded VAE
    with its codebook tied to ``image_emb``) at ``cfg``'s widths, float32,
    seeded."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape, std=0.02):
        return torch.randn(shape, generator=g) * std

    d, inner, v = cfg.dim, cfg.heads * cfg.dim_head, cfg.vae
    sd = {"vae.codebook.weight": w(v.num_tokens, v.codebook_dim, std=1.0)}
    ch = [v.channels] + [v.hidden_dim] * v.num_layers
    for i in range(v.num_layers):
        sd[f"vae.encoder.{i}.0.weight"] = w(ch[i + 1], ch[i], 4, 4)
        sd[f"vae.encoder.{i}.0.bias"] = w(ch[i + 1])
    sd[f"vae.encoder.{v.num_layers}.weight"] = w(v.num_tokens, ch[-1], 1, 1)
    sd[f"vae.encoder.{v.num_layers}.bias"] = w(v.num_tokens)
    dec = [v.codebook_dim] + [v.hidden_dim] * v.num_layers
    for i in range(v.num_layers):
        sd[f"vae.decoder.{i}.0.weight"] = w(dec[i], dec[i + 1], 4, 4)
        sd[f"vae.decoder.{i}.0.bias"] = w(dec[i + 1])
    sd[f"vae.decoder.{v.num_layers}.weight"] = w(v.channels, dec[-1], 1, 1)
    sd[f"vae.decoder.{v.num_layers}.bias"] = w(v.channels)
    for i in range(cfg.depth):
        a, f = f"transformer.layers.layers.{i}.0.", \
            f"transformer.layers.layers.{i}.1."
        sd.update({a + "norm.weight": 1 + w(d), a + "norm.bias": w(d),
                   a + "fn.to_qkv.weight": w(3 * inner, d),
                   a + "fn.to_out.0.weight": w(d, inner),
                   a + "fn.to_out.0.bias": w(d),
                   f + "norm.weight": 1 + w(d), f + "norm.bias": w(d),
                   f + "fn.net.0.weight": w(8 * d, d),
                   f + "fn.net.0.bias": w(8 * d),
                   f + "fn.net.3.weight": w(d, 4 * d),
                   f + "fn.net.3.bias": w(d)})
    size = v.image_size
    sd.update({"text_emb.weight": w(cfg.num_text_tokens, d, std=1.0),
               "image_emb.weight": sd["vae.codebook.weight"],
               "text_pos_emb.weight": w(cfg.text_seq_len, d, std=1.0),
               "image_pos_emb.weights.0": w(1, size, 1, d, std=1.0),
               "image_pos_emb.weights.1": w(1, 1, size, d, std=1.0),
               "to_logits.0.weight": 1 + w(d), "to_logits.0.bias": w(d),
               "to_logits.1.weight": w(cfg.total_tokens, d),
               "to_logits.1.bias": w(cfg.total_tokens)})
    return sd


def phase_import() -> dict:
    """Reference weights in and out through the entry points' ``main``:
    a seeded reference-layout DALLE ``state_dict`` at the north width
    (depth ``SERVE_DEPTH``) is
    saved as a ``.pth``; ``import_torch dalle`` turns it into a DALLE and
    a VAE checkpoint; ``gen_dalle`` samples one image from them on the
    card (its grid PNG 260 x 260 x 3); ``export-dalle`` writes the
    checkpoint back, and every tensor must equal the input bit for bit.
    The JAX package's import CLI records no ``meta.vae_checkpoint``, which
    gen_dalle and export-dalle read, so the manifest gains it here, as a
    user would add it."""
    import dataclasses
    import shutil
    import tempfile
    from dalle_pytorch_tpu_torch import checkpoint as C
    from dalle_pytorch_tpu_torch.cli import gen_dalle, import_torch
    from dalle_pytorch_tpu_torch.data import images as I
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    root = tempfile.mkdtemp(prefix="chip-smoke-import-")
    try:
        sd = reference_state_dict(cfg)
        pth = os.path.join(root, "dalle.pth")
        torch.save(sd, pth)
        models = os.path.join(root, "models")
        dalle_dir = os.path.join(models, "imported_dalle-0")
        vae_dir = os.path.join(models, "imported_vae-0")
        t0 = time.perf_counter()
        import_torch.main(["dalle", pth, "--out", dalle_dir, "--vae_out",
                           vae_dir, "--heads", str(cfg.heads)])
        import_s = time.perf_counter() - t0
        manifest = C.load_manifest(dalle_dir)
        manifest["meta"]["vae_checkpoint"] = vae_dir
        with open(os.path.join(dalle_dir, C.MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(root, "only.txt"), "w") as f:
            f.write("a red square\na small blue circle\n")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_dalle.main(["a red square", "--name", "imported",
                        "--dalle_epoch", "0", "--num_images", "1",
                        "--seed", "5", "--models_dir", models,
                        "--results_dir", os.path.join(root, "gen"),
                        "--captions_only", os.path.join(root, "only.txt")])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        (png,) = os.listdir(os.path.join(root, "gen"))
        img = I.read_image(os.path.join(root, "gen", png))
        check(img.shape == (260, 260, 3), f"import: the grid is {img.shape}")
        back = os.path.join(root, "back.pth")
        t0 = time.perf_counter()
        import_torch.main(["export-dalle", back, "--out", dalle_dir])
        export_s = time.perf_counter() - t0
        out = torch.load(back, weights_only=True)
        check(set(out) == set(sd), f"import: export keys differ: "
              f"{sorted(set(out) ^ set(sd))[:8]}")
        unequal = [k for k in sd if not torch.equal(out[k], sd[k])]
        check(not unequal, f"import: {len(unequal)} tensors changed, e.g. "
                           f"{unequal[:4]}")
        record = dict(phase="import", ok=True, tensors=len(sd),
                      pth_bytes=os.path.getsize(pth), import_s=import_s,
                      gen_dalle_s=gen_s, export_s=export_s,
                      round_trip_bit_equal=True,
                      gen_grid_shape=list(img.shape))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(**record)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = timed(phase_build)
    kernel = timed(phase_kernel)
    timed(phase_decode)
    engine = timed(phase_engine)
    flash = timed(phase_flash)
    train = timed(phase_train)
    wide_train = timed(phase_wide_train)
    fused_train = timed(phase_fused_train)
    sparse = timed(phase_sparse_kernels)
    sparse_train = timed(phase_sparse_train)
    wide_sparse_train = timed(phase_wide_sparse_train)
    sparse_engine = timed(phase_sparse_engine)
    wide_engine = timed(phase_wide_engine)
    generate = timed(phase_generate)
    timed(phase_vae_train)
    rev_train = timed(phase_rev_train)
    rev_decode = timed(phase_rev_decode)
    moe_train = timed(phase_moe_train)
    clip_train = timed(phase_clip_train)
    remat = timed(phase_remat)
    cli = timed(phase_cli, train)
    features = timed(phase_serve_features)
    timed(phase_import)
    emit(phase_seconds=PHASE_SECONDS)
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
    # the wide bodies at the wide_train path's case (bfloat16, all-True
    # mask, b 8, h 2, n 1280, d 256): K1, K2a and K2b split on the tensor
    # cores
    wc = flash[case_name(torch.bfloat16, False, WIDE_TIMED["d"])]
    for name, kind, line, count, library_ms in (
            ("flash_attention_fwd_wide_wgmma", "fwd", 88, "k1",
             wc["library"]["sdpa_fwd_ms"]),
            ("flash_attention_bwd_dq_wide_wgmma", "dq", 322, "k2a", None),
            ("flash_attention_bwd_dkv_wide_wgmma", "dkv", 367, "k2b",
             wc["library"]["sdpa_bwd_ms"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"dalle_pytorch_tpu/ops/flash_attention.py:{line}",
            "launches": wide_train["launches"][count],
            "max_abs_err": wc["max_abs_err"][kind],
            "ms": wc[kind]["ms"], "plain_ms": wc[kind]["plain_ms"],
            "bound_ms": wc[kind]["bound_ms"],
            "bound_by": wc[kind]["bound_by"], "library_ms": library_ms})
    # fused K2b's tensor-core bodies at the fused_train path's cases
    # (bfloat16, all-True mask; the north width and WIDE_TIMED), beside
    # SDPA's backward alone, which computes the same dq, dk and dv
    for name, fc_, width in (
            ("flash_attention_bwd_fused_wgmma", fc, "north"),
            ("flash_attention_bwd_fused_wide_wgmma", wc, "wide")):
        rows.append({
            "name": name, "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
            "replaces": "dalle_pytorch_tpu/ops/flash_attention.py:367",
            "launches": fused_train[width]["launches"]["k2b"],
            "max_abs_err": fc_["max_abs_err"]["fused"],
            "ms": fc_["fused"]["ms"], "plain_ms": fc_["fused"]["plain_ms"],
            "bound_ms": fc_["fused"]["bound_ms"],
            "bound_by": fc_["fused"]["bound_by"],
            "library_ms": fc_["library"]["sdpa_bwd_ms"]})
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
    # K3's wide tensor-core body at the wide_sparse_train path's case
    # (bfloat16, all-True mask, b 8, h 2, n 1280, d 256), beside SDPA with
    # the layout as a boolean mask
    k3w = sparse["k3"][case_name(torch.bfloat16, False, WIDE_TIMED["d"])]
    rows.append({
        "name": "block_sparse_attention_fwd_wide_wgmma", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": wide_sparse_train["launches"]["k3"],
        "max_abs_err": max(k3w["max_abs_err"].values()),
        "ms": k3w["ms"], "plain_ms": k3w["plain_ms"],
        "bound_ms": k3w["bound_ms"], "bound_by": k3w["bound_by"],
        "library_ms": k3w["sdpa_masked_ms"]})
    # K3 without the causal constraint, as the CLIP rerank of the
    # generate path runs it: the text encoder's case (bfloat16, n 256,
    # caption padding)
    k3c = sparse["k3"]["bfloat16/pad/noncausal/n256"]
    rows.append({
        "name": "block_sparse_attention_fwd_noncausal", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": generate["k3_launches"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]})
    # K4's wide split body at the wide serving shape (bfloat16 pages, 8
    # slots, heads=2, dim_head=256), both walks, launched by wide_engine
    for name, rec, walk, engine in (
            ("paged_decode_attention_wide", kernel["bfloat16/dh256/h2"],
             "prefix", "dense"),
            ("paged_decode_attention_visible_wide",
             sparse["k4_visible"]["bfloat16/dh256/h2"], "visible",
             "sparse_reads")):
        rows.append({
            "name": name, "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
            "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
            "launches": wide_engine[engine]["k4_launches"][walk],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    # the training slice's paths: the flash kernels at the north training
    # case (the reversible step, its backward recomputing K1; the MoE
    # model; the four remat modes), K3 without the causal constraint at
    # the CLIP text encoder's case (CLIP training), K4 at the serving case
    # (the reversible model's engine run)
    for path, rec in (("rev_train", rev_train), ("moe_train", moe_train),
                      ("remat", remat), ("cli", cli)):
        for name, kind, line, count, library_ms in (
                ("flash_attention_fwd", "fwd", 88, "k1",
                 lib["sdpa_fwd_ms"]),
                ("flash_attention_bwd_dq", "dq", 322, "k2a", None),
                ("flash_attention_bwd_dkv", "dkv", 367, "k2b",
                 lib["sdpa_bwd_ms"])):
            rows.append({
                "name": f"{name}@{path}", "route": "cuda",
                "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
                "replaces":
                    f"dalle_pytorch_tpu/ops/flash_attention.py:{line}",
                "launches": rec["launches"][count],
                "max_abs_err": fc["max_abs_err"][kind],
                "ms": fc[kind]["ms"], "plain_ms": fc[kind]["plain_ms"],
                "bound_ms": fc[kind]["bound_ms"],
                "bound_by": fc[kind]["bound_by"],
                "library_ms": library_ms})
    rows.append({
        "name": "block_sparse_attention_fwd_noncausal@clip_train",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": clip_train["launches"]["k3"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]})
    rows.append({
        "name": "paged_decode_attention@rev_decode", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": rev_decode["k4_launches"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None})
    # the single engine's features: K4 once per draft and verify offset
    # (run B, at one verify offset's row mask on the run's state), and K3
    # without the causal constraint in the postprocess worker's CLIP
    spec = features["B"]["k4_at_verify_offset"]
    rows += [{
        "name": "paged_decode_attention@serve_spec", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": features["B"]["k4_launches"],
        "max_abs_err": spec["max_abs_err"], "ms": spec["ms"],
        "plain_ms": spec["plain_ms"], "bound_ms": spec["bound_ms"],
        "bound_by": spec["bound_by"], "library_ms": None}, {
        "name": "block_sparse_attention_fwd_noncausal@postprocess",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": features["A"]["k3_launches"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]}]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
