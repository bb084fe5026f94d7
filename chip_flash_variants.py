"""Where the time of the tensor-core flash bodies goes, on one H100.

    python3 chip_flash_variants.py

Builds edited copies of ``dalle_pytorch_tpu_torch/csrc/flash_attention.cu``
side by side, each with one piece of the bfloat16 tensor-core bodies
taken out or changed, and times K1 (forward), K2a (dq) and K2b split
(dk, dv) of each copy with CUDA events and torch.profiler, with the
all-True mask training passes and with no mask, at two shapes (causal):
``north`` (b 8, h 8, n 1,280, d 64: the narrow bodies) and ``wide`` (b 8,
h 2, n 1,280, d 256: the north width split as heads=2, dim_head=256,
where bfloat16 K1 and K2b split run the wide tensor-core bodies). A copy
without a piece computes wrong values: only the ``CHECKED`` variants are
held against the plain versions, as ``chip_smoke.py`` holds them
(``held``: bf16 rtol/atol 2e-2, the gradients dq, dk and dv at
``grad_atol``). One copy carries a planted fault instead:
``dq_drop_tile``'s K2a leaves key tile 15 out of the sums of rows 960 on,
and the run fails unless ``chip_smoke.py``'s dq check rejects it (its
line also says whether the plain 2e-2 atol would have). Each shape's
first line gives the bounds (``chip_smoke.flash_bound``) and
``F.scaled_dot_product_attention``'s forward and backward alone, the
library yardstick. Prints one JSON line per variant, shape and mask, then
the card's name and power limit. Needs a CUDA card; imports nothing of
JAX.

The variants, at both shapes unless named for one: ``tree`` (north) and
``wide_tree`` (wide), the source as it is; ``no_exp`` (exponentials
replaced by their argument), ``no_score_products`` (S = Q K^T, K2a's
dP = dO V^T, and K2b's S^T and dP^T, not issued), ``no_output_products``
(O += P V, dQ += dS K, dV and dK not issued), ``no_copies`` (no key or
query tile copied after the first two); north only: ``stages3`` (K1's
narrow ring of 3 tiles filled one ahead instead of 4 filled two ahead:
less shared memory, so more blocks an SM; K2b shares the constant and
takes a query tile's 1 / l the iteration before it is used, so needs two
tiles ahead), ``dq_stages4`` (K2a's ring of 4 tiles filled two ahead, as
K1's, instead of its own 3 filled one ahead); wide only:
``wide_cuda_cores`` (the source as it is, its bf16 d 192 and 256 calls
sent back to the CUDA-core wide bodies: the wrappers ask the C entry
points for them, ``ROUTED_TO_CUDA_CORES``; the "before" of the wide
redesign), ``wide_fwd_g1`` (wide K1 as
one warpgroup of 64 query rows over a ring of three tiles filled one
ahead, its O += P V running under the next tile's S, against two
warpgroups sharing two tiles, each O += P V waited for within its
iteration), ``wide_fwd_split_ring`` (wide K1's two warpgroups with K and
V refilled at separate barriers, two a tile, so that O += P V runs
under the next S), ``wide_dkv_own_scores`` (wide K2b's dK warpgroup
computes S^T and P^T itself instead of taking P^T from the dV
warpgroup through shared memory: 5 tile products a query tile instead
of 4). The last two are designs the source left behind; their edits
write the code back into the copy.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "flash_attention.cu"

VARIANTS = {
    "tree": {},
    "wide_tree": {},
    "no_exp": {
        "x = wg::exp2_approx((x - m_new) * kLog2e);":
            "x = (x - m_new) * kLog2e;",
        ": wg::exp2_approx((x - sm[c]) * kLog2e) *":
            ": ((x - sm[c]) * kLog2e) *",
        "x = wg::exp2_approx((x * scale - mq) * kLog2e) * inv_l;":
            "x = ((x * scale - mq) * kLog2e) * inv_l;",
        "x = keep ? wg::exp2_approx(fmaf(x, sl2, nml2[hh])) * cl[hh]":
            "x = keep ? fmaf(x, sl2, nml2[hh]) * cl[hh]",
        "x = wg::exp2_approx(fmaf(x, sl2, nml2[hh])) * cl[hh];":
            "x = fmaf(x, sl2, nml2[hh]) * cl[hh];"},
    "no_score_products": {
        "wg::mma_ss_n64(s, wg::desc_k(tQ, kk), wg::desc_k(tK, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(st, wg::desc_k(tK, kk), wg::desc_k(tQ, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(dpt, wg::desc_k(tV, kk), wg::desc_k(tO, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(dp, wg::desc_k(tO, kk), wg::desc_k(tV, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(st, wg::desc_k(sK, kk), wg::desc_k(tQ, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(dpt, wg::desc_k(sV, kk), wg::desc_k(tO, kk), kk > 0);":
            ";"},
    "no_output_products": {
        "for (int kk = 0; kk < 4; ++kk) mma_rs<D>(o, pa[kk], "
        "wg::desc_mn(tV, kk));": "",
        "mma_rs<D>(dv_acc, pa[kk], wg::desc_mn(tO, kk));": ";",
        "mma_rs<D>(dk_acc, da[kk], wg::desc_mn(tQ, kk));": ";",
        "for (int kk = 0; kk < 4; ++kk) mma_rs<D>(acc, da[kk], "
        "wg::desc_mn(tK, kk));": "",
        "mma_rs<D>(acc, frag[kk], wg::desc_mn(tO, kk));": ";",
        "mma_rs<D>(acc, frag[kk], wg::desc_mn(tQ, kk));": ";"},
    "no_copies": {
        "    if (it < num_k) {": "    if (it < 2) {",
        "    if (iq < num_q) {\n      const int q0 = iq * kTile;":
            "    if (iq < iq0 + 2) {\n      const int q0 = iq * kTile;"},
    "stages3": {"constexpr int kStages = 4;": "constexpr int kStages = 3;"},
    "dq_stages4": {"constexpr int kDqStages = 3;":
                   "constexpr int kDqStages = 4;"},
    "wide_cuda_cores": {},
    "wide_fwd_g1": {"constexpr int kWideFwdGroups = 2;":
                    "constexpr int kWideFwdGroups = 1;",
                    "constexpr int kWideFwdStages = 2;":
                    "constexpr int kWideFwdStages = 3;"},
    # K1's body takes SPLIT (two stages filled one ahead), the wide kernel
    # sets it: K and V in separate copy groups, K of tile it + 1 after the
    # barrier that opens tile it, V of tile it + 1 (load_values) after a
    # second barrier (turn_values) once every warpgroup's O += P V of tile
    # it - 1 has completed, so that O += P V runs under the next S
    "wide_fwd_split_ring": {
        "template <int D, int G, int STAGES, int AHEAD>\n__device__":
            "template <int D, int G, int STAGES, int AHEAD, bool SPLIT = "
            "false>\n__device__",
        "      const uint32_t at = (it % STAGES) * kT;\n"
        "      wg::load_tile<D, kNT>(sK + at, kh, it * kTile, n, tid);\n"
        "      wg::load_tile<D, kNT>(sV + at, vh, it * kTile, n, tid);\n"
        "    }\n    wg::cp_async_commit();\n  };\n":
            "      const uint32_t at = (it % STAGES) * kT;\n"
            "      wg::load_tile<D, kNT>(sK + at, kh, it * kTile, n, tid);\n"
            "      if constexpr (!SPLIT)\n"
            "        wg::load_tile<D, kNT>(sV + at, vh, it * kTile, n, tid);\n"
            "    }\n    wg::cp_async_commit();\n  };\n"
            "  auto load_values = [&](int it) {\n"
            "    if (it < num_k)\n"
            "      wg::load_tile<D, kNT>(sV + (it % STAGES) * kT, vh, "
            "it * kTile, n, tid);\n"
            "    wg::cp_async_commit();\n  };\n"
            "  auto turn_values = [&](int it) {\n"
            "    wg::cp_async_wait<1>();\n    wg::fence_async_shared();\n"
            "    __syncthreads();\n    load_values(it + 1);\n  };\n",
        "  for (int it = 0; it < AHEAD; ++it) load_keys(it);\n":
            "  for (int it = 0; it < AHEAD; ++it) load_keys(it);\n"
            "  if constexpr (SPLIT) load_values(0);\n",
        "    wg::cp_async_wait<AHEAD - 1>();   // key tile `it` has landed":
            "    wg::cp_async_wait<SPLIT ? 1 : AHEAD - 1>();",
        "      wg::mma_wait<0>();              // the last O += P V frees "
        "its V stage\n":
            "      wg::mma_wait<0>();\n"
            "      if constexpr (SPLIT) turn_values(it);\n",
        "    for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, pa[kk]);\n":
            "    for (int kk = 0; kk < 4; ++kk) wg::a_frag(s, kk, pa[kk]);\n"
            "    if constexpr (SPLIT) turn_values(it);\n",
        "    if constexpr (STAGES - AHEAD == 1) {":
            "    if constexpr (STAGES - AHEAD == 1 && !SPLIT) {",
        "  fwd_wgmma<D, kWideFwdGroups, kWideFwdStages, kWideFwdAhead>(":
            "  fwd_wgmma<D, kWideFwdGroups, kWideFwdStages, kWideFwdAhead, "
            "true>("},
    # the dV warpgroup hands nothing across; the dK warpgroup issues S^T
    # before its dP^T and takes P^T and the keep bits from it
    "wide_dkv_own_scores": {
        "#pragma unroll\n"
        "      for (int i = 0; i < 32; ++i) shared_p[i * wg::kThreads + tid] "
        "= st[i];\n"
        "      shared_keep[tid] = keep;\n"
        "      wg::bar_arrive(1, 2 * wg::kThreads);\n": "",
        "      wg::mma_fence();\n#pragma unroll\n"
        "      for (int kk = 0; kk < D / 16; ++kk)\n"
        "        wg::mma_ss_n64(dpt,":
            "      wg::mma_fence();\n#pragma unroll\n"
            "      for (int kk = 0; kk < D / 16; ++kk)\n"
            "        wg::mma_ss_n64(st, wg::desc_k(sK, kk), "
            "wg::desc_k(tQ, kk), kk > 0);\n"
            "      wg::mma_commit();\n#pragma unroll\n"
            "      for (int kk = 0; kk < D / 16; ++kk)\n"
            "        wg::mma_ss_n64(dpt,",
        "      wg::bar_sync(1, 2 * wg::kThreads);     // warpgroup 0's P^T "
        "is in\n"
        "      const int r = tid - wg::kThreads;\n#pragma unroll\n"
        "      for (int i = 0; i < 32; ++i) st[i] = shared_p[i * "
        "wg::kThreads + r];\n"
        "      const uint32_t keep = shared_keep[r];\n":
            "      wg::mma_wait<1>();            // S^T (dP^T may still run)\n"
            "      wg::hold(st);\n"
            "      const uint32_t keep = probs(st);\n",
        "      33 * wg::kThreads * sizeof(float) + 1024;        // P^T, keep "
        "bits": "      1024;"},
    "dq_drop_tile": {
        "    if (!live_group || (causal && k0 > wq0 + wg::kRows - 1)) {\n"
        "      wg::mma_wait<0>();              // the last dQ += dS K frees":
        "    if (!live_group || (causal && k0 > wq0 + wg::kRows - 1) ||\n"
        "        it == 15) {\n"
        "      wg::mma_wait<0>();              // the last dQ += dS K frees"},
}
CHECKED = ("tree", "wide_tree", "stages3", "dq_stages4", "wide_cuda_cores",
           "wide_fwd_g1", "wide_fwd_split_ring", "wide_dkv_own_scores")
# variants whose wrappers ask the C entry points for the CUDA-core wide
# bodies where the tree runs the wide tensor-core ones
ROUTED_TO_CUDA_CORES = ("wide_cuda_cores",)
# planted faults K2a's dq check must reject; not timed
REJECTED = ("dq_drop_tile",)
# (b, h, n, d) of each shape
SHAPES = {"north": (8, 8, 1280, 64), "wide": (8, 2, 1280, 256)}
# the kernels each variant computes right (if CHECKED) or times at all, by
# shape; at the wide shape K2a runs its CUDA-core body in every variant
# but wide_cuda_cores, where it stands beside the other two
DEFAULT_KERNELS = {"north": ("k1", "k2a", "k2b_split"),
                   "wide": ("k1", "k2b_split")}
KERNELS = {"tree": {"north": DEFAULT_KERNELS["north"]},
           "wide_tree": {"wide": DEFAULT_KERNELS["wide"]},
           "stages3": {"north": ("k1",)}, "dq_stages4": {"north": ("k2a",)},
           "dq_drop_tile": {"north": ("k2a",)},
           "wide_cuda_cores": {"wide": ("k1", "k2a", "k2b_split")},
           "wide_fwd_g1": {"wide": ("k1",)},
           "wide_fwd_split_ring": {"wide": ("k1",)},
           "wide_dkv_own_scores": {"wide": ("k2b_split",)}}


def build_variants(build) -> dict:
    """{variant: loaded library}, all nvcc processes started together."""
    src = (build.CSRC / SOURCE).read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits.items():
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {SOURCE}")
            text = text.replace(old, new)
        copy = build.CSRC / f"_variant_{name}.cu"      # includes resolve
        copy.write_text(text)
        lib = out_dir / f"{name}.so"
        running[name] = (copy, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(copy)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (copy, lib, proc) in running.items():
        log, _ = proc.communicate()
        copy.unlink()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def events_us(fn, iters: int = 30, warmup: int = 3) -> float:
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
    return start.elapsed_time(end) / iters * 1e3


def rejected_by_dq_check(chip_smoke, dq, dq_p) -> dict:
    """Holds a faulty dq as ``chip_smoke.py`` holds K2a's; fails the run
    if the check passes it. Also says whether the 2e-2 atol alone would
    have passed it."""
    err = (dq.float() - dq_p.float()).abs()
    atol = chip_smoke.grad_atol(torch.bfloat16, dq_p, 2e-2)
    try:
        chip_smoke.held("planted fault dq", dq, dq_p, 2e-2, atol)
    except chip_smoke.SmokeFailure:
        pass
    else:
        raise SystemExit(f"K2a's dq check passed a planted fault (max abs "
                         f"{float(err.max()):.3e}, atol {atol:.3e})")
    bound = 2e-2 + 2e-2 * dq_p.float().abs()
    return {"max_abs_err": float(err.max()), "dq_atol": atol,
            "rejected": True,
            "passes_atol_2e-2": bool((err <= bound).all())}


def library_record(chip_smoke, shape, q, k, v, do) -> dict:
    """The bounds of the three kernels and SDPA's forward and backward
    alone (causal, no padding) at one shape: CUDA events us per call and
    profiler device us per call."""
    import torch.nn.functional as F
    b, h, n, d = q.shape
    rec = {"shape": shape, "b": b, "h": h, "n": n, "d": d}
    for kernel, kind in (("k1", "fwd"), ("k2a", "dq"), ("k2b_split", "dkv")):
        ms, by = chip_smoke.flash_bound(kind, torch.bfloat16, b, h, n, d)
        rec[f"{kernel}_bound_us"] = ms * 1e3
        rec[f"{kernel}_bound_by"] = by
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, is_causal=True, scale=512 ** -0.5)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                       scale=512 ** -0.5)
    sdpa_bwd = lambda: torch.autograd.grad(   # noqa: E731
        o, leaves, do, retain_graph=True)
    rec.update(sdpa_fwd_us=events_us(sdpa),
               sdpa_fwd_device_us=chip_smoke.all_device_us(sdpa),
               sdpa_bwd_us=events_us(sdpa_bwd),
               sdpa_bwd_device_us=chip_smoke.all_device_us(sdpa_bwd))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_flash_variants: no CUDA device is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dalle_pytorch_tpu_torch.ops import build
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    libs = build_variants(build)
    for name, lib in libs.items():
        for fn in ("flash_attention_fwd", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv"):
            getattr(lib, fn).argtypes = FA._ARGTYPES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    entry, wide_tc = FA._entry, FA.wide_tensor_cores
    try:
        for shape, (b, h, n, d) in SHAPES.items():
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v, do = (torch.randn((b, h, n, d), generator=g,
                                       device="cuda").to(torch.bfloat16)
                           for _ in range(4))
            print(json.dumps(library_record(chip_smoke, shape, q, k, v, do)),
                  flush=True)
            masks = {"all_true": torch.ones((b, n), dtype=torch.bool,
                                            device="cuda"), "none": None}
            for mask_name, mask in masks.items():
                kw = dict(scale=512 ** -0.5, causal=True, mask=mask)
                out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
                dstat = (do.float() * out_p.float()).sum(-1)
                args = (q, k, v, do, m_p, l_p, dstat)
                dk_p, dv_p, _ = FA.flash_attention_bwd_dkv_plain(*args, **kw)
                dq_p = FA.flash_attention_bwd_dq_plain(*args, **kw)
                for name, lib in libs.items():
                    kernels = KERNELS.get(name, DEFAULT_KERNELS).get(shape)
                    if not kernels:
                        continue
                    FA._entry = lambda fn, lib=lib: getattr(lib, fn)
                    FA.wide_tensor_cores = (
                        (lambda kind, dtype, d: False)
                        if name in ROUTED_TO_CUDA_CORES else wide_tc)
                    record = {"variant": name, "shape": shape,
                              "mask": mask_name}
                    calls = {
                        "k1": (lambda: FA.flash_attention_fwd(q, k, v,
                                                              **kw)[:1],
                               (out_p,)),
                        "k2a": (lambda: (FA.flash_attention_bwd_dq(*args,
                                                                   **kw),),
                                (dq_p,)),
                        "k2b_split": (
                            lambda: FA.flash_attention_bwd_dkv(*args,
                                                               **kw)[:2],
                            (dk_p, dv_p))}
                    calls = {k_: c for k_, c in calls.items()
                             if k_ in kernels}
                    if name in REJECTED:
                        (dq,) = calls["k2a"][0]()
                        record.update(rejected_by_dq_check(chip_smoke, dq,
                                                           dq_p))
                        print(json.dumps(record), flush=True)
                        continue
                    if name in CHECKED:
                        record["max_abs_err"] = max(
                            chip_smoke.held(
                                f"{name} {shape} {kernel}", got, want, 2e-2,
                                chip_smoke.grad_atol(torch.bfloat16, want,
                                                     2e-2)
                                if kernel != "k1" else 2e-2)
                            for kernel, (fn, wants) in calls.items()
                            for got, want in zip(fn(), wants))
                    for kernel, (fn, _) in calls.items():
                        record[f"{kernel}_us"] = events_us(fn)
                        record[f"{kernel}_device_us"] = \
                            chip_smoke.all_device_us(fn)
                    print(json.dumps(record), flush=True)
                del dk_p, dv_p, dq_p, out_p
    finally:
        FA._entry, FA.wide_tensor_cores = entry, wide_tc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
