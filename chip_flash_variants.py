"""Where the time of the tensor-core flash bodies goes, on one H100.

    python3 chip_flash_variants.py

Builds edited copies of ``dalle_pytorch_tpu_torch/csrc/flash_attention.cu``
side by side, each with one piece of the bfloat16 K1 (forward), K2a (dq)
and K2b split (dk, dv) bodies taken out, and times K1, K2a and K2b of
each copy with CUDA events at the north training shapes (b 8, h 8,
n 1,280, d 64, causal), with the all-True mask training passes and with
no mask. A copy without a piece computes wrong values: only ``tree``,
``stages3`` and ``dq_stages4`` are checked against the plain versions,
as ``chip_smoke.py`` holds them (``held``: bf16 rtol/atol 2e-2, the
gradients dq, dk and dv at ``grad_atol``). One copy carries a planted
fault instead: ``dq_drop_tile``'s K2a leaves key tile 15 out of the
sums of rows 960 on, and the run fails unless ``chip_smoke.py``'s dq
check rejects it (its line also says whether the plain 2e-2 atol would
have). Prints one JSON line per variant and mask, then the card's name
and power limit. Needs a CUDA card; imports nothing of JAX.

The variants: ``tree`` (the source as it is), ``no_exp`` (exponentials
replaced by their argument), ``no_score_products`` (S = Q K^T, K2a's
dP = dO V^T, and K2b's S^T and dP^T, not issued), ``no_output_products``
(O += P V, dQ += dS K, dV and dK not issued), ``no_copies`` (no key or
query tile copied after the first), ``stages3`` (K1's ring of 3 tiles
filled one ahead instead of 4 filled two ahead: less shared memory, so
more blocks an SM; K1 only, since K2b shares the constant and takes a
query tile's 1 / l the iteration before it is used, so needs two tiles
ahead), ``dq_stages4`` (K2a's ring of 4 tiles filled two ahead, as
K1's, instead of its own 3 filled one ahead).
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
            ";"},
    "no_output_products": {
        "for (int kk = 0; kk < 4; ++kk) mma_rs<D>(o, pa[kk], "
        "wg::desc_mn(tV, kk));": "",
        "mma_rs<D>(dv_acc, pa[kk], wg::desc_mn(tO, kk));": ";",
        "mma_rs<D>(dk_acc, da[kk], wg::desc_mn(tQ, kk));": ";",
        "for (int kk = 0; kk < 4; ++kk) mma_rs<D>(acc, da[kk], "
        "wg::desc_mn(tK, kk));": ""},
    "no_copies": {
        "    if (it < num_k) {": "    if (it < 2) {",
        "    if (iq < num_q) {\n      const int q0 = iq * kTile;":
            "    if (iq < iq0 + 2) {\n      const int q0 = iq * kTile;"},
    "stages3": {"constexpr int kStages = 4;": "constexpr int kStages = 3;"},
    "dq_stages4": {"constexpr int kDqStages = 3;":
                   "constexpr int kDqStages = 4;"},
    "dq_drop_tile": {
        "    if (!live_group || (causal && k0 > wq0 + wg::kRows - 1)) {\n"
        "      wg::mma_wait<0>();              // the last dQ += dS K frees":
        "    if (!live_group || (causal && k0 > wq0 + wg::kRows - 1) ||\n"
        "        it == 15) {\n"
        "      wg::mma_wait<0>();              // the last dQ += dS K frees"},
}
CHECKED = ("tree", "stages3", "dq_stages4")
# planted faults K2a's dq check must reject; not timed
REJECTED = ("dq_drop_tile",)
# the kernels each variant computes right (if CHECKED) or times at all
KERNELS = {"stages3": ("k1",), "dq_stages4": ("k2a",),
           "dq_drop_tile": ("k2a",)}


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
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((8, 8, 1280, 64), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    masks = {"all_true": torch.ones((8, 1280), dtype=torch.bool,
                                    device="cuda"), "none": None}
    entry = FA._entry
    try:
        for mask_name, mask in masks.items():
            kw = dict(scale=512 ** -0.5, causal=True, mask=mask)
            out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
            dstat = (do.float() * out_p.float()).sum(-1)
            args = (q, k, v, do, m_p, l_p, dstat)
            dk_p, dv_p, _ = FA.flash_attention_bwd_dkv_plain(*args, **kw)
            dq_p = FA.flash_attention_bwd_dq_plain(*args, **kw)
            for name, lib in libs.items():
                for fn in ("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"):
                    getattr(lib, fn).argtypes = FA._ARGTYPES[fn]
                    getattr(lib, fn).restype = ctypes.c_int
                FA._entry = lambda fn, lib=lib: getattr(lib, fn)
                record = {"variant": name, "mask": mask_name}
                calls = {
                    "k1": (lambda: FA.flash_attention_fwd(q, k, v, **kw)[:1],
                           (out_p,)),
                    "k2a": (lambda: (FA.flash_attention_bwd_dq(*args, **kw),),
                            (dq_p,)),
                    "k2b_split": (
                        lambda: FA.flash_attention_bwd_dkv(*args, **kw)[:2],
                        (dk_p, dv_p))}
                calls = {k_: c for k_, c in calls.items()
                         if k_ in KERNELS.get(name, calls)}
                if name in REJECTED:
                    (dq,) = calls["k2a"][0]()
                    record.update(rejected_by_dq_check(chip_smoke, dq, dq_p))
                    print(json.dumps(record), flush=True)
                    continue
                if name in CHECKED:
                    record["max_abs_err"] = max(
                        chip_smoke.held(
                            f"{name} {kernel}", got, want, 2e-2,
                            chip_smoke.grad_atol(torch.bfloat16, want, 2e-2)
                            if kernel != "k1" else 2e-2)
                        for kernel, (fn, wants) in calls.items()
                        for got, want in zip(fn(), wants))
                for kernel, (fn, _) in calls.items():
                    record[f"{kernel}_us"] = events_us(fn)
                print(json.dumps(record), flush=True)
    finally:
        FA._entry = entry
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
