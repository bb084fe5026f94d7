"""Where the time of the tensor-core flash bodies goes, on one H100.

    python3 chip_flash_variants.py

Builds edited copies of ``dalle_pytorch_tpu_torch/csrc/flash_attention.cu``
side by side, each with one piece of the bfloat16 K1 (forward) and K2b
split (dk, dv) bodies taken out, and times K1 and K2b of each copy with
CUDA events at the north training shapes (b 8, h 8, n 1,280, d 64,
causal), with the all-True mask training passes and with no mask. A
copy without a piece computes wrong values: only ``tree`` is checked,
against the plain versions (bf16, 2e-2). Prints one JSON line per
variant and mask, then the card's name and power limit. Needs a CUDA
card; imports nothing of JAX.

The variants: ``tree`` (the source as it is), ``no_exp`` (exponentials
replaced by their argument), ``no_score_products`` (S = Q K^T, and K2b's
S^T and dP^T, not issued), ``no_output_products`` (O += P V, dV and dK
not issued), ``no_copies`` (no key or query tile copied after the
first).
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
            "x = ((x * scale - mq) * kLog2e) * inv_l;"},
    "no_score_products": {
        "wg::mma_ss_n64(s, wg::desc_k(tQ, kk), wg::desc_k(tK, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(st, wg::desc_k(tK, kk), wg::desc_k(tQ, kk), kk > 0);":
            ";",
        "wg::mma_ss_n64(dpt, wg::desc_k(tV, kk), wg::desc_k(tO, kk), kk > 0);":
            ";"},
    "no_output_products": {
        "for (int kk = 0; kk < 4; ++kk) mma_rs<D>(o, pa[kk], "
        "wg::desc_mn(tV, kk));": "",
        "mma_rs<D>(dv_acc, pa[kk], wg::desc_mn(tO, kk));": ";",
        "mma_rs<D>(dk_acc, da[kk], wg::desc_mn(tQ, kk));": ";"},
    "no_copies": {
        "    if (it < num_k) {": "    if (it < 2) {",
        "    if (iq < num_q) {\n      const int q0 = iq * kTile;":
            "    if (iq < iq0 + 2) {\n      const int q0 = iq * kTile;"},
}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_flash_variants: no CUDA device is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
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
            for name, lib in libs.items():
                for fn in ("flash_attention_fwd", "flash_attention_bwd_dkv"):
                    getattr(lib, fn).argtypes = FA._ARGTYPES[fn]
                    getattr(lib, fn).restype = ctypes.c_int
                FA._entry = lambda fn, lib=lib: getattr(lib, fn)
                record = {"variant": name, "mask": mask_name}
                if name == "tree":
                    out = FA.flash_attention_fwd(q, k, v, **kw)[0]
                    dk, dv, _ = FA.flash_attention_bwd_dkv(*args, **kw)
                    err = max(float((a.float() - b.float()).abs().max())
                              for a, b in ((out, out_p), (dk, dk_p),
                                           (dv, dv_p)))
                    ok = all(torch.allclose(a.float(), b.float(), rtol=2e-2,
                                            atol=2e-2)
                             for a, b in ((out, out_p), (dk, dk_p),
                                          (dv, dv_p)))
                    if not ok:
                        raise SystemExit(f"tree differs from the plain "
                                         f"versions (max abs {err:.3e})")
                    record["max_abs_err"] = err
                record["k1_us"] = events_us(
                    lambda: FA.flash_attention_fwd(q, k, v, **kw))
                record["k2b_split_us"] = events_us(
                    lambda: FA.flash_attention_bwd_dkv(*args, **kw))
                print(json.dumps(record), flush=True)
    finally:
        FA._entry = entry
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
