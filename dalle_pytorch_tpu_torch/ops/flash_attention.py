"""Exact causal + pad attention with an O(n)-memory forward and backward
(kernels K1, K2a and K2b).

Port of ``dalle_pytorch_tpu/ops/flash_attention.py``:

* ``flash_attention`` (``:634``) is a ``torch.autograd.Function``: the
  forward kernel K1 (``_fwd_kernel`` ``:88``) gives ``out`` and the f32
  row statistics ``m`` and ``l``, and the backward is chosen by
  ``bwd_impl`` as in JAX: ``'xla'`` runs ``blockwise_attention_bwd``
  (``:216``) in plain PyTorch, ``'pallas'`` launches K2a (dq,
  ``_bwd_dq_kernel`` ``:322``) then K2b in split mode (dk, dv,
  ``_bwd_keygrid_kernel`` ``:367`` as ``_bwd_dkv_kernel``), and
  ``'pallas_fused'`` launches K2b in fused mode (dq, dk and dv in one
  pass, ``_bwd_fused_kernel``);
* each kernel's wrapper launches the hand-written CUDA kernel
  (``csrc/flash_attention.cu``) on CUDA tensors and runs its plain
  PyTorch version only for tensors that lie on the CPU (the tests'
  path). There is no fallback: on the card the kernel launches or the
  call raises.

The masking contract, shared by every function here and by the kernels:

* pad pairs (``mask[i] & mask[j]`` False) score the finite
  ``FILL = -3.0e38``, so a fully padded query row averages uniformly
  over its causal prefix; ``ds`` is zeroed where the fill replaced the
  score (the forward's select blocks the gradient to q.k there);
* causal (``j > i``) and ragged (``j >= n``) pairs are left out: -inf;
* the running max starts at ``FILL`` and a zero ``l`` becomes 1;
* ``m`` and ``l`` are kept SEPARATELY, never as ``m + log(l)``: with
  ``m == FILL`` the log term would be absorbed (``:136-138``).

What bounds the kernels on the H100: operations. At the north training
shapes (b 8, h 8, n 1280, d 64, causal) K1 does ~13.4 GFLOP of tile
products against ~42 MB moved in bf16, above the ~295 flops per byte
where the tensor cores, not memory, set the limit; K2a and K2b do 1.5x
and 2x (2.5x fused) K1's products. In bfloat16, K1, K2a and K2b (split
and fused) run on the tensor cores (wgmma over asynchronously staged
bf16 tiles, ``csrc/wgmma.cuh``; above d 128 at d 192 and 256); float32
and the other wide calls run CUDA-core FMAs
(``csrc/flash_attention.cu`` says how). Like the Pallas bodies, every
version rounds p and ds to the input dtype before the second product of
each pair.

Head dims: any d >= 1, as the JAX kernels take. The narrow bodies are
compiled for d 64 and 128 (``KERNEL_DIM_HEADS``); above 128 the wide
bodies take any multiple of ``WIDE_DIM_MULTIPLE`` (64). In bfloat16 at d
192 and 256 (``WIDE_WGMMA_DIM_HEADS``), K1, K2a and K2b (split and
fused) run wide tensor-core bodies (``wide_tensor_cores`` chooses, the
wrappers tell the C entry points): K1 two warpgroups over a 2-tile K + V
ring; K2a two warpgroups over the same ring, one computing S and P, the
other dP and dS, each adding its share of dq's columns; K2b two
warpgroups, one computing dV and one dK over the whole d, the first also
adding dq in fused mode. Every other wide call (float32, d above 256)
runs a CUDA-core body in which a block owns a slice of at most 128
output columns and streams q.k and dout.v through 64-column chunks.
``kernel_body`` names
the kernel each call runs. Each wrapper runs any other d through
``any_dim_head``: q, k, v and dout zero-padded to the next of those
widths, the kernel launched, out, dq, dk and dv sliced back. That is
exact (zero columns add nothing to q.k or dout.v), and ``scale``, a
wrapper argument, still comes from the real d. A d the kernels take
runs with no copy.

``D = sum(dout * out)`` stays plain PyTorch, as in JAX (``:476-477``).
The kernels take their own tile (64 query rows by 64 key columns,
chosen for the H100's shared memory); ``block_q``/``block_k`` are the
JAX knobs, and only ``block_k`` changes anything here: the tile walk of
the plain blockwise backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from dalle_pytorch_tpu_torch.ops import build

FILL = -3.0e38
BWD_IMPLS = ("xla", "pallas", "pallas_fused")
# the head dims the narrow bodies are compiled for; above the widest of
# them the wide bodies take any multiple of WIDE_DIM_MULTIPLE (any other d
# runs zero-padded: any_dim_head)
KERNEL_DIM_HEADS = (64, 128)
NARROW_MAX_DIM_HEAD = KERNEL_DIM_HEADS[-1]
WIDE_DIM_MULTIPLE = 64
# the wide widths whose bfloat16 K1, K2a and K2b (split and fused) run on
# the tensor cores (wgmma's output width stops at 256)
WIDE_WGMMA_DIM_HEADS = (192, 256)
# K1, K2a, K2b split, K2b fused
KINDS = ("fwd", "dq", "dkv", "fused")
# dtype codes of the C entry points
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions (one-shot; what the kernels compute, up to summation order)
# ---------------------------------------------------------------------------

def _validate(q, k, v, mask, *extra):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (b, h, n, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, n, _ = q.shape
    if mask is not None and (mask.shape != (b, n)
                             or mask.dtype != torch.bool):
        raise ValueError(f"mask must be bool (b, n) = {(b, n)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for t in extra:
        if t.shape[:3] != q.shape[:3]:
            raise ValueError(f"{tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")


def _scores(q, k, *, scale, causal, mask):
    """f32 scores with the two fills, and ``live`` (None without a mask):
    False where the pad fill replaced the score."""
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    live = None
    if mask is not None:
        live = (mask[:, :, None] & mask[:, None, :])[:, None]
        s = torch.where(live, s, FILL)
    if causal:
        n = q.shape[2]
        future = torch.ones((n, n), dtype=torch.bool,
                            device=q.device).triu(1)
        s = s.masked_fill(future, float("-inf"))
    return s, live


def flash_attention_fwd_plain(q, k, v, *, scale: float, causal: bool,
                              mask: Optional[torch.Tensor] = None):
    """(out in q's dtype, m, l) with f32 ``m``/``l`` of shape (b, h, n)."""
    _validate(q, k, v, mask)
    s, _ = _scores(q, k, scale=scale, causal=causal, mask=mask)
    m = torch.clamp(s.amax(dim=-1), min=FILL)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l = torch.where(l == 0.0, 1.0, l)
    # the second product takes p in v's dtype, as the kernels and JAX do
    out = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(),
                       v.float()) / l[..., None]
    return out.to(q.dtype), m, l


def _probs_and_ds(q, k, v, dout, m, l, dstat, *, scale, causal, mask):
    s, live = _scores(q, k, scale=scale, causal=causal, mask=mask)
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    dp = torch.einsum("bhid,bhjd->bhij", dout.float(), v.float())
    ds = p * (dp - dstat[..., None]) * scale
    if live is not None:
        ds = torch.where(live, ds, 0.0)
    return p, ds


def flash_attention_bwd_dq_plain(q, k, v, dout, m, l, dstat, *,
                                 scale: float, causal: bool,
                                 mask: Optional[torch.Tensor] = None):
    """dq in q's dtype, from the forward's (m, l) and D = sum(dout*out)."""
    _validate(q, k, v, mask, dout, m, l, dstat)
    _, ds = _probs_and_ds(q, k, v, dout, m, l, dstat, scale=scale,
                          causal=causal, mask=mask)
    return torch.einsum("bhij,bhjd->bhid", ds.to(k.dtype).float(),
                        k.float()).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, dout, m, l, dstat, *,
                                  scale: float, causal: bool,
                                  mask: Optional[torch.Tensor] = None,
                                  with_dq: bool = False):
    """(dk, dv in k's/v's dtype, dq in f32 or None): the key-grid pass,
    with dq too in fused mode."""
    _validate(q, k, v, mask, dout, m, l, dstat)
    p, ds = _probs_and_ds(q, k, v, dout, m, l, dstat, scale=scale,
                          causal=causal, mask=mask)
    ds = ds.to(q.dtype).float()
    dv = torch.einsum("bhij,bhid->bhjd", p.to(dout.dtype).float(),
                      dout.float())
    dk = torch.einsum("bhij,bhid->bhjd", ds, q.float())
    dq = torch.einsum("bhij,bhjd->bhid", ds, k.float()) if with_dq else None
    return dk.to(k.dtype), dv.to(v.dtype), dq


def blockwise_attention_bwd(q, k, v, mask, dout, out, softmax_stats, *,
                            scale: float, block_k: int,
                            structural_mask_fn: Callable,
                            mask_queries: bool = True):
    """Flash backward as a loop over key tiles of ``block_k`` columns;
    never materialises (n, n). ``softmax_stats`` is the forward's (m, l).
    ``structural_mask_fn(rows, cols) -> (n, BK) bool or None`` gives the
    -inf structural mask (causal and/or a sparsity layout); the pad
    ``mask`` (b, n) applies with ``FILL`` to key columns, and to query
    rows when ``mask_queries``. Products take the input dtype's values
    with f32 accumulation, as ``preferred_element_type=f32`` does; the
    probability and ds chain stays f32. A ragged last tile is simply
    shorter (JAX pads it and masks the pad keys, which is the same)."""
    m_stat, l_stat = softmax_stats
    b, h, n, d = q.shape
    cdt = q.dtype
    qf, doutf = q.float(), dout.to(cdt).float()
    inv_l = (1.0 / l_stat)[..., None]
    dstat = (dout.float() * out.float()).sum(dim=-1)[..., None]
    rows = torch.arange(n, device=q.device)
    dq = torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j0 in range(0, n, block_k):
        j1 = min(j0 + block_k, n)
        ks, vs = k[:, :, j0:j1].float(), v[:, :, j0:j1].float()
        cols = torch.arange(j0, j1, device=q.device)
        s = torch.einsum("bhid,bhjd->bhij", qf, ks) * scale
        live = None
        if mask is not None:
            pad_ok = mask[:, None, j0:j1]
            if mask_queries:
                pad_ok = pad_ok & mask[:, :, None]
            live = pad_ok[:, None]
            s = torch.where(live, s, FILL)
        struct = structural_mask_fn(rows, cols)
        if struct is not None:
            s = torch.where(struct, s, float("-inf"))
        p = torch.exp(s - m_stat[..., None]) * inv_l
        dvs.append(torch.einsum("bhij,bhid->bhjd", p.to(cdt).float(),
                                doutf))
        dp = torch.einsum("bhid,bhjd->bhij", doutf, vs)
        ds = p * (dp - dstat) * scale
        if live is not None:
            ds = torch.where(live, ds, 0.0)
        ds_c = ds.to(cdt).float()
        dks.append(torch.einsum("bhij,bhid->bhjd", ds_c, qf))
        dq = dq + torch.einsum("bhij,bhjd->bhid", ds_c, ks)
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# head dims: any d >= 1 on the kernels' widths
# ---------------------------------------------------------------------------

def kernel_dim_head(d: int) -> int:
    """The width the kernels run a d-wide head at: up to 128 the next of
    ``KERNEL_DIM_HEADS`` (the narrow bodies), above it the next multiple
    of ``WIDE_DIM_MULTIPLE`` (the wide bodies). Raises ``ValueError`` for
    a d below 1."""
    if d < 1:
        raise ValueError(f"dim_head {d}: the kernels take any dim_head of "
                         f"1 or more")
    if d > NARROW_MAX_DIM_HEAD:
        return -(-d // WIDE_DIM_MULTIPLE) * WIDE_DIM_MULTIPLE
    return next(w for w in KERNEL_DIM_HEADS if d <= w)


def wide_tensor_cores(dtype: torch.dtype, d: int) -> bool:
    """Whether a CUDA call on ``dtype`` tensors at the kernel width ``d``
    runs a wide tensor-core body: bfloat16 at ``WIDE_WGMMA_DIM_HEADS``,
    for every kernel that has one (K1, K2a, K2b split and fused, and
    ``block_sparse.py``'s K3). The wrappers pass it to the C entry points
    (``wide_wgmma``), which run the CUDA-core wide bodies where it is
    false."""
    return dtype == torch.bfloat16 and d in WIDE_WGMMA_DIM_HEADS


def kernel_body(kind: str, dtype: torch.dtype, d: int) -> str:
    """The ``__global__`` function of ``csrc/flash_attention.cu`` that a
    CUDA call of ``kind`` (``KINDS``: K1, K2a, K2b split, K2b fused) on
    ``dtype`` tensors of head dim ``d`` launches, at the width it runs
    at (``kernel_dim_head``). ``chip_smoke.py`` holds it against the
    kernels' names in its profiles."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}, not one of {KINDS}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernels take float32 or bfloat16, not "
                         f"{dtype}")
    width = kernel_dim_head(d)
    stem = {"fwd": "flash_fwd", "dq": "flash_bwd_dq"}.get(kind,
                                                          "flash_bwd_dkv")
    # the fused mode's tensor-core bodies have their own names; on the
    # CUDA cores it is a mode of K2b's body
    tc_stem = "flash_bwd_fused" if kind == "fused" else stem
    if width <= NARROW_MAX_DIM_HEAD:
        if dtype == torch.bfloat16:
            return f"{tc_stem}_wgmma_kernel"
        return f"{stem}_kernel"
    if wide_tensor_cores(dtype, width):
        return f"{tc_stem}_wide_wgmma_kernel"
    return f"{stem}_wide_kernel"


def at_kernel_dim_head(fn: Callable, q: torch.Tensor, *args, **kw):
    """``fn(q, *args, **kw)`` at ``kernel_dim_head(d)``: every 4-D tensor
    argument (q, k, v, dout) zero-padded along its last axis, every 4-D
    tensor result (out, dq, dk, dv) sliced back to d; m, l, D and the
    mask pass as they are. Exact, since the zero columns add nothing to
    q.k or dout.v and the results' padded columns are zero. ``scale``
    must come from the caller: from the real d, never the padded one.
    At a width the kernels take it is ``fn(q, *args, **kw)`` on the
    tensors given."""
    d = q.shape[-1]
    width = kernel_dim_head(d)
    if width == d:
        return fn(q, *args, **kw)

    def pad(t):
        if isinstance(t, torch.Tensor) and t.dim() == 4:
            return torch.nn.functional.pad(t, (0, width - d))
        return t

    def cut(t):
        if isinstance(t, torch.Tensor) and t.dim() == 4:
            return t[..., :d].contiguous()
        return t

    res = fn(pad(q), *(pad(a) for a in args), **kw)
    return tuple(cut(t) for t in res) if isinstance(res, tuple) else cut(res)


def any_dim_head(wrapper: Callable) -> Callable:
    """Lets a kernel wrapper take any d >= 1 on the card: a CUDA call at
    a width the kernels do not take runs through ``at_kernel_dim_head``;
    CPU calls and the kernels' own widths reach ``wrapper`` as they are.
    Its first argument is q."""

    @functools.wraps(wrapper)
    def run(q, *args, **kw):
        if q.device.type == "cuda" and \
                kernel_dim_head(q.shape[-1]) != q.shape[-1]:
            return at_kernel_dim_head(run, q, *args, **kw)
        return wrapper(q, *args, **kw)

    return run


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_attention_fwd": [_P] * 7 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "flash_attention_bwd_dq": [_P] * 9 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "flash_attention_bwd_dkv": [_P] * 11 + [_I] * 4 + [_F, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(build.load("flash_attention"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _kernel_args(fn_name, q, k, v, mask, dout=None, stats=()):
    """Check what the CUDA kernels take; returns (dtype code, mask
    pointer or None). Raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn_name} runs on cuda or cpu tensors, got "
                         f"{q.device}")
    code = _DTYPE_CODE.get(q.dtype)
    same = [k, v] + ([] if dout is None else [dout])
    if code is None or any(t.dtype != q.dtype for t in same):
        raise ValueError(f"{fn_name}: q, k, v (and dout) must all be "
                         f"float32 or all bfloat16, got "
                         f"{[str(t.dtype) for t in [q] + same]}")
    if any(t.dtype != torch.float32 for t in stats):
        raise ValueError(f"{fn_name}: m, l and D must be float32")
    if q.shape[-1] < 1 or kernel_dim_head(q.shape[-1]) != q.shape[-1]:
        raise ValueError(f"{fn_name}: dim_head {q.shape[-1]} is not one of "
                         f"the kernel's widths ({KERNEL_DIM_HEADS}, or a "
                         f"multiple of {WIDE_DIM_MULTIPLE} above "
                         f"{NARROW_MAX_DIM_HEAD}; the wrappers pad other "
                         f"widths: any_dim_head)")
    tensors = [q, *same, *stats] + ([] if mask is None else [mask])
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{fn_name}: every input must lie on q's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn_name}: every input must be contiguous")
    if any(t.data_ptr() % 16 for t in [q, *same]):
        raise ValueError(f"{fn_name}: q, k, v (and dout) must start on a "
                         f"16-byte boundary (the kernels copy 16 bytes at a "
                         f"time)")
    return code, (None if mask is None else mask.data_ptr())


def _check_rc(fn_name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed with CUDA "
                           f"error {rc}")


@any_dim_head
def flash_attention_fwd(q, k, v, *, scale: float, causal: bool,
                        mask: Optional[torch.Tensor] = None):
    """K1: (out, m, l). The CUDA kernel for CUDA tensors (any d,
    ``any_dim_head``), the plain version for CPU tensors.
    Counts launches in ``flash_attention_fwd.launches``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale=scale,
                                         causal=causal, mask=mask)
    _validate(q, k, v, mask)
    code, mask_ptr = _kernel_args("flash_attention_fwd", q, k, v, mask)
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    m = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
        out.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, n, d,
        float(scale), int(causal), code,
        int(wide_tensor_cores(q.dtype, d)), stream)
    _check_rc("flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return out, m, l


@any_dim_head
def flash_attention_bwd_dq(q, k, v, dout, m, l, dstat, *, scale: float,
                           causal: bool,
                           mask: Optional[torch.Tensor] = None):
    """K2a: dq in q's dtype. The CUDA kernel for CUDA tensors (any d,
    ``any_dim_head``), the plain version for CPU tensors.
    Counts ``flash_attention_bwd_dq.launches``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, dout, m, l, dstat,
                                            scale=scale, causal=causal,
                                            mask=mask)
    _validate(q, k, v, mask, dout, m, l, dstat)
    code, mask_ptr = _kernel_args("flash_attention_bwd_dq", q, k, v, mask,
                                  dout, (m, l, dstat))
    b, h, n, d = q.shape
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry("flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), dstat.data_ptr(), mask_ptr,
        dq.data_ptr(), b, h, n, d, float(scale), int(causal), code,
        int(wide_tensor_cores(q.dtype, d)), stream)
    _check_rc("flash_attention_bwd_dq", rc)
    flash_attention_bwd_dq.launches += 1
    return dq


@any_dim_head
def flash_attention_bwd_dkv(q, k, v, dout, m, l, dstat, *, scale: float,
                            causal: bool,
                            mask: Optional[torch.Tensor] = None,
                            with_dq: bool = False):
    """K2b: (dk, dv, dq f32 or None). Split mode (``with_dq=False``) or
    fused mode, where every key-tile block adds its share of dq into one
    f32 buffer by atomic reductions — so the fused dq's summation order
    changes from run to run. The CUDA kernel for CUDA tensors (any d,
    ``any_dim_head``), the plain version for CPU tensors.
    Counts ``flash_attention_bwd_dkv.launches``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, dout, m, l, dstat,
                                             scale=scale, causal=causal,
                                             mask=mask, with_dq=with_dq)
    _validate(q, k, v, mask, dout, m, l, dstat)
    code, mask_ptr = _kernel_args("flash_attention_bwd_dkv", q, k, v, mask,
                                  dout, (m, l, dstat))
    b, h, n, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dq = (torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
          if with_dq else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _entry("flash_attention_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), dstat.data_ptr(), mask_ptr,
        dk.data_ptr(), dv.data_ptr(), None if dq is None else dq.data_ptr(),
        b, h, n, d, float(scale), int(causal), code,
        int(wide_tensor_cores(q.dtype, d)), stream)
    _check_rc("flash_attention_bwd_dkv", rc)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv, dq


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# autograd plumbing + public entry
# ---------------------------------------------------------------------------

def _causal_structure(causal: bool):
    def structural(rows, cols):
        if not causal:
            return None
        return cols[None, :] <= rows[:, None]
    return structural


class _Flash(torch.autograd.Function):
    """K1 forward; the backward ``bwd_impl`` selects (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal, block_k, bwd_impl):
        out, m, l = flash_attention_fwd(q, k, v, scale=scale,
                                        causal=causal, mask=mask)
        ctx.save_for_backward(q, k, v, mask, out, m, l)
        ctx.opts = (scale, causal, block_k, bwd_impl)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, m, l = ctx.saved_tensors
        scale, causal, block_k, bwd_impl = ctx.opts
        dout = dout.contiguous()
        if bwd_impl == "xla":
            dq, dk, dv = blockwise_attention_bwd(
                q, k, v, mask, dout, out, (m, l), scale=scale,
                block_k=min(block_k, q.shape[2]),
                structural_mask_fn=_causal_structure(causal))
            return dq, dk, dv, None, None, None, None, None
        dstat = (dout.float() * out.float()).sum(dim=-1)
        kw = dict(scale=scale, causal=causal, mask=mask)
        if bwd_impl == "pallas":
            dq = flash_attention_bwd_dq(q, k, v, dout, m, l, dstat, **kw)
            dk, dv, _ = flash_attention_bwd_dkv(q, k, v, dout, m, l, dstat,
                                                **kw)
        else:
            dk, dv, dq32 = flash_attention_bwd_dkv(
                q, k, v, dout, m, l, dstat, with_dq=True, **kw)
            dq = dq32.to(q.dtype)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    mask: Optional[torch.Tensor] = None, block_q: int = 128,
                    block_k: int = 128,
                    bwd_impl: str = "xla") -> torch.Tensor:
    """Exact attention, differentiable. q/k/v: (b, h, n, d), contiguous
    on the card; mask: (b, n) bool, True = keep. ``block_q`` is accepted
    for the JAX signature (the kernels use their own tile);
    ``block_k`` sets the plain blockwise backward's key tile."""
    del block_q
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, mask, float(scale), bool(causal),
                        int(block_k), bwd_impl)
