"""Serving at head dims above 128 in the port, against the JAX package,
on the CPU: the tiny DALLE of tests/test_torch_engine.py and
tests/test_torch_sparse_reads.py (dim 32, depth 2, text 8, sequence 24)
split into 2 heads of 192, the width at which the card's K4 runs its
wide split body (``paged_attention.wide_split``) with its own split
size. The port's engine gives tokens identical to JAX's one-shot
``generate_images`` (bf16 and int8 caches alike go through the same
engine; here float32 and the int8 cache) with images within 1e-4, and,
with the sparse pattern, identical tokens to the JAX sparse-reads engine
with ``sparse_reads`` on and off. Plus the routes ``kernel_body`` names
and the split sizes the wrapper takes for each page dtype and head dim.

On the CPU the wrapper runs K4's plain version; the card tests
(tests/test_torch_kernels_cuda.py) hold the wide split body to it.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.serve import Request, RequestQueue, SamplingParams
from dalle_pytorch_tpu.serve.engine import Engine as JEngine
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import paged_attention as PA
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine
from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VAE_KW = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
              hidden_dim=8)
WIDE = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8, heads=2,
            dim_head=192)
SPARSE = dict(sparse_attn=(True, False), sparse_block=4)

REQS = [((3, 7, 9), 11, dict()),
        ((5, 2, 8, 1, 4), 23, dict(temperature=0.7, filter_thres=0.8)),
        ((6, 6), 5, dict(temperature=1.3, top_p=0.9))]


def cfgs(**kw):
    fields = {**WIDE, **kw}
    return (JD.DALLEConfig(vae=JV.VAEConfig(**VAE_KW), **fields),
            TD.DALLEConfig(vae=TV.VAEConfig(**VAE_KW), **fields))


@pytest.fixture(scope="module")
def bundle():
    """{name: (JAX config, port config, JAX params, port model)}, the
    dense and the sparse tiny DALLE at 2 heads of 192, and the VAE."""
    key = jax.random.PRNGKey(0)
    jcfg, _ = cfgs()
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1),
                                       jcfg.vae))
    out = {}
    for name, kw in (("dense", {}), ("sparse", SPARSE)):
        jc, tc = cfgs(**kw)
        params = jax.device_get(JD.dalle_init(key, jc, vae_p))
        out[name] = (jc, tc, params,
                     from_jax.dalle_from_jax(params, tc, device="cpu"))
    vae = from_jax.vae_from_jax(vae_p, out["dense"][1].vae, device="cpu")
    return out, vae_p, vae


def requests():
    return [S.Request(codes=c, seed=s, sampling=S.SamplingParams(**sp))
            for c, s, sp in REQS]


def port_run(model, vae=None, **kw):
    queue = S.RequestQueue(max_depth=8, max_prompt_len=WIDE["text_seq_len"])
    post = None if vae is None else PostProcessor(vae, model)
    engine = Engine(model, queue, num_slots=2, device="cpu", complete=post,
                    **kw)
    handles = [queue.submit(r) for r in requests()]
    engine.run_until_idle()
    results = [h.result(timeout=5) for h in handles]
    assert all(r.status == S.OK for r in results), results
    assert engine.alloc.in_use == 0
    return engine, results


@pytest.mark.parametrize("quantize_cache,chunk_steps,page_size",
                         [(False, 4, 8), (False, 8, 16), (True, 4, 8)])
def test_wide_engine_tokens_and_images_match_jax(bundle, quantize_cache,
                                                 chunk_steps, page_size):
    """The port's engine at 2 heads of 192 against JAX's one-shot
    sampler, request by request: identical image tokens, images within
    1e-4, every page freed."""
    models, vae_p, vae = bundle
    jcfg, tcfg, params, model = models["dense"]
    engine, results = port_run(model, vae, chunk_steps=chunk_steps,
                               page_size=page_size,
                               quantize_cache=quantize_cache)
    assert engine.pool["k"].shape[-1] == 192
    for (codes, seed, sp), res in zip(REQS, results):
        imgs, seq = JD.generate_images(
            params, vae_p, jnp.asarray([codes], jnp.int32), cfg=jcfg,
            rng=jax.random.PRNGKey(seed), quantize_cache=quantize_cache,
            return_img_seq=True, **sp)
        np.testing.assert_array_equal(res.tokens, np.asarray(seq)[0])
        np.testing.assert_allclose(res.image, np.asarray(imgs)[0],
                                   atol=1e-4, rtol=1e-4)


def test_wide_engine_tokens_match_jax_with_sparse_reads_on_and_off(bundle):
    """The sparse DALLE at 2 heads of 192 (K4's visible walk in the
    sparse layer, its prefix walk in the dense one) against the JAX
    sparse-reads engine (paged, gather reads): identical tokens with
    ``sparse_reads`` on and off."""
    models, _, _ = bundle
    jcfg, _, params, model = models["sparse"]
    queue = RequestQueue(max_depth=8)
    jengine = JEngine(params, jcfg, queue, num_slots=2, chunk_steps=4,
                      kv="paged", page_size=8, paged_attn="gather",
                      sparse_reads=True)
    handles = [queue.submit(Request(codes=c, seed=s,
                                    sampling=SamplingParams(**sp)))
               for c, s, sp in REQS]
    jengine.run_until_idle()
    want = [np.asarray(h.result(timeout=5).tokens) for h in handles]
    engine, on = port_run(model, chunk_steps=4, page_size=8,
                          sparse_reads=True)
    assert engine.stats()["sparse_reads"] is True
    _, off = port_run(model, chunk_steps=4, page_size=8)
    for a, b, w in zip(on, off, want):
        np.testing.assert_array_equal(a.tokens, w)
        np.testing.assert_array_equal(b.tokens, w)


# -- the wrapper's routes and split sizes -------------------------------------------

BODY_ROUTES = [
    (torch.bfloat16, 64, False, "paged_decode_kernel"),
    (torch.int8, 128, True, "paged_decode_visible_kernel"),
    (torch.bfloat16, 129, False, "paged_decode_wide_split_kernel"),
    (torch.bfloat16, 192, True, "paged_decode_visible_wide_split_kernel"),
    (torch.bfloat16, 256, False, "paged_decode_wide_split_kernel"),
    (torch.int8, 160, False, "paged_decode_wide_split_kernel"),
    (torch.int8, 256, True, "paged_decode_visible_wide_split_kernel"),
    (torch.float32, 192, False, "paged_decode_wide_kernel"),
    (torch.float32, 256, True, "paged_decode_wide_kernel"),
    (torch.bfloat16, 320, True, "paged_decode_wide_kernel"),
    (torch.int8, 320, False, "paged_decode_wide_kernel"),
]


@pytest.mark.parametrize("kv_dtype,dh,visible,name", BODY_ROUTES)
def test_kernel_body_routes_each_call(kv_dtype, dh, visible, name):
    """The kernel each call launches: the narrow walks up to dh 128, the
    wide split body for bf16 and int8 pages at dh 129-256 (with the
    shorter wide splits), the CUDA-core wide body for float32 pages
    above 128 and for any dh above 256 (the narrow split size)."""
    assert PA.kernel_body(kv_dtype, dh, visible) == name
    split = PA.wide_split(kv_dtype, dh)
    assert split == ("wide_split" in name)
    for ps in (8, 16):
        assert PA.pages_per_split(ps, split) \
            == (PA.WIDE_SPLIT_ROWS if split else PA.SPLIT_ROWS) // ps


def test_kernel_body_names_kernels_of_the_source():
    src = (Path(PA.__file__).parent.parent / "csrc"
           / "paged_attention.cu").read_text()
    defined = set(re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?"
                             r"\s+(\w+)\(", src))
    names = {name for *_, name in BODY_ROUTES}
    assert names <= defined, names - defined
    with pytest.raises(ValueError, match="no K4 body"):
        PA.kernel_body(torch.float16, 64)


def test_wide_split_fills_the_card_at_two_heads():
    """The reckoning behind ``WIDE_SPLIT_ROWS``: late in a serve step at
    2 heads of 256, 6 live slots near pos 1,100 (69 pages of 16 each)
    give more blocks than the H100's 132 SMs on the wide split size, and
    fewer than half of them on the narrow one."""
    pages, slots, heads = -(-1100 // 16), 6, 2

    def blocks(wide):
        return slots * heads * -(-pages // PA.pages_per_split(16, wide))
    assert blocks(True) > 132 > 2 * blocks(False)
