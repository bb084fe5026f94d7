"""The port's serving engine end to end on the CPU, against the JAX
package: the same weights (through the bridge), prompts, seeds and
sampling knobs give IDENTICAL image tokens to the JAX one-shot sampler
``generate_images`` — which tests/test_paged_attention.py holds equal to
the JAX ``Engine(kv='paged', paged_attn='kernel')`` — and images
allclose at 1e-4. Plus the engine's page and request lifecycle, and the
scheduler it pulls from."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine, PoolTooSmall
from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
JCFG = JD.DALLEConfig(dim=32, depth=2, vae=JVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
TCFG = TD.DALLEConfig(dim=32, depth=2, vae=TVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)

REQS = [
    S.Request(codes=(3, 7, 9), seed=11),
    S.Request(codes=(5, 2, 8, 1, 4), seed=23,
              sampling=S.SamplingParams(temperature=0.7, filter_thres=0.8)),
    S.Request(codes=(6, 6), seed=5,
              sampling=S.SamplingParams(temperature=1.3, top_p=0.9)),
]


@pytest.fixture(scope="module")
def bundle():
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    model = from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")
    vae = from_jax.vae_from_jax(vae_p, TVCFG, device="cpu")
    return dal_p, vae_p, model, vae


_REF: dict = {}


def reference(bundle, req, quantize_cache=False):
    """Memoized JAX generate_images at batch 1: (image tokens, image)."""
    dal_p, vae_p, _, _ = bundle
    key = (req.codes, req.seed, req.sampling, quantize_cache)
    if key not in _REF:
        imgs, seq = JD.generate_images(
            dal_p, vae_p, jnp.asarray([req.codes], jnp.int32), cfg=JCFG,
            rng=jax.random.PRNGKey(req.seed),
            filter_thres=req.sampling.filter_thres,
            top_p=req.sampling.top_p,
            temperature=req.sampling.temperature,
            quantize_cache=quantize_cache, return_img_seq=True)
        _REF[key] = (np.asarray(seq)[0], np.asarray(imgs)[0])
    return _REF[key]


def run(bundle, reqs, **kw):
    _, _, model, vae = bundle
    queue = S.RequestQueue(max_depth=16, max_prompt_len=TCFG.text_seq_len)
    post = PostProcessor(vae, model)
    engine = Engine(model, queue, complete=post, device="cpu", **kw)
    handles = [queue.submit(r) for r in reqs]
    engine.run_until_idle()
    return engine, [h.result(timeout=5) for h in handles]


@pytest.mark.parametrize("chunk_steps,page_size", [(1, 8), (8, 8),
                                                   (4, 16)])
def test_tokens_and_images_match_jax(bundle, chunk_steps, page_size):
    """3 requests over 2 slots (slot reuse, mixed prompt lengths, top-k,
    temperatures, nucleus; slots finish mid-chunk at K=8): identical
    tokens, images allclose 1e-4, every page back in the pool, one ring
    read per chunk."""
    engine, results = run(bundle, REQS, num_slots=2,
                          chunk_steps=chunk_steps, page_size=page_size)
    for req, res in zip(REQS, results):
        tokens, image = reference(bundle, req)
        assert res.status == S.OK, res.reason
        np.testing.assert_array_equal(res.tokens, tokens)
        assert list(res.text_tokens[:len(req.codes)]) == list(req.codes)
        np.testing.assert_allclose(res.image, image, atol=1e-4, rtol=1e-4)
    assert engine.alloc.in_use == 0
    assert engine.harvests * chunk_steps == engine.decode_steps
    assert engine.completed == 3 and engine.active_slots() == 0


def test_int8_kv_tokens_match_jax(bundle):
    engine, results = run(bundle, REQS[:1], num_slots=2, page_size=8,
                          quantize_cache=True)
    tokens, _ = reference(bundle, REQS[0], quantize_cache=True)
    np.testing.assert_array_equal(results[0].tokens, tokens)
    assert engine.pool["k"].dtype == torch.int8


def test_replay_is_deterministic_and_slot_order_free(bundle):
    """The same request alone, or behind others in another slot, gives
    the same tokens (a token is a function of (logits, fold_in(key,
    pos)) only)."""
    _, alone = run(bundle, [REQS[2]], num_slots=1, page_size=8)
    _, crowd = run(bundle, REQS[::-1], num_slots=3, page_size=8,
                   chunk_steps=3)
    np.testing.assert_array_equal(alone[0].tokens, crowd[0].tokens)


def test_engine_without_device_raises_when_cuda_is_absent(bundle):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is the card")
    _, _, model, _ = bundle
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, S.RequestQueue())


def test_undersized_pool_is_a_typed_error_naming_eviction(bundle):
    _, _, model, _ = bundle
    with pytest.raises(PoolTooSmall, match="eviction"):
        Engine(model, S.RequestQueue(), num_slots=2, page_size=8,
               num_pages=4, device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        Engine(model, S.RequestQueue(), page_size=4, device="cpu")


def test_invalid_and_expired_requests_get_typed_results(bundle):
    _, _, model, _ = bundle
    now = [0.0]
    queue = S.RequestQueue(clock=lambda: now[0])
    engine = Engine(model, queue, num_slots=1, page_size=8, device="cpu",
                    clock=lambda: now[0])
    late = queue.submit(S.Request(codes=(1,), deadline_s=0.5))
    long_prompt = queue.submit(S.Request(codes=tuple(range(1, 10))))
    now[0] = 1.0
    engine.run_until_idle()
    assert late.result(0).status == S.DEADLINE_EXCEEDED
    assert long_prompt.result(0).status == S.ERROR
    assert engine.alloc.in_use == 0


# -- scheduler ------------------------------------------------------------------

def test_buckets_and_grouping():
    assert S.prefill_buckets(256) == (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert S.prefill_buckets(24) == (1, 2, 4, 8, 16, 24)
    assert S.bucket_for(17, S.prefill_buckets(256)) == 32
    with pytest.raises(ValueError):
        S.bucket_for(300, S.prefill_buckets(256))
    q = S.RequestQueue()
    hs = [q.submit(S.Request(codes=(1,) * n)) for n in (1, 17, 3, 20, 1)]
    groups = S.group_by_bucket(hs, S.prefill_buckets(256))
    assert {b: [h.request.request_id for h in g]
            for b, g in groups.items()} == {1: [0, 4], 32: [1, 3], 4: [2]}


def test_queue_order_backpressure_and_requeue():
    q = S.RequestQueue(max_depth=3, max_prompt_len=8)
    with pytest.raises(S.InvalidRequest):
        q.submit(S.Request(codes=()))
    with pytest.raises(S.InvalidRequest):
        q.submit(S.Request(codes=(1,) * 9))
    a = q.submit(S.Request(codes=(1,), priority=1))
    b = q.submit(S.Request(codes=(1,), priority=0))
    c = q.submit(S.Request(codes=(1,), priority=1))
    with pytest.raises(S.QueueFull):
        q.submit(S.Request(codes=(1,)))
    ready, expired = q.pop_ready(2)
    assert ready == [b, a] and expired == []
    q.requeue(a)
    q.requeue(a)                                 # no double entry
    assert q.pop_ready(5)[0] == [a, c]
    assert a.fulfill(S.Result(status=S.OK, request_id=0))
    assert not a.fulfill(S.Result(status=S.ERROR, request_id=0))
    assert a.result(0).ok
