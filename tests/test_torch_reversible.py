"""The reversible DALLE (``ops/reversible.py``, ``reversible=True``)
against the JAX package on the CPU, at the tiny ``bench.py::build_cfg(
tiny=True)`` widths (dim 32, depth 2, 2 heads of 16, text 8 + image 16
tokens), the weights bridged by ``compat/from_jax.py``.

Training: the eval logits and loss (the mean of the two streams); the
train-mode loss and the gradient of every parameter under dropout 0.1
(the backward replays each layer's dropout keys while it inverts the
layers) for attention 'xla' and flash with the 'pallas' and
'pallas_fused' backwards (JAX's Pallas kernels in interpret mode, the
port's plain versions); a block-sparse pattern; ``torch.autograd.grad``
and ``accumulate_grads`` against JAX's two-microbatch step; and the
memory contract: the tensors the step saves for its backward do not
grow with depth (JAX ``tests/test_reversible.py:132``).

Decoding: ``prefill`` and ``decode_step`` (the two-stream form, K/V
from x2), the paged and sparse-reads steps, ``generate_images`` and the
serving engine give JAX's hidden states and identical tokens for a
fixed key.

float32. Tolerances: losses, logits and hidden states rtol/atol 1e-5;
gradients rtol 1e-4 / atol 2e-5, as ``test_torch_train`` (the inversion
x2 = y2 - g(y1) rounds as JAX's does; the f32 sums run in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.cli import common as JCOM
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.ops import decode as JDEC
from dalle_pytorch_tpu.parallel import train as JP
from dalle_pytorch_tpu_torch.cli import common as TCOM
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import decode as TDEC
from dalle_pytorch_tpu_torch.ops import prng
from dalle_pytorch_tpu_torch.ops import transformer as TT
from dalle_pytorch_tpu_torch.parallel import train as TP
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.serve.engine import Engine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
VAE_KW = dict(image_size=16, num_tokens=32, codebook_dim=32, num_layers=2,
              hidden_dim=8)
DALLE_KW = dict(dim=32, depth=2, num_text_tokens=64, text_seq_len=8,
                heads=2, dim_head=16, reversible=True)
B = 4
L = 24                                     # text 8 + image 16


def cfgs(**kw):
    fields = {**DALLE_KW, **kw}
    return (JD.DALLEConfig(vae=JV.VAEConfig(**VAE_KW), **fields),
            TD.DALLEConfig(vae=TV.VAEConfig(**VAE_KW), **fields))


@pytest.fixture(scope="module")
def trees():
    key = jax.random.PRNGKey(0)
    jcfg, _ = cfgs()
    vae = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), jcfg.vae))
    return jax.device_get(JD.dalle_init(key, jcfg, vae)), vae


@pytest.fixture(scope="module")
def batch_np():
    rs = np.random.RandomState(3)
    mask = np.ones((B, 8), bool)
    mask[1, 5:] = False                    # padded text tails
    mask[2, 2:] = False
    return {"text": rs.randint(1, 64, (B, 8)).astype(np.int32),
            "mask": mask,
            "image": rs.randint(0, 32, (B, 16)).astype(np.int32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.tensor(v).long() if v.dtype == np.int32
            else torch.tensor(v) for k, v in b.items()}


def port(trees, tcfg):
    return from_jax.dalle_from_jax(trees[0], tcfg, device="cpu")


def assert_grads_match(model, jgrads, tcfg):
    want = dict(from_jax.dalle_from_jax(jax.device_get(jgrads), tcfg,
                                        device="cpu").named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **GRAD_TOL)
    assert len(want) > 20


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_eval_logits_and_loss_match_jax(trees, batch_np, attn_impl):
    jcfg, tcfg = cfgs(attn_impl=attn_impl)
    model = port(trees, tcfg)
    jb, tb = jbatch(batch_np), tbatch(batch_np)
    for return_loss in (False, True):
        want = JD.dalle_apply(trees[0], jb["text"], jb["image"], cfg=jcfg,
                              mask=jb["mask"], return_loss=return_loss)
        with torch.no_grad():
            got = TD.dalle_apply(model, tb["text"], tb["image"],
                                 mask=tb["mask"], return_loss=return_loss)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the streams' mean is not the sequential stack of the same weights
    _, seq = cfgs(attn_impl=attn_impl, reversible=False)
    with torch.no_grad():
        other = TD.dalle_apply(port(trees, seq), tb["text"], tb["image"],
                               mask=tb["mask"], return_loss=True)
    assert abs(float(other) - float(want)) > 1e-3


@pytest.mark.parametrize("attn_impl,bwd_impl", [
    ("xla", "xla"), ("flash", "pallas"), ("flash", "pallas_fused")])
def test_train_loss_and_every_gradient_match_jax(trees, batch_np, attn_impl,
                                                 bwd_impl):
    """Dropout 0.1 in both branches: the backward's recompute replays
    each layer's keys, so the inverted streams and every gradient are
    JAX's; two keys give different losses."""
    jcfg, tcfg = cfgs(attn_impl=attn_impl, attn_bwd_impl=bwd_impl,
                      attn_dropout=0.1, ff_dropout=0.1, loss_chunk=10)
    model = port(trees, tcfg)
    jloss, jgrads = jax.value_and_grad(JP.dalle_loss_fn(jcfg))(
        trees[0], jbatch(batch_np), jax.random.PRNGKey(5))
    loss = TP.dalle_loss_fn()(model, tbatch(batch_np), prng.prng_key(5))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert_grads_match(model, jgrads, tcfg)
    with torch.no_grad():
        other = TP.dalle_loss_fn()(model, tbatch(batch_np), prng.prng_key(6))
    assert abs(float(other) - float(loss.detach())) > 5e-5


@pytest.mark.parametrize("sparse_impl", ["ref", "pallas"])
def test_sparse_pattern_gradients_match_jax(batch_np, sparse_impl):
    """A block-sparse layer then a dense one (``sparse_attn=(True,
    False)``, block 4 so the layout bites at 24 tokens): the layers go by
    their per-layer bool in the forward and in the inverting backward."""
    kw = dict(sparse_attn=(True, False), sparse_block=4,
              sparse_impl=sparse_impl, attn_dropout=0.1, ff_dropout=0.1)
    jcfg, tcfg = cfgs(**kw)
    key = jax.random.PRNGKey(0)
    dalle = jax.device_get(JD.dalle_init(key, jcfg))
    model = from_jax.dalle_from_jax(dalle, tcfg, device="cpu")
    jloss, jgrads = jax.value_and_grad(JP.dalle_loss_fn(jcfg))(
        dalle, jbatch(batch_np), jax.random.PRNGKey(7))
    loss = TP.dalle_loss_fn()(model, tbatch(batch_np), prng.prng_key(7))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert_grads_match(model, jgrads, tcfg)


def test_autograd_grad_and_accumulate_grads(trees, batch_np):
    """``torch.autograd.grad(loss, params)`` returns the gradients
    ``backward`` leaves, and ``grad_accum=2`` through ``make_train_step``
    lands on JAX's parameters after one Adam step."""
    jcfg, tcfg = cfgs(attn_dropout=0.1, ff_dropout=0.1)
    model = port(trees, tcfg)
    params = list(model.parameters())
    loss = TP.dalle_loss_fn()(model, tbatch(batch_np), prng.prng_key(2))
    grads = torch.autograd.grad(loss, params)
    loss = TP.dalle_loss_fn()(model, tbatch(batch_np), prng.prng_key(2))
    loss.backward()
    for g, p in zip(grads, params):
        torch.testing.assert_close(g, p.grad, rtol=0, atol=0)
    model.zero_grad(set_to_none=True)

    import types
    args = types.SimpleNamespace(lr=3e-3, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)
    jopt = JCOM.make_optimizer(args)
    jstep = JP.make_train_step(JP.dalle_loss_fn(jcfg), jopt, grad_accum=2)
    jparams, _, jloss = jstep(trees[0], jopt.init(trees[0]),
                              jbatch(batch_np), jax.random.PRNGKey(4))
    tstep = TP.make_train_step(TP.dalle_loss_fn(),
                               TCOM.make_optimizer(args, model.parameters()),
                               grad_accum=2)
    tloss = tstep(model, tbatch(batch_np), prng.prng_key(4))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = dict(from_jax.dalle_from_jax(jax.device_get(jparams), tcfg,
                                        device="cpu").named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), atol=2e-5,
                                   err_msg=name)


def saved_count(depth: int, reversible: bool) -> int:
    """Tensors the stack saves for its backward at ``depth``, counted by
    ``saved_tensors_hooks`` around one train-mode ``transformer_apply``."""
    cfg = TT.TransformerConfig(dim=16, depth=depth, seq_len=6, heads=2,
                               dim_head=8, reversible=reversible,
                               attn_dropout=0.1, ff_dropout=0.1)
    model = TT.Transformer(cfg)
    x = torch.randn(2, 6, 16, requires_grad=True)
    n = [0]

    def pack(t):
        n[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = TT.transformer_apply(model, x, cfg=cfg,
                                   rng=prng.prng_key(0), train=True)
    out.sum().backward()
    assert x.grad is not None
    return n[0]


def test_saved_tensors_do_not_grow_with_depth():
    rev = [saved_count(d, True) for d in (1, 2, 6)]
    assert rev[0] == rev[1] == rev[2] <= 4, rev
    seq = [saved_count(d, False) for d in (1, 2)]
    assert seq[1] > seq[0] > rev[0]


# -- decoding -----------------------------------------------------------------

@torch.no_grad()
def test_prefill_and_decode_steps_match_jax(trees):
    """The two-stream prefill into the dense cache (K/V from x2) with a
    pad mask, then three ``decode_step``s: h_out and the cache."""
    jcfg, tcfg = cfgs()
    model = port(trees, tcfg)
    params = trees[0]
    text = np.random.RandomState(1).randint(1, 64, (2, 5))
    mask = np.ones((2, 5), bool)
    mask[0, :2] = False
    jx = JD.embed_prompt(params, jcfg, jnp.asarray(text))
    jh, jcache = JDEC.prefill(params["transformer"], jx,
                              cfg=jcfg.transformer, total_len=L,
                              prompt_mask=jnp.asarray(mask))
    th, tcache = TDEC.prefill(model.transformer,
                              TD.embed_prompt(model, torch.tensor(text)),
                              cfg=tcfg.transformer, total_len=L,
                              prompt_mask=torch.tensor(mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    jkm = JDEC._full_key_mask(jnp.asarray(mask), 2, 5, L)
    tkm = TDEC._full_key_mask(torch.tensor(mask), 2, 5, L)
    tok = np.random.RandomState(2).randint(0, 64, (3, 2))
    for step, pos in enumerate((5, 6, 7)):
        jh, jcache = JDEC.decode_step(
            params["transformer"],
            JD.decode_token_embed(params, jcfg, jnp.asarray(tok[step]),
                                  jnp.full((2,), pos)),
            pos, jcache, cfg=jcfg.transformer, key_mask=jkm)
        th = TDEC.decode_step(
            model.transformer,
            TD.decode_token_embed(model, torch.tensor(tok[step]),
                                  torch.full((2,), pos)),
            pos, tcache, cfg=tcfg.transformer, key_mask=tkm)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for name, buf in tcache.items():
        np.testing.assert_allclose(buf.numpy(), np.asarray(jcache[name]),
                                   **TOL)


@torch.no_grad()
@pytest.mark.parametrize("pattern", [False, (True, False)])
def test_paged_and_sparse_reads_steps_match_jax(pattern):
    """One step at ragged positions over a random page pool: the port's
    kernel and gather steps (and with a sparse pattern its sparse-reads
    steps) against JAX's gather step: h_out and every layer's K/V."""
    jcfg, tcfg = cfgs(sparse_attn=pattern, sparse_block=8)
    params = jax.device_get(JD.dalle_init(jax.random.PRNGKey(0), jcfg))
    model = from_jax.dalle_from_jax(params, tcfg, device="cpu")
    ps, mp = 8, L // 8
    rs = np.random.RandomState(7)
    shape = (2, 3 * mp + 1, 2, ps, 16)
    pool_np = {"k": rs.randn(*shape).astype(np.float32),
               "v": rs.randn(*shape).astype(np.float32)}
    bt = np.zeros((3, mp), np.int32)
    for i in range(3):
        bt[i] = np.arange(1 + i * mp, 1 + (i + 1) * mp)
    pos = np.array([L - 1, 13, 0], np.int32)
    key_mask = np.ones((3, L), bool)
    key_mask[1, 1] = False
    x = rs.randn(3, 32).astype(np.float32)
    jpool = {k: jnp.asarray(v) for k, v in pool_np.items()}
    if not pattern:                 # the dense steps read a dense view
        jpool = JDEC.paged_view(jpool, jnp.asarray(bt), L)
    jh, jks, jvs = JDEC._decode_step_math(
        params["transformer"], jnp.asarray(x), jnp.asarray(pos), jpool,
        attn_impl="gather", block_tables=jnp.asarray(bt),
        cfg=jcfg.transformer, key_mask=jnp.asarray(key_mask),
        sparse_reads=bool(pattern))
    pool = {k: torch.tensor(v) for k, v in pool_np.items()}
    tbt = torch.tensor(bt)
    tkw = dict(cfg=tcfg.transformer, key_mask=torch.tensor(key_mask))
    args = (model.transformer, torch.tensor(x), torch.tensor(pos))
    runs = {"kernel": TDEC._decode_step_math(*args, pool, block_tables=tbt,
                                             **tkw),
            "gather": TDEC._decode_step_math(
                *args, TDEC.paged_view(pool, tbt, L), attn_impl="gather",
                **tkw)}
    if pattern:
        runs["sparse_reads"] = TDEC._decode_step_math(
            *args, pool, block_tables=tbt, sparse_reads=True, **tkw)
    for what, (h, ks, vs) in runs.items():
        for g, w, name in ((h, jh, "h"), (ks, jks, "k"), (vs, jvs, "v")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f"{what} {name}")


def test_generate_and_engine_tokens_identical_to_jax(trees):
    """``generate_images`` for two prompts, and the serving engine for
    one request, give JAX's ``generate_images`` tokens for the key."""
    jcfg, tcfg = cfgs()
    dalle, vae = trees
    model = port(trees, tcfg)
    tvae = from_jax.vae_from_jax(vae, tcfg.vae, device="cpu")
    text = np.random.RandomState(0).randint(1, 64, (2, 8))
    _, jseq = JD.generate_images(dalle, vae, jnp.asarray(text), cfg=jcfg,
                                 rng=jax.random.PRNGKey(3),
                                 return_img_seq=True)
    _, tseq = TD.generate_images(model, tvae, torch.tensor(text),
                                 rng=prng.prng_key(3), return_img_seq=True)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))

    codes = (3, 7, 9)
    _, want = JD.generate_images(dalle, vae, jnp.asarray([codes], jnp.int32),
                                 cfg=jcfg, rng=jax.random.PRNGKey(11),
                                 return_img_seq=True)
    queue = S.RequestQueue(max_depth=4, max_prompt_len=tcfg.text_seq_len)
    engine = Engine(model, queue, num_slots=2, chunk_steps=4, page_size=8,
                    device="cpu", kv="paged", paged_attn="kernel")
    handle = queue.submit(S.Request(codes=codes, seed=11))
    engine.run_until_idle()
    res = handle.result(timeout=5)
    assert res.status == S.OK, res.reason
    np.testing.assert_array_equal(res.tokens, np.asarray(want)[0])
    assert engine.alloc.in_use == 0
