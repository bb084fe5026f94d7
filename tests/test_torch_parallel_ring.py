"""The port's collectives and sequence-parallel attention bodies on CPU
process groups (gloo), against the JAX package.

``parallel/collectives.py``: each collective's forward and its
transpose (psum -> psum, all_gather -> reduce_scatter, all_to_all -> the
reverse all-to-all, ppermute -> the reverse rotation) on 2 and 4 ranks,
and bfloat16 and bool tensors over gloo. ``parallel/ring.py``: the ring
and Ulysses bodies over GLOBAL q, k, v against JAX's ``ring_attention``
and ``ulysses_attention`` on conftest's 8-device CPU mesh, causal or not,
with a text-padding mask or none, Ulysses with ``kv_chunks`` 2 and 4,
over sp 2, sp 4 and dp 2 x sp 2; their gradients (the local bodies'
backward, summed over the ranks) against ``jax.grad`` of JAX's one-device
dense attention (``dense_attention_weights``), since JAX's sharded
gradient compiles for ~10 s, and JAX's own tests hold the sharded ring
to that oracle; Ulysses' refusal of heads that do not divide, with
JAX's message. float32, to 2e-5 (``tests/test_parallel.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dalle_pytorch_tpu.ops.attention import dense_attention_weights
from dalle_pytorch_tpu.parallel import (make_mesh, ring_attention,
                                        ulysses_attention)
from dalle_pytorch_tpu_torch.parallel.launch import spawn

import torch_parallel_ranks as R

ATOL = 2e-5
B, H, N, D = 2, 4, 16, 8


def inputs():
    rs = np.random.RandomState(0)
    qkv = [rs.randn(B, H, N, D).astype(np.float32) for _ in range(3)]
    mask = np.ones((B, N), bool)
    mask[1, 11:] = False                   # a padded tail, fully padded rows
    return qkv, mask


CASES = [("ring", c, m, None) for c in (True, False) for m in (True, False)]
CASES += [("ulysses", c, m, None) for c in (True, False)
          for m in (True, False)]
CASES += [("ulysses", True, True, 2), ("ulysses", False, True, 4)]


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results: the collectives and every attention case
    over sp = the world (2 and 4), and the dp 2 x sp 2 layout."""
    qkv, mask = inputs()
    out = {}
    for world in (2, 4):
        spec = {"qkv": qkv, "mask": mask, "cases": CASES,
                "grads": world == 2}
        out[world] = spawn(R.attention_case, world, (spec,),
                            device="cpu", timeout_s=180)
        out[("col", world)] = spawn(R.collectives_case, world,
                                    device="cpu", timeout_s=120)
    spec = {"qkv": qkv, "mask": mask, "dp": 2,
            "cases": [("ring", True, True, None)]}
    out["dp2xsp2"] = spawn(R.attention_case, 4, (spec,), device="cpu",
                            timeout_s=180)
    return out


def jax_out(name, causal, masked, chunks, world):
    qkv, mask = inputs()
    mesh = make_mesh({"sp": world}, jax.devices()[:world])
    kw = dict(mesh=mesh, causal=causal,
              mask=jnp.asarray(mask) if masked else None)
    q, k, v = (jnp.asarray(a) for a in qkv)
    if name == "ring":
        return np.asarray(ring_attention(q, k, v, **kw))
    return np.asarray(ulysses_attention(q, k, v, kv_chunks=chunks, **kw))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_matches_jax_sharded(ranks, world, case):
    want = jax_out(*case, world)
    for r, got in enumerate(ranks[world]):
        np.testing.assert_allclose(got[tuple(case)], want, atol=ATOL,
                                   err_msg=f"rank {r}")


def test_ring_dp_times_sp_matches_jax(ranks):
    qkv, mask = inputs()
    mesh = make_mesh({"dp": 2, "sp": 2}, jax.devices()[:4])
    q, k, v = (jnp.asarray(a) for a in qkv)
    want = np.asarray(ring_attention(q, k, v, mesh=mesh, causal=True,
                                     batch_axis="dp",
                                     mask=jnp.asarray(mask)))
    for got in ranks["dp2xsp2"]:
        np.testing.assert_allclose(got[("ring", True, True, None)], want,
                                   atol=ATOL)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_gradients_match_jax_dense(ranks, name):
    qkv, mask = inputs()

    def loss(q, k, v):
        w = dense_attention_weights(q, k, D ** -0.5, jnp.asarray(mask),
                                    causal=True)
        return jnp.sum(jnp.einsum("bhij,bhjd->bhid", w, v) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in qkv))
    for got in ranks[2]:
        for g, w in zip(got[("grad", name)], want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4,
                                       rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_their_transposes(ranks, world):
    n = world
    res = ranks[("col", world)]
    base = np.arange(6.0).reshape(2, 3)
    total = sum(base + 10 * r for r in range(n))
    scale = sum(r + 1 for r in range(n))
    for r, got in enumerate(res):
        y, g = got["psum"]
        np.testing.assert_allclose(y, total)
        # the cotangent of psum is the psum of the ranks' cotangents
        np.testing.assert_allclose(g, np.full((2, 3), scale))
        y, g = got["all_gather"]
        np.testing.assert_allclose(
            y, np.concatenate([np.full((2, 3), float(i)) for i in range(n)],
                              axis=1))
        # reduce_scatter of sum_r (r+1) * iota, this rank's columns
        cot = np.arange(2 * 3 * n).reshape(2, 3 * n) * scale
        np.testing.assert_allclose(g, cot[:, r * 3:(r + 1) * 3])
        y, g = got["all_to_all"]
        # chunk r of every rank's rows, concatenated along columns
        want = np.concatenate([
            (np.arange(n * 2 * 3.0).reshape(n * 2, 3) + 100 * s)[
                r * 2:(r + 1) * 2] for s in range(n)], axis=1)
        np.testing.assert_allclose(y, want)
        # the reverse all-to-all sends every receiver's cotangent back
        want_g = np.concatenate([np.full((2, 3), float(s + 1))
                                 for s in range(n)], axis=0)
        np.testing.assert_allclose(g, want_g)
        y, g = got["ppermute"]
        np.testing.assert_allclose(y, np.full(3, float((r - 1) % n)))
        # the reverse rotation: the cotangent of the rank this one fed
        np.testing.assert_allclose(g, np.full(3, float((r + 1) % n + 1)))
        np.testing.assert_array_equal(
            got["bf16_gather"],
            np.concatenate([[1.5, -2.25, float(i)] for i in range(n)]))
        np.testing.assert_array_equal(
            got["bool_permute"], [True, (r - 1) % n % 2 == 0])
        np.testing.assert_array_equal(
            got["bf16_psum"], [1.5 * n, -2.25 * n, sum(range(n))])


def test_ulysses_refuses_heads_that_do_not_divide():
    from dalle_pytorch_tpu_torch.parallel import ring as TR
    from dalle_pytorch_tpu_torch.parallel.mesh import Mesh
    jmesh = make_mesh({"sp": 8})
    q = jnp.zeros((1, 4, 16, 8))
    with pytest.raises(ValueError) as jerr:
        ulysses_attention(q, q, q, mesh=jmesh, axis="sp")
    import torch
    tq = torch.zeros((1, 4, 16, 8))
    mesh = Mesh({"sp": 8}, np.arange(8).reshape(8), {"sp": 0}, {})
    with pytest.raises(ValueError) as terr:
        TR.ulysses_attention(tq, tq, tq, mesh=mesh, axis="sp")
    assert str(terr.value) == str(jerr.value)
