"""fsdp, checkpoints under placement and generation over a dp-sharded
candidate batch in the port, on CPU process groups (gloo), against the
JAX package.

``dalle_param_specs(fsdp=)`` stores each layer on one rank of the fsdp
group in contiguous blocks of layers (JAX's spec on the depth axis). The
ranks of the group see the same rows (JAX splits the batch over dp
only); a layer's weights reach them from their owner before it runs,
and again wherever the stack recomputes it (``remat='full'``, the
reversible stack's backward); the transpose sums each layer's gradient
into its owner. Two Adam steps with the global-norm clip and dropout 0.1
give JAX's one-device loss and parameters (gathered, 2e-5) at fsdp 2
(plain, ``remat='full'``, reversible) and tp 2 x fsdp 2. A rank stores
the reckoned share of the parameters. A checkpoint restored under tp 2
or fsdp 2 (the optimizer's moments placed by name) and saved again is
byte for byte the one-process checkpoint. ``generate_images(mesh=)``
over dp 2 gives JAX's one-device tokens (top-k, guidance) and CLIP
rerank scores. float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dalle_pytorch_tpu.models import clip as JC
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.parallel.launch import spawn

import torch_parallel_jax as J
import torch_parallel_ranks as R

REMAT = dict(J.DALLE, remat="full")
REVERSIBLE = dict(J.DALLE, reversible=True)
GEN = dict(J.DALLE, attn_dropout=0.0, ff_dropout=0.0)
CLIP_KW = dict(dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=64,
               text_enc_depth=1, text_seq_len=8, text_heads=2,
               visual_enc_depth=1, visual_heads=2, visual_image_size=16,
               visual_patch_size=4)
TEXT = np.random.RandomState(0).randint(1, 63, (4, 8))
GEN_CASES = [("top_k", {}), ("guidance", {"opts": {"guidance": 3.0}}),
             ("clip", {"clip": True})]


def gen_bundle():
    key = jax.random.PRNGKey(0)
    jcfg = J.jax_cfg(GEN)
    vp = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), jcfg.vae))
    params = jax.device_get(JD.dalle_init(key, jcfg, vp))
    cp = jax.device_get(JC.clip_init(jax.random.PRNGKey(5),
                                     JC.CLIPConfig(**CLIP_KW)))
    return params, vp, cp


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fsdp"))
    params, vp, cp = gen_bundle()
    items = [("step_case", J.step_spec(J.DALLE, {"fsdp": 2},
                                       {"fsdp": "fsdp"})),
             ("step_case", J.step_spec(REMAT, {"fsdp": 2},
                                       {"fsdp": "fsdp"})),
             ("step_case", J.step_spec(REVERSIBLE, {"fsdp": 2},
                                       {"fsdp": "fsdp"})),
             ("place_case", {**J.step_spec(J.DALLE, {"fsdp": 2},
                                           {"fsdp": "fsdp"}), "dir": d}),
             ("place_case", {**J.step_spec(J.DALLE, {"tp": 2},
                                           {"tp": "tp"}), "dir": d}),
             ("generate_case", {"dp": 2, "cfg": {**GEN, "vae": J.VAE},
                                "params": params, "vae": vp, "clip": cp,
                                "clip_cfg": CLIP_KW, "text": TEXT,
                                "seed": 3, "cases": GEN_CASES})]
    return spawn(R.run_cases, 2, (items,), device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def four():
    items = [("step_case", J.step_spec(J.DALLE, {"tp": 2, "fsdp": 2},
                                       {"tp": "tp", "fsdp": "fsdp"}))]
    return spawn(R.run_cases, 4, (items,), device="cpu", timeout_s=240)


@pytest.mark.parametrize("case, kw", [(0, J.DALLE), (1, REMAT),
                                      (2, REVERSIBLE)],
                         ids=["plain", "remat_full", "reversible"])
def test_fsdp2_step_matches_jax_one_device_step(two, case, kw):
    want = J.jax_steps(kw)
    for rank in two:
        J.assert_step_matches(rank[case], want)


def test_fsdp2_refetches_where_the_stack_recomputes(two):
    """``remat='full'`` fetches each layer again in the backward: one
    more broadcast a layer a step than the plain stack (the gathers of
    ``checkpoint_state`` are the same in both)."""
    depth = J.DALLE["depth"]
    for rank in two:
        plain, remat = rank[0]["calls"], rank[1]["calls"]
        assert remat["broadcast"] - plain["broadcast"] == depth * J.STEPS


def test_fsdp2_fetches_each_layer_from_its_blocks_owner(two):
    """Every fsdp rank runs every layer, so each layer is fetched from
    the rank storing its block: the first half from rank 0, the rest
    from rank 1."""
    depth = J.DALLE["depth"]
    want = [i // (depth // 2) for i in range(depth)]
    for rank in two:
        assert rank[0]["owners"] == want


def test_tp2_fsdp2_step_matches_jax_one_device_step(four):
    want = J.jax_steps(J.DALLE)
    for rank in four:
        J.assert_step_matches(rank[0], want)


def _counts(kw):
    params, _ = J.setup(kw)
    model = from_jax.dalle_from_jax(params, J.torch_cfg(kw), device="cpu")
    total = sum(p.numel() for p in model.parameters())
    layers = sum(p.numel() for p in model.transformer.parameters())
    split = sum(p.numel() for n, p in model.named_parameters()
                if n.endswith(("qkv.weight", "out.weight", "w1.weight",
                               "w1.bias", "w2.weight"))
                or n.startswith("logits_proj"))
    return total, layers, split


def test_fsdp_ranks_store_their_share(two, four):
    """fsdp 2: the embeddings and head whole, half of the layers; tp 2 x
    fsdp 2: of that, half of the split tensors' pieces once more. The
    moments follow: two a stored element."""
    total, layers, split = _counts(J.DALLE)
    for rank in two:
        assert rank[0]["stage_params"] == total - layers // 2
        assert rank[3]["stored"] == total - layers // 2
        assert rank[3]["moments"] == 2 * rank[3]["stored"]
        assert rank[4]["stored"] == total - split // 2
    head = J.DALLE["dim"] * 96 + 96      # the head's weight and bias
    for rank in four:
        # per rank: the non-layer parameters (head halved by tp) and half
        # of the layers, whose split tensors are halved again
        layer_split = (split - head) // 2
        want = (total - layers - head // 2) + (layers // 2
                                                - layer_split // 2)
        assert rank[0]["stage_params"] == want


@pytest.mark.parametrize("case", [3, 4], ids=["fsdp2", "tp2"])
def test_checkpoint_under_placement_is_the_one_process_bytes(two, case):
    for rank in two:
        got = rank[case]
        assert got["files"] and all(got["same_bytes"].values()), got


@pytest.mark.parametrize("name", ["top_k", "guidance"])
def test_generate_over_dp2_gives_jax_one_device_tokens(two, name):
    params, vp, _ = gen_bundle()
    opts = dict(GEN_CASES)[name].get("opts", {})
    ji, jseq = JD.generate_images(params, vp, jnp.asarray(TEXT),
                                  cfg=J.jax_cfg(GEN),
                                  rng=jax.random.PRNGKey(3),
                                  return_img_seq=True, **opts)
    for rank in two:
        got = rank[5][name]
        np.testing.assert_array_equal(got["ids"], np.asarray(jseq))
        np.testing.assert_allclose(got["images"], np.asarray(ji),
                                   rtol=1e-5, atol=1e-5)


def test_generate_over_dp2_clip_rerank_matches_jax(two):
    params, vp, cp = gen_bundle()
    jcc = JC.CLIPConfig(**CLIP_KW)
    ji, js = JD.generate_images(params, vp, jnp.asarray(TEXT),
                                cfg=J.jax_cfg(GEN),
                                rng=jax.random.PRNGKey(3), clip_params=cp,
                                clip_cfg=jcc)
    for rank in two:
        got = rank[5]["clip"]
        np.testing.assert_allclose(got["images"], np.asarray(ji),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["scores"], np.asarray(js),
                                   rtol=1e-5, atol=1e-5)
        assert list(np.argsort(-got["scores"])) == list(
            np.argsort(-np.asarray(js)))
