"""The PyTorch port's primitives, attention, transformer stack, VAE decoder
and weight bridge, held against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; float32,
atol 1e-5 (both sides are float32 CPU math that differs only in
summation order). Also: the port imports nothing of JAX, and its entry
points refuse to run without a CUDA device unless asked for the CPU.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.ops import attention as JA
from dalle_pytorch_tpu.ops import core as JC
from dalle_pytorch_tpu.ops import transformer as JT
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.ops import attention as TA
from dalle_pytorch_tpu_torch.ops import core as TC
from dalle_pytorch_tpu_torch.ops import transformer as TT


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-5

# bench.py build_cfg(tiny=True) widths, depth 2
JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
JCFG = JD.DALLEConfig(dim=32, depth=2, vae=JVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
TCFG = TD.DALLEConfig(dim=32, depth=2, vae=TVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)


def rnd(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_trees():
    key = jax.random.PRNGKey(0)
    vae = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    return jax.device_get(JD.dalle_init(key, JCFG, vae)), vae


@pytest.fixture(scope="module")
def port(jax_trees):
    dalle, vae = jax_trees
    return (from_jax.dalle_from_jax(dalle, TCFG, device="cpu"),
            from_jax.vae_from_jax(vae, TVCFG, device="cpu"))


# -- primitives ---------------------------------------------------------------

def test_linear_layernorm_gelu_embedding():
    jp = {"w": rnd(0, 12, 7), "b": rnd(1, 7)}
    lin = torch.nn.Linear(12, 7)
    from_jax._linear(lin, jp)
    x = rnd(2, 3, 5, 12)
    close(TC.linear(lin, torch.tensor(x)), JC.linear(jp, jnp.asarray(x)))

    lp = {"g": rnd(3, 12), "b": rnd(4, 12)}
    ln = torch.nn.LayerNorm(12)
    from_jax._layernorm(ln, lp)
    close(TC.layernorm(ln, torch.tensor(x)), JC.layernorm(lp, jnp.asarray(x)))

    close(TC.gelu(torch.tensor(x)), JC.gelu(jnp.asarray(x)))

    emb = torch.nn.Embedding(12, 7)
    w = rnd(5, 12, 7)
    with torch.no_grad():
        emb.weight.copy_(torch.tensor(w))
    ids = np.array([[0, 3, 11], [5, 5, 1]])
    close(TC.embedding(emb, torch.tensor(ids)),
          JC.embedding({"w": jnp.asarray(w)}, jnp.asarray(ids)))
    assert TC.neg_inf(torch.float32) == float(JC.neg_inf(jnp.float32))
    assert TC.neg_inf(torch.bfloat16) == float(JC.neg_inf(jnp.bfloat16))


def test_layernorm_runs_in_float32_for_bf16():
    """bf16 in, bf16 out, but normalised in f32 like the JAX op."""
    lp = {"g": rnd(3, 64), "b": rnd(4, 64)}
    ln = torch.nn.LayerNorm(64)
    from_jax._layernorm(ln, lp)
    x = (rnd(6, 4, 64) * 30 + 100).astype(np.float32)
    xb = torch.tensor(x).to(torch.bfloat16)
    y = TC.layernorm(ln, xb)
    assert y.dtype == torch.bfloat16
    ref = JC.layernorm(lp, jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(y.float().detach().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=0.05, rtol=0.02)


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 4),
                                              (1, 0, 1)])
def test_conv2d_matches_jax_nhwc(stride, padding, k):
    jp = {"w": rnd(7, k, k, 3, 5), "b": rnd(8, 5)}
    conv = torch.nn.Conv2d(3, 5, k)
    from_jax._conv(conv, jp)
    x = rnd(9, 2, 8, 8, 3)
    got = TC.conv2d(conv, torch.tensor(x).permute(0, 3, 1, 2),
                    stride=stride, padding=padding).permute(0, 2, 3, 1)
    close(got, JC.conv2d(jp, jnp.asarray(x), stride=stride,
                         padding=padding))


def test_conv2d_transpose_layout_is_iohw_without_flip():
    """The JAX flipped-kernel dilated conv over HWIO ``w`` equals torch's
    transposed conv over ``w.transpose(2, 3, 0, 1)`` — pinned, not
    assumed (a flipped or OIHW layout fails this)."""
    jp = {"w": rnd(10, 4, 4, 6, 5), "b": rnd(11, 5)}
    conv = torch.nn.ConvTranspose2d(6, 5, 4)
    from_jax._conv_transpose(conv, jp)
    x = rnd(12, 2, 5, 5, 6)
    got = TC.conv2d_transpose(conv, torch.tensor(x).permute(0, 3, 1, 2),
                              stride=2, padding=1).permute(0, 2, 3, 1)
    assert got.shape == (2, 10, 10, 5)
    close(got, JC.conv2d_transpose(jp, jnp.asarray(x), stride=2, padding=1))


# -- attention / transformer ----------------------------------------------------

def test_attention_helpers_and_dense_apply(jax_trees, port):
    dalle, _ = jax_trees
    model, _ = port
    lp = jax.tree.map(lambda a: a[0], dalle["transformer"])["attn"]
    p = model.transformer.layers[0].attn
    x = rnd(13, 2, 6, TCFG.dim)
    tq, tk, tv = TA.qkv_project(p, torch.tensor(x), TCFG.heads)
    jq, jk, jv = JA.qkv_project(lp, jnp.asarray(x), JCFG.heads)
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        close(t, j)
    close(TA.merge_heads(tq), JA.merge_heads(jq))
    close(TA.split_heads(TA.merge_heads(tq), TCFG.heads), jq)
    close(TA.output_tail(p, tv), JA.output_tail(lp, jv))
    mask = np.ones((2, 6), bool)
    mask[1, :2] = False                    # fully padded leading rows
    scale = TCFG.transformer.scale
    assert scale == JCFG.transformer.scale == TCFG.dim ** -0.5
    got = TA.attention_apply(p, torch.tensor(x), heads=TCFG.heads,
                             scale=scale, causal=True,
                             mask=torch.tensor(mask))
    want = JA.attention_apply(lp, jnp.asarray(x), heads=JCFG.heads,
                              dim_head=JCFG.dim_head, scale=scale,
                              causal=True, mask=jnp.asarray(mask))
    close(got, want)


def test_transformer_stack_matches_jax(jax_trees, port):
    dalle, _ = jax_trees
    model, _ = port
    x = rnd(14, 2, 10, TCFG.dim)
    mask = np.ones((2, 10), bool)
    mask[0, 7:] = False
    got = TT.transformer_apply(model.transformer, torch.tensor(x),
                               cfg=TCFG.transformer, mask=torch.tensor(mask))
    want = JT.transformer_apply(dalle["transformer"], jnp.asarray(x),
                                cfg=JCFG.transformer, mask=jnp.asarray(mask))
    close(got, want)


@pytest.mark.parametrize("option, refused", [
    (dict(reversible=True), dict(reversible=True, moe_experts=4)),
    (dict(moe_experts=4), dict(moe_experts=4, moe_k=5)),
    (dict(remat="full"), dict(remat="everything"))])
def test_later_slice_options_raise(option, refused):
    """The options of the training slice construct, and what JAX refuses
    of them (reversible with MoE, k above the experts, an unknown remat
    mode) raises ValueError, JAX's type."""
    cfg = TD.DALLEConfig(dim=32, depth=2, vae=TVCFG, **option)
    assert all(getattr(cfg.transformer, k) == v for k, v in option.items())
    with pytest.raises(ValueError):
        TD.DALLEConfig(dim=32, depth=2, vae=TVCFG, **refused)


# -- VAE decode -----------------------------------------------------------------

@pytest.mark.parametrize("resblocks", [0, 1])
def test_vae_decode_matches_jax(resblocks):
    jcfg = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8,
                        num_resnet_blocks=resblocks)
    tcfg = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                        num_layers=2, hidden_dim=8,
                        num_resnet_blocks=resblocks)
    jp = jax.device_get(JV.vae_init(jax.random.PRNGKey(3), jcfg))
    vae = from_jax.vae_from_jax(jp, tcfg, device="cpu")
    ids = np.random.RandomState(15).randint(0, 32, (2, 16))
    cb = rnd(16, 32, 32)
    got = TV.decode(vae, torch.tensor(ids), codebook=torch.tensor(cb))
    want = JV.decode(jp, jnp.asarray(ids), codebook=jnp.asarray(cb))
    assert got.shape == (2, 16, 16, 3)
    close(got, want)
    close(TV.decode(vae, torch.tensor(ids)), JV.decode(jp, jnp.asarray(ids)))


# -- weight bridge --------------------------------------------------------------

def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_round_trips_every_tensor_exactly(jax_trees, dtype):
    trees = tuple(jax_trees)
    dal_p, vae_p = jax.device_get(jax.tree.map(
        lambda a: jnp.asarray(a, dtype), trees))
    model = from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")
    vae = from_jax.vae_from_jax(vae_p, TVCFG, device="cpu")
    want_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert all(p.dtype == want_dtype for p in model.parameters())

    def same(t, a):
        a = from_jax.to_tensor(a)
        assert t.dtype == a.dtype and t.shape == a.shape
        assert torch.equal(t.detach(), a)

    n = 0
    same(model.text_emb.weight, dal_p["text_emb"]["w"])
    same(model.image_emb.weight, dal_p["image_emb"]["w"])
    same(model.image_emb.weight, vae_p["codebook"]["w"])   # the tie
    same(model.text_pos_emb.weight, dal_p["text_pos_emb"]["w"])
    same(model.image_pos_rows.weight, dal_p["image_pos_emb"]["rows"])
    same(model.image_pos_cols.weight, dal_p["image_pos_emb"]["cols"])
    n += 5
    st = dal_p["transformer"]
    for i, layer in enumerate(model.transformer.layers):
        for mod, sub in ((layer.attn, st["attn"]), (layer.ff, st["ff"])):
            same(mod.ln.weight, sub["ln"]["g"][i])
            same(mod.ln.bias, sub["ln"]["b"][i])
            n += 2
        same(layer.attn.qkv.weight.T, st["attn"]["qkv"]["w"][i])
        same(layer.attn.out.weight.T, st["attn"]["out"]["w"][i])
        same(layer.attn.out.bias, st["attn"]["out"]["b"][i])
        for name in ("w1", "w2"):
            same(getattr(layer.ff, name).weight.T, st["ff"][name]["w"][i])
            same(getattr(layer.ff, name).bias, st["ff"][name]["b"][i])
        n += 7
    same(model.logits_ln.weight, dal_p["to_logits"]["ln"]["g"])
    same(model.logits_ln.bias, dal_p["to_logits"]["ln"]["b"])
    same(model.logits_proj.weight.T, dal_p["to_logits"]["proj"]["w"])
    same(model.logits_proj.bias, dal_p["to_logits"]["proj"]["b"])
    n += 4
    assert n == sum(1 for _ in model.parameters())

    same(vae.codebook.weight, vae_p["codebook"]["w"])
    for m, p in zip(vae.dec_convs, vae_p["dec_convs"]):
        same(m.weight.permute(2, 3, 0, 1), p["w"])
        same(m.bias, p["b"])
    same(vae.dec_out.weight.permute(2, 3, 1, 0), vae_p["dec_out"]["w"])
    same(vae.dec_out.bias, vae_p["dec_out"]["b"])
    assert 2 * len(vae.dec_convs) + 3 == sum(1 for _ in vae.parameters())


def test_bridge_rejects_depth_mismatch(jax_trees):
    dalle, _ = jax_trees
    cfg = TD.DALLEConfig(dim=32, depth=3, vae=TVCFG, num_text_tokens=64,
                         text_seq_len=8, heads=2, dim_head=16)
    with pytest.raises(ValueError, match="stacks 2 layers"):
        from_jax.dalle_from_jax(dalle, cfg, device="cpu")


# -- package rules ----------------------------------------------------------------

def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "dalle_pytorch_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "dalle_pytorch_tpu"), f"{f}: imports {mod}"


def test_entry_points_raise_without_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.dalle_init(TCFG, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TV.vae_init(TVCFG, seed=0)
    model = TD.dalle_init(TCFG, seed=0, device="cpu")
    assert model.text_emb.weight.device.type == "cpu"


def test_seeded_init_is_deterministic_and_ties_the_codebook():
    vae = TV.vae_init(TVCFG, seed=1, device="cpu")
    a = TD.dalle_init(TCFG, seed=2, vae=vae, device="cpu")
    b = TD.dalle_init(TCFG, seed=2, vae=vae, device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert torch.equal(a.image_emb.weight, vae.codebook.weight)
    c = TD.dalle_init(TCFG, seed=3, device="cpu")
    assert not torch.equal(a.text_emb.weight, c.text_emb.weight)


def test_kernel_library_hash_covers_every_shared_header(tmp_path,
                                                        monkeypatch):
    """Every quoted include of a kernel source is a ``csrc/*.cuh`` header,
    and editing such a header renames every kernel's library, so a stale
    build is never loaded."""
    import re
    import shutil

    from dalle_pytorch_tpu_torch.ops import build
    for src in build.SOURCES.values():
        for inc in re.findall(r'#include "([^"]+)"',
                              (build.CSRC / src).read_text()):
            assert inc.endswith(".cuh") and (build.CSRC / inc).is_file(), inc
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = csrc / "tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
    assert len(set(after.values())) == len(build.SOURCES)
