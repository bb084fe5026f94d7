"""Reference ``.pth`` state dicts in and out of the port, against the JAX
package: ``compat/torch_import.py`` gives the JAX functions' trees leaf
for leaf (``np.array_equal``) and their config kwargs, both key schemes
(sequential and reversible) map to one layout, ``compat/torch_export.py``
gives JAX's export dict for dict, and the port's ``cli/import_torch.py``
writes checkpoint directories byte-identical to
``python -m dalle_pytorch_tpu.cli.import_torch`` for the same ``.pth``.
An imported DALLE's logits equal the JAX forward's to 1e-5 (float32).

The reference-layout state dicts are built here from plain ``torch.nn``
modules arranged as the reference arranges them."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from dalle_pytorch_tpu import checkpoint as jckpt
from dalle_pytorch_tpu.cli import import_torch as jcli
from dalle_pytorch_tpu.compat import torch_export as jexp
from dalle_pytorch_tpu.compat import torch_import as jimp
from dalle_pytorch_tpu.models import clip as JC
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu_torch import checkpoint as tckpt
from dalle_pytorch_tpu_torch.cli import import_torch as tcli
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.compat import torch_export as texp
from dalle_pytorch_tpu_torch.compat import torch_import as timp
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# reference-layout modules (Sequential indices as the reference lays them out)
# ---------------------------------------------------------------------------

def build_torch_vae(num_tokens=24, codebook_dim=16, num_layers=2,
                    num_resnet_blocks=0, hidden_dim=8, channels=3):
    def resblock(ch):
        m = nn.Module()
        m.net = nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1), nn.ReLU(),
                              nn.Conv2d(ch, ch, 3, padding=1), nn.ReLU(),
                              nn.Conv2d(ch, ch, 1))
        return m

    has_res = num_resnet_blocks > 0
    enc_ch = [channels] + [hidden_dim] * num_layers
    dec_ch = [hidden_dim] * num_layers
    enc_layers = [nn.Sequential(nn.Conv2d(i, o, 4, stride=2, padding=1),
                                nn.ReLU())
                  for i, o in zip(enc_ch[:-1], enc_ch[1:])]
    dec_in = dec_ch[0] if has_res else codebook_dim
    dec_io = list(zip([dec_in] + dec_ch[:-1], dec_ch))
    dec_layers = [nn.Sequential(nn.ConvTranspose2d(i, o, 4, stride=2,
                                                   padding=1), nn.ReLU())
                  for i, o in dec_io]
    for _ in range(num_resnet_blocks):
        enc_layers.append(resblock(enc_ch[-1]))
        dec_layers.insert(0, resblock(dec_ch[0]))
    if has_res:
        dec_layers.insert(0, nn.Conv2d(codebook_dim, dec_ch[0], 1))
    enc_layers.append(nn.Conv2d(enc_ch[-1], num_tokens, 1))
    dec_layers.append(nn.Conv2d(dec_ch[-1], channels, 1))
    m = nn.Module()
    m.codebook = nn.Embedding(num_tokens, codebook_dim)
    m.encoder = nn.Sequential(*enc_layers)
    m.decoder = nn.Sequential(*dec_layers)
    return m


def _prenorm_attn(dim, heads, dim_head):
    m = nn.Module()
    m.norm = nn.LayerNorm(dim)
    m.fn = nn.Module()
    inner = heads * dim_head
    m.fn.to_qkv = nn.Linear(dim, inner * 3, bias=False)
    m.fn.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))
    return m


def _prenorm_ff(dim, mult=4):
    m = nn.Module()
    m.norm = nn.LayerNorm(dim)
    m.fn = nn.Module()
    m.fn.net = nn.Sequential(nn.Linear(dim, dim * mult * 2), nn.Identity(),
                             nn.Dropout(0.0), nn.Linear(dim * mult, dim))
    return m


def build_torch_transformer(dim=16, depth=3, heads=2, dim_head=8):
    m = nn.Module()
    m.layers = nn.Module()
    m.layers.layers = nn.ModuleList([
        nn.ModuleList([_prenorm_attn(dim, heads, dim_head), _prenorm_ff(dim)])
        for _ in range(depth)])
    return m


def dalle_state_dict(dim=16, depth=2, num_text=32, text_seq=8,
                     image_size=16, heads=2, seed=3):
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    vae = build_torch_vae(num_tokens=24, codebook_dim=dim)
    tr = build_torch_transformer(dim=dim, depth=depth, heads=heads,
                                 dim_head=dim // heads)
    sd = {f"vae.{k}": _np(v) for k, v in vae.state_dict().items()}
    sd.update({f"transformer.{k}": _np(v)
               for k, v in tr.state_dict().items()})
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd["text_emb.weight"] = f32(num_text, dim)
    sd["image_emb.weight"] = sd["vae.codebook.weight"]          # tied
    sd["text_pos_emb.weight"] = f32(text_seq, dim)
    sd["image_pos_emb.weights.0"] = f32(1, image_size, 1, dim)
    sd["image_pos_emb.weights.1"] = f32(1, 1, image_size, dim)
    total = num_text + 24 + 1
    sd["to_logits.0.weight"] = 1 + 0.1 * f32(dim)
    sd["to_logits.0.bias"] = 0.1 * f32(dim)
    sd["to_logits.1.weight"] = f32(total, dim)
    sd["to_logits.1.bias"] = f32(total)
    return sd


def clip_state_dict(dim=16, seed=4):
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = {}
    # CLIP's encoders have heads of 64
    for k, v in build_torch_transformer(dim=dim, depth=2, dim_head=64) \
            .state_dict().items():
        sd[f"text_transformer.{k}"] = _np(v)
    for k, v in build_torch_transformer(dim=dim, depth=1, dim_head=64) \
            .state_dict().items():
        sd[f"visual_transformer.{k}"] = _np(v)
    patch, side = 8, 2
    sd["text_emb.weight"] = f32(32, dim)
    sd["text_pos_emb.weight"] = f32(8, dim)
    sd["to_text_latent.weight"] = f32(12, dim)
    sd["to_visual_embedding.weight"] = f32(dim, 3 * patch * patch)
    sd["to_visual_embedding.bias"] = f32(dim)
    sd["visual_pos_emb.weight"] = f32(side * side, dim)
    sd["to_visual_latent.weight"] = f32(12, dim)
    sd["temperature"] = np.asarray(1.5, np.float32)
    return sd


def vae_state_dict(resblocks, seed=5):
    torch.manual_seed(seed)
    return {k: _np(v) for k, v in
            build_torch_vae(num_resnet_blocks=resblocks).state_dict().items()}


def reversible_keys(sd):
    """layers.layers.{i}.{0|1}.rest -> layers.blocks.{i}.{f|g}.net.rest"""
    out = {}
    for k, v in sd.items():
        m = k.split(".")
        branch = "f" if m[3] == "0" else "g"
        out[".".join(["layers", "blocks", m[2], branch, "net"] + m[4:])] = v
    return out


def assert_trees_equal(a, b):
    """Same structure, every leaf np.array_equal (and the same dtype)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# import: the JAX functions' trees and kwargs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resblocks", [0, 2])
def test_import_vae_equals_jax(resblocks):
    sd = vae_state_dict(resblocks)
    got, got_kw = timp.import_vae(sd, image_size=16)
    want, want_kw = jimp.import_vae(sd, image_size=16)
    assert_trees_equal(got, want)
    assert got_kw == want_kw


def test_import_dalle_equals_jax():
    sd = dalle_state_dict()
    got = timp.import_dalle(sd, image_size=16, heads=2)
    want = jimp.import_dalle(sd, image_size=16, heads=2)
    assert_trees_equal(got[0], want[0])
    assert_trees_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]
    with pytest.raises(ValueError, match="heads=3"):
        timp.import_dalle(sd, image_size=16, heads=3)


def test_import_clip_equals_jax():
    sd = clip_state_dict()
    got, got_kw = timp.import_clip(sd)
    want, want_kw = jimp.import_clip(sd)
    assert_trees_equal(got, want)
    assert got_kw == want_kw


@pytest.mark.parametrize("depth", [1, 3])
def test_reversible_key_scheme_maps_to_same_layout(depth):
    torch.manual_seed(2)
    sd = {k: _np(v) for k, v in
          build_torch_transformer(depth=depth).state_dict().items()}
    seq = timp.import_transformer(sd)
    rev = timp.import_transformer(reversible_keys(sd))
    assert_trees_equal(seq, rev)
    assert_trees_equal(rev, jimp.import_transformer(reversible_keys(sd)))


def test_missing_keys_raise_like_jax():
    with pytest.raises(KeyError, match="no transformer layers"):
        timp.import_transformer({})
    with pytest.raises(KeyError, match="codebook.weight"):
        timp.import_vae({})


# ---------------------------------------------------------------------------
# export: the JAX dicts, and the port's modules
# ---------------------------------------------------------------------------

def assert_state_dicts_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["vae", "dalle", "clip"])
def test_export_equals_jax_and_round_trips(kind):
    if kind == "vae":
        sd = vae_state_dict(1)
        tree, _ = timp.import_vae(sd, image_size=16)
        got, want = texp.export_vae(tree), jexp.export_vae(tree)
    elif kind == "dalle":
        sd = dalle_state_dict()
        tree, vtree, _, _ = timp.import_dalle(sd, image_size=16, heads=2)
        got = texp.export_dalle(tree, vtree)
        want = jexp.export_dalle(tree, vtree)
    else:
        sd = clip_state_dict()
        tree, _ = timp.import_clip(sd)
        got, want = texp.export_clip(tree), jexp.export_clip(tree)
    assert_state_dicts_equal(got, want)
    assert_state_dicts_equal(got, {k: np.asarray(v, np.float32)
                                   for k, v in sd.items()})


def test_export_of_a_port_module_equals_its_tree():
    sd = dalle_state_dict()
    tree, vtree, kw, vkw = timp.import_dalle(sd, image_size=16, heads=2)
    cfg = TD.DALLEConfig(vae=TV.VAEConfig(**vkw), heads=2, **kw)
    model = from_jax.dalle_from_jax(tree, cfg, device="cpu")
    assert_state_dicts_equal(texp.export_dalle(model),
                             texp.export_dalle(tree))
    # a bfloat16 module exports its values widened to float32
    bf = from_jax.dalle_from_jax(tree, cfg, device="cpu",
                                 dtype=torch.bfloat16)
    out = texp.export_dalle(bf)
    assert out["text_emb.weight"].dtype == np.float32
    np.testing.assert_array_equal(
        out["text_emb.weight"],
        torch.from_numpy(sd["text_emb.weight"]).bfloat16().float().numpy())


def test_export_refuses_moe_and_int8_like_jax():
    stacked = {"ff": {"moe": {}}}
    with pytest.raises(ValueError, match="MoE"):
        texp.export_transformer(stacked)
    with pytest.raises(ValueError, match="int8"):
        texp._linear({}, "x", {"w_q": 0})


# ---------------------------------------------------------------------------
# the CLI: byte-identical checkpoint directories, and back
# ---------------------------------------------------------------------------

def dir_bytes(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _save_pth(sd, path):
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    return str(path)


@pytest.mark.parametrize("kind", ["vae", "dalle", "clip"])
def test_cli_writes_the_jax_clis_bytes(tmp_path, kind):
    sd = {"vae": lambda: vae_state_dict(1), "dalle": dalle_state_dict,
          "clip": clip_state_dict}[kind]()
    pth = _save_pth(sd, tmp_path / "in.pth")
    extra = {"vae": ["--image_size", "16", "--epoch", "7"],
             "dalle": ["--image_size", "16", "--heads", "2"],
             "clip": ["--heads", "2"]}[kind]
    outs = {}
    for who, main in (("jax", jcli.main), ("port", tcli.main)):
        out = tmp_path / who / f"{kind}-0"
        argv = [kind, pth, "--out", str(out)] + extra
        if kind == "dalle":
            argv += ["--vae_out", str(tmp_path / who / "vae-0")]
        main(argv)
        outs[who] = out
    assert dir_bytes(outs["port"]) == dir_bytes(outs["jax"])
    if kind == "dalle":
        assert dir_bytes(tmp_path / "port" / "vae-0") \
            == dir_bytes(tmp_path / "jax" / "vae-0")
    # and the port restores what the JAX package restores
    got, manifest = tckpt.restore_params(str(outs["port"]))
    want, _ = jckpt.restore_params(str(outs["jax"]))
    assert_trees_equal(got, jax.device_get(want))
    assert manifest["kind"] == kind


@pytest.mark.parametrize("kind", ["vae", "clip"])
def test_cli_export_round_trip_is_bit_equal(tmp_path, kind):
    sd = vae_state_dict(2) if kind == "vae" else clip_state_dict()
    pth = _save_pth(sd, tmp_path / "in.pth")
    out = tmp_path / "ckpt"
    tcli.main([kind, pth, "--out", str(out), "--heads", "2"])
    for who, main in (("jax", jcli.main), ("port", tcli.main)):
        back = str(tmp_path / f"{who}.pth")
        main([f"export-{kind}", back, "--out", str(out)])
        b = torch.load(back, weights_only=True)
        assert set(b) == set(sd)
        for k in sd:
            assert np.array_equal(_np(b[k]), sd[k]), k


def test_cli_export_refuses_another_kind(tmp_path):
    pth = _save_pth(vae_state_dict(0), tmp_path / "in.pth")
    out = tmp_path / "vae"
    tcli.main(["vae", pth, "--out", str(out)])
    with pytest.raises(SystemExit, match="kind='vae'"):
        tcli.main(["export-dalle", str(tmp_path / "x.pth"), "--out",
                   str(out)])


def test_cli_dalle_refuses_a_bad_head_count(tmp_path):
    pth = _save_pth(dalle_state_dict(), tmp_path / "in.pth")
    with pytest.raises(SystemExit, match="heads=3"):
        tcli.main(["dalle", pth, "--out", str(tmp_path / "d"),
                   "--heads", "3"])


# ---------------------------------------------------------------------------
# an imported DALLE computes the JAX forward
# ---------------------------------------------------------------------------

def test_imported_dalle_logits_match_jax():
    """float32: the port's forward on the imported weights equals the
    JAX forward on the JAX import of the same state dict to 1e-5 at the
    allowed positions (the forbidden ones hold the same fill)."""
    sd = dalle_state_dict()
    tree, vtree, kw, vkw = timp.import_dalle(sd, image_size=16, heads=2)
    jtree, _, jkw, jvkw = jimp.import_dalle(sd, image_size=16, heads=2)
    jcfg = JD.DALLEConfig(vae=JV.VAEConfig(**jvkw), heads=2, **jkw)
    tcfg = TD.DALLEConfig(vae=TV.VAEConfig(**vkw), heads=2, **kw)
    model = from_jax.dalle_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(7)
    text = rng.integers(0, tcfg.num_text_tokens, (2, tcfg.text_seq_len))
    ids = rng.integers(0, tcfg.num_image_tokens, (2, tcfg.image_seq_len))
    with torch.no_grad():
        got = TD.dalle_apply(model, torch.from_numpy(text),
                             torch.from_numpy(ids)).numpy()
    want = np.asarray(JD.dalle_apply(jax.tree.map(jnp.asarray, jtree),
                                     jnp.asarray(text), jnp.asarray(ids),
                                     cfg=jcfg))
    keep = ~np.asarray(JD.logits_mask(jcfg))
    np.testing.assert_allclose(got[:, keep], want[:, keep], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[:, ~keep], want[:, ~keep])


def test_imported_clip_scores_match_jax():
    from dalle_pytorch_tpu_torch.models import clip as TC
    sd = clip_state_dict()
    tree, kw = timp.import_clip(sd)
    jcfg = JC.CLIPConfig(text_heads=2, visual_heads=2, sparse_attn=False,
                         **kw)
    tcfg = TC.CLIPConfig(text_heads=2, visual_heads=2, sparse_attn=False,
                         **kw)
    model = from_jax.clip_from_jax(tree, tcfg, device="cpu")
    rng = np.random.default_rng(8)
    text = rng.integers(1, 32, (2, 8))
    imgs = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        got = TC.clip_apply(model, torch.from_numpy(text),
                            torch.from_numpy(imgs)).numpy()
    want = np.asarray(JC.clip_apply(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(text), jnp.asarray(imgs),
                                    cfg=jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
