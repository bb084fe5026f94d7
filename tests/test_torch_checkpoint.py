"""The port's checkpoints (``checkpoint.py``, ``compat/msgpack.py``,
``compat/to_jax.py``, ``cli/common.py::Optimizer.state_tree``) against
the JAX package's, on the CPU at tiny configs.

Covered: the msgpack codec against flax's ``msgpack_serialize`` and
``msgpack_restore`` on trees of every leaf kind (ints of every width,
floats, strings, bytes, numpy scalars, bfloat16, empty arrays) and with
flax's ``MAX_CHUNK_SIZE`` patched down (chunked leaves); payload bytes
byte-identical to flax's for the VAE (with a resnet block), DALLE
(plain, MoE, reversible), CLIP, in float32 and bfloat16, with optax's
state after two Adam steps under a constant learning rate, a warm-up
schedule and the global-norm clip, and the EMA; a JAX checkpoint
restoring in the port and the port's in JAX (its ``restore_train`` and
``validate``); the two ``validate``s on damaged checkpoints, and
``latest_valid`` / ``gc_steps`` choosing the same directories; the
refusal of an optimizer state of other flags; bfloat16 leaves decoding
with ``ml_dtypes`` absent.

Every comparison is exact: bytes, or bit-equal arrays.
"""

import functools
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dalle_pytorch_tpu import checkpoint as JC
from dalle_pytorch_tpu.cli import common as JCOM
from dalle_pytorch_tpu.models import clip as JCL
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.resilience import faults as JF
from dalle_pytorch_tpu_torch import checkpoint as TC
from dalle_pytorch_tpu_torch.cli import common as TCOM
from dalle_pytorch_tpu_torch.compat import from_jax, msgpack, to_jax
from dalle_pytorch_tpu_torch.models import clip as TCL
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_KW = dict(image_size=16, num_tokens=24, codebook_dim=16, num_layers=2,
              hidden_dim=8, num_resnet_blocks=1)
DALLE_KW = dict(dim=16, depth=2, num_text_tokens=50, text_seq_len=8,
                heads=2, dim_head=8)
CLIP_KW = dict(dim_text=16, dim_image=16, dim_latent=8, num_text_tokens=50,
               text_enc_depth=1, text_seq_len=8, text_heads=2,
               visual_enc_depth=1, visual_heads=2, visual_image_size=16,
               visual_patch_size=8)
MODELS = ("vae", "dalle", "moe", "reversible", "clip")
SCHEDULES = {"constant": {}, "warmup": dict(warmup_steps=3),
             "clip": dict(clip_grad_norm=1.0),
             "cosine_clip": dict(lr_schedule="cosine", clip_grad_norm=1.0)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def opt_args(**kw):
    a = dict(lr=1e-3, lr_schedule="constant", warmup_steps=0, decay_steps=0,
             lr_end_ratio=0.1, n_epochs=1, clip_grad_norm=0.0,
             ema_decay=0.9)
    a.update(kw)
    return types.SimpleNamespace(**a)


@functools.lru_cache(maxsize=None)
def jax_model(kind: str, dtype=jnp.float32):
    """(JAX params, the port's config) of one tiny model."""
    vc = JV.VAEConfig(**VAE_KW)
    tvc = TV.VAEConfig(**VAE_KW)
    if kind == "vae":
        init, cfg = functools.partial(JV.vae_init, cfg=vc), tvc
    elif kind == "clip":
        init = functools.partial(JCL.clip_init,
                                 cfg=JCL.CLIPConfig(**CLIP_KW))
        cfg = TCL.CLIPConfig(**CLIP_KW)
    else:
        extra = {"moe": dict(moe_experts=2), "reversible":
                 dict(reversible=True)}.get(kind, {})
        init = functools.partial(JD.dalle_init, cfg=JD.DALLEConfig(
            vae=vc, **DALLE_KW, **extra))
        cfg = TD.DALLEConfig(vae=tvc, **DALLE_KW, **extra)
    params = jax.jit(lambda key: jax.tree.map(
        lambda x: x.astype(dtype), init(key)))(jax.random.PRNGKey(3))
    return params, cfg


def port_model(tree, cfg):
    if isinstance(cfg, TV.VAEConfig):
        return from_jax.discrete_vae_from_jax(tree, cfg, device="cpu")
    if isinstance(cfg, TCL.CLIPConfig):
        return from_jax.clip_from_jax(tree, cfg, device="cpu")
    return from_jax.dalle_from_jax(tree, cfg, device="cpu")


def trained_jax_state(params, schedule: dict):
    """optax's state and the parameters after two Adam steps on fixed
    gradients, and an EMA tree."""
    opt = JCOM.make_optimizer(opt_args(**schedule), steps_per_epoch=4)

    @jax.jit
    def run(params):
        state = opt.init(params)
        grads = jax.tree.map(lambda x: jnp.full_like(x, 0.01), params)
        for _ in range(2):
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
        ema = jax.tree.map(lambda x: x.astype(jnp.float32) * 0.5, params)
        return params, state, ema

    return run(params)


def files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in (TC.PARAMS, TC.OPT_STATE, TC.EMA)
            if os.path.exists(os.path.join(path, f))}


# -- the codec ----------------------------------------------------------------

def codec_tree():
    rng = np.random.default_rng(0)
    bf16 = np.asarray(jnp.asarray(rng.normal(size=(3, 2)), jnp.bfloat16))
    return {
        "z": {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": np.arange(5, dtype=np.int32)},
        "list": [rng.normal(size=(2,)).astype(np.float16),
                 np.array(3, np.int64), {"k": np.zeros((0, 2), np.uint8)}],
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768,
                 -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
        "float": 1.5, "str": "x" * 40, "long": "y" * 300, "bool": True,
        "none": None, "bytes": b"\x00" * 70000,
        "scalars": [np.float32(2.5), np.int8(-3), np.bool_(True)],
        "sizes": {str(i): np.ones(i, np.uint8) for i in
                  (1, 2, 4, 8, 16, 17, 300, 70000)},
        "bf16": bf16, "mask": np.array([True, False]),
        "many": {f"k{i}": i for i in range(20)},
    }


def _bf16_as_tensor(tree):
    if isinstance(tree, dict):
        return {k: _bf16_as_tensor(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_as_tensor(v) for v in tree]
    if isinstance(tree, np.ndarray) and tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return tree


def _equal_trees(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _equal_trees(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal_trees(g, w)
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("leaves", ["numpy", "torch_bf16"])
def test_codec_bytes_equal_flax(leaves):
    tree = codec_tree()
    want = serialization.msgpack_serialize(tree)
    got = msgpack.packb(tree if leaves == "numpy" else _bf16_as_tensor(tree))
    assert got == want
    _equal_trees(msgpack.unpackb(want),
                 serialization.msgpack_restore(want))


def test_codec_chunked_leaves_equal_flax(monkeypatch):
    rng = np.random.default_rng(1)
    tree = {"big": rng.normal(size=(10, 7)).astype(np.float32),
            "nested": {"w": np.arange(33, dtype=np.int64)},
            "in_list": [rng.normal(size=(50,)).astype(np.float32)],
            "small": np.ones(3, np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    want = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in want
    assert msgpack.packb(tree) == want
    _equal_trees(msgpack.unpackb(want), serialization.msgpack_restore(want))


def test_codec_state_dict_form_equals_to_bytes():
    """``packb(to_state_dict(.), sort_keys=False)`` is flax's
    ``to_bytes`` (lists and tuples as '0', '1', ... maps)."""
    params = {"b": [np.ones(2, np.float32), np.zeros(1, np.float32)],
              "a": np.ones(3, np.float32)}
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    state = jax.tree.map(np.asarray, opt.init(params))
    want = serialization.to_bytes(state)
    zeros = {"a": np.zeros(3, np.float32),
             "b": [np.zeros(2, np.float32), np.zeros(1, np.float32)]}
    ported = {"0": {}, "1": {"0": {"count": np.asarray(0, np.int32),
                                   "mu": zeros, "nu": zeros}, "1": {}}}
    got = msgpack.packb(msgpack.to_state_dict(ported), sort_keys=False)
    assert got == want


@pytest.mark.parametrize("data", [b"", b"\x92\x01", b"\xc1", b"\xa5abc",
                                  b"\x01\x02"])
def test_codec_rejects_malformed_bytes(data):
    with pytest.raises(msgpack.MsgpackError):
        msgpack.unpackb(data)


# -- checkpoints: bytes -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", MODELS)
def test_params_and_ema_bytes_equal_jax(tmp_path, kind, dtype):
    """The port's payloads for the same weights are the JAX package's,
    byte for byte, so the manifests' crc32s agree."""
    params, cfg = jax_model(kind, getattr(jnp, dtype))
    ema = jax.jit(lambda p: jax.tree.map(
        lambda x: x.astype(jnp.float32) + 1, p))(params)
    JC.save(str(tmp_path / "j"), params, ema=ema, kind=kind)
    tree, _ = TC.restore_params(str(tmp_path / "j"))
    model = port_model(tree, cfg)
    assert next(model.parameters()).dtype == getattr(torch, dtype)
    t_ema, _ = TCOM.make_ema(opt_args(), model, str(tmp_path / "j"))
    TC.save(str(tmp_path / "t"), model, ema=t_ema, kind=kind)
    assert files(tmp_path / "t") == files(tmp_path / "j")
    assert TC.load_manifest(str(tmp_path / "t"))["payloads"] == \
        JC.load_manifest(str(tmp_path / "j"))["payloads"]


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("kind,dtype", [("vae", "float32"),
                                        ("dalle", "bfloat16"),
                                        ("moe", "float32"),
                                        ("clip", "float32")])
def test_optimizer_state_round_trips_byte_for_byte(tmp_path, kind, dtype,
                                                   schedule):
    """optax's state after two steps restores into the port's Optimizer
    (torch Adam's exp_avg / exp_avg_sq and the count) and is written back
    as the same bytes."""
    params, cfg = jax_model(kind, getattr(jnp, dtype))
    params, state, ema = trained_jax_state(params, SCHEDULES[schedule])
    JC.save(str(tmp_path / "j"), params, opt_state=state, ema=ema)
    model = port_model(TC.restore_params(str(tmp_path / "j"))[0], cfg)
    opt = TCOM.make_optimizer(opt_args(**SCHEDULES[schedule]),
                              model.parameters(), steps_per_epoch=4)
    assert TC.restore_opt_state(str(tmp_path / "j"), opt, model)
    assert opt.count == 2
    raw = TC.restore(str(tmp_path / "j"), opt_state=True)[1]
    _equal_trees(raw, serialization.msgpack_restore(
        files(tmp_path / "j")[TC.OPT_STATE]))
    t_ema, _ = TCOM.make_ema(opt_args(), model, str(tmp_path / "j"))
    TC.save(str(tmp_path / "t"), model, opt_state=opt, ema=t_ema)
    assert files(tmp_path / "t") == files(tmp_path / "j")


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_jax_resumes_the_ports_optimizer_state(tmp_path, schedule):
    """The port trains two steps and saves; JAX's ``restore_train`` takes
    the state into its optimizer, moments bit-equal to torch's."""
    params, cfg = jax_model("dalle")
    model = port_model(jax.device_get(params), cfg)
    opt = TCOM.make_optimizer(opt_args(**SCHEDULES[schedule]),
                              model.parameters(), steps_per_epoch=4)
    for _ in range(2):
        loss = sum((p.float() ** 2).sum() for p in model.parameters())
        loss.backward()
        opt.step()
    TC.save(str(tmp_path / "t"), model, opt_state=opt, config=cfg,
            kind="dalle")
    assert JC.validate(str(tmp_path / "t")) == (True, "ok")
    jopt = JCOM.make_optimizer(opt_args(**SCHEDULES[schedule]),
                               steps_per_epoch=4)
    jparams, jstate, manifest = JC.restore_train(str(tmp_path / "t"), jopt)
    JC.dalle_config_from_manifest(manifest)          # JAX takes the config
    adam = jstate[1][0] if SCHEDULES[schedule].get("clip_grad_norm") \
        else jstate[0]
    assert int(adam.count) == 2
    mu = to_jax.tree(model, {n: opt.adam.state[p]["exp_avg"]
                             for n, p in model.named_parameters()})
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b.numpy()), adam.mu, mu)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b.detach().numpy()), jparams, to_jax.tree(model))


@pytest.mark.parametrize("written,resumed", [("constant", "clip"),
                                             ("clip", "constant"),
                                             ("constant", "warmup"),
                                             ("warmup", "constant")])
def test_other_optimizer_flags_are_refused_like_jax(tmp_path, written,
                                                    resumed):
    params, cfg = jax_model("vae")
    params, state, _ = trained_jax_state(params, SCHEDULES[written])
    JC.save(str(tmp_path / "j"), params, opt_state=state)
    model = port_model(jax.device_get(params), cfg)
    opt = TCOM.make_optimizer(opt_args(**SCHEDULES[resumed]),
                              model.parameters())
    with pytest.raises(ValueError, match="same optimizer-shaping flags"):
        TC.restore_opt_state(str(tmp_path / "j"), opt, model)
    with pytest.raises(ValueError, match="same optimizer-shaping flags"):
        JC.restore_train(str(tmp_path / "j"), JCOM.make_optimizer(
            opt_args(**SCHEDULES[resumed])))


def test_restore_train_loads_weights_in_place(tmp_path):
    params, cfg = jax_model("clip")
    params, state, _ = trained_jax_state(params, {})
    JC.save(str(tmp_path / "j"), params, opt_state=state)
    model = TCL.clip_init(cfg, seed=0, device="cpu")
    opt = TCOM.make_optimizer(opt_args(), model.parameters())
    TC.restore_train(str(tmp_path / "j"), model, opt)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b.detach().numpy()), params, to_jax.tree(model))
    assert opt.count == 2


def test_config_manifest_is_jax_readable(tmp_path):
    _, cfg = jax_model("reversible")
    cfg = TD.DALLEConfig(**{**cfg.__dict__, "sparse_attn": (True, False)})
    model = TD.dalle_init(cfg, device="cpu")
    TC.save(str(tmp_path / "t"), model, config=cfg, kind="dalle")
    manifest = JC.load_manifest(str(tmp_path / "t"))
    jcfg = JC.dalle_config_from_manifest(manifest)
    assert jcfg.sparse_attn == (True, False) and jcfg.reversible
    assert TC.dalle_config_from_manifest(manifest) == cfg
    clip_cfg = TCL.CLIPConfig(**CLIP_KW)
    TC.save(str(tmp_path / "c"), TCL.clip_init(clip_cfg, device="cpu"),
            config=clip_cfg)
    manifest = TC.load_manifest(str(tmp_path / "c"))
    assert JCL.CLIPConfig(**manifest["config"]) == JCL.CLIPConfig(**CLIP_KW)
    assert TC.clip_config_from_manifest(manifest) == clip_cfg


def test_bfloat16_decodes_without_ml_dtypes(tmp_path):
    params, _ = jax_model("vae", jnp.bfloat16)
    JC.save(str(tmp_path / "j"), params)
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from dalle_pytorch_tpu_torch import checkpoint as C\n"
        f"t, _ = C.restore_params({str(tmp_path / 'j')!r})\n"
        "w = t['codebook']['w']\n"
        "assert 'jax' not in sys.modules\n"
        "print(w.dtype, int(w.view(__import__('torch').int16)[0, 0]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = np.asarray(params["codebook"]["w"]).view(np.int16)[0, 0]
    assert out.stdout.split() == ["torch.bfloat16", str(int(want))]


# -- validation and the directory templates -----------------------------------

def _damaged(tmp_path):
    """{name: checkpoint dir} written by the port, some damaged the ways
    the JAX package's fault helpers damage them."""
    params, cfg = jax_model("vae")
    model = port_model(jax.device_get(params), cfg)
    out = {}
    for name in ("good", "truncated", "flipped", "no_manifest", "bad_json",
                 "no_params", "missing_opt"):
        path = str(tmp_path / name)
        opt = TCOM.make_optimizer(opt_args(), model.parameters())
        TC.save(path, model, opt_state=opt, ema={
            n: p.detach().float() for n, p in model.named_parameters()})
        out[name] = path
    JF.truncate_params(out["truncated"])
    data = bytearray(open(os.path.join(out["flipped"], TC.EMA), "rb").read())
    data[-1] ^= 0xFF
    open(os.path.join(out["flipped"], TC.EMA), "wb").write(bytes(data))
    JF.remove_manifest(out["no_manifest"])
    open(os.path.join(out["bad_json"], TC.MANIFEST), "w").write("{oops")
    os.remove(os.path.join(out["no_params"], TC.PARAMS))
    os.remove(os.path.join(out["missing_opt"], TC.OPT_STATE))
    return out


def test_validate_agrees_with_jax(tmp_path):
    for name, path in _damaged(tmp_path).items():
        ok, reason = TC.validate(path)
        assert (ok, reason) == JC.validate(path), name
        assert ok == (name == "good"), (name, reason)


def test_latest_valid_and_gc_pick_the_same_directories(tmp_path):
    params, cfg = jax_model("vae")
    model = port_model(jax.device_get(params), cfg)
    models = str(tmp_path)
    for epoch in range(3):
        TC.save(TC.ckpt_path(models, "run", epoch), model)
    for step in (4, 8, 12, 16):
        TC.save(TC.step_ckpt_path(models, "run", step), model)
    JF.truncate_params(TC.ckpt_path(models, "run", 2))
    JF.truncate_params(TC.step_ckpt_path(models, "run", 16))
    assert TC.latest_valid(models, "run") == JC.latest_valid(models, "run")
    assert TC.latest_valid(models, "run")[1] == 1
    assert TC.latest(models, "run") == JC.latest(models, "run")
    assert TC.latest_valid_step(models, "run") == \
        JC.latest_valid_step(models, "run")
    assert TC.step_checkpoints(models, "run") == \
        JC.step_checkpoints(models, "run")
    removed = TC.gc_steps(models, "run", keep=2)
    assert [os.path.basename(p) for p in removed] == ["run-step4",
                                                      "run-step8"]
    assert JC.gc_steps(models, "run", keep=2) == []
    assert sorted(os.listdir(models)) == ["run-0", "run-1", "run-2",
                                          "run-step12", "run-step16"]


def test_interrupted_save_leaves_the_previous_checkpoint(tmp_path,
                                                         monkeypatch):
    """A writer killed after its payloads, before its manifest, leaves
    the previous checkpoint whole and no staging directory."""
    params, cfg = jax_model("vae")
    model = port_model(jax.device_get(params), cfg)
    path = TC.ckpt_path(str(tmp_path), "vae", 0)
    TC.save(path, model)
    before = files(path)

    def killed(*a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(TC.json, "dump", killed)
    with pytest.raises(KeyboardInterrupt):
        TC.save(path, model, ema={n: p.detach() * 2 for n, p in
                                  model.named_parameters()})
    assert files(path) == before
    assert [e for e in os.listdir(tmp_path) if e.startswith(".ckpt")] == []


def test_vae_halves_lay_out_as_their_part_of_the_jax_tree():
    params, cfg = jax_model("vae")
    host = jax.device_get(params)
    for half, keys in ((from_jax.vae_from_jax, ("codebook", "dec_convs",
                                                "dec_out", "dec_res",
                                                "dec_stem")),
                       (from_jax.vae_encoder_from_jax, ("enc_convs",
                                                        "enc_out",
                                                        "enc_res"))):
        got = to_jax.tree(half(host, cfg, device="cpu"))
        assert list(got) == sorted(keys)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), b.numpy()), {k: host[k] for k in keys}, got)
