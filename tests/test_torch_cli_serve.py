"""The port's serving CLI (``cli/serve.py``) on the CPU, beside the JAX
package's: ``build_parser()`` has JAX's flags, choices and defaults; the
process-isolation flags reach a process replica set, the gateway flags
(``--gateway``, ``--cells``, ``--tenants``) build a gateway over thread
cells that answers a request over HTTP, ``--mesh_devices 2`` builds a
server on a ``MeshEngine`` over two CPU devices (``serve_specs
.visible_devices`` substituted), while the replica-set flags (``--replicas``,
``--replica_roles``, ``--max_replicas``, ``--min_replicas``,
``--autoscale``) serve, a set
answering JAX's tokens and ``POST /admin/scale``'s upgrade loading a
checkpoint path; and ``main(argv)`` on a tiny checkpoint directory
written by the port's
``checkpoint.py`` (DALLE with an EMA, its VAE, a CLIP, the vocabulary),
with ``serve_http`` replaced by one caption request over HTTP, serves the
JAX CLI's tokens and CLIP score for the same checkpoint, with
``--use_ema``, the paged kernel read and the prefix cache, and with
``--quantize int8``."""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.cli import serve as JCLI
from dalle_pytorch_tpu.models import clip as JC
from dalle_pytorch_tpu.models import dalle as JD
from dalle_pytorch_tpu.models import vae as JV
from dalle_pytorch_tpu.serve import server as JSRV
from dalle_pytorch_tpu_torch import checkpoint as ckpt
from dalle_pytorch_tpu_torch.cli import serve as CLI
from dalle_pytorch_tpu_torch.compat import from_jax
from dalle_pytorch_tpu_torch.data.vocabulary import Vocabulary
from dalle_pytorch_tpu_torch.models import clip as TC
from dalle_pytorch_tpu_torch.models import dalle as TD
from dalle_pytorch_tpu_torch.models import vae as TV
from dalle_pytorch_tpu_torch.serve import gateway as GW
from dalle_pytorch_tpu_torch.serve import server as SRV


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def options(parser) -> dict:
    """{option string: (default, choices, nargs, const)}."""
    return {a.option_strings[0]: (a.default, a.choices, a.nargs, a.const)
            for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def test_parser_matches_jax():
    assert options(CLI.build_parser()) == options(JCLI.build_parser())
    assert vars(CLI.build_parser().parse_args([])) == \
        vars(JCLI.build_parser().parse_args([]))


# the fleet flags and the ROADMAP.md queue 1 item each belonged to:
# items 2b (process isolation), 2c (the gateway) and 3c (the mesh)
FLEET_ARGV = [(["--mesh_devices", "2"], "item 3c"),
              (["--isolation", "process"], "item 2b"),
              (["--transport", "socket"], "item 2b"),
              (["--worker_ckpt", "x"], "item 2b"),
              (["--worker_endpoint", "127.0.0.2:0"], "item 2b"),
              (["--worker_cmd", ""], "item 2b"),
              (["--attach_token", "t"], "item 2b"),
              (["--child_rss_limit_mb", "10"], "item 2b"),
              (["--gateway"], "item 2c"), (["--cells", "3"], "item 2c"),
              (["--tenants", "t.json"], "item 2c")]
SOCKET = ["--replicas", "2", "--isolation", "process", "--transport",
          "socket"]
# each item-2b flag: what it needs beside it, and how it shows on the set
PROCESS_FLAGS = {
    "--isolation": (["--replicas", "2"],
                    lambda rs: all(r.engine.pid > 0 for r in rs.replicas)),
    "--transport": (["--replicas", "2", "--isolation", "process"],
                    lambda rs: rs.listener is not None),
    "--worker_ckpt": (SOCKET, lambda rs: rs.worker_ckpt == "x"),
    "--worker_endpoint": (SOCKET,
                          lambda rs: rs.listener.host == "127.0.0.2"),
    "--worker_cmd": (SOCKET, lambda rs: all(r.engine.awaiting_operator
                                            for r in rs.replicas)),
    "--attach_token": (SOCKET, lambda rs: rs.listener.token == "t"),
    "--child_rss_limit_mb": (["--replicas", "2", "--isolation", "process"],
                             lambda rs: rs.child_rss_limit_mb == 10),
}
# each item-2c flag: what it needs beside it, and how it shows on the
# built gateway (its cells are thread servers of 2 slots)
GATEWAY_FLAGS = {
    "--gateway": ([], lambda gw: len(gw.cells) == 2
                  and gw.tenants is None),
    "--cells": (["--gateway"], lambda gw: len(gw.cells) == 3),
    "--tenants": (["--gateway"],
                  lambda gw: gw.tenants.names() == ["acme"]
                  and gw.tenants.spec("acme").weight == 2.0),
}
TENANTS_JSON = {"tenants": [{"name": "acme", "key": "ka", "weight": 2}]}


@pytest.mark.parametrize("argv,item", FLEET_ARGV, ids=lambda a: a[0]
                         if isinstance(a, list) else "")
def test_fleet_flags_exit_naming_queue_items_5_and_6(argv, item, models_dir,
                                                     monkeypatch, tmp_path):
    """(Named for the queue numbering of its first version.) A flag of
    ROADMAP.md queue 1 item 2b reaches a process ``ReplicaSet`` (served
    from the toy checkpoint on the CPU, closed at once); a flag of item
    2c builds a ``Gateway`` over thread cells, which answers one request
    over HTTP (with the tenant's key under ``--tenants``); item 3c's
    ``--mesh_devices 2`` serves from a ``MeshEngine`` over two devices
    (two CPU devices here) whose health names the mesh."""
    if item == "item 2c":
        extra, shows = GATEWAY_FLAGS[argv[0]]
        if argv[0] == "--tenants":
            path = tmp_path / "t.json"
            path.write_text(json.dumps(TENANTS_JSON))
            argv = ["--tenants", str(path)]
        got = []
        monkeypatch.setattr(GW, "serve_gateway_http",
                            lambda gw, host, port: got.append(gw))
        CLI.main(["--name", "toy", "--models_dir", str(models_dir),
                  "--num_slots", "2", "--init_deadline_s", "0"]
                 + extra + argv, device="cpu")
        (gw,) = got
        httpd = GW.make_gateway_http_server(gw, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            assert shows(gw)
            assert all(c.capacity == 2 for c in gw.cells)
            assert gw.model_version == "toy_dalle@0"
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/generate",
                data=json.dumps({"codes": [3, 4], "seed": 1}).encode(),
                headers={"X-API-Key": "ka"})
            with urllib.request.urlopen(req, timeout=120) as r:
                body = json.loads(r.read())
            assert body["status"] == "ok"
            assert len(body["tokens"]) == TCFG.image_seq_len
        finally:
            httpd.shutdown()
            httpd.server_close()
            gw.close(timeout=5.0)
        return
    if item == "item 2b":
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        extra, shows = PROCESS_FLAGS[argv[0]]
        got = []
        monkeypatch.setattr(SRV, "serve_http",
                            lambda server, host, port: got.append(server))
        CLI.main(["--name", "toy", "--models_dir", str(models_dir),
                  "--init_deadline_s", "0"] + extra + argv, device="cpu")
        (server,) = got
        try:
            assert server.engine.isolation == "process"
            assert shows(server.engine)
        finally:
            server.close(timeout=5.0)
        return
    from dalle_pytorch_tpu_torch.parallel import serve_specs as SS
    from dalle_pytorch_tpu_torch.serve.mesh_engine import MeshEngine
    monkeypatch.setattr(SS, "visible_devices",
                        lambda: [torch.device("cpu")] * 2)
    got = []
    monkeypatch.setattr(SRV, "serve_http",
                        lambda server, host, port: got.append(server))
    CLI.main(["--name", "toy", "--models_dir", str(models_dir),
              "--num_slots", "2", "--init_deadline_s", "0"] + argv,
             device="cpu")
    (server,) = got
    try:
        assert isinstance(server.engine, MeshEngine)
        assert server.engine.kv_sharded
        assert server.health()["mesh_shape"] == {"mp": 2}
        res = server.generate([3, 4], seed=1, timeout=120)
        assert res.status == "ok"
        assert len(res.tokens) == TCFG.image_seq_len
    finally:
        server.close()


def test_autoscale_without_headroom_exits_as_jax_does(models_dir):
    argv = ["--name", "toy", "--models_dir", str(models_dir),
            "--autoscale", "--replicas", "2"]
    for mod, kw in ((CLI, {"device": "cpu"}), (JCLI, {})):
        with pytest.raises(SystemExit, match="--max_replicas > "
                                             "--replicas"):
            mod.main(argv, **kw)


def test_gateway_with_autoscale_exits_as_jax_does(models_dir):
    argv = ["--name", "toy", "--models_dir", str(models_dir), "--gateway",
            "--autoscale", "--replicas", "1", "--max_replicas", "2"]
    for mod, kw in ((CLI, {"device": "cpu"}), (JCLI, {})):
        with pytest.raises(SystemExit, match="--gateway does not compose "
                                             "with --autoscale"):
            mod.main(argv, **kw)


# -- main(argv) on one checkpoint, both packages -----------------------------

TVCFG = TV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
TCFG = TD.DALLEConfig(dim=32, depth=2, vae=TVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
JVCFG = JV.VAEConfig(image_size=16, num_tokens=32, codebook_dim=32,
                     num_layers=2, hidden_dim=8)
JCFG = JD.DALLEConfig(dim=32, depth=2, vae=JVCFG, num_text_tokens=64,
                      text_seq_len=8, heads=2, dim_head=16)
CLIP_KW = dict(dim_text=16, dim_image=16, dim_latent=8, num_text_tokens=64,
               text_seq_len=8, text_enc_depth=1, visual_enc_depth=1,
               text_heads=2, visual_heads=2, visual_image_size=16,
               visual_patch_size=8, sparse_attn=False)
CAPTIONS = ["a red square", "a blue circle", "a small green square"]


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    """``toy_dalle-0`` (with an EMA), the VAE it names, ``clip-0`` and
    ``toy-vocab.json``, all written by the port."""
    root = tmp_path_factory.mktemp("serve_models")
    key = jax.random.PRNGKey(0)
    vae_p = jax.device_get(JV.vae_init(jax.random.fold_in(key, 1), JVCFG))
    dal_p = jax.device_get(JD.dalle_init(key, JCFG, vae_p))
    clip_p = jax.device_get(JC.clip_init(jax.random.PRNGKey(7),
                                         JC.CLIPConfig(**CLIP_KW)))
    vae_path = ckpt.save(str(root / "vae-0"), vae_p, config=TVCFG,
                         kind="vae")
    model = from_jax.dalle_from_jax(dal_p, TCFG, device="cpu")
    g = torch.Generator().manual_seed(1)
    ema = {n: p.detach() + 0.05 * torch.randn(p.shape, generator=g)
           for n, p in model.named_parameters()}
    ckpt.save(str(root / "toy_dalle-0"), model, config=TCFG, kind="dalle",
              meta={"vae_checkpoint": vae_path}, ema=ema)
    clip = from_jax.clip_from_jax(clip_p, TC.CLIPConfig(**CLIP_KW),
                                  device="cpu")
    ckpt.save(str(root / "clip-0"), clip, config=TC.CLIPConfig(**CLIP_KW),
              kind="clip")
    Vocabulary.from_captions(CAPTIONS).save(str(root / "toy-vocab.json"))
    return root


def serve_once(mod, monkeypatch, body):
    """Replace ``mod.serve_http`` with one POST /generate over HTTP on an
    ephemeral port; returns the list the answer lands in."""
    got = []

    def one_request(server, host, port):
        httpd = mod.make_http_server(server, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/generate",
                data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                got.append(json.loads(r.read()))
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()

    monkeypatch.setattr(mod, "serve_http", one_request)
    return got


@pytest.mark.parametrize("extra", [
    ["--use_ema", "--clip_name", "clip", "--kv", "paged", "--page_size",
     "8", "--paged_attn", "kernel", "--prefix_cache", "--num_slots", "2"],
    ["--quantize", "int8", "--chunk_steps", "4"]],
    ids=["ema_clip_paged_kernel", "int8"])
def test_main_serves_the_jax_cli_tokens(models_dir, monkeypatch, extra):
    argv = ["--name", "toy", "--models_dir", str(models_dir),
            "--port", "0", "--init_deadline_s", "0"] + extra
    body = {"caption": "a red square", "seed": 3}
    port_got = serve_once(SRV, monkeypatch, body)
    CLI.main(argv, device="cpu")
    jax_got = serve_once(JSRV, monkeypatch, body)
    JCLI.main(argv)
    (port,), (jax_,) = port_got, jax_got
    assert port["status"] == jax_["status"] == "ok"
    assert port["tokens"] == jax_["tokens"]
    assert port["weights_version"] == jax_["weights_version"] \
        == "toy_dalle@0"
    assert port["image_shape"] == [16, 16, 3]
    if "--clip_name" in extra:
        np.testing.assert_allclose(port["clip_score"], jax_["clip_score"],
                                   rtol=1e-5, atol=1e-5)


# -- the replica-set flags ----------------------------------------------------

def capture_server(mod, monkeypatch):
    """Replace ``mod.serve_http`` with a hook that keeps the started
    server and closes it."""
    got = []

    def keep(server, host, port):
        got.append(server)
        server.close()

    monkeypatch.setattr(mod, "serve_http", keep)
    return got


@pytest.mark.parametrize("argv,want", [
    (["--replicas", "2"], (2, 2, None, ("both", "both"))),
    (["--replicas", "2", "--kv", "paged", "--page_size", "8",
      "--replica_roles", "prefill,decode"],
     (2, 2, None, ("prefill", "decode"))),
    (["--max_replicas", "4"], (1, 4, None, ("both",))),
    (["--autoscale", "--max_replicas", "3"], (1, 3, (1, 3), ("both",))),
    (["--autoscale", "--replicas", "2", "--max_replicas", "3",
      "--min_replicas", "2"], (2, 3, (2, 3), ("both", "both")))],
    ids=["replicas", "replica_roles", "max_replicas", "autoscale",
         "min_replicas"])
def test_replica_set_flags_now_serve(models_dir, monkeypatch, argv, want):
    base = ["--name", "toy", "--models_dir", str(models_dir), "--port",
            "0", "--init_deadline_s", "0", "--heartbeat_s", "30"]
    got = capture_server(SRV, monkeypatch)
    CLI.main(base + argv, device="cpu")
    server = got[0]
    rs = server.engine
    n, cap, auto, roles = want
    assert server._is_set and rs.n_replicas == n and rs.max_replicas == cap
    assert tuple(r.role for r in rs.replicas) == roles
    assert rs.heartbeat_s == 30.0
    if auto is None:
        assert server.autoscaler is None
    else:
        p = server.autoscaler.policy
        assert (p.min_replicas, p.max_replicas) == auto


def test_replica_set_serves_the_jax_cli_tokens(models_dir, monkeypatch):
    argv = ["--name", "toy", "--models_dir", str(models_dir),
            "--port", "0", "--init_deadline_s", "0", "--replicas", "2",
            "--num_slots", "2", "--chunk_steps", "4"]
    body = {"caption": "a red square", "seed": 3}
    port_got = serve_once(SRV, monkeypatch, body)
    CLI.main(argv, device="cpu")
    jax_got = serve_once(JSRV, monkeypatch, body)
    JCLI.main(argv)
    (port,), (jax_,) = port_got, jax_got
    assert port["status"] == jax_["status"] == "ok"
    assert port["tokens"] == jax_["tokens"]
    assert port["weights_version"] == jax_["weights_version"] \
        == "toy_dalle@0"


def test_admin_upgrade_loads_a_checkpoint_path(models_dir, monkeypatch):
    """``POST /admin/scale`` ``upgrade``: the server's ``load_weights``
    restores the path as startup did, every replica cycles and the
    fleet serves the new version."""
    argv = ["--name", "toy", "--models_dir", str(models_dir), "--port",
            "0", "--init_deadline_s", "0", "--replicas", "2",
            "--num_slots", "2", "--chunk_steps", "4", "--use_ema"]
    got = []

    def upgrade(server, host, port):
        try:
            got.append(server.scale(
                "upgrade", ckpt=str(models_dir / "toy_dalle-0"),
                version="toy_dalle@0-again", canaries=1))
            got.append(server.generate([3, 7, 9], seed=2, timeout=120))
            with pytest.raises(SRV.ScaleError) as ei:
                server.scale("upgrade", ckpt=str(models_dir / "nope"),
                             version="v9")
            got.append(ei.value.record["reason"])
        finally:
            server.close()

    monkeypatch.setattr(SRV, "serve_http", upgrade)
    CLI.main(argv, device="cpu")
    record, result, reason = got
    assert [r["replica"] for r in record["replicas"]] == [0, 1]
    assert result.status == "ok"
    assert result.weights_version == "toy_dalle@0-again"
    assert reason == "weight_load_failed"
