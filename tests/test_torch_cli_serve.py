"""The port's serving CLI (``cli/serve.py``) on the CPU, beside the JAX
package's: ``build_parser()`` has JAX's flags, choices and defaults; each
fleet flag ends in ``SystemExit`` naming ROADMAP queue items 5 and 6;
and ``main(argv)`` on a tiny checkpoint directory written by the port's
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


FLEET_ARGV = [["--replicas", "2"], ["--replica_roles", "prefill,decode"],
              ["--mesh_devices", "2"], ["--isolation", "process"],
              ["--transport", "socket"], ["--worker_ckpt", "x"],
              ["--worker_endpoint", "0.0.0.0:9"], ["--worker_cmd", ""],
              ["--attach_token", "t"], ["--child_rss_limit_mb", "10"],
              ["--autoscale"], ["--max_replicas", "4"],
              ["--min_replicas", "2"], ["--gateway"], ["--cells", "3"],
              ["--tenants", "t.json"]]


@pytest.mark.parametrize("argv", FLEET_ARGV, ids=lambda a: a[0])
def test_fleet_flags_exit_naming_queue_items_5_and_6(argv):
    with pytest.raises(SystemExit) as ei:
        CLI.main(argv, device="cpu")
    msg = str(ei.value)
    assert argv[0] in msg and "items 5" in msg and "6" in msg


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
