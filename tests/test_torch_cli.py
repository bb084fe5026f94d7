"""The port's CLIs end to end on the CPU, beside the JAX package's, at
the sizes of ``tests/test_cli.py`` (16 px images, a 2-layer VAE of 24
codes of 16, a DALLE of dim 16, depth 2, 2 heads of 8, text 8).

Covered: the port's ``train_vae`` -> ``train_dalle`` (flash attention
with the split kernel backward's plain versions, an EMA) ->
``gen_dalle`` (EMA weights, CLIP rerank with ``--scores_json``) ->
``train_clip`` -> ``mix_vae`` write the artifacts the JAX CLIs write
(checkpoint directories, their payloads, manifests' kinds, configs and
meta keys, the vocabulary, the grids), and the JAX package validates
and reads every checkpoint the port wrote; ``gen_dalle`` of both
packages on one JAX-written checkpoint and seed: the tokens
``generate_images`` samples are identical and the grid PNGs agree
within 1 of 255; each multi-process flag alone in one process ends in
``SystemExit`` as JAX's setup refuses it, while ``--guard_transfers``
trains (``tests/test_torch_guard.py`` runs it in every trainer); a JPEG
in the image folder fails with the typed error.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dalle_pytorch_tpu import checkpoint as JC

IMG = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """8 images written by PIL and their captions (``tests/test_cli.py``'s
    dataset)."""
    root = tmp_path_factory.mktemp("cli_data")
    img_dir = root / "imagedata" / "0"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = []
    for i in range(8):
        arr = np.zeros((IMG, IMG, 3), np.uint8)
        arr[:, :, i % 3] = 255
        arr[i:i + 6, i:i + 6] = rng.integers(0, 255, (6, 6, 3))
        Image.fromarray(arr).save(img_dir / f"img{i}.png")
        names.append(f"img{i}.png")
    colors = ["red", "blue", "green", "gray"]
    (root / "only.txt").write_text(
        "".join(f"a {colors[i % 4]} square\n" for i in range(8)))
    (root / "pairs.txt").write_text(
        "".join(f"{n} : a {colors[i % 4]} square\n"
                for i, n in enumerate(names)))
    return root


def dirs(root):
    return ["--models_dir", str(root / "models"),
            "--results_dir", str(root / "results")]


def vae_argv(data, root):
    return ["--dataPath", str(data / "imagedata"), "--imageSize", str(IMG),
            "--batchSize", "4", "--num_layers", "2", "--num_tokens", "24",
            "--codebook_dim", "16", "--hidden_dim", "8", "--lr", "3e-3",
            "--log_interval", "1", "--dp", "1", "--n_epochs", "2",
            "--tempsched", "--metrics", str(root / "metrics.jsonl")] + \
        dirs(root)


def dalle_argv(data, root, extra=()):
    return ["--dataPath", str(data / "imagedata"), "--imageSize", str(IMG),
            "--batchSize", "4", "--captions_only", str(data / "only.txt"),
            "--captions", str(data / "pairs.txt"), "--vaename", "vae",
            "--vae_epoch", "1", "--name", "toy", "--n_epochs", "1",
            "--dim", "16", "--depth", "2", "--heads", "2", "--dim_head", "8",
            "--num_text_tokens", "50", "--text_seq_len", "8", "--lr", "1e-3",
            "--log_interval", "1", "--dp", "1", "--ema_decay", "0.9"] + \
        dirs(root) + list(extra)


def clip_argv(data, root):
    return ["--dataPath", str(data / "imagedata"), "--imageSize", str(IMG),
            "--batchSize", "4", "--captions_only", str(data / "only.txt"),
            "--captions", str(data / "pairs.txt"), "--name", "clip",
            "--n_epochs", "1", "--dim_text", "16", "--dim_image", "16",
            "--dim_latent", "8", "--num_text_tokens", "50",
            "--text_seq_len", "8", "--text_enc_depth", "1",
            "--text_heads", "2", "--visual_enc_depth", "1",
            "--visual_heads", "2", "--visual_patch_size", "8",
            "--log_interval", "1", "--dp", "1"] + dirs(root)


def gen_argv(root, extra=()):
    return ["a red square", "--name", "toy", "--dalle_epoch", "0",
            "--num_images", "2", "--seed", "3"] + dirs(root) + list(extra)


def mix_argv(data, root):
    return ["--vaename", "vae", "--load_epoch", "1", "--models_dir",
            str(root / "models"), "--dataPath", str(data / "imagedata"),
            "--imageSize", str(IMG), "--batchSize", "4", "--out_dir",
            str(root / "mixed"), "--max_batches", "1"]


def run_pipeline(pkg, data, root, device_kw):
    """train_vae -> train_dalle -> gen_dalle -> train_clip -> gen_dalle
    with the rerank -> mix_vae of one package."""
    import importlib
    cli = {name: importlib.import_module(f"{pkg}.cli.{name}") for name in
           ("train_vae", "train_dalle", "gen_dalle", "train_clip",
            "mix_vae")}
    cli["train_vae"].main(vae_argv(data, root), **device_kw)
    cli["train_dalle"].main(dalle_argv(data, root, (
        "--attn_impl", "flash", "--attn_bwd_impl", "pallas")), **device_kw)
    cli["gen_dalle"].main(gen_argv(root, ("--use_ema",)), **device_kw)
    cli["train_clip"].main(clip_argv(data, root), **device_kw)
    cli["gen_dalle"].main(gen_argv(root, (
        "--clip_name", "clip", "--scores_json",
        str(root / "scores.jsonl"))), **device_kw)
    cli["mix_vae"].main(mix_argv(data, root), **device_kw)


@pytest.fixture(scope="module")
def runs(data):
    """{package: its run directory} after both pipelines."""
    out = {}
    for pkg, kw in (("dalle_pytorch_tpu", {}),
                    ("dalle_pytorch_tpu_torch", {"device": "cpu"})):
        root = data / pkg
        (root / "models").mkdir(parents=True)
        (root / "results").mkdir()
        run_pipeline(pkg, data, root, kw)
        out[pkg] = root
    return out


def listing(root):
    """{directory: its file names}, ``gen_dalle``'s grids without their
    time stamps (two runs in one second write one file)."""
    out = {}
    for sub in ("models", "results", "mixed"):
        for dirpath, _, names in os.walk(root / sub):
            rel = os.path.relpath(dirpath, root)
            out[rel] = sorted({n if not n.startswith("gendalle") else
                               n.rsplit("-", 1)[0] for n in names})
    return out


def test_pipeline_writes_the_artifacts_jax_writes(runs):
    j, t = runs["dalle_pytorch_tpu"], runs["dalle_pytorch_tpu_torch"]
    assert listing(t) == listing(j)
    assert sorted(os.listdir(t / "models")) == [
        "clip-0", "clip-vocab.json", "toy-vocab.json", "toy_dalle-0",
        "vae-0", "vae-1"]
    for name in os.listdir(j / "models"):
        if name.endswith(".json"):
            assert (t / "models" / name).read_bytes() == \
                (j / "models" / name).read_bytes()
            continue
        jm = JC.load_manifest(str(j / "models" / name))
        tm = JC.load_manifest(str(t / "models" / name))
        assert (tm["kind"], tm["step"], tm["config"]) == \
            (jm["kind"], jm["step"], jm["config"])
        assert set(tm["meta"]) == set(jm["meta"])
        assert set(tm["payloads"]) == set(jm["payloads"])
        assert JC.validate(str(t / "models" / name)) == (True, "ok")
        # the JAX package reads every tree the port wrote
        params, _ = JC.restore_params(str(t / "models" / name))
        jparams, _ = JC.restore_params(str(j / "models" / name))
        import jax
        assert jax.tree.structure(params) == jax.tree.structure(jparams)
        jax.tree.map(lambda a, b: (a.shape, a.dtype) == (b.shape, b.dtype)
                     or pytest.fail(name), params, jparams)
    vae_meta = JC.load_manifest(str(t / "models" / "vae-1"))["meta"]
    assert vae_meta["temperature"] == pytest.approx(0.9 * 0.7, rel=1e-12)
    scores = [json.loads(line) for line in
              (t / "scores.jsonl").read_text().splitlines()]
    assert len(scores) == 1 and len(scores[0]["scores"]) == 2
    for line in (t / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        assert "loss" not in rec or np.isfinite(rec["loss"])


def test_gen_dalle_samples_jax_tokens_from_one_checkpoint(runs, tmp_path):
    """Both packages' ``gen_dalle`` on the JAX-written DALLE checkpoint
    (and its VAE) with one seed: identical tokens, grid PNGs within 1 of
    255."""
    import jax
    import jax.numpy as jnp

    from dalle_pytorch_tpu.cli import gen_dalle as JG
    from dalle_pytorch_tpu.data import Vocabulary as JVocab
    from dalle_pytorch_tpu.models import dalle as JD
    from dalle_pytorch_tpu_torch import checkpoint as TC
    from dalle_pytorch_tpu_torch.cli import gen_dalle as TG
    from dalle_pytorch_tpu_torch.compat import from_jax
    from dalle_pytorch_tpu_torch.models import dalle as TD
    from dalle_pytorch_tpu_torch.ops import prng

    root = runs["dalle_pytorch_tpu"]
    path = JC.ckpt_path(str(root / "models"), "toy_dalle", 0)
    jparams, manifest = JC.restore_params(path)
    jvae, _ = JC.restore_params(manifest["meta"]["vae_checkpoint"])
    codes = JVocab.load(str(root / "models" / "toy-vocab.json")).encode(
        "a red square")
    _, jseq = JD.generate_images(
        jax.device_put(jparams), jax.device_put(jvae),
        jnp.asarray([codes] * 2, jnp.int32),
        cfg=JC.dalle_config_from_manifest(manifest),
        rng=jax.random.PRNGKey(3), return_img_seq=True)
    tparams, tmanifest = TC.restore_params(path)
    tvae_params, vmanifest = TC.restore_params(
        tmanifest["meta"]["vae_checkpoint"])
    model = from_jax.dalle_from_jax(
        tparams, TC.dalle_config_from_manifest(tmanifest), device="cpu")
    vae = from_jax.vae_from_jax(
        tvae_params, TC.vae_config_from_manifest(vmanifest), device="cpu")
    _, tseq = TD.generate_images(
        model, vae, torch.tensor([codes] * 2, dtype=torch.int32),
        rng=prng.prng_key(3), return_img_seq=True)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))

    grids = {}
    for name, gen, kw in (("jax", JG, {}), ("port", TG, {"device": "cpu"})):
        out = tmp_path / name
        gen.main(["a red square", "--name", "toy", "--dalle_epoch", "0",
                  "--num_images", "2", "--seed", "3", "--models_dir",
                  str(root / "models"), "--results_dir", str(out)], **kw)
        (png,) = os.listdir(out)
        grids[name] = np.asarray(Image.open(out / png)).astype(int)
    assert grids["port"].shape == grids["jax"].shape
    assert np.abs(grids["port"] - grids["jax"]).max() <= 1


def _unreachable():
    """A localhost coordinator nobody listens on."""
    from dalle_pytorch_tpu_torch.parallel.launch import free_port
    return f"127.0.0.1:{free_port()}"


# each multi-process flag alone in one process ends as JAX's setup does:
# the mesh flags against the world size, the join flags without their
# partners, a join with a deadline against a coordinator nobody runs
# (rank 1 of 2); and the transfer guard (ROADMAP.md queue 1 item 4),
# refused until the port took it, which now trains
@pytest.mark.parametrize("flag, match", [
    (["--dp", "2"], "world size"),
    (["--coordinator", "localhost:1234"], "process count"),
    (["--num_processes", "2"], "coordinator address"),
    (["--process_id", "1", "--num_processes", "2", "--coordinator",
      "UNREACHABLE", "--init_retries", "1", "--init_deadline_s", "1"],
     "bring-up failed"),
    (["--init_deadline_s", "1", "--init_retries", "1", "--coordinator",
      "UNREACHABLE", "--num_processes", "2", "--process_id", "1"],
     "bring-up failed"),
    (["--sp", "2"], "must divide the device count"),
    (["--pp", "2"], "must divide the device count"),
    (["--guard_transfers"], "queue 1 item 4")])
def test_unported_flags_end_in_system_exit(data, tmp_path, flag, match):
    from dalle_pytorch_tpu_torch.cli import train_dalle
    if flag == ["--guard_transfers"]:
        from dalle_pytorch_tpu_torch.cli import train_vae
        train_vae.main(vae_argv(data, tmp_path) + flag, device="cpu")
        assert (tmp_path / "models" / "vae-1").is_dir()
        return
    flag = [_unreachable() if f == "UNREACHABLE" else f for f in flag]
    with pytest.raises(SystemExit, match=match):
        train_dalle.main(dalle_argv(data, tmp_path, flag), device="cpu")


@pytest.mark.parametrize("cli", ["train_vae", "train_clip"])
def test_unported_flags_refused_by_every_trainer(data, tmp_path, cli):
    import importlib
    main = importlib.import_module(f"dalle_pytorch_tpu_torch.cli.{cli}").main
    argv = (vae_argv if cli == "train_vae" else clip_argv)(data, tmp_path)
    with pytest.raises(SystemExit, match="--dp"):
        main(argv + ["--dp", "4"], device="cpu")


def test_a_jpeg_in_the_folder_fails_with_the_typed_error(data, tmp_path,
                                                        monkeypatch):
    """Where libjpeg is missing, a JPEG folder fails with the typed error
    naming it (with libjpeg the folder trains:
    ``tests/test_torch_images.py``)."""
    from dalle_pytorch_tpu_torch import native
    from dalle_pytorch_tpu_torch.cli import train_vae
    from dalle_pytorch_tpu_torch.data.images import UnsupportedImage
    from dalle_pytorch_tpu_torch.native import build as NB
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(NB, "LIBS", ("-ljpeg_not_on_this_machine",))
    folder = tmp_path / "imagedata" / "0"
    folder.mkdir(parents=True)
    for i in range(4):
        Image.fromarray(np.zeros((IMG, IMG, 3), np.uint8)).save(
            folder / f"im{i}.jpg")
    argv = vae_argv(data, tmp_path)
    argv[argv.index("--dataPath") + 1] = str(tmp_path / "imagedata")
    with pytest.raises(UnsupportedImage, match="JPEG.*libjpeg"):
        train_vae.main(argv, device="cpu")


@pytest.mark.parametrize("cli", ["train_vae", "train_dalle", "gen_dalle",
                                 "train_clip", "mix_vae"])
def test_entry_points_need_a_card_unless_told_cpu(data, tmp_path, cli):
    """Without ``device="cpu"`` every CLI runs on the card, and with no
    card it raises (no silent CPU fallback)."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    argv = {"train_vae": lambda: vae_argv(data, tmp_path),
            "train_dalle": lambda: dalle_argv(data, tmp_path),
            "gen_dalle": lambda: gen_argv(tmp_path),
            "train_clip": lambda: clip_argv(data, tmp_path),
            "mix_vae": lambda: mix_argv(data, tmp_path)}[cli]()
    main = importlib.import_module(f"dalle_pytorch_tpu_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_caption_drop_draws_jax_mask():
    """``train_dalle``'s null-caption draw is JAX's step's, bit for bit."""
    import jax
    import jax.numpy as jnp

    from dalle_pytorch_tpu_torch.cli.train_dalle import caption_dropped
    from dalle_pytorch_tpu_torch.ops import prng
    text = np.arange(1, 1 + 64 * 8, dtype=np.int32).reshape(64, 8)
    for step, p in ((0, 0.1), (7, 0.5), (123, 0.9)):
        key = jax.random.fold_in(jax.random.PRNGKey(11), step)
        drop = jax.random.bernoulli(jax.random.fold_in(key, 0x0CFD), p,
                                    (64, 1))
        want = np.asarray(jnp.where(drop, 0, jnp.asarray(text)))
        got = caption_dropped(torch.from_numpy(text),
                              prng.fold_in(prng.prng_key(11), step), p)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < (want[:, 0] == 0).sum() < 64
