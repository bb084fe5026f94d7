"""The port's training CLIs across ranks on the CPU (gloo), beside the JAX
CLI.

A JAX-written VAE and DALLE checkpoint (``tests/test_cli.py``'s 16 px
dataset, a DALLE of dim 16, depth 2, 2 heads of 8, dropout 0.1) is
resumed for one epoch: by JAX's ``train_dalle --dp 2 --sp 2`` and
``--dp 2 --pp 2`` in one process (dp 1 x sp 2 and dp 1 x pp 2 meshes on
conftest's CPU devices), and by the port's ``train_dalle --sp 2`` and
``--pp 2`` as two rank processes each, joined by
``--coordinator``/``--num_processes``/``--process_id``: every step's
loss in the metrics agrees to 1e-5 relative (the per-position and the
per-stage dropout masks are JAX's); and by the port's ``--dp 2`` over
two ranks. In each port run rank 0 alone writes (the metrics, the
checkpoint with no staging residue, the vocabulary; rank 1's results
directory never exists), and the checkpoint validates and restores in
the JAX package, the pipeline's gathered from both stages. A NaN under
``--pp 2 --save_every 1`` rolls every rank back to the gathered step
checkpoint, each stage placed as it was set up. The mesh refusals (sp
with pp, sp or pp that do not divide the devices, ``--caption_drop``
with either) end in JAX's messages.
"""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from dalle_pytorch_tpu import checkpoint as JC
from dalle_pytorch_tpu_torch.parallel.launch import free_port, spawn

import torch_parallel_ranks as R

IMG = 16


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The dataset and a JAX VAE and DALLE (epoch 0) under ``models``."""
    from dalle_pytorch_tpu.cli import train_dalle, train_vae
    root = tmp_path_factory.mktemp("cli_parallel")
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
    models = root / "models"
    train_vae.main(["--dataPath", str(root / "imagedata"), "--imageSize",
                    str(IMG), "--batchSize", "4", "--num_layers", "2",
                    "--num_tokens", "24", "--codebook_dim", "16",
                    "--hidden_dim", "8", "--n_epochs", "1", "--dp", "1",
                    "--models_dir", str(models), "--results_dir",
                    str(root / "results")])
    train_dalle.main(dalle_argv(root, models, root / "results")
                     + ["--n_epochs", "1", "--dp", "1"])
    return root


def dalle_argv(root, models, results):
    return ["--dataPath", str(root / "imagedata"), "--imageSize", str(IMG),
            "--batchSize", "4", "--captions_only", str(root / "only.txt"),
            "--captions", str(root / "pairs.txt"), "--vaename", "vae",
            "--vae_epoch", "0", "--name", "toy", "--dim", "16", "--depth",
            "2", "--heads", "2", "--dim_head", "8", "--num_text_tokens",
            "50", "--text_seq_len", "8", "--lr", "1e-3", "--log_interval",
            "1", "--sample_every", "0", "--models_dir", str(models),
            "--results_dir", str(results)]


def copy_models(base, name):
    run = base / name
    shutil.copytree(base / "models", run / "models")
    return run


def resume_argv(base, run, results):
    return dalle_argv(base, run / "models", results) + [
        "--load_dalle", "toy", "--n_epochs", "1", "--metrics",
        str(run / "metrics.jsonl")]


def losses(path):
    with open(path) as f:
        return [json.loads(x)["loss"] for x in f if '"loss"' in x]


def port_run(base, name, flags):
    """Two port ranks resuming the checkpoint with ``flags``; rank r's
    results directory is its own, so a write by rank 1 shows."""
    run = copy_models(base, name)
    argv = resume_argv(base, run, run / "results{rank}") + flags
    spawn(R.cli_case, 2, ({"cli": "train_dalle", "argv": argv, "world": 2,
                           "port": free_port()},), device="cpu",
          timeout_s=300)
    return run


@pytest.fixture(scope="module")
def runs(base):
    from dalle_pytorch_tpu.cli import train_dalle
    out = {}
    for name, flags in (("jax_sp", ["--sp", "2"]),
                        ("jax_pp", ["--pp", "2", "--pp_microbatches", "2"])):
        out[name] = copy_models(base, name)
        train_dalle.main(resume_argv(base, out[name], out[name] / "results")
                         + ["--dp", "2"] + flags)
    return {**out,
            "sp": port_run(base, "sp", ["--sp", "2"]),
            "pp": port_run(base, "pp", ["--pp", "2", "--pp_microbatches",
                                        "2"]),
            "dp": port_run(base, "dp", ["--dp", "2"])}


@pytest.mark.parametrize("name", ["sp", "pp"])
def test_cli_losses_match_jax_on_two_devices(runs, name):
    """JAX's ``--dp 2 --sp 2`` / ``--dp 2 --pp 2`` lay 2 devices out as
    dp 1 x sp 2 / dp 1 x pp 2, the port's two ranks alike."""
    want = losses(runs[f"jax_{name}"] / "metrics.jsonl")
    got = losses(runs[name] / "metrics.jsonl")
    assert len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["sp", "pp", "dp"])
def test_only_rank0_writes(runs, name):
    run = runs[name]
    models = run / "models"
    assert not (run / "results1").exists()
    assert (run / "results0").is_dir()
    assert not [d for d in os.listdir(models) if d.startswith(".ckpt-")]
    assert os.path.isfile(models / "toy-vocab.json")
    ok, why = JC.validate(str(models / "toy_dalle-1"))
    assert ok, why
    steps = losses(run / "metrics.jsonl")
    # dp 2 splits the 8 pairs over the ranks: one step of 4 rows each
    assert len(steps) == (1 if name == "dp" else 2)
    assert all(np.isfinite(steps))


@pytest.mark.parametrize("name", ["sp", "pp", "dp"])
def test_checkpoint_restores_in_jax_whole(runs, name):
    params, manifest = JC.restore_params(
        str(runs[name] / "models" / "toy_dalle-1"))
    assert manifest["meta"]["epoch"] == 1
    # the pipeline's stages were gathered: both layers are in the tree
    assert params["transformer"]["attn"]["qkv"]["w"].shape[0] == 2
    start, _ = JC.restore_params(str(runs[name] / "models" / "toy_dalle-0"))
    moved = np.abs(np.asarray(params["transformer"]["attn"]["qkv"]["w"])
                   - np.asarray(start["transformer"]["attn"]["qkv"]["w"]))
    assert moved[0].max() > 0 and moved[1].max() > 0


def test_pp_rollback_restores_each_stage(base, monkeypatch):
    """A NaN loss at step 2 under ``--pp 2 --save_every 1``: every rank
    rolls back to the step-1 checkpoint (written once, gathered from both
    stages) and places it as it was set up, each stage its own layers;
    the run goes on to a finite epoch and a valid checkpoint."""
    monkeypatch.setenv("DALLE_FAULTS", json.dumps({"nan_loss_at_step": 2}))
    run = port_run(base, "pp_rollback", ["--pp", "2", "--pp_microbatches",
                                         "2", "--save_every", "1"])
    with open(run / "metrics.jsonl") as f:
        kinds = [json.loads(x).get("kind") for x in f]
    assert kinds.count("rollback") == 1
    ok, why = JC.validate(str(run / "models" / "toy_dalle-1"))
    assert ok, why
    assert all(np.isfinite(losses(run / "metrics.jsonl")))


@pytest.mark.parametrize("flags", [
    ["--sp", "2", "--pp", "2"], ["--sp", "2"], ["--pp", "2"],
    ["--caption_drop", "0.5", "--sp", "2"],
    ["--caption_drop", "0.5", "--pp", "2"]],
    ids=["sp-and-pp", "sp-divides", "pp-divides", "caption-drop-sp",
         "caption-drop-pp"])
def test_mesh_refusals_match_the_jax_cli(base, tmp_path, flags):
    """One device (JAX's ``--dp 1``, the port's lone process): JAX's
    setup refusals, message for message."""
    from dalle_pytorch_tpu.cli import train_dalle as JT
    from dalle_pytorch_tpu_torch.cli import train_dalle as TT
    argv = dalle_argv(base, tmp_path / "models", tmp_path / "results") + [
        "--dp", "1"] + flags
    with pytest.raises(SystemExit) as jerr:
        JT.main(argv)
    with pytest.raises(SystemExit) as terr:
        TT.main(argv, device="cpu")
    assert str(terr.value) == str(jerr.value)
