"""``--guard_transfers`` in the port's trainers (``cli/common.py``).

JAX wraps each supervised step body in ``guards.no_transfers()``; the
port wraps it in ``transfer_guard``, which sets
``torch.cuda.set_sync_debug_mode("error")`` on a card and restores the
previous mode after, so an implicit sync in the body raises at the call.
On the CPU the mode does nothing, so these tests check:

* the three trainers (``train_vae`` -> ``train_dalle`` -> ``train_clip``)
  train with the flag at the sizes of JAX's ``tests/test_cli.py``, and
  every step body of each runs inside the guard (the loss read
  outside it);
* the guard sets the mode to ``"error"`` on a CUDA device and restores
  the previous one, after a raise too, and leaves the CPU alone;
* ``step_rng`` ships its counter through ``ops.core.device_put`` and
  gives ``fold_in(key, step)``'s key.

That a seeded implicit sync raises under the guard is shown on the card
(``chip_smoke.py``'s ``cli`` phase).
"""

import contextlib

import numpy as np
import pytest
import torch
from PIL import Image

from dalle_pytorch_tpu_torch.cli import common
from dalle_pytorch_tpu_torch.ops import core, prng

IMG = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``tests/test_cli.py``'s dataset: 8 images written by PIL and
    their captions."""
    root = tmp_path_factory.mktemp("guard_data")
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


ARGV = {
    "train_vae": lambda d, r: [
        "--dataPath", str(d / "imagedata"), "--imageSize", str(IMG),
        "--batchSize", "4", "--num_layers", "2", "--num_tokens", "24",
        "--codebook_dim", "16", "--hidden_dim", "8", "--lr", "3e-3",
        "--n_epochs", "2", "--tempsched"] + dirs(r),
    "train_dalle": lambda d, r: [
        "--dataPath", str(d / "imagedata"), "--imageSize", str(IMG),
        "--batchSize", "4", "--captions_only", str(d / "only.txt"),
        "--captions", str(d / "pairs.txt"), "--vaename", "vae",
        "--vae_epoch", "1", "--name", "toy", "--n_epochs", "1",
        "--dim", "16", "--depth", "2", "--heads", "2", "--dim_head", "8",
        "--num_text_tokens", "50", "--text_seq_len", "8", "--lr", "1e-3",
        "--attn_impl", "flash", "--attn_bwd_impl", "pallas",
        "--attn_dropout", "0.1", "--ff_dropout", "0.1"] + dirs(r),
    "train_clip": lambda d, r: [
        "--dataPath", str(d / "imagedata"), "--imageSize", str(IMG),
        "--batchSize", "4", "--captions_only", str(d / "only.txt"),
        "--captions", str(d / "pairs.txt"), "--name", "clip",
        "--n_epochs", "1", "--dim_text", "16", "--dim_image", "16",
        "--dim_latent", "8", "--num_text_tokens", "50",
        "--text_seq_len", "8", "--text_enc_depth", "1",
        "--text_heads", "2", "--visual_enc_depth", "1",
        "--visual_heads", "2", "--visual_patch_size", "8"] + dirs(r),
}
# the steps each run takes: 8 images in batches of 4, over its epochs
STEPS = {"train_vae": 4, "train_dalle": 2, "train_clip": 2}


@pytest.fixture(scope="module")
def guarded_runs(data, tmp_path_factory):
    """The three trainers with ``--guard_transfers`` in one run directory
    (the DALLE reads the VAE), each step body's entries into the guard
    recorded: {cli: [device, ...]}, and every loop-side float() read
    with whether the guard was on."""
    import importlib
    root = tmp_path_factory.mktemp("guard_runs")
    real = common.transfer_guard
    entries = {}
    state = {"inside": False}

    @contextlib.contextmanager
    def recording(device):
        entries[current].append(str(device))
        with real(device):
            state["inside"] = True
            try:
                yield
            finally:
                state["inside"] = False

    mp = pytest.MonkeyPatch()
    mp.setattr(common, "transfer_guard", recording)
    # the loss read happens with the guard off
    reads = []
    mp.setattr(common, "float", lambda v: reads.append(state["inside"])
               or float(v), raising=False)
    try:
        for current in ("train_vae", "train_dalle", "train_clip"):
            entries[current] = []
            mod = importlib.import_module(
                f"dalle_pytorch_tpu_torch.cli.{current}")
            mod.main(ARGV[current](data, root) + ["--guard_transfers"],
                     device="cpu")
    finally:
        mp.undo()
    return root, entries, reads


@pytest.mark.parametrize("cli", ["train_vae", "train_dalle", "train_clip"])
def test_every_trainer_trains_under_the_guard(guarded_runs, cli):
    root, entries, _ = guarded_runs
    assert entries[cli] == ["cpu"] * STEPS[cli]
    name = {"train_vae": "vae", "train_dalle": "toy",
            "train_clip": "clip"}[cli]
    assert any(p.name.startswith(f"{name}-")
               for p in (root / "models").iterdir())


def test_the_loss_is_read_outside_the_guard(guarded_runs):
    _, _, reads = guarded_runs
    assert reads and not any(reads)


class _Mode:
    """torch.cuda's sync debug mode, recorded."""

    def __init__(self, start=0):
        self.mode = start
        self.calls = []

    def get(self):
        return self.mode

    def set(self, mode):
        self.calls.append(mode)
        self.mode = mode


@pytest.mark.parametrize("start", [0, "warn"])
def test_guard_sets_error_and_restores_the_mode(monkeypatch, start):
    mode = _Mode(start)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", mode.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", mode.set)
    seen = []
    with common.transfer_guard(torch.device("cuda", 0)):
        seen.append(mode.mode)
    assert seen == ["error"] and mode.mode == start
    with pytest.raises(RuntimeError, match="seeded"):
        with common.transfer_guard("cuda"):
            raise RuntimeError("seeded")
    assert mode.calls == ["error", start, "error", start]
    with common.transfer_guard(torch.device("cpu")):
        pass
    assert len(mode.calls) == 4            # the CPU is left alone


def test_step_rng_ships_its_counter_and_keeps_the_key():
    key = prng.prng_key(7)
    for step in (0, 1, 12345, 2 ** 33 + 5):
        assert torch.equal(common.step_rng(key, step),
                           prng.fold_in(key, torch.tensor(step)))
    t = core.device_put(np.int64(3), "cpu")
    assert t.dtype == torch.int64 and int(t) == 3
