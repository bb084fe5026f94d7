"""Resuming across packages, and the port's supervisor, on the CPU.

Cross-resume: one package's ``train_dalle`` writes epoch 0 with its
optimizer state (over a VAE the other package trained); both packages
resume one more epoch from it on the same data and step keys, and their
parameters agree. Tolerance: atol 1e-6 on parameters moved by two Adam
steps at lr 1e-3, dropout 0.1 (float32 sums in other orders, and the
global-norm clip's 1e-6 / norm, ``ROADMAP.md`` queue 3); measured
1.2e-7 (one float32 ulp at 1) in both directions.

The supervisor (``tests/test_faults.py``'s cases on the port's
``train_vae`` at 8 px): a SIGTERM before step 2 writes a mid-epoch
checkpoint, and ``--auto_resume`` finishes with parameters bit-equal to
an uninterrupted run, every step trained once; an injected NaN batch
rolls back to the last checkpoint and the run finishes finite; a NaN
loss in ``train_dalle`` rolls back too; a NaN with nothing to roll back
to raises ``TrainingDiverged``.

``train_vae``'s own step (``make_step``: the loss at the batch's
temperature, Adam, the weight clamp) against JAX's.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from dalle_pytorch_tpu import checkpoint as JC
from dalle_pytorch_tpu_torch import checkpoint as TC
from dalle_pytorch_tpu_torch.resilience import faults
from dalle_pytorch_tpu_torch.resilience.supervisor import TrainingDiverged


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.deactivate()
    yield
    faults.deactivate()


def make_data(root, img: int):
    img_dir = root / "imagedata" / "0"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    colors = ["red", "blue", "green", "gray"]
    for i in range(8):
        arr = np.zeros((img, img, 3), np.uint8)
        arr[:, :, i % 3] = 255
        s = min(6, img // 2)
        o = i % (img - s)
        arr[o:o + s, o:o + s] = rng.integers(0, 255, (s, s, 3))
        Image.fromarray(arr).save(img_dir / f"img{i}.png")
    (root / "only.txt").write_text(
        "".join(f"a {colors[i % 4]} square\n" for i in range(8)))
    (root / "pairs.txt").write_text(
        "".join(f"img{i}.png : a {colors[i % 4]} square\n"
                for i in range(8)))
    (root / "models").mkdir()
    (root / "results").mkdir()


def common(root):
    return ["--models_dir", str(root / "models"), "--results_dir",
            str(root / "results"), "--metrics", str(root / "metrics.jsonl"),
            "--log_interval", "1", "--dp", "1"]


def vae_argv(root, img=16, extra=()):
    return ["--dataPath", str(root / "imagedata"), "--imageSize", str(img),
            "--batchSize", "4", "--num_layers", "2",
            "--num_tokens", "24" if img == 16 else "8",
            "--codebook_dim", "16" if img == 16 else "8",
            "--hidden_dim", "8" if img == 16 else "4", "--lr", "3e-3"] + \
        common(root) + list(extra)


def dalle_argv(root, extra=()):
    return ["--dataPath", str(root / "imagedata"), "--imageSize", "16",
            "--batchSize", "4", "--captions_only", str(root / "only.txt"),
            "--captions", str(root / "pairs.txt"), "--vaename", "vae",
            "--vae_epoch", "0", "--name", "toy", "--dim", "16", "--depth",
            "2", "--heads", "2", "--dim_head", "8", "--num_text_tokens",
            "50", "--text_seq_len", "8", "--lr", "1e-3", "--sample_every",
            "0"] + common(root) + list(extra)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree)}


def read_metrics(root):
    return [json.loads(line) for line in
            (root / "metrics.jsonl").read_text().splitlines()]


# -- resuming across packages -------------------------------------------------

@pytest.mark.parametrize("writer,flags", [
    ("jax", ("--lr_schedule", "cosine", "--warmup_steps", "1",
             "--clip_grad_norm", "1.0", "--ema_decay", "0.9")),
    ("port", ())])
def test_both_packages_resume_one_checkpoint_alike(tmp_path, writer, flags):
    from dalle_pytorch_tpu.cli import train_dalle as JT
    from dalle_pytorch_tpu.cli import train_vae as JV
    from dalle_pytorch_tpu_torch.cli import train_dalle as TT
    from dalle_pytorch_tpu_torch.cli import train_vae as TV
    mains = {"jax": (JT.main, {}), "port": (TT.main, {"device": "cpu"})}
    first = tmp_path / "first"
    make_data(first, 16)
    # the VAE from the package that does not write the DALLE
    if writer == "jax":
        TV.main(vae_argv(first, extra=("--n_epochs", "1")), device="cpu")
    else:
        JV.main(vae_argv(first, extra=("--n_epochs", "1")))
    main, kw = mains[writer]
    main(dalle_argv(first, flags + ("--n_epochs", "1")), **kw)
    second = tmp_path / "second"
    shutil.copytree(first, second)
    out = {}
    for pkg, root in (("jax", first), ("port", second)):
        main, kw = mains[pkg]
        main(dalle_argv(root, flags + ("--n_epochs", "1", "--load_dalle",
                                       "toy", "--start_epoch", "1")), **kw)
        path = str(root / "models" / "toy_dalle-1")
        assert JC.validate(path) == (True, "ok")
        out[pkg] = (flat(TC.restore_params(path)[0]),
                    JC.load_manifest(path))
    (jp, jm), (tp, tm) = out["jax"], out["port"]
    assert jm["meta"]["global_step"] == tm["meta"]["global_step"] == 4
    assert tm["meta"]["lr_schedule"] == jm["meta"]["lr_schedule"]
    assert tp.keys() == jp.keys()
    moved = 0.0
    start = flat(TC.restore_params(str(first / "models" / "toy_dalle-0"))[0])
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        moved = max(moved, float(np.abs(jp[k] - start[k]).max()))
    assert moved > 1e-4                 # the resumed epoch did train
    assert tm["meta"]["avg_loss"] == pytest.approx(jm["meta"]["avg_loss"],
                                                   rel=1e-4)


# -- the supervisor -----------------------------------------------------------

def test_sigterm_mid_epoch_then_auto_resume_matches_uninterrupted(tmp_path):
    from dalle_pytorch_tpu_torch.cli.train_vae import main
    ref = tmp_path / "ref"
    make_data(ref, 8)
    main(vae_argv(ref, 8, ("--n_epochs", "2")), device="cpu")
    ref_params, ref_manifest = TC.restore_params(str(ref / "models" /
                                                     "vae-1"))

    run = tmp_path / "run"
    make_data(run, 8)
    with faults.injected(sigterm_at_step=2):
        main(vae_argv(run, 8, ("--n_epochs", "2")), device="cpu")
    steps_done, preempt = TC.step_checkpoints(str(run / "models"), "vae")[-1]
    assert steps_done == 3
    meta = TC.load_manifest(preempt)["meta"]
    assert (meta["epoch"], meta["step_in_epoch"]) == (1, 1)
    assert any(r.get("kind") == "preempted" for r in read_metrics(run))

    main(vae_argv(run, 8, ("--n_epochs", "1", "--auto_resume")),
         device="cpu")
    got, manifest = TC.restore_params(str(run / "models" / "vae-1"))
    want, got = flat(ref_params), flat(got)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert manifest["meta"]["avg_loss"] == ref_manifest["meta"]["avg_loss"]
    recs = read_metrics(run)
    trained = [r["step"] for r in recs
               if "loss" in r and "step" in r and "kind" not in r]
    assert sorted(trained) == [0, 1, 2, 3]
    resumed = [r for r in recs if r.get("kind") == "resume"]
    assert resumed and resumed[0]["step_in_epoch"] == 1


def test_injected_nan_rolls_back_and_finishes(tmp_path):
    from dalle_pytorch_tpu_torch.cli.train_vae import main
    make_data(tmp_path, 8)
    with faults.injected(nan_at_step=2):
        main(vae_argv(tmp_path, 8, ("--n_epochs", "2", "--save_every", "1",
                                    "--rewarm_steps", "2")), device="cpu")
    recs = read_metrics(tmp_path)
    rollbacks = [r for r in recs if r.get("kind") == "rollback"]
    assert len(rollbacks) == 1 and rollbacks[0]["step"] == 2
    # the newest anchor: the epoch-0 checkpoint, written after step 1
    assert rollbacks[0]["checkpoint"].endswith("vae-0")
    params, _ = TC.restore_params(str(tmp_path / "models" / "vae-1"))
    assert all(np.isfinite(v).all() for v in flat(params).values())


def test_nan_loss_rolls_back_train_dalle(tmp_path):
    from dalle_pytorch_tpu_torch.cli import train_dalle, train_vae
    make_data(tmp_path, 16)
    train_vae.main(vae_argv(tmp_path, extra=("--n_epochs", "1")),
                   device="cpu")
    with faults.injected(nan_loss_at_step=1):
        train_dalle.main(dalle_argv(tmp_path, ("--n_epochs", "1",
                                               "--save_every", "1")),
                         device="cpu")
    kinds = [r.get("kind") for r in read_metrics(tmp_path)]
    assert kinds.count("rollback") == 1
    assert TC.validate(str(tmp_path / "models" / "toy_dalle-0"))[0]


def test_nan_with_no_checkpoint_fails_fast(tmp_path):
    from dalle_pytorch_tpu_torch.cli.train_vae import main
    make_data(tmp_path, 8)
    with faults.injected(nan_at_step=0):
        with pytest.raises(TrainingDiverged, match="no valid checkpoint"):
            main(vae_argv(tmp_path, 8, ("--n_epochs", "1")), device="cpu")


# -- train_vae's step ---------------------------------------------------------

@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_train_vae_step_matches_jax(clip):
    """Two steps of ``train_vae``'s step (Huber + mse at the batch's
    temperature, Adam, the weight clamp) against JAX's ``make_step`` from
    the same weights, batch and keys: parameters within atol 2e-5, as
    ``test_torch_vae_train``'s Adam steps."""
    import types

    import jax
    import jax.numpy as jnp

    from dalle_pytorch_tpu.cli import common as JCOM
    from dalle_pytorch_tpu.cli import train_vae as JTV
    from dalle_pytorch_tpu.models import vae as JV
    from dalle_pytorch_tpu_torch.cli import common as TCOM
    from dalle_pytorch_tpu_torch.cli import train_vae as TTV
    from dalle_pytorch_tpu_torch.compat import from_jax, to_jax
    from dalle_pytorch_tpu_torch.models import vae as TV
    from dalle_pytorch_tpu_torch.ops import prng
    kw = dict(image_size=16, num_tokens=24, codebook_dim=16, num_layers=2,
              hidden_dim=8)
    args = types.SimpleNamespace(lr=3e-3, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)
    jcfg, tcfg = JV.VAEConfig(**kw), TV.VAEConfig(**kw)
    params = JV.vae_init(jax.random.PRNGKey(0), jcfg)
    jopt = JCOM.make_optimizer(args)
    jstep = JTV.make_step(jcfg, jopt, clip)
    vae = from_jax.discrete_vae_from_jax(jax.device_get(params), tcfg,
                                         device="cpu")
    tstep = TTV.make_step(tcfg, TCOM.make_optimizer(args, vae.parameters()),
                          clip)
    images = np.random.default_rng(1).uniform(
        -1, 1, (4, 16, 16, 3)).astype(np.float32)
    state = jopt.init(params)
    for step in range(2):
        temp = 0.9 * 0.7 ** step
        params, state, jloss = jstep(
            params, state, {"images": jnp.asarray(images),
                            "temperature": jnp.float32(temp)},
            jax.random.fold_in(jax.random.PRNGKey(5), step))
        tloss = tstep(vae, {"images": torch.from_numpy(images),
                            "temperature": temp},
                      prng.fold_in(prng.prng_key(5), step))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                                   atol=1e-5)
    got = to_jax.tree(vae)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b.numpy(), np.asarray(a), rtol=0, atol=2e-5), params, got)
    if clip:
        assert max(float(t.detach().abs().max()) for t in
                   vae.parameters()) == float(np.float32(clip))
