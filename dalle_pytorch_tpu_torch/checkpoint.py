"""Checkpoints: parameters, optimizer state, EMA and run metadata.

Port of ``dalle_pytorch_tpu/checkpoint.py``, in its format, so either
package resumes the other's runs:

    {dir}/{name}-{epoch}/
        manifest.json      # kind, step, the config as a plain dict, meta,
                           # each payload's bytes and crc32, format 1
        params.msgpack     # the JAX parameter tree (flax msgpack)
        opt_state.msgpack  # optional: optax's adam state (flax to_bytes)
        ema.msgpack        # optional: the float32 EMA, as a JAX tree

The payloads are written by ``compat/msgpack.py``, byte for byte what
flax writes for the same tree, from the JAX-layout trees of
``compat/to_jax.py``; the optimizer's state is the optax tree
``cli/common.py::Optimizer.state_tree`` builds. ``save`` takes the port's
objects (a module, its ``Optimizer``, its EMA dict) or plain trees.
Restores return trees (numpy leaves; bfloat16 leaves as CPU tensors):
``compat/from_jax.py`` builds modules from them, and ``restore_train``
loads a checkpoint into a live model and optimizer. Runs write their
checkpoints from their one process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import zlib
from typing import Any, Optional, Tuple

from torch import nn

from dalle_pytorch_tpu_torch.compat import msgpack

MANIFEST = "manifest.json"
PARAMS = "params.msgpack"
OPT_STATE = "opt_state.msgpack"
EMA = "ema.msgpack"


def _config_dict(config: Any) -> Any:
    """Dataclass config -> JSON-safe dict (recursively, so the VAEConfig
    nested in DALLEConfig survives)."""
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return {f.name: _config_dict(getattr(config, f.name))
                for f in dataclasses.fields(config)}
    if isinstance(config, (list, tuple)):
        return list(_config_dict(c) for c in config)
    return config


def _payloads(params, opt_state, ema) -> dict:
    """{file name: bytes} of what ``save`` writes."""
    from dalle_pytorch_tpu_torch.compat import to_jax
    model = params if isinstance(params, nn.Module) else None
    out = {PARAMS: msgpack.packb(to_jax.tree(model) if model is not None
                                 else params)}
    if opt_state is not None:
        if hasattr(opt_state, "state_tree"):
            opt_state = opt_state.state_tree(model)
        out[OPT_STATE] = msgpack.packb(msgpack.to_state_dict(opt_state),
                                       sort_keys=False)
    if ema is not None:
        out[EMA] = msgpack.packb(to_jax.tree(model, ema)
                                 if model is not None else ema)
    return out


def save(path: str, params, *, step: int = 0, config: Any = None,
         opt_state=None, kind: str = "model", meta: Optional[dict] = None,
         ema=None) -> str:
    """Write a checkpoint directory atomically (tmp dir + rename), so a
    killed writer never leaves a half-checkpoint that resume would trust.
    ``params`` is a module (then ``opt_state`` may be its ``Optimizer``
    and ``ema`` its ``{name: tensor}`` EMA) or a JAX-layout tree (then
    both are trees too)."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt-tmp-")
    try:
        payloads = {}
        for fname, data in _payloads(params, opt_state, ema).items():
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(data)
            # size + crc32 in the manifest let ``validate`` prove
            # integrity without decoding the payloads
            payloads[fname] = {"bytes": len(data),
                               "crc32": zlib.crc32(data)}
        manifest = {
            "kind": kind,
            "step": int(step),
            "config": _config_dict(config) if config is not None else None,
            "meta": meta or {},
            "payloads": payloads,
            "format": 1,
        }
        # the manifest last: its presence implies every payload before it
        # was fully written
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        # swap in with no window where neither old nor new exists
        old = None
        if os.path.isdir(path):
            old = tempfile.mkdtemp(dir=parent, prefix=".ckpt-old-")
            os.rmdir(old)
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def _read(path: str, fname: str):
    with open(os.path.join(path, fname), "rb") as f:
        return msgpack.unpackb(f.read())


def restore(path: str, opt_state: bool = False) -> Tuple[Any, Any, dict]:
    """-> (params tree, optimizer state | None, manifest). The optimizer
    state is the state-dict tree ``to_bytes`` wrote (read only with
    ``opt_state``; ``FileNotFoundError`` when the checkpoint has
    none)."""
    manifest = load_manifest(path)
    params = _read(path, PARAMS)
    state = None
    if opt_state:
        if not os.path.exists(os.path.join(path, OPT_STATE)):
            raise FileNotFoundError(
                f"checkpoint {path} has no optimizer state to restore")
        state = _read(path, OPT_STATE)
    return params, state, manifest


def restore_params(path: str) -> Tuple[Any, dict]:
    params, _, manifest = restore(path)
    return params, manifest


def restore_ema(path: str):
    """The checkpoint's EMA tree (float32), or None when it was written
    without ``--ema_decay``."""
    if not os.path.exists(os.path.join(path, EMA)):
        return None
    return _read(path, EMA)


def load_into(model: nn.Module, tree) -> nn.Module:
    """Copy a JAX-layout tree's weights into ``model`` in place (cast to
    its dtypes)."""
    from dalle_pytorch_tpu_torch.compat import to_jax
    model.load_state_dict(to_jax.module(tree, model).state_dict())
    return model


def restore_opt_state(path: str, optimizer, model: nn.Module) -> bool:
    """Load the checkpoint's optimizer state into ``optimizer`` (whose
    parameters are ``model``'s); False when it has none (weights only).
    Corrupt bytes and a tree of another optimizer raise distinct
    ``ValueError``s."""
    opt_file = os.path.join(path, OPT_STATE)
    if not os.path.exists(opt_file):
        return False
    with open(opt_file, "rb") as f:
        data = f.read()
    # decode in two steps so a corrupt or truncated file is not
    # misdiagnosed as a flag mismatch
    try:
        state = msgpack.unpackb(data)
    except Exception as e:
        raise ValueError(
            f"optimizer state file {opt_file!r} is corrupt or "
            f"truncated — cannot decode its msgpack payload ({e}); "
            "restore from an older checkpoint or retrain") from e
    try:
        optimizer.load_state_tree(model, state)
    except (KeyError, ValueError) as e:
        # the optimizer's state TREE differs from the one that wrote the
        # checkpoint, e.g. --clip_grad_norm toggled (optax.chain adds an
        # entry) or a schedule where there was a constant learning rate
        raise ValueError(
            f"optimizer state in {path!r} does not match this "
            "run's optimizer — resume with the same "
            "optimizer-shaping flags (e.g. --clip_grad_norm) "
            "the checkpoint was written with, or the file is from "
            f"an incompatible version ({e})") from e
    return True


def restore_train(path: str, model: nn.Module, optimizer) -> dict:
    """Load the checkpoint's parameters into ``model`` and its optimizer
    state (when it has one) into ``optimizer``; returns the manifest."""
    params, manifest = restore_params(path)
    load_into(model, params)
    restore_opt_state(path, optimizer, model)
    return manifest


# ---------------------------------------------------------------------------
# validation — what "a checkpoint resume may trust" means
# ---------------------------------------------------------------------------

def validate(path: str) -> Tuple[bool, str]:
    """(ok, reason): is ``path`` a checkpoint a resume may trust? The
    manifest must be present and a JSON object; then each payload's size
    and crc32 must equal the manifest's record (checkpoints without one
    decode every payload instead)."""
    try:
        manifest = load_manifest(path)
    except FileNotFoundError:
        return False, "missing manifest"
    except (ValueError, OSError) as e:
        return False, f"unreadable manifest: {e}"
    if not isinstance(manifest, dict):
        return False, "manifest is not an object"
    params_file = os.path.join(path, PARAMS)
    if not os.path.exists(params_file):
        return False, "missing params.msgpack"
    payloads = manifest.get("payloads")
    if isinstance(payloads, dict) and PARAMS in payloads:
        for fname, info in payloads.items():
            fpath = os.path.join(path, fname)
            if not os.path.exists(fpath):
                return False, f"missing {fname}"
            if os.path.getsize(fpath) != info.get("bytes"):
                return False, (f"corrupt {fname}: size "
                               f"{os.path.getsize(fpath)} != recorded "
                               f"{info.get('bytes')}")
            crc = 0
            with open(fpath, "rb") as f:
                while chunk := f.read(1 << 22):
                    crc = zlib.crc32(chunk, crc)
            if crc != info.get("crc32"):
                return False, f"corrupt {fname}: crc32 mismatch"
        return True, "ok"
    for fname in (PARAMS, OPT_STATE, EMA):
        if not os.path.exists(os.path.join(path, fname)):
            continue
        try:
            _read(path, fname)
        except Exception as e:
            return False, f"corrupt {fname}: {type(e).__name__}: {e}"
    return True, "ok"


# ---------------------------------------------------------------------------
# epoch-templated naming — the cross-CLI contract
# ---------------------------------------------------------------------------

def ckpt_path(models_dir: str, name: str, epoch: int) -> str:
    """``{models_dir}/{name}-{epoch}``, the template every CLI shares."""
    return os.path.join(models_dir, f"{name}-{epoch}")


def _epoch_dirs(models_dir: str, name: str, need_manifest: bool) -> list:
    if not os.path.isdir(models_dir):
        return []
    pat = re.compile(re.escape(name) + r"-(\d+)$")
    out = []
    for entry in os.listdir(models_dir):
        m = pat.match(entry)
        full = os.path.join(models_dir, entry)
        if m and os.path.isdir(full) and (
                not need_manifest
                or os.path.exists(os.path.join(full, MANIFEST))):
            out.append((int(m.group(1)), full))
    return out


def latest(models_dir: str, name: str) -> Optional[Tuple[str, int]]:
    """Newest (path, epoch) for ``name`` under ``models_dir``, or None."""
    found = _epoch_dirs(models_dir, name, need_manifest=True)
    if not found:
        return None
    epoch, full = max(found)
    return full, epoch


def latest_valid(models_dir: str, name: str):
    """Newest (path, epoch) for ``name`` that passes ``validate``; invalid
    candidates are skipped newest-first with a warning. None when nothing
    valid exists."""
    for epoch, full in sorted(_epoch_dirs(models_dir, name, False),
                              reverse=True):
        ok, reason = validate(full)
        if ok:
            return full, epoch
        print(f"warning: skipping invalid checkpoint {full!r} ({reason})",
              flush=True)
    return None


# ---------------------------------------------------------------------------
# step-templated naming — mid-epoch supervisor checkpoints
# ---------------------------------------------------------------------------
# ``{name}-step{N}`` (N = completed optimizer steps) cannot collide with the
# epoch template and stays invisible to ``latest``; only the auto-resume
# path reads these.

def step_ckpt_path(models_dir: str, name: str, step: int) -> str:
    return os.path.join(models_dir, f"{name}-step{step}")


def step_checkpoints(models_dir: str, name: str):
    """All (step, path) step checkpoints for ``name``, oldest first."""
    if not os.path.isdir(models_dir):
        return []
    pat = re.compile(re.escape(name) + r"-step(\d+)$")
    out = []
    for entry in os.listdir(models_dir):
        m = pat.match(entry)
        full = os.path.join(models_dir, entry)
        if m and os.path.isdir(full) and \
                os.path.exists(os.path.join(full, MANIFEST)):
            out.append((int(m.group(1)), full))
    return sorted(out)


def latest_valid_step(models_dir: str, name: str):
    """Newest (path, step) step checkpoint passing ``validate``, or None."""
    for step, full in reversed(step_checkpoints(models_dir, name)):
        ok, reason = validate(full)
        if ok:
            return full, step
        print(f"warning: skipping invalid checkpoint {full!r} ({reason})",
              flush=True)
    return None


def gc_steps(models_dir: str, name: str, keep: int) -> list:
    """Delete all but the newest ``keep`` step checkpoints (epoch
    checkpoints are never touched). Returns the removed paths."""
    if keep < 1:
        return []
    removed = []
    ckpts = step_checkpoints(models_dir, name)
    for _, full in ckpts[:max(len(ckpts) - keep, 0)]:
        shutil.rmtree(full, ignore_errors=True)
        removed.append(full)
    return removed


# ---------------------------------------------------------------------------
# config reconstruction
# ---------------------------------------------------------------------------

def vae_config_from_manifest(manifest: dict):
    from dalle_pytorch_tpu_torch.models.vae import VAEConfig
    return VAEConfig(**manifest["config"])


def dalle_config_from_manifest(manifest: dict):
    from dalle_pytorch_tpu_torch.models.dalle import DALLEConfig
    from dalle_pytorch_tpu_torch.models.vae import VAEConfig
    cfg = dict(manifest["config"])
    cfg["vae"] = VAEConfig(**cfg["vae"])
    if isinstance(cfg.get("sparse_attn"), list):
        cfg["sparse_attn"] = tuple(cfg["sparse_attn"])
    return DALLEConfig(**cfg)


def clip_config_from_manifest(manifest: dict):
    from dalle_pytorch_tpu_torch.models.clip import CLIPConfig
    return CLIPConfig(**manifest["config"])
