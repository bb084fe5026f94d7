"""Debug toggles: anomaly detection and loss-sanity guards.

Port of ``dalle_pytorch_tpu/utils/debug.py`` (``:25-47``).
``enable_nan_checks`` is JAX's ``jax_debug_nans``/``jax_debug_infs``
switch; its torch counterpart is autograd's anomaly mode, which names
the forward op whose backward produced the first NaN (slow, debugging
only; ``--nan_checks`` on the training CLIs). ``check_finite_tree`` and
``guard_loss`` are the cheap always-on checks the CLIs use to fail fast
with context instead of training on garbage.
"""

from __future__ import annotations

import math
from typing import Any, List

import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd anomaly detection on or off, process-wide."""
    torch.autograd.set_detect_anomaly(bool(enable))


def _leaves(tree: Any, path: str, out: List) -> None:
    """(name, tensor) of every tensor leaf: a module's dotted parameter
    names, JAX's ``keystr`` (``['a']['b']``) for nested dicts and
    sequences."""
    if isinstance(tree, torch.nn.Module):
        out.extend(tree.named_parameters())
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _leaves(v, f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _leaves(v, f"{path}[{i}]", out)
    elif isinstance(tree, torch.Tensor):
        out.append((path, tree))


def check_finite_tree(tree: Any, name: str = "tree") -> None:
    """Host-side assert that every floating leaf of ``tree`` (a module's
    parameters, or a dict/list of tensors) is finite; waits for the
    values. Raises ``FloatingPointError`` naming at most 8 bad leaves."""
    leaves: List = []
    _leaves(tree, "", leaves)
    bad = [path for path, t in leaves
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}: {', '.join(bad[:8])}"
            + (" ..." if len(bad) > 8 else ""))


def guard_loss(loss, step: int) -> float:
    """Raise with step context when the scalar loss goes non-finite."""
    val = float(loss)
    if not math.isfinite(val):
        raise FloatingPointError(f"loss became {val} at step {step}")
    return val
