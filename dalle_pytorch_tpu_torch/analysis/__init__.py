"""Concurrency analysis of the port's threaded serve tier.

Port of ``dalle_pytorch_tpu/analysis/``'s concurrency half, stdlib only:
``racelint`` is the whole-program AST pass (``python -m
dalle_pytorch_tpu_torch.analysis.racelint``), ``lintcore`` its finding
schema and waiver parser, and ``guards`` its runtime twin, the
lock-order sanitizer. Rule catalog and rationale:
docs/STATIC_ANALYSIS.md. ``jaxlint`` and the JAX half of ``guards``
read JAX programs and are not ported.
"""

from dalle_pytorch_tpu_torch.analysis.guards import (  # noqa: F401
    LockOrderError, LockOrderRecorder, TrackedLock, instrument_locks,
    instrument_module_lock, restore_locks)

_RACELINT_NAMES = ("RULES", "Finding", "lint_file", "lint_files",
                   "lint_source", "lock_order_edges")


def __getattr__(name):
    # lazy: `python -m ...analysis.racelint` warns if the package
    # __init__ already imported the submodule before runpy runs it
    if name in _RACELINT_NAMES:
        from dalle_pytorch_tpu_torch.analysis import racelint
        return getattr(racelint, name)
    raise AttributeError(name)
