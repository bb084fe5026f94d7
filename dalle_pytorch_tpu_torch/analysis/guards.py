"""Lock-order sanitizer: racelint's runtime twin.

Port of the lock-order half of ``dalle_pytorch_tpu/analysis/guards.py``
(``:137-311``): ``LockOrderError``, ``LockOrderRecorder``,
``TrackedLock`` and ``instrument_locks``, with the same lock ids, so an
edge recorded here compares directly against
``racelint.lock_order_edges(paths)``. Swap an object's
``threading.Lock`` attrs for wrappers that record the real acquisition
order. An ACQUISITION-ORDER INVERSION (this thread acquires B→A after
A→B was ever observed) raises at once — the single-threaded witness of a
deadlock that needs two threads to actually fire — and
``assert_consistent_with(racelint.lock_order_edges(...))`` asserts every
runtime edge was predicted by the static graph.

Beyond the JAX half: the recorder keeps every inversion it raised in
``errors``, so one raised inside a replica thread, where the replica set
takes any exception for a replica fault, still fails the caller's check;
a ``TrackedLock`` whose acquire raises releases the lock it took, so the
raising thread leaves no lock held behind it; ``instrument_module_lock``
names a module-level lock as racelint does (``paged_attention._LOCK``);
and ``restore_locks`` puts the plain locks back. The JAX half's transfer
guard and compile counters are not ported: the port's transfer guard is
``cli/common.py::transfer_guard``, and the port traces no programs.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple


class LockOrderError(AssertionError):
    """An acquisition-order inversion: this thread acquired ``second``
    while holding ``first``, but the opposite order ``second -> first``
    was already observed (possibly transitively). Two threads running
    those two paths concurrently can deadlock — the recorder surfaces
    the hazard from a single-threaded witness, no actual deadlock
    required."""

    def __init__(self, first: str, second: str,
                 chain: List[str]):
        path = " -> ".join(chain)
        super().__init__(
            f"lock-order inversion: acquiring {second!r} while holding "
            f"{first!r}, but the order {path} was already observed")
        self.first = first
        self.second = second
        self.chain = chain


class LockOrderRecorder:
    """Records the directed graph of observed lock-acquisition orders.

    Each thread keeps its own held-stack (thread-local); every acquire
    of ``b`` while ``a`` is held records the edge ``a -> b``. Before
    recording, the recorder checks whether ``b`` can already reach ``a``
    through observed edges — if so, the program has demonstrated both
    orders, ``LockOrderError`` is raised at the inverting acquire, and
    the error is kept in ``errors``.

    Lock NAMES are racelint's lock ids (``ClassName.attr``), so edges
    here compare directly against ``racelint.lock_order_edges(paths)``:
    ``assert_consistent_with(static_edges)`` asserts every edge the
    program actually exercised was predicted by the static graph.
    Same-name edges are skipped — distinct instances of the same class
    share a name, and ordering within one id is an instance-level
    question the static graph deliberately doesn't model either.
    """

    def __init__(self) -> None:
        self._edges: Dict[str, Set[str]] = {}
        self._sites: Dict[Tuple[str, str], str] = {}
        self._tls = threading.local()
        self._graph_lock = threading.Lock()
        self.errors: List[LockOrderError] = []

    # -- per-thread held stack ------------------------------------------
    def _held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _find_chain(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src -> ... -> dst over observed edges, or None."""
        parents: Dict[str, str] = {}
        frontier = [src]
        seen = {src}
        while frontier:
            node = frontier.pop()
            for nxt in self._edges.get(node, ()):
                if nxt in seen:
                    continue
                parents[nxt] = node
                if nxt == dst:
                    chain = [dst]
                    while chain[-1] != src:
                        chain.append(parents[chain[-1]])
                    return chain[::-1]
                seen.add(nxt)
                frontier.append(nxt)
        return None

    def on_acquire(self, name: str) -> None:
        held = self._held()
        with self._graph_lock:
            for h in held:
                if h == name:
                    continue
                chain = self._find_chain(name, h)
                if chain is not None:
                    err = LockOrderError(h, name, chain)
                    self.errors.append(err)
                    raise err
                self._edges.setdefault(h, set()).add(name)
                self._sites.setdefault((h, name),
                                       threading.current_thread().name)
        held.append(name)

    def on_release(self, name: str) -> None:
        held = self._held()
        # release in LIFO discipline is the common case, but timed/early
        # releases may pop out of order — remove the most recent match
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # -- inspection -----------------------------------------------------
    def edges(self) -> Set[Tuple[str, str]]:
        with self._graph_lock:
            return {(a, b) for a, succ in self._edges.items() for b in succ}

    def assert_consistent_with(
            self, static_edges: Iterable[Tuple[str, str]]) -> None:
        """Every observed runtime edge must appear in the static graph.

        ``static_edges`` is ``racelint.lock_order_edges(paths)`` — the
        set of held->acquired pairs the analyzer derived from source. A
        runtime edge the static pass missed means the call-graph
        resolution has a hole worth fixing (or a lock was taken through
        a path the analyzer cannot see, e.g. a callback)."""
        static = set(static_edges)
        missing = sorted(e for e in self.edges() if e not in static)
        if missing:
            rendered = ", ".join(f"{a} -> {b}" for a, b in missing)
            raise AssertionError(
                f"runtime lock order not predicted by static graph: "
                f"{rendered}")


class TrackedLock:
    """A drop-in ``threading.Lock``/``RLock`` wrapper that reports
    acquisition order to a :class:`LockOrderRecorder`. Passthrough for
    the lock API the serve tier uses: ``with``, ``acquire(blocking=,
    timeout=)``, ``release``, ``locked``."""

    def __init__(self, name: str, recorder: LockOrderRecorder,
                 lock=None):
        self.name = name
        self._recorder = recorder
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            try:
                self._recorder.on_acquire(self.name)
            except BaseException:
                # an inversion: the caller never gets the lock, so no
                # one would release it
                self._lock.release()
                raise
        return ok

    def release(self) -> None:
        self._lock.release()
        self._recorder.on_release(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    # an alias, not a def: racelint's unique-method fallback would take
    # utils/profiling.py's explicit ``profile.__enter__()`` for this one
    # and graph a false edge from the engine's lock to the recorder's
    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()


_LOCK_TYPES = (type(threading.Lock()), type(threading.RLock()))


def _lock_attrs(obj) -> List[str]:
    try:
        return list(vars(obj))
    except TypeError:       # __slots__ classes (obs.Trace) have no __dict__
        return [a for klass in type(obj).__mro__
                for a in getattr(klass, "__slots__", ())]


def instrument_locks(obj, recorder: LockOrderRecorder,
                     cls_name: Optional[str] = None) -> List[str]:
    """Replace every ``threading.Lock``/``RLock`` attribute in
    ``vars(obj)`` with a :class:`TrackedLock` named with racelint's lock
    id (``ClassName.attr``). Returns the names installed.

    ``cls_name`` overrides the class part — needed when the lock is
    defined by a base class (racelint names locks after the DEFINING
    class, e.g. ``RequestQueue._lock`` even on a ``WeightedFairQueue``
    instance)."""
    base = cls_name or type(obj).__name__
    installed = []
    for attr in _lock_attrs(obj):
        val = getattr(obj, attr, None)
        if isinstance(val, _LOCK_TYPES):
            name = f"{base}.{attr}"
            tracked = TrackedLock(name, recorder, lock=val)
            setattr(obj, attr, tracked)
            installed.append(name)
    return installed


def instrument_module_lock(module, attr: str,
                           recorder: LockOrderRecorder) -> str:
    """Replace the module-level lock ``module.<attr>`` with a
    :class:`TrackedLock` named with racelint's id for it: the module's
    last dotted part and the name (``paged_attention._LOCK``; a
    package's ``__init__`` is the package, ``native._lock``). The
    module's own functions read the global at each call, so they take
    the wrapper from then on. Returns the name."""
    name = f"{module.__name__.rsplit('.', 1)[-1]}.{attr}"
    val = getattr(module, attr)
    if not isinstance(val, _LOCK_TYPES):
        raise TypeError(f"{name} is {type(val).__name__}, not a lock")
    setattr(module, attr, TrackedLock(name, recorder, lock=val))
    return name


def restore_locks(obj) -> List[str]:
    """Put back the plain lock under every :class:`TrackedLock`
    attribute of ``obj`` (an instance or a module). Returns the names
    restored."""
    restored = []
    for attr in _lock_attrs(obj):
        val = getattr(obj, attr, None)
        if isinstance(val, TrackedLock):
            setattr(obj, attr, val._lock)
            restored.append(val.name)
    return restored
