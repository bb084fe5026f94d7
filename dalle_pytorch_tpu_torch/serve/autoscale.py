"""Load-driven autoscaler for the replica set.

Port of ``dalle_pytorch_tpu/serve/autoscale.py`` (``:52-290``), whole.
The scale API (``ReplicaSet.add_replica`` / ``remove_replica``) is the
mechanism; this is the POLICY: a small control loop over the signals
``/stats`` exports (slot occupancy, shared-queue depth, the worst
replica's free-page fraction), calling the same two operator calls an
admin would, within ``min_replicas``/``max_replicas``. Every decision
that changes, or tries to change, the fleet is a structured
``autoscale_decision`` event.

* Hysteresis: a breach must persist ``breach_ticks`` consecutive ticks;
  the out and in counters reset each other.
* Cooldown: ``cooldown_s`` of silence after any action.
* Caps are typed: at ``max_replicas`` the scaler records an ``at_max``
  decision; at ``min_replicas`` scale-in never fires.
* A reshaping fleet is left alone: during a rolling upgrade, or while a
  replica is still coming up.

Drivable as ``tick(now)`` (the sync driver, tests) or ``start()`` (a
thread ticking every ``interval_s``, what ``cli/serve.py --autoscale``
runs).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from dalle_pytorch_tpu_torch.utils.metrics import structured_event


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The policy knobs (``cli/serve.py --autoscale_*``). Scale OUT when
    occupancy exceeds ``high_occupancy``, the shared queue backs up
    past ``queue_high`` entries per live replica, or any replica's free
    pages fall below ``page_low_frac`` of its pool — sustained for
    ``breach_ticks`` ticks. Scale IN when occupancy sits below
    ``low_occupancy`` with an empty queue for the same stretch."""

    min_replicas: int = 1
    max_replicas: int = 4
    high_occupancy: float = 0.85
    low_occupancy: float = 0.25
    queue_high: int = 4              # shared-queue entries per replica
    page_low_frac: float = 0.10      # pages_free/num_pages pressure line
    breach_ticks: int = 3            # hysteresis: consecutive breaches
    cooldown_s: float = 10.0         # silence after any action
    interval_s: float = 1.0          # threaded tick cadence

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})")
        if not 0.0 <= self.low_occupancy < self.high_occupancy <= 1.0:
            raise ValueError(
                f"need 0 <= low_occupancy < high_occupancy <= 1, got "
                f"{self.low_occupancy}/{self.high_occupancy}")
        if self.breach_ticks < 1:
            raise ValueError(f"breach_ticks must be >= 1, got "
                             f"{self.breach_ticks}")


class Autoscaler:
    """The policy loop over one ``ReplicaSet``. ``tick()`` reads the
    signals, updates the hysteresis counters, and — past the breach
    and cooldown gates — calls the scale API; every fleet-changing
    decision (and every typed rejection) is a structured
    ``autoscale_decision`` event and is returned to the caller."""

    def __init__(self, replica_set, policy: AutoscalePolicy,
                 metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        from dalle_pytorch_tpu_torch.serve.replica import ReplicaSet
        if not isinstance(replica_set, ReplicaSet):
            raise TypeError(
                "Autoscaler needs a ReplicaSet — a single engine has "
                "no slots to add (serve with replicas >= 1 through "
                "the replica set, or drop --autoscale)")
        self.rs = replica_set
        self.policy = policy
        # default to the SET's RecordingMetrics: every decision then
        # lands in the set-level flight ring (always on) even when no
        # JSONL sink was configured — "why did the fleet reshape" must
        # be answerable from /debug/events alone
        self.metrics = metrics if metrics is not None \
            else getattr(replica_set, "metrics", None)
        self.clock = clock
        self.out_breach = 0          # consecutive scale-out breaches
        self.in_breach = 0           # consecutive scale-in breaches
        self.last_action_t: Optional[float] = None
        self.decisions: list = []    # every acted/rejected decision
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals ------------------------------------------------------------

    def signals(self) -> dict:
        """One reading of the load signals, straight off the set's own
        host-side bookkeeping (no device syncs): live replica count,
        mean slot occupancy, shared-queue depth, and the worst
        replica's free-page fraction (1.0 when not paged / unknown)."""
        from dalle_pytorch_tpu_torch.serve.replica import RUNNING
        rs = self.rs
        live = [r for r in rs.replicas
                if r.state == RUNNING and r.engine is not None
                and not r.canary]
        slots = sum(r.engine.num_slots for r in live)
        active = sum(r.engine.active_slots() for r in live)
        page_frac = 1.0
        if rs.kv == "paged":
            for r in live:
                e = r.engine
                # a process replica's count is its child's last frame:
                # -1 before the first
                if e.pages_free >= 0:
                    page_frac = min(page_frac, e.pages_free / e.num_pages)
        return {
            "live_replicas": len(live),
            "occupancy": active / slots if slots else 1.0,
            "queue_depth": rs.queue.depth(),
            "page_free_frac": round(page_frac, 4),
        }

    # -- the decision -------------------------------------------------------

    def _decide(self, sig: dict) -> Optional[str]:
        """Pure policy: signals -> 'out' | 'in' | None, updating the
        hysteresis counters. Separated from ``tick`` so tests can
        table-drive it."""
        p = self.policy
        live = max(sig["live_replicas"], 1)
        hot = (sig["occupancy"] > p.high_occupancy
               or sig["queue_depth"] > p.queue_high * live
               or sig["page_free_frac"] < p.page_low_frac)
        cold = (sig["occupancy"] < p.low_occupancy
                and sig["queue_depth"] == 0)
        self.out_breach = self.out_breach + 1 if hot else 0
        self.in_breach = self.in_breach + 1 if cold else 0
        if self.out_breach >= p.breach_ticks:
            return "out"
        if self.in_breach >= p.breach_ticks:
            return "in"
        return None

    def _record(self, action: str, sig: dict, **fields) -> dict:
        rec = structured_event("autoscale_decision", action=action,
                               **sig, **fields)
        self.decisions.append(rec)
        if self.metrics is not None:
            try:
                self.metrics.event(**rec)
            except Exception:   # noqa: BLE001 — observability only
                pass
        return rec

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One control iteration. Returns the decision record when the
        tick acted (or was typed-rejected at a cap), None on a quiet
        tick — so a sync driver can count decisions directly."""
        from dalle_pytorch_tpu_torch.serve import replica as R
        p = self.policy
        now = self.clock() if now is None else now
        rs = self.rs
        if rs._upgrading:
            # a rolling upgrade owns the fleet; reshaping under it
            # would be typed-rejected anyway — don't even ask, and
            # don't let the upgrade's drain spikes charge the counters
            self.out_breach = self.in_breach = 0
            return None
        if self.last_action_t is not None \
                and now - self.last_action_t < p.cooldown_s:
            return None
        # a replica still coming up (spawned, compiling, circuit-broken
        # from a previous decision) is capacity in flight: deciding
        # again off the same congestion would double-spend
        if any(r.state == R.BROKEN or (r.state == R.RUNNING
                                       and not rs._replica_serving(r))
               for r in rs.replicas if r.state != R.RETIRED):
            return None
        sig = self.signals()
        action = self._decide(sig)
        if action is None:
            return None
        live = sig["live_replicas"]
        if action == "out":
            self.out_breach = 0
            if live >= p.max_replicas:
                self.last_action_t = now    # don't re-emit every tick
                return self._record("at_max", sig,
                                    max_replicas=p.max_replicas)
            try:
                index = rs.add_replica()
            except R.ScaleError as e:
                self.last_action_t = now
                return self._record("rejected", sig,
                                    error=e.record.get("reason"))
            self.last_action_t = now
            return self._record("scale_out", sig, replica=index,
                                replicas=rs.n_replicas)
        self.in_breach = 0
        if live <= p.min_replicas:
            return None         # quietly at floor: idle is not an event
        # retire the youngest live replica: the one the last burst
        # added, whose retirement disturbs the least-warmed caches
        victim = max((r for r in rs.replicas
                      if r.state == R.RUNNING and not r.canary),
                     key=lambda r: r.index, default=None)
        if victim is None:
            return None
        # remove_replica(drain=True) live-migrates the victim's
        # in-flight work to survivors before the fence — the delta of
        # the set's migrated_tokens_saved counter across the call is
        # what this decision avoided re-decoding
        saved0 = rs.migrated_tokens_saved
        try:
            reclaimed = rs.remove_replica(victim.index, drain=True,
                                          reason="autoscale scale-in")
        except R.ScaleError as e:
            self.last_action_t = now
            return self._record("rejected", sig,
                                error=e.record.get("reason"))
        self.last_action_t = now
        return self._record("scale_in", sig, replica=victim.index,
                            reclaimed=reclaimed,
                            tokens_saved=rs.migrated_tokens_saved
                            - saved0,
                            replicas=rs.n_replicas)

    # -- threaded drive -----------------------------------------------------

    def start(self) -> "Autoscaler":
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serve-autoscaler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:   # noqa: BLE001 — the policy loop must
                pass            # never take down serving
            self._stop.wait(self.policy.interval_s)

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
