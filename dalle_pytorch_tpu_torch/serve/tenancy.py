"""Tenants for the gateway: identity, quotas, fair shares.

Port of ``dalle_pytorch_tpu/serve/tenancy.py`` (``:1-367``). A TENANT is
the unit of isolation at the gateway's front door:

* an API key, checked in constant time (``serve/auth.py``) at every
  submit; an unknown or wrong key is a typed 401, never a default tenant;
* token buckets: ``rps`` (requests a second) and ``image_tokens_per_s``
  (decode work a second). A refusal is a typed 429 carrying
  ``retry_after_s``, raised before the shared queue sees the request;
* a page budget: ``max_pages`` caps the tenant's in-flight KV pages
  across the fleet (reserved at admission, released at the terminal);
* a weight: its share of the ``WeightedFairQueue`` under saturation;
* an SLO tier: the hedge threshold (``serve/gateway.py``), how long a
  request may wait un-fulfilled before a duplicate goes to a second cell.

The table reloads live (``reload``): bucket levels and in-flight pages
of a tenant that persists across the reload carry over, so an edit
cannot wash away a tenant's spent budget. Every clock is injected
(``clock=``): a test drives the buckets without the wall clock.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional

from dalle_pytorch_tpu_torch.serve import auth
from dalle_pytorch_tpu_torch.serve import scheduler as S
from dalle_pytorch_tpu_torch.utils.metrics import structured_event

# SLO tier -> default hedge threshold in seconds (None never hedges)
TIERS: Dict[str, Optional[float]] = {
    "gold": 2.0,
    "silver": 8.0,
    "bronze": None,
}


class AuthError(S.ServeRejected):
    """Typed authentication failure (HTTP 401): an unknown API key, or
    one that fails the constant-time compare."""


class TenantThrottled(S.ServeRejected):
    """Typed per-tenant quota refusal (HTTP 429). ``record`` is a
    ``tenant_throttled`` event naming the tenant, the quota that tripped
    (``rps`` / ``image_tokens`` / ``pages``) and ``retry_after_s``."""

    @property
    def retry_after_s(self) -> float:
        return float(self.record.get("retry_after_s", 0.0))


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's identity and limits, as the ``--tenants`` JSON gives
    them. Zero for a rate or budget means unlimited."""
    name: str
    key: str = ""
    weight: float = 1.0
    rps: float = 0.0                  # requests per second (0 = no cap)
    image_tokens_per_s: float = 0.0   # decode work per second
    max_pages: int = 0                # fleet-wide in-flight page cap
    tier: str = "bronze"
    hedge_s: Optional[float] = None   # overrides the tier default

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be "
                             f"> 0, got {self.weight}")
        if self.tier not in TIERS:
            raise ValueError(f"tenant {self.name!r}: unknown tier "
                             f"{self.tier!r} (have {sorted(TIERS)})")

    @property
    def hedge_after_s(self) -> Optional[float]:
        return self.hedge_s if self.hedge_s is not None \
            else TIERS[self.tier]

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        return cls(
            name=str(d["name"]),
            key=str(d.get("key", "")),
            weight=float(d.get("weight", 1.0)),
            rps=float(d.get("rps", 0.0)),
            image_tokens_per_s=float(d.get("image_tokens_per_s", 0.0)),
            max_pages=int(d.get("max_pages", 0)),
            tier=str(d.get("tier", "bronze")),
            hedge_s=(None if d.get("hedge_s") is None
                     else float(d["hedge_s"])))


class TokenBucket:
    """A token bucket of capacity ``burst`` refilled at ``rate`` a
    second (``rate <= 0``: no limit). ``take`` returns the retry-after in
    seconds, 0.0 when the tokens were granted. Not thread-safe alone:
    ``TenantTable``'s lock serializes it."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        # one second of rate by default, never below one whole token
        self.burst = float(burst) if burst is not None \
            else max(self.rate, 1.0)
        self.clock = clock
        self.level = self.burst
        self._last = clock()

    def _refill(self, now: float) -> None:
        self.level = min(self.burst,
                         self.level + (now - self._last) * self.rate)
        self._last = now

    def take(self, amount: float = 1.0) -> float:
        """Take ``amount`` tokens: 0.0 on success, else the seconds until
        the bucket holds ``amount`` again (the 429's ``Retry-After``). A
        refusal takes nothing."""
        if self.rate <= 0:
            return 0.0
        now = self.clock()
        self._refill(now)
        if self.level >= amount:
            self.level -= amount
            return 0.0
        return (amount - self.level) / self.rate


class TenantState:
    """One tenant's runtime ledger (buckets, in-flight pages, counters),
    apart from its frozen spec so ``reload`` can swap the spec."""

    def __init__(self, spec: TenantSpec,
                 clock: Callable[[], float] = time.monotonic):
        self.spec = spec
        self.req_bucket = TokenBucket(spec.rps, clock=clock)
        # one request is hundreds of image tokens: a burst holds at
        # least one full image
        self.tok_bucket = TokenBucket(
            spec.image_tokens_per_s,
            burst=max(spec.image_tokens_per_s, 1024.0), clock=clock)
        self.pages_in_flight = 0
        self.admitted = 0
        self.throttled = 0
        self.completed = 0

    def rebind(self, spec: TenantSpec) -> None:
        """Adopt a reloaded spec's limits and keep the ledger: bucket
        levels carry over, clamped to the new bursts."""
        self.spec = spec
        self.req_bucket.rate = spec.rps
        self.req_bucket.burst = max(spec.rps, 1.0)
        self.req_bucket.level = min(self.req_bucket.level,
                                    self.req_bucket.burst)
        self.tok_bucket.rate = spec.image_tokens_per_s
        self.tok_bucket.burst = max(spec.image_tokens_per_s, 1024.0)
        self.tok_bucket.level = min(self.tok_bucket.level,
                                    self.tok_bucket.burst)


class TenantTable:
    """The gateway's tenant registry: authentication, admission quotas,
    page reservations, WFQ weights. Thread-safe (the HTTP threads and the
    gateway's pump share it)."""

    def __init__(self, specs: List[TenantSpec],
                 clock: Callable[[], float] = time.monotonic,
                 on_event=None):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        self.clock = clock
        self.on_event = on_event
        self._lock = threading.Lock()
        self._states: Dict[str, TenantState] = {
            s.name: TenantState(s, clock=clock) for s in specs}
        self.reloads = 0

    @classmethod
    def from_json(cls, data, **kw) -> "TenantTable":
        """From the ``--tenants`` JSON: a list of tenant dicts or
        ``{"tenants": [...]}``."""
        if isinstance(data, dict):
            data = data.get("tenants", [])
        if not isinstance(data, list):
            raise ValueError("tenants JSON must be a list or "
                             "{'tenants': [...]}")
        return cls([TenantSpec.from_dict(d) for d in data], **kw)

    @classmethod
    def from_file(cls, path: str, **kw) -> "TenantTable":
        with open(path) as f:
            return cls.from_json(json.load(f), **kw)

    def __len__(self) -> int:
        with self._lock:
            return len(self._states)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._states)

    def spec(self, name: str) -> TenantSpec:
        with self._lock:
            return self._states[name].spec

    def weight_of(self, name: str) -> float:
        """The WFQ weight; a name the table lacks (the anonymous tenant)
        weighs 1.0."""
        with self._lock:
            st = self._states.get(name)
            return st.spec.weight if st is not None else 1.0

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {name: {
                "weight": st.spec.weight,
                "tier": st.spec.tier,
                "admitted": st.admitted,
                "throttled": st.throttled,
                "completed": st.completed,
                "pages_in_flight": st.pages_in_flight,
                "max_pages": st.spec.max_pages,
            } for name, st in self._states.items()}

    def _event(self, kind: str, **fields) -> dict:
        record = structured_event(kind, **fields)
        if self.on_event is not None:
            self.on_event(record)
        return record

    def authenticate(self, api_key: str) -> TenantSpec:
        """The tenant of an API key, every candidate compared in constant
        time. A tenant with an empty key is open (it matches the empty
        key); anything else unmatched is an ``AuthError``."""
        with self._lock:
            for st in self._states.values():
                key = st.spec.key
                if (key == "" and api_key == "") or \
                        auth.check_token(api_key, key):
                    return st.spec
        raise AuthError(self._event(
            "gateway_auth_failed", reason="unknown_api_key"))

    def admit(self, tenant: str, *, image_tokens: int,
              pages: int) -> None:
        """Charge one request, all or nothing: the request bucket, the
        image-token bucket, then the page budget; a refusal refunds the
        takes before it and raises ``TenantThrottled`` naming the quota."""
        with self._lock:
            st = self._states.get(tenant)
            if st is None:
                raise AuthError(self._event(
                    "gateway_auth_failed", reason="unknown_tenant",
                    tenant=tenant))
            retry = st.req_bucket.take(1.0)
            if retry > 0.0:
                st.throttled += 1
                raise TenantThrottled(self._event(
                    "tenant_throttled", tenant=tenant, quota="rps",
                    retry_after_s=round(retry, 4)))
            retry = st.tok_bucket.take(float(image_tokens))
            if retry > 0.0:
                st.req_bucket.level += 1.0
                st.throttled += 1
                raise TenantThrottled(self._event(
                    "tenant_throttled", tenant=tenant,
                    quota="image_tokens",
                    retry_after_s=round(retry, 4)))
            if st.spec.max_pages > 0 and \
                    st.pages_in_flight + pages > st.spec.max_pages:
                st.req_bucket.level += 1.0
                st.tok_bucket.level += float(image_tokens)
                st.throttled += 1
                raise TenantThrottled(self._event(
                    "tenant_throttled", tenant=tenant, quota="pages",
                    pages_in_flight=st.pages_in_flight,
                    requested=pages, max_pages=st.spec.max_pages,
                    # pages free as flights finish: one request's time
                    retry_after_s=1.0))
            st.pages_in_flight += pages
            st.admitted += 1

    def release(self, tenant: str, *, pages: int,
                completed: bool = True) -> None:
        """Return a terminal request's page reservation (the gateway
        releases once per flight; the floor at 0 only guards a release
        racing a reload that dropped and re-added the tenant)."""
        with self._lock:
            st = self._states.get(tenant)
            if st is None:
                return
            st.pages_in_flight = max(0, st.pages_in_flight - pages)
            if completed:
                st.completed += 1

    def reload(self, data) -> dict:
        """Swap in a new tenant list (``POST /admin/tenants``): tenants
        that persist keep their ledger, new ones start fresh, removed
        ones finish their flights but admit nothing more. Returns the
        ``gateway_tenants_reloaded`` event."""
        if isinstance(data, dict):
            data = data.get("tenants", [])
        specs = [TenantSpec.from_dict(d) for d in data]
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        with self._lock:
            old = set(self._states)
            states: Dict[str, TenantState] = {}
            for spec in specs:
                st = self._states.get(spec.name)
                if st is not None:
                    st.rebind(spec)
                else:
                    st = TenantState(spec, clock=self.clock)
                states[spec.name] = st
            self._states = states
            self.reloads += 1
            added = sorted(set(names) - old)
            removed = sorted(old - set(names))
        return self._event("gateway_tenants_reloaded",
                           tenants=sorted(names), added=added,
                           removed=removed)
