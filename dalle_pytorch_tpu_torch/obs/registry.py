"""Histograms and the Prometheus text exposition behind ``GET /metrics``.

Port of ``dalle_pytorch_tpu/obs/registry.py`` (``:24-249``). Counters and
gauges are sampled at each scrape from the same dicts ``/stats`` reads;
the latency histograms (queue wait, prefill, ms per token, end to end)
are fed at fulfilment and their bounded sample windows are the source of
``/stats``' percentiles, so those describe RECENT traffic. The bucket
counts are cumulative, as Prometheus wants. Text format 0.0.4: HELP and
TYPE headers, ``{label="value"}`` samples, histogram ``_bucket`` /
``_sum`` / ``_count`` lines with an ``le`` ladder ending at ``+Inf``.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# default latency ladder (seconds): sub-ms to a minute
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid Prometheus metric name {name!r}")
    return name


def escape_label_value(v) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n") \
        .replace('"', '\\"')


def format_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


class Histogram:
    """One label-set's histogram: cumulative bucket counters (the
    Prometheus contract) plus a bounded sample window (the percentile
    source)."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window: int = 4096):
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        if not self.bounds:
            raise ValueError("need at least one histogram bucket bound")
        self.counts = [0] * (len(self.bounds) + 1)   # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self._window: "deque" = deque(maxlen=int(window))
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            self._window.append(v)

    def window(self) -> List[float]:
        with self._lock:
            return list(self._window)

    def snapshot(self) -> Tuple[List[int], int, float]:
        """(bucket counts, total count, sum) under one lock — a scrape
        reading the fields piecemeal could interleave with observe()'s
        three bumps and render a cumulative bucket above _count (a
        non-monotonic le ladder breaks histogram_quantile)."""
        with self._lock:
            return list(self.counts), self.count, self.sum

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the sliding window (0.0 when
        empty — no completed requests yet)."""
        with self._lock:
            vals = sorted(self._window)
        if not vals:
            return 0.0
        return vals[min(int(q * len(vals)), len(vals) - 1)]


class LabeledHistogram:
    """A histogram family: one child ``Histogram`` per label set (the
    per-``weights_version`` split the rolling-upgrade surface needs),
    with family-wide percentiles merged across children for /stats."""

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window: int = 4096):
        self.name = _check_name(name)
        self.help = str(help_text)
        self.buckets = tuple(sorted(buckets))
        self.window = int(window)
        self._children: Dict[Tuple[Tuple[str, str], ...], Histogram] = {}
        self._lock = threading.Lock()

    def child(self, **labels) -> Histogram:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            h = self._children.get(key)
            if h is None:
                h = self._children[key] = Histogram(self.buckets,
                                                    self.window)
            return h

    def observe(self, v: float, **labels) -> None:
        self.child(**labels).observe(v)

    def children(self) -> List[Tuple[dict, Histogram]]:
        with self._lock:
            return [(dict(key), h) for key, h in self._children.items()]

    def percentiles(self, qs: Sequence[float] = (0.50, 0.95, 0.99)) \
            -> Dict[float, float]:
        """{q: seconds} over the merged window, ONE collect+sort for
        every requested quantile — /stats asks for five at a time and
        the windows can hold thousands of samples per label set."""
        vals: List[float] = []
        for _, h in self.children():
            vals.extend(h.window())
        vals.sort()
        if not vals:
            return {q: 0.0 for q in qs}
        n = len(vals)
        return {q: vals[min(int(q * n), n - 1)] for q in qs}

    def percentiles_ms(self, qs=(0.50, 0.95, 0.99)) -> dict:
        """{'p50': ms, ...} over the merged window — the /stats
        ``latency_ms`` surface."""
        ps = self.percentiles(qs)
        return {f"p{int(q * 100)}": round(1e3 * ps[q], 3) for q in qs}

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for labels, h in sorted(self.children(),
                                key=lambda kv: sorted(kv[0].items())):
            counts, count, total = h.snapshot()
            cum = 0
            for bound, n in zip(h.bounds, counts):
                cum += n
                le = dict(labels, le=_fmt_value(float(bound)))
                lines.append(f"{self.name}_bucket{format_labels(le)} "
                             f"{cum}")
            le = dict(labels, le="+Inf")
            lines.append(f"{self.name}_bucket{format_labels(le)} "
                         f"{count}")
            lines.append(f"{self.name}_sum{format_labels(labels)} "
                         f"{_fmt_value(total)}")
            lines.append(f"{self.name}_count{format_labels(labels)} "
                         f"{count}")
        return lines


# samples: iterable of (labels_dict_or_None, numeric_value)
Samples = Iterable[Tuple[Optional[dict], object]]


class Registry:
    """Holds the histogram families and renders one exposition page.
    Counters and gauges are passed as SAMPLES at render time — they are
    projections of the live /stats dicts, not a second set of state to
    keep consistent."""

    def __init__(self):
        self._hists: List[LabeledHistogram] = []

    def histogram(self, name: str, help_text: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  window: int = 4096) -> LabeledHistogram:
        h = LabeledHistogram(name, help_text, buckets=buckets,
                             window=window)
        self._hists.append(h)
        return h

    @staticmethod
    def _render_family(name: str, help_text: str, kind: str,
                       samples: Samples) -> List[str]:
        _check_name(name)
        lines = [f"# HELP {name} {help_text}", f"# TYPE {name} {kind}"]
        n = len(lines)
        for labels, value in samples:
            if value is None:
                continue
            lines.append(f"{name}{format_labels(labels)} "
                         f"{_fmt_value(value)}")
        if len(lines) == n:     # no samples: drop the headers too
            return []
        return lines

    def render(self, counters=(), gauges=()) -> str:
        """``counters``/``gauges``: iterables of (name, help, samples).
        Returns the full text page, newline-terminated."""
        lines: List[str] = []
        for name, help_text, samples in counters:
            lines.extend(self._render_family(name, help_text, "counter",
                                             samples))
        for name, help_text, samples in gauges:
            lines.extend(self._render_family(name, help_text, "gauge",
                                             samples))
        for h in self._hists:
            lines.extend(h.render())
        return "\n".join(lines) + "\n"
