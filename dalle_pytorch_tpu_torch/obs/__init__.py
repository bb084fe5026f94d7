"""Serving observability: per-request traces, the flight recorder and
the metrics registry behind ``/metrics``.

Port of ``dalle_pytorch_tpu/obs/``: ``trace`` (span timelines that tile
a request's latency), ``flight`` (the always-on ring of recent events
behind ``/debug/events``) and ``registry`` (sliding-window histograms
and the Prometheus text exposition). Standard library only.
"""

from dalle_pytorch_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder, RecordingMetrics, wrap_metrics)
from dalle_pytorch_tpu_torch.obs.registry import (  # noqa: F401
    Histogram, LabeledHistogram, Registry)
from dalle_pytorch_tpu_torch.obs.trace import Trace, new_trace_id  # noqa: F401
