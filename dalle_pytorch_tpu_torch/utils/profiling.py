"""The ``--profile_dir`` hook: a torch.profiler trace of a few steps.

Port of ``dalle_pytorch_tpu/utils/profiling.py``'s ``StepProfiler``: the
window [start, start + steps) of a training loop is traced (host, and the
card's kernels when there is one) and written as a Chrome trace,
``{log_dir}/trace-steps{start}-{stop}.json`` (Perfetto opens it).
"""

from __future__ import annotations

import os
from typing import Optional

import torch


class StepProfiler:
    """    prof = StepProfiler(log_dir, start=10, steps=3)
        for i, batch in ...:
            prof.maybe_start(i)
            ...train step...
            prof.maybe_stop(i)
    """

    def __init__(self, log_dir: Optional[str], start: int = 10,
                 steps: int = 3):
        self.log_dir = log_dir
        self.start = start
        self.stop_at = start + steps
        self._prof = None
        self.trace_path = None

    def maybe_start(self, step: int) -> None:
        if self.log_dir and self._prof is None and step == self.start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step + 1 >= self.stop_at:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir, f"trace-steps{self.start}-{self.stop_at}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
