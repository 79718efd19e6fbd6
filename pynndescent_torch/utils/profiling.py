"""Structured phase timings (``NNDescent(..., profile=True)`` ->
``index.phase_times_``), the counterpart of pynndescent_tpu/utils/profiling.py.

CUDA runs asynchronously, so each phase exit synchronises the device when
profiling is on; when it is off no synchronisation is added. Each phase is
also a ``phase/<name>`` range of ``torch.profiler``. A directory
given as ``profile`` additionally records a ``torch.profiler`` trace of the
build there.
"""

from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """Accumulates wall seconds per named phase. Disabled instances are
    no-ops so the hot path can call them unconditionally."""

    def __init__(self, profile=False, device=None):
        self.enabled = bool(profile)
        self.trace_dir = profile if isinstance(profile, str) else None
        self.device = torch.device(device) if device is not None else None
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name):
        if not self.enabled:
            yield self
            return
        self.block()
        t0 = time.perf_counter()
        try:
            # a range of its own in a torch.profiler trace of the build
            with torch.profiler.record_function(f"phase/{name}"):
                yield self
        finally:
            self.block()
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def trace(self):
        """One profiler trace over the enclosing region (the whole build)."""
        if self.trace_dir is None:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(self.trace_dir),
        ):
            yield

    def block(self):
        """Wait for the device at a phase boundary (no-op when profiling is
        off, or on the CPU, where torch runs synchronously)."""
        if self.enabled and self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
