"""The traced window: a ``torch.profiler`` run over it, reduced in memory.

On a CUDA device the profiler records the device's activity alone (kernels,
copies, sets, and the CUDA runtime and driver API calls that the device tracer
sees), not PyTorch's operators: recording every operator slowed a 1M build
by 40% and doubled its idle share. No trace file is written. The events are
read once into arrays, from which the per-layer readers
(``metrics/*.py``) and the result's ``breakdown`` are computed.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel"}
# calls in which the host waits for the device: every device-to-host copy of
# PyTorch ends in a stream synchronisation, so copies are not counted again
SYNC_CALLS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy"}
TOP = 10


@dataclass
class Trace:
    t0: int  # the window's range, ns
    t1: int
    names: list[str]
    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_name: np.ndarray
    host_start: np.ndarray
    host_end: np.ndarray
    host_name: np.ndarray
    calls: Counter = field(default_factory=Counter)  # runtime / driver calls by name

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        s, e = _union(self.dev_start, self.dev_end, self.t0, self.t1)
        return float((e - s).sum()) * 1e-9

    def idle_pct(self) -> float | None:
        if self.dev_start.size == 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def device_s(self, contains: str) -> float:
        """Summed device seconds of the operations whose name contains ``contains``."""
        codes = [i for i, n in enumerate(self.names) if contains in n]
        m = np.isin(self.dev_name, codes)
        return float((self.dev_end[m] - self.dev_start[m]).sum()) * 1e-9

    def count_calls(self, names) -> int:
        return sum(self.calls[n] for n in names)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps'
        time summed by what the host was doing: the runtime call in progress
        at a gap's middle, else its Python and operators before the device
        operation that ended the gap. At most ``TOP`` of each, largest first."""
        dur = (self.dev_end - self.dev_start).astype(np.float64) * 1e-9
        by_name = np.bincount(self.dev_name, weights=dur, minlength=len(self.names))
        top = np.argsort(-by_name)[:TOP]
        ops = [[self.names[i][:160], float(by_name[i])] for i in top if by_name[i] > 0]
        s, e = _union(self.dev_start, self.dev_end, self.t0, self.t1)
        g0 = np.concatenate([[self.t0], e])
        g1 = np.concatenate([s, [self.t1]])
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        # the runtime call in progress at each gap's middle (calls do not nest)
        mid = (g0 + g1) // 2
        label = np.full(mid.shape, -1, np.int64)
        if self.host_start.size:
            at = np.searchsorted(self.host_start, mid, side="right") - 1
            live = (at >= 0) & (self.host_end[np.maximum(at, 0)] >= mid)
            label = np.where(live, self.host_name[np.maximum(at, 0)], -1)
        # else the device operation that ended the gap
        order = np.argsort(self.dev_start, kind="stable")
        nxt = np.searchsorted(self.dev_start[order], g1, side="left")
        after = np.full(nxt.shape, -2, np.int64)
        if order.size:
            ended_by = self.dev_name[order[np.minimum(nxt, order.size - 1)]]
            after = np.where(nxt < order.size, ended_by, -2)
        gaps = Counter()
        sec = (g1 - g0).astype(np.float64) * 1e-9
        for (lv, code), t in _sum_by(np.stack([label, after], 1), sec):
            if lv >= 0:
                name = self.names[lv]
            elif code >= 0:
                name = f"host, before {self.names[code]}"
            else:
                name = "host, to the window's end"
            gaps[name[:160]] += t
        return {"device_ops": ops, "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}


def _sum_by(keys: np.ndarray, values: np.ndarray):
    """Sum ``values`` by the rows of ``keys``: ((key row), total) pairs."""
    if keys.size == 0:
        return []
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    tot = np.bincount(inv.ravel(), weights=values, minlength=len(uniq))
    return [(tuple(int(x) for x in u), float(t)) for u, t in zip(uniq, tot)]


def _union(start, end, t0, t1):
    """Disjoint sorted intervals covering [start, end) clipped to [t0, t1)."""
    if start.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(start, kind="stable")
    s = np.clip(start[order], t0, t1)
    e = np.clip(end[order], t0, t1)
    e_max = np.maximum.accumulate(e)
    new = s[1:] > e_max[:-1]
    starts = s[np.concatenate([[True], new])]
    ends = e_max[np.concatenate([new, [True]])]
    keep = ends > starts
    return starts[keep], ends[keep]


class Tracer:
    """Profiles the block it wraps when enabled; ``extract`` gives the Trace."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self._prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        if self.device.type != "cuda":
            raise ValueError("the traced window profiles a CUDA device")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    record_shapes=False, profile_memory=False,
                                    with_stack=False) as prof:
            yield
            torch.cuda.synchronize(self.device)
        self._prof = prof

    def extract(self) -> Trace | None:
        if self._prof is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return reduce_events(events)


def reduce_events(events) -> Trace:
    """Read the profiler's events into a Trace spanning them.

    Events are told apart by their device and name, which every PyTorch
    release gives (``activity_type`` is not in all of them): device events
    are kernels, copies and sets; host events are runtime and driver calls
    (names that start with ``cu``)."""
    names: dict[str, int] = {}
    dev, host, calls = [], [], Counter()
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        code = names.setdefault(name, len(names))
        if "CUDA" in str(ev.device_type()):
            dev.append((s, e, code))
        elif name.startswith("cu"):
            host.append((s, e, code))
            calls[name] += 1
    dev_a = np.array(dev, dtype=np.int64).reshape(-1, 3)
    host_a = np.array(host, dtype=np.int64).reshape(-1, 3)
    host_a = host_a[np.argsort(host_a[:, 0], kind="stable")]
    both = np.concatenate([dev_a[:, :2], host_a[:, :2]])
    if both.size == 0:
        raise RuntimeError("the profiler recorded no event in the window")
    return Trace(int(both[:, 0].min()), int(both[:, 1].max()), list(names), dev_a[:, 0],
                 dev_a[:, 1], dev_a[:, 2], host_a[:, 0], host_a[:, 1], host_a[:, 2], calls)
