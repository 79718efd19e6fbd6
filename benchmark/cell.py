"""One run of one cell: inputs, set-up, the measured window, the program's
work after it, then the reference and the metrics."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

import torch

from benchmark import data, judge, stats
from benchmark.spec import Spec
from benchmark.loops import sync
from benchmark.trace import Trace, Tracer


@dataclass
class RunInfo:
    """What a per-layer reader (``metrics/<name>.py``) gets: the cell's
    configuration, mix and resolved index parameters, what the traced
    window did (builds, queries, and the builds' summed ``phase_times_``),
    and its trace."""
    cell: dict
    config: dict
    traffic: dict
    index: dict  # NNDescent keywords the builds used
    builds: int
    queries: int
    phases: dict
    trace: Trace | None


def _note(msg: str):
    print(msg, file=sys.stderr, flush=True)


def run_cell(spec: Spec, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """The result of one run, as the contract's JSON object (and ``checks``)."""
    from pynndescent_torch import NNDescent

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = spec.limits(cell_name)
    ref = spec.reference(cfg["metric"])  # refused here, before any work, if missing
    Loop = spec.loop(mix["kind"])

    t0 = time.perf_counter()
    inputs = data.make(spec.generator(cfg["generator"]), cfg, mix, seed, device)
    t1 = time.perf_counter()
    loop = Loop(NNDescent, cfg, mix, inputs, seed, device,
                profile=trace and bool(mix.get("trace_phases")))
    loop.warm()
    sync(device)
    setup_s = time.perf_counter() - t_start
    _note(f"set-up {setup_s:.3f} s: imports and context {t0 - t_start:.3f}, inputs {t1 - t0:.3f}, "
          f"warm {time.perf_counter() - t1:.3f}")

    length = min(seconds, mix.get("trace_seconds", seconds)) if trace else seconds
    tracer = Tracer(trace, device)
    with tracer.window():
        win = loop.window(length)
    if win.failed == 0:
        loop.after()
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    loop.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = tracer.extract()
    if tr is not None:
        _note(f"trace: {tr.dev_start.size} device ops, {tr.host_start.size} runtime calls, read in "
              f"{time.perf_counter() - t0:.3f} s; calls {dict(tr.calls.most_common(12))}")
    _note(f"window {win.seconds:.3f} s: {win.builds} builds, {win.queries} queries, "
          f"{win.failed} failed; peak {peak} bytes")
    if win.latencies:
        q = [1e3 * stats.percentile(win.latencies, p) for p in (0, 50, 95, 100)]
        _note("call ms: min {:.3f} median {:.3f} p95 {:.3f} max {:.3f}".format(*q))
    for line in win.notes:
        _note(line)

    t0 = time.perf_counter()
    answers = {name: arr for name, a in loop.answers.items() if (arr := a.arrays()) is not None}
    verdict = judge.judge(ref, answers, inputs, cfg, limits, device)
    _note(f"reference and judge {time.perf_counter() - t0:.3f} s")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if trace:
        info = RunInfo(cell, cfg, mix, dict(loop.index_kw), win.builds, win.queries, win.phases,
                       tr)
        wanted = spec.per_layer(cell_name)
        values = {m["name"]: spec.reader(m["name"])(info) for m in wanted}
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    else:
        wanted = spec.end_to_end(cell_name)
        values = {"setup_s": setup_s, "recall10": verdict.recall10, **win.values()}
    # a reader that finds nothing returns None and its metric is left out
    metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
               for m in wanted if values.get(m["name"]) is not None}
    missing = [m["name"] for m in wanted if m["name"] not in metrics]
    if missing and not trace:
        _note(f"{cell_name}: no reading of {missing}")
    result = {"correct": (verdict.correct and win.failed == 0 and win.attempted > 0
                          and not (missing and not trace)),
              "attempted": win.attempted, "failed": win.failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = tr.breakdown()
    result["checks"] = verdict.checks
    return result
