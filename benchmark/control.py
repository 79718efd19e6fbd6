"""The control of ``correct``: the plain reference put in the program's
place and computed in TF32 (``reference/<metric>.py``'s ``knn`` with
``control=True``), the precision just below the float32 (TF32 off) the
configurations state. Every judged answer of a cell is its answer, at
the cell's own sizes and inputs; the judge has to find it not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--judged N]

``--judged N`` holds the control to the first N judged queries in the
seed's order, as many as a run answers, where a run answers fewer than its
pool (one query a call). One line a seed on standard output: the numbers compared, beside their
limits, and ``correct``. Exits non-zero if any seed's control is correct.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_verdict(spec, cell_name: str, seed: int, device, judged: int | None = None):
    """The judge's verdict on the control's answers for one seed."""
    import numpy as np
    import torch

    from benchmark import data, judge

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    inputs = data.make(spec.generator(cfg["generator"]), cfg, mix, seed, device)
    rows = {"query": inputs.judged[:judged]}
    if inputs.graph_rows is not None:
        rows["graph"] = inputs.graph_rows
    empty = np.zeros((0,))
    shape = {name: (r, empty, empty, np.zeros(len(r), np.int64)) for name, r in rows.items()}
    ref = spec.reference(cfg["metric"])
    answers = judge.reference_answers(ref, shape, inputs, cfg["k"], device, control=True)
    return judge.judge(ref, answers, inputs, cfg, spec.limits(cell_name), device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--judged", type=int, default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    any_correct = False
    for seed in (int(s) for s in args.seeds.split(",")):
        v = control_verdict(spec, args.workload, seed, torch.device("cuda", 0), args.judged)
        any_correct |= v.correct
        print(json.dumps({"workload": args.workload, "seed": seed, "judged": args.judged,
                          "correct": v.correct,
                          "checks": v.checks}), flush=True)
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())
