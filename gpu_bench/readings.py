#!/usr/bin/env python3
"""The readings the limits of a cell's check are set from, in one process
on the card (the benchmark's runs never run this):

* lower: the program's numbers on each of ``--seeds``, each from a short
  window at the cell's own load and the same check as a run;
* upper: the control's numbers on each of ``--control-seeds``: the
  reference computed in TF32 (``gpu_bench/reference``) put in the program's
  place on the cell's own inputs, judged by the same check; and, with
  ``--fault``, the program's numbers with that fault planted in its search
  (``gpu_bench/faults.py``) on each of ``--fault-seeds``.

    python3 gpu_bench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--fault few_hypotheses --fault-seeds 7,8,9] \
        [--seconds 3] [--out FILE]

One JSON line a seed on standard output (and appended to ``--out``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", action="append", default=[],
                    help="a fault of gpu_bench/faults.py (repeatable)")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from gpu_bench import faults, harness
    from gpu_bench.generators import derive_seed

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    spec = harness.resolve(harness.load_benchmark(ROOT), args.workload, ROOT)
    if spec["cell"]["chips"] > 1:
        if args.seeds:
            ap.error("a cell on several chips reads the program's numbers from its runs")
        spec["cell"] = dict(spec["cell"], chips=1)    # the control runs in this process alone
    torch.backends.cuda.matmul.allow_tf32 = bool(spec["config"].get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(spec["config"].get("tf32", False))
    limits = spec["workload"]["check"]["limits"]

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    runs = [("program", None, _seeds(args.seeds)), ("control", None, _seeds(args.control_seeds))]
    runs += [("fault", name, _seeds(args.fault_seeds)) for name in args.fault]
    for kind, fault, seeds in runs:
        for seed in seeds:
            t = time.perf_counter()
            driver = harness.driver_for(spec, dev, seed)
            if kind != "control":
                with faults.planted(fault) if fault else contextlib.nullcontext():
                    driver.setup()
                    kept = harness.Reservoir(spec["workload"]["check"]["batches"],
                                             derive_seed(seed, 9))
                    win = harness.closed_loop(driver, args.seconds, spec["traffic"]["in_flight"],
                                              kept)
                driver.release()
                numbers = driver.check(win.kept)
                extra = dict(batches=win.batches, fault=fault)
            else:
                driver.setup()
                driver.release()
                numbers = driver.judge([driver.control_outputs(j) for j in
                                        range(spec["workload"]["check"]["batches"])])
                extra = {}
            emit(dict(workload=args.workload, kind=kind, seed=seed, numbers=numbers, limits=limits,
                      seconds=round(time.perf_counter() - t, 3), **extra))
            del driver
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
