#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card and print its result
as the last line of standard output.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 gpu_bench/run.py --list      # every cell resolved to its files

Set-up (the kernels built at first use into ``build/kernels/`` inside the
checkout, the inputs made on the card from the seed, a warm-up of the
cell's own shapes), then a closed loop for ``--seconds``, then the check
against the plain reference.  ``--trace 1`` traces a few whole batches
with ``torch.profiler`` and reports the per-layer metrics; ``--trace 0``
the end-to-end ones.  Exits 2 without a card (or with fewer than the cell
asks for), 3 when a forbidden module (JAX, the JAX package) is loaded;
neither prints a result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true", help="resolve every cell and print it")
    args = ap.parse_args(argv)

    from gpu_bench import harness

    if args.list:
        print(json.dumps(harness.list_all(ROOT), indent=1))
        return 0
    if not args.workload:
        ap.error("--workload is required")
    if args.seed < 0:
        ap.error("--seed must be non-negative")
    import torch

    bench = harness.load_benchmark(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              root=ROOT)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the run's process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
