"""Where the host's time goes when it enqueues one segmented sum
(``ops/kernels/segment_sum.py``) on the card, at the pose graph's shape
(P = 4,541 poses, the 9,098 endpoints [ei; ej], float64, W = 6), beside
the scatter it replaced (``torch.zeros`` + ``index_add_``) and the pieces
of the wrapper: the C call alone (one kernel launch), the input checks,
the output's ``torch.empty``, the stream handle (``current_stream()``
against the raw handle) and a ``torch.cat`` of two [E, 6] halves.

    python examples/probe_segment_sum_host_torch.py [--calls N]

Each row is the best of 3 rounds of N calls back to back (no wait; the
card finishes each call faster than the host enqueues it), in µs a call.
Prints one line a row and, last, the card's name and power limit.
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import segment_sum as ss


def _us(fn, calls: int) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(best)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=3000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_segment_sum_host_torch: no CUDA device")
        return 2
    dev = torch.device("cuda")
    P, E = 4541, 4549
    gen = torch.Generator(device=dev).manual_seed(0)
    ends = torch.randint(0, P, (2 * E,), generator=gen, device=dev)
    plan = ss.build_plan(ends, P)
    v = torch.randn(2 * E, 6, generator=gen, device=dev, dtype=torch.float64)
    lib = _build.library()
    out = torch.empty((P, 6), dtype=v.dtype, device=dev)
    ss.segment_sum(v, plan)                      # makes the plan's scratch
    part = plan.scratch[v.dtype, 6]
    stream = torch.cuda.current_stream().cuda_stream
    long_blocks = min(plan.piece_rows.shape[0],
                      ss.LONG_BLOCKS_PER_SM * _build.sm_count(dev.index or 0))
    c_args = (v.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
              plan.pieces.data_ptr(), plan.piece_rows.data_ptr(), out.data_ptr(),
              part.data_ptr(), plan.scratch["arrivals"].data_ptr(), P, 6, long_blocks, 1,
              stream)
    rows = dict(
        segment_sum=lambda: ss.segment_sum(v, plan),
        zeros_index_add=lambda: torch.zeros((P, 6), dtype=v.dtype,
                                            device=dev).index_add_(0, ends, v),
        index_add_only=lambda: out.index_add_(0, ends, v),
        c_call=lambda: lib.pmt_segment_sum(*c_args),
        check_inputs=lambda: ss._check_inputs(v, plan),
        empty=lambda: torch.empty((P, 6), dtype=v.dtype, device=dev),
        current_stream=lambda: torch.cuda.current_stream().cuda_stream,
        raw_stream=lambda: torch._C._cuda_getCurrentRawStream(dev.index or 0),
        cat=lambda: torch.cat([v[:E], v[E:]]),
    )
    for name, fn in rows.items():
        print(f"host {name}: {_us(fn, args.calls):.2f} us a call", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
