#!/usr/bin/env python3
"""What K3 (the batched minimal 8-point solve) costs on the card.

    python examples/probe_eightpoint_torch.py --ptxas [CSRC_DIR]
    python examples/probe_eightpoint_torch.py --groups [--parent CSRC_DIR]
    python examples/probe_eightpoint_torch.py --phases

``--ptxas`` compiles ``eightpoint.cu`` (from CSRC_DIR, by default the
package's ``csrc/``) with the build's flags and ``-Xptxas -v`` into a
temporary cubin and prints, for each kernel, what ptxas reports: registers
a thread, spill stores and loads, stack frame and shared memory, and its
warnings and notes on the kernel they name.  It needs ``nvcc`` only, no
card.

``--groups`` times the kernel with each lane-group size G forced
(CUDA-graph replays, 50 launches × 5) over a sweep of batch sizes, 1 to 64
pairs of 512 samples (one pair is what the slices launch, 64 the batched
shape), in turns, and checks every G against the plain version bit for
bit.  For each size it prints the G that ``_build.eight_point_group``
picks and the fastest G; first the launch floor (a graph of one-element
``add_`` launches, timed the same way) and the card's name and power
limit.
With ``--parent CSRC_DIR`` it also builds the one-thread-per-sample kernel
of an earlier tree (whose ``pmt_eight_point`` takes sp1, sp2, F, count,
stream) and times it in turns with the others: parent, each G, then the
same backwards.  Needs one CUDA device.

``--phases`` compiles an instrumented copy of ``eightpoint.cu`` (the
package's source is not changed: the probe inserts ``clock64()`` reads at
the phase boundaries, found by the lines listed in ``PHASE_MARKS``) and
prints, for each G at one and 64 pairs, the mean SM clocks that thread 0
of a block spends in each phase of one launch: staging, Hartley + AᵀA, the
9×9 Cholesky, the 4 inverse iterations, the 3×3 stage, and the
normalization and sign.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def ptxas_report(csrc: str, source: str = "eightpoint.cu", sass: bool = False) -> list:
    """ptxas's resource lines for each kernel of ``csrc/<source>``; with
    ``sass``, also each kernel's SASS opcodes and their counts (from
    ``cuobjdump -sass`` of the same cubin)."""
    from points_matching_tpu_torch.ops.kernels import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "kernel.cubin")
        proc = subprocess.run(
            [_build._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-I", csrc,
             "-o", cubin, os.path.join(csrc, source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        dump = ""
        if sass:
            cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
            dump = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                                  text=True, check=True).stdout
    rows, name = [], None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            stack, st, ld = map(int, m.groups())
            rows.append(dict(kernel=name, stack=stack, spill_stores=st, spill_loads=ld))
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and rows and rows[-1]["kernel"] == name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            rows[-1].update(registers=int(m.group(1)),
                            smem=int(smem.group(1)) if smem else 0)
    # ptxas's warnings and notes (a wgmma serialised, say), on the kernels they name
    notes = [ln.strip() for ln in proc.stderr.splitlines()
             if "warning" in ln.lower() or "Performance" in ln]
    for line in notes:
        owners = [row for row in rows if row["kernel"] in line]
        if not owners:
            rows.append(dict(kernel="(unnamed)"))
            owners = rows[-1:]
        for row in owners:
            row.setdefault("notes", []).append(line)
    if sass:
        opcodes, name = {}, None
        for line in dump.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                opcodes[name] = {}
                continue
            m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m and name:
                op = m.group(1).split(".")[0]
                opcodes[name][op] = opcodes[name].get(op, 0) + 1
        for row in rows:
            row["sass"] = dict(sorted(opcodes.get(row["kernel"], {}).items(),
                                      key=lambda kv: -kv[1]))
    return rows


def parent_kernel(csrc: str):
    """The earlier tree's K3 as a callable (sp1, sp2) → F, from its own
    build of ``eightpoint.cu``."""
    import ctypes

    import torch

    from points_matching_tpu_torch.ops.kernels import _build

    out = os.path.join(ROOT, "build", "probe", "libparent_eightpoint.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out,
                           os.path.join(csrc, "eightpoint.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    fn = ctypes.CDLL(out).pmt_eight_point
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(sp1, sp2):
        F = torch.empty((*sp1.shape[:-2], 3, 3), dtype=torch.float32, device=sp1.device)
        rc = fn(sp1.data_ptr(), sp2.data_ptr(), F.data_ptr(), sp1.numel() // 16,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent pmt_eight_point: CUDA error {rc}")
        return F

    return run


PHASES = ("staging", "hartley+ata", "cholesky", "iterations", "3x3", "sign")
# where the instrumented copy reads the clock: (mark, the start of a line of
# eightpoint.cu, before or after that line); thread 0 of a block records mark k at [block][k]
PHASE_MARKS = (
    (0, "// 1. stage the inputs", "before"),
    (1, "// 2. Hartley and AᵀA", "before"),
    (2, "// 3. the serial core", "before"),
    (3, "cholesky<9>(A, L, invd);", "after"),
    (4, "inverse_iteration<9, 4>(L, invd, f);", "after"),
    (5, "inverse_iteration<3, 8>(L3, invd3, v3);", "after"),
    (6, "const int g = base + static_cast<int>(threadIdx.x);", "before"),
)
PHASE_HEADER = """
__device__ long long* pmt_k3_clocks = nullptr;     // [blocks][8]
#define PMT_PHASE(k) do { if (threadIdx.x == 0 && pmt_k3_clocks) { long long t_; \\
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_)::"memory"); \\
  pmt_k3_clocks[blockIdx.x * 8 + (k)] = t_; } } while (0)
"""
PHASE_FOOTER = """
PMT_EXPORT int pmt_eight_point_set_clocks(void* clocks) {
  return static_cast<int>(cudaMemcpyToSymbol(pmt_k3_clocks, &clocks, sizeof(clocks)));
}
"""


def instrumented_source(text: str) -> str:
    """``eightpoint.cu`` with a clock read at each of ``PHASE_MARKS``."""
    lines = text.splitlines()
    for k, anchor, where in PHASE_MARKS:
        at = [i for i, line in enumerate(lines) if line.strip().startswith(anchor)]
        if len(at) != 1:
            raise RuntimeError(f"phase mark {k}: {anchor!r} found {len(at)} times in "
                               "eightpoint.cu")
        lines.insert(at[0] + (where == "after"), f"  PMT_PHASE({k});")
    out = "\n".join(lines) + "\n" + PHASE_FOOTER
    head = '#include "pmt_common.cuh"\n'
    return out.replace(head, head + PHASE_HEADER, 1)


def samples(B: int = 64, N: int = 512, H: int = 512):
    """chip_smoke.py's K3 inputs: B scenes × H samples of 8 distinct
    correspondences."""
    import torch

    from chip_smoke import _scenes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p1, p2, _ = _scenes(B, N, gen, dev)
    pick = torch.rand(B, H, N, generator=gen, device=dev).topk(8, dim=-1).indices
    return tuple(torch.gather(p[:, None].expand(B, H, N, 2), 2,
                              pick[..., None].expand(B, H, 8, 2)).contiguous()
                 for p in (p1, p2))


def phases() -> None:
    """Mean clocks per phase of thread 0 of each block, one launch per G
    and shape, from an instrumented copy of the kernel."""
    import ctypes

    import torch

    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
        GROUPS, samples_per_block)

    work = os.path.join(ROOT, "build", "probe")
    os.makedirs(work, exist_ok=True)
    csrc = os.path.join(ROOT, "points_matching_tpu_torch", "csrc")
    with open(os.path.join(csrc, "eightpoint.cu"), encoding="utf-8") as f:
        patched = instrumented_source(f.read())
    cu = os.path.join(work, "eightpoint_phases.cu")
    with open(cu, "w", encoding="utf-8") as f:
        f.write(patched)
    out = os.path.join(work, "libk3_phases.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", out, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    lib.pmt_eight_point.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.pmt_eight_point_set_clocks.argtypes = [ctypes.c_void_p]
    sp1, sp2 = samples()
    print("phases (mean SM clocks of thread 0 a block): " + ", ".join(PHASES))
    for nb in (1, sp1.shape[0]):
        a, c = sp1[:nb], sp2[:nb]
        count = a.numel() // 16
        F = torch.empty(count, 9, device=a.device)

        def launch(g):
            rc = lib.pmt_eight_point(a.data_ptr(), c.data_ptr(), F.data_ptr(), count, g,
                                     torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"pmt_eight_point: CUDA error {rc}")

        for g in GROUPS:
            blocks = -(-count // samples_per_block(g))
            clocks = torch.zeros(blocks, 8, dtype=torch.int64, device=a.device)
            for _ in range(3):
                launch(g)
            torch.cuda.synchronize()
            lib.pmt_eight_point_set_clocks(clocks.data_ptr())
            launch(g)
            torch.cuda.synchronize()
            lib.pmt_eight_point_set_clocks(None)
            d = (clocks[:, 1:7] - clocks[:, :6]).double().mean(0).tolist()
            total = float((clocks[:, 6] - clocks[:, 0]).double().mean())
            print(f"  samples {count} G {g}: " + " / ".join(f"{x:.0f}" for x in d)
                  + f"; total {total:.0f}")


SWEEP_PAIRS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def groups(parent_csrc) -> None:
    import torch

    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
        GROUPS, minimal_eight_point, minimal_eight_point_plain)
    from points_matching_tpu_torch.utils.profiling import cuda_graph_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda")
    sms = _build.sm_count(0)
    parent = parent_kernel(parent_csrc) if parent_csrc else None
    one = torch.zeros(1, device=dev)
    print(f"launch_floor_ms {cuda_graph_ms(lambda: one.add_(1)):.5f}")
    sp1, sp2 = samples()
    for nb in SWEEP_PAIRS:
        a, c = sp1[:nb], sp2[:nb]
        count = a.numel() // 16
        want = minimal_eight_point_plain(a, c)
        runs = {g: (lambda g=g: minimal_eight_point(a, c, _group=g)) for g in GROUPS}
        if parent:
            runs["parent"] = lambda: parent(a, c)
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} at {count} samples differs from plain: "
                                   f"{float((got - want).abs().max())}")
        order = (["parent"] if parent else []) + list(GROUPS)
        times = {k: [] for k in order}
        for name in order + order[::-1]:
            times[name].append(cuda_graph_ms(runs[name]))
        best = min(GROUPS, key=lambda g: max(times[g]))
        rule = _build.eight_point_group(count, sms)
        print(f"samples {count}: rule G = {rule}, fastest G = {best} (by the slower turn); "
              "all equal plain bit for bit")
        for name in order:
            print(f"  {name}: " + " / ".join(f"{t:.5f}" for t in times[name]) + " ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ptxas", nargs="?", const=os.path.join(
        ROOT, "points_matching_tpu_torch", "csrc"), metavar="CSRC_DIR")
    ap.add_argument("--groups", action="store_true")
    ap.add_argument("--parent", metavar="CSRC_DIR")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if args.ptxas:
        for row in ptxas_report(args.ptxas):
            print("ptxas", row)
    if args.groups:
        groups(args.parent)
    if args.phases:
        phases()
    return 0


if __name__ == "__main__":
    sys.exit(main())
