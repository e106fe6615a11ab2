#!/usr/bin/env python3
"""The segmented-sum kernel's design choices, measured in turns on the card.

    python examples/probe_segment_sum_variants_torch.py

Builds ``csrc/segment_sum.cu`` as shipped and once for each variant in
``VARIANTS`` (the shipped source with one edit: the copy loop unrolled,
launch bounds of 5 or 6 blocks an SM, a lane a row of 6 or 9 columns, 2
columns a lane at W = 36), all at once, each alone with the build's flags into
``build/probe/segment_sum/<name>/``, and prints each build's ptxas
registers and spill stores.  Then, at the shapes the paths launch the
kernel at (``chip_smoke.py``'s ``segment_sum`` phase: the ba sparse camera
and landmark plans, config 4's 283-segment batch, the pose graph at P =
4,541 and the dense P = 100 block plan), it times every build as
CUDA-graph replays in turns (each build, then the same backwards; each
time the mean of its two turns) after checking that its sums equal the
shipped kernel's bit for bit, and last the shipped kernel with 2, 4, 6
and 8 piece blocks an SM (``segment_sum.LONG_BLOCKS_PER_SM``).  Prints the
card's name and power limit first.  Needs one CUDA device.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import os
import re
import shutil
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name → (text of the shipped source, its replacement)
VARIANTS = {
    "copy_loop_unrolled": ("#pragma unroll 1                                   // fewer registers, as fast",
                           "#pragma unroll"),
    "min_blocks_5": ("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 5)"),
    "min_blocks_6": ("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 6)"),
    "lane_a_row_w6": ("template <> struct ShortShape<6> { static constexpr int V = 2; };",
                      "template <> struct ShortShape<6> { static constexpr int V = 6; };"),
    "lane_a_row_w9": ("template <> struct ShortShape<9> { static constexpr int V = 3; };",
                      "template <> struct ShortShape<9> { static constexpr int V = 9; };"),
    "two_columns_w36": ("template <> struct ShortShape<36> { static constexpr int V = 4; };",
                        "template <> struct ShortShape<36> { static constexpr int V = 2; };"),
}
LONG_BLOCKS = (2, 4, 6, 8)


def build(name: str, source: str):
    """``source`` built alone into ``build/probe/segment_sum/<name>/``: its
    ``pmt_segment_sum`` with the package's argtypes, and ptxas's registers
    and spill stores by instance (``"f36"``: float32, W = 36)."""
    from points_matching_tpu_torch.ops.kernels import _build
    from probe_eightpoint_torch import ptxas_report

    d = os.path.join(ROOT, "build", "probe", "segment_sum", name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "segment_sum.cu"), "w") as f:
        f.write(source)
    shutil.copy(os.path.join(_build.CSRC, "pmt_common.cuh"), d)
    so = os.path.join(d, "libsegment_sum.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o", so,
                           os.path.join(d, "segment_sum.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.pmt_segment_sum.argtypes = _build._SIGNATURES["pmt_segment_sum"]
    lib.pmt_segment_sum.restype = ctypes.c_int
    regs = {}
    for row in ptxas_report(d, "segment_sum.cu"):
        m = re.search(r"I([fd])Li(\d+)E", row["kernel"])
        if m and "registers" in row:
            regs[m.group(1) + m.group(2)] = (row["registers"], row["spill_stores"])
    return lib, regs


def shapes(dev):
    """(tag, plan, W, dtype) at chip_smoke.py's segment_sum shapes."""
    import torch

    import chip_smoke as cs
    from points_matching_tpu_torch.ba.pose_graph import _block_plan, make_odometry_chain
    from points_matching_tpu_torch.ba.sparse import make_sparse_ba_state, sparse_plans
    from points_matching_tpu_torch.core.types import flat_rows
    from points_matching_tpu_torch.data.synthetic import make_sparse_ba_problem
    from points_matching_tpu_torch.ops.kernels import segment_sum as ss

    gen = torch.Generator(device=dev).manual_seed(14)
    prob = make_sparse_ba_problem(seed=1, num_cameras=64, num_landmarks=16384,
                                  obs_per_landmark=8, device=dev)
    ba = make_sparse_ba_state(prob["poses"], prob["X"], prob["cam_idx"], prob["lm_idx"],
                              prob["uv"], prob["obs_mask"])
    cp, lp = sparse_plans(ba)
    S, C, L, O = 283, cs.SEG4, 2048, 8192
    mask = torch.rand(S, O, generator=gen, device=dev) < 0.6
    c4c = ss.build_plan(flat_rows(torch.randint(0, C, (S, O), generator=gen, device=dev), C),
                        S * C, mask)
    c4l = ss.build_plan(flat_rows(torch.randint(0, L, (S, O), generator=gen, device=dev), L),
                        S * L, mask)
    P = 4541
    g = make_odometry_chain(cs._circuit_poses(P, 500, dev),
                            torch.Generator(device=dev).manual_seed(P),
                            loop_edges=tuple((i, i + 500) for i in range(0, P - 500, 500)))
    g1 = make_odometry_chain(cs._circuit_poses(100, 99, dev),
                             torch.Generator(device=dev).manual_seed(100), odom_noise=0.01,
                             loop_edges=((0, 99),), loop_weight=20.0)
    pg = ss.build_plan(torch.cat([g.edges_i, g.edges_j]), P)
    f32, f64 = torch.float32, torch.float64
    return [("ba sparse cameras", cp, 36, f32), ("ba sparse cameras", cp, 6, f32),
            ("ba sparse landmarks", lp, 9, f32), ("ba sparse landmarks", lp, 3, f32),
            ("config4 cameras", c4c, 36, f32), ("config4 landmarks", c4l, 9, f32),
            ("pose graph P=4541", pg, 6, f64), ("pose graph P=4541", pg, 36, f64),
            ("pose graph dense P=100", _block_plan(g1), 36, f64)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_segment_sum_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from points_matching_tpu_torch.core.device import pin_fp32
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.ops.kernels import segment_sum as ss
    from points_matching_tpu_torch.utils.profiling import cuda_graph_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    pin_fp32()
    dev = torch.device("cuda")
    with open(os.path.join(_build.CSRC, "segment_sum.cu")) as f:
        shipped = f.read()
    sources = {"shipped": shipped}
    for name, (old, new) in VARIANTS.items():
        if shipped.count(old) != 1:
            raise RuntimeError(f"variant {name}: its text is not once in segment_sum.cu")
        sources[name] = shipped.replace(old, new)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:   # nvcc in parallel
        built = dict(zip(sources, pool.map(build, sources, sources.values())))
    libs = {}
    for name, (lib, regs) in built.items():
        libs[name] = lib
        print(f"build {name}: registers, spill stores {regs}", flush=True)
    real, per_sm_default = ss._build, ss.LONG_BLOCKS_PER_SM

    def use(name):
        """the wrapper's ``_build`` with ``libs[name]`` as its library"""
        ss._build = types.SimpleNamespace(library=lambda: libs[name], check=real.check,
                                          sm_count=real.sm_count)

    gen = torch.Generator(device=dev).manual_seed(15)
    order = list(libs) + list(libs)[::-1]
    try:
        for tag, plan, W, dtype in shapes(dev):
            values = torch.randn(plan.num_entries, W, generator=gen, device=dev, dtype=dtype)
            use("shipped")
            ref = ss.segment_sum(values, plan)
            times = {name: [] for name in libs}
            for name in order:
                use(name)
                got = ss.segment_sum(values, plan)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise RuntimeError(f"{name} differs from the shipped kernel at {tag} W = {W}")
                times[name].append(cuda_graph_ms(lambda: ss.segment_sum(values, plan)))
            print(f"{tag} W = {W} {str(dtype)[6:]}: ms " + ", ".join(
                f"{name} {sum(t) / 2:.5f}" for name, t in times.items()), flush=True)
            if plan.pieces[-1] > 0:
                use("shipped")
                per_sm = {}
                for lb in LONG_BLOCKS + LONG_BLOCKS[::-1]:
                    ss.LONG_BLOCKS_PER_SM = lb
                    per_sm.setdefault(lb, []).append(
                        cuda_graph_ms(lambda: ss.segment_sum(values, plan)))
                ss.LONG_BLOCKS_PER_SM = per_sm_default
                print(f"{tag} W = {W} {str(dtype)[6:]}: ms by piece blocks an SM " + ", ".join(
                    f"{lb} {sum(t) / 2:.5f}" for lb, t in per_sm.items()), flush=True)
    finally:
        ss._build, ss.LONG_BLOCKS_PER_SM = real, per_sm_default
    return 0


if __name__ == "__main__":
    sys.exit(main())
