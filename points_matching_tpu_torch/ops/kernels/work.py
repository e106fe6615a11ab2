"""The work of each kernel: the bytes it must move and the operations it
must do on given inputs, and the least time the card could take for them.

One source for ``chip_smoke.py``'s kernel table and for
``utils/profiling.roofline``: each wrapper carries its count as a ``work``
attribute taking the wrapper's own arguments (``fused_l2_top2.work(q, t,
t_mask)``), and ``bound`` turns a count into a time against a device's
peaks (``utils/profiling.chip_peaks``).  A kernel launched through ctypes
is invisible to ``torch.utils.flop_counter``, so the counts are written
here by hand:

* bytes: each input read once, each output written once;
* operations: in the unit the kernel is bound by — fp32 FMA flops (an FMA
  is two) for K1, one instruction per unfused fp32 operation for K2 and K3
  (built with ``--fmad=false``) and for the segmented sum's f32 adds (its
  f64 adds at the fp64 rate), population counts for K4.  Where the work
  depends on the data it is counted from the inputs: a masked train row of
  K1 or K4 needs no distance, so only the valid rows count.
* a kernel that spends two units — the probes' tensor-core kernels: bf16
  products on the matrix unit and an fp32 or integer epilogue a cell on
  the CUDA cores — carries the second in ``more``; its bound is the
  largest of the three times, and ``bound_unit`` says which unit set the
  operations' time.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

# which entry of ``chip_peaks`` is the rate of each unit
UNIT_RATE = {"flops": "flops", "instr": "instr_per_s", "popc": "popc_per_s",
             "bf16_tc": "bf16_tc_flops", "f64_instr": "f64_instr_per_s"}


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    ops: float
    unit: str            # a key of UNIT_RATE
    more: tuple = ()     # ((ops, unit), ...) spent in other units beside ``ops``


def bound(work: Work, peaks: dict) -> dict:
    """The least time for ``work`` on a device with ``peaks``: the larger
    of bytes over the memory rate and each unit's operations over its peak
    rate, as ``{"bound_ms": t, "bound_by": "bytes" | "operations",
    "bound_unit": unit}`` (the unit whose operations take the longest)."""
    t_bytes = work.bytes / (peaks["hbm_gbps"] * 1e9) * 1e3
    t_ops, unit = max((ops / peaks[UNIT_RATE[u]] * 1e3, u)
                      for ops, u in ((work.ops, work.unit), *work.more))
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_unit=unit)


def elementwise_ops(fn, *args) -> int:
    """Scalar operations of a plain version written as elementwise tensor
    ops (K2, K3): the largest element count of each arithmetic, comparison
    or select op it dispatches.  Run on one sample or cell, it counts the
    kernel's per-item instructions, since the plain versions repeat the
    kernels' operation chains."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counted = {"add", "sub", "mul", "div", "reciprocal", "sqrt", "abs", "neg",
               "clamp_min", "clamp_max", "maximum", "minimum", "where", "isfinite",
               "gt", "lt", "ge", "le", "eq", "ne", "bitwise_and", "sum"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in counted:
                sizes = [x.numel() for x in (*args, out) if hasattr(x, "numel")]
                self.n += max(sizes)
            return out

    with Count() as c:
        fn(*args)
    return c.n


def _one_sample(*shape):
    g = torch.Generator().manual_seed(0)
    return torch.rand(*shape, generator=g) * 500.0


@functools.lru_cache(maxsize=None)
def eight_point_ops_per_sample() -> int:
    """K3's fp32 operations a sample (its plain version on one sample)."""
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
        minimal_eight_point_plain)

    return elementwise_ops(minimal_eight_point_plain, _one_sample(1, 1, 8, 2),
                           _one_sample(1, 1, 8, 2))


@functools.lru_cache(maxsize=None)
def ransac_score_ops_per_cell() -> int:
    """K2's fp32 operations a (hypothesis, point) cell."""
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import ransac_score_plain

    F = _one_sample(1, 1, 3, 3) / 500.0
    return elementwise_ops(ransac_score_plain, F, _one_sample(1, 1, 2), _one_sample(1, 1, 2),
                           torch.ones(1, 1, dtype=torch.bool), 1.5)


def l2_top2_work(q, t, t_mask, t_points=None, compute_dtype: str = "f32") -> Work:
    """K1 (K1b with ``t_points``): q and the valid t rows read once, the
    mask read, dist and idx written once (+ the valid rows' points read and
    the matched points written); one FMA per (query, valid train row, dim)
    cell, at the width given (not the padded one)."""
    B, N1, D = q.shape
    N2 = t.shape[1]
    valid = int(t_mask.sum())
    P = 0 if t_points is None else t_points.shape[2]
    nbytes = 4 * (B * N1 + valid) * D + B * N2 + 16 * B * N1 + 4 * P * (valid + B * N1)
    return Work(nbytes, 2 * N1 * valid * D, "flops")


def hamming_top2_work(q, t, t_mask) -> Work:
    """K4: q and the valid t rows' words read once, the mask read, dist and
    idx written once; one population count per (query, valid train row,
    word) cell."""
    B, N1, W = q.shape
    N2 = t.shape[1]
    valid = int(t_mask.sum())
    return Work(4 * (B * N1 + valid) * W + B * N2 + 16 * B * N1, N1 * valid * W, "popc")


def eight_point_work(sp1, sp2, **_) -> Work:
    """K3: each sample's 2 × 8 points read and its F written once; the
    plain version's operations a sample."""
    count = sp1.numel() // 16
    return Work(count * (2 * 8 * 2 + 9) * 4, count * eight_point_ops_per_sample(), "instr")


def ransac_score_work(F_h, p1, p2, mask, threshold=None) -> Work:
    """K2: each hypothesis read and its count written once, each mask bit
    and each valid point pair read once; the plain version's operations a
    cell, over the valid cells (a masked point needs no gate)."""
    B, H = F_h.shape[:2]
    N = p1.shape[1]
    valid = int(mask.sum())
    return Work(B * H * (9 + 1) * 4 + B * N + valid * 2 * 2 * 4,
                H * valid * ransac_score_ops_per_cell(), "instr")


# The probes' kernels (``probe_match.py``, ``probe_score.py``).  Their
# epilogues, in instructions a cell on the card: the row minimum is one
# FMNMX; the packed top-2 is d = t2 − 2·acc (one FFMA), the monotone key
# (a shift and a LOP3), the column in its low bits (a LOP3) and the
# order-free insertion b2 = min(b2, max(b1, k)), b1 = min(b1, k) (three
# integer min/max).
GEMM_ROWMIN_EPILOGUE = 1
PACKED_TOP2_EPILOGUE = 7


def _match_bytes(q, t) -> int:
    B, N1, D = q.shape
    return 4 * B * (N1 + t.shape[1]) * D


def probe_gemm_rowmin_work(q, t) -> Work:
    """P1: q and t read once, the row minima written once; 2·N1·N2·D
    flops on the matrix unit and the minimum a cell."""
    B, N1, D = q.shape
    cells = B * N1 * t.shape[1]
    return Work(_match_bytes(q, t) + 4 * B * N1, 2 * cells * D, "bf16_tc",
                ((GEMM_ROWMIN_EPILOGUE * cells, "instr"),))


def probe_packed_top2_work(q, t, t2) -> Work:
    """P2: q, t and t2 read once, dist and idx written once; 2·N1·N2·D
    flops on the matrix unit and the packed-key epilogue a cell."""
    B, N1, D = q.shape
    N2 = t.shape[1]
    cells = B * N1 * N2
    return Work(_match_bytes(q, t) + 4 * B * N2 + 16 * B * N1, 2 * cells * D, "bf16_tc",
                ((PACKED_TOP2_EPILOGUE * cells, "instr"),))


@functools.lru_cache(maxsize=None)
def score_variant_ops_per_cell(gate: str, products: str) -> int:
    """The fp32 operations a (hypothesis, point) cell of a score variant:
    the whole plain version for fp32 products, its gate alone for the
    tensor-core ones (their products run on the matrix unit)."""
    from points_matching_tpu_torch.ops.kernels import probe_score

    F = _one_sample(1, 1, 3, 3) / 500.0
    p1, p2 = _one_sample(1, 1, 2), _one_sample(1, 1, 2)
    mask = torch.ones(1, 1, dtype=torch.bool)
    if products == "f32":
        return elementwise_ops(probe_score.score_variant_plain, F, p1, p2, mask, 1.5,
                               gate, products)
    a = probe_score.variant_products(F, p1, p2, products)
    return elementwise_ops(probe_score.variant_gate, *a, p2, mask, 1.5 ** 2, gate)


def probe_score_work(F_h, p1, p2, mask, threshold=None, gate="multiply",
                     products="bf16x3") -> Work:
    """A score variant: K2's bytes; over the valid cells, the plain
    version's fp32 operations (fp32 products), or the five products a cell
    on the matrix unit (3 multiply-adds each, three times over for the
    3-term split) and the gate's fp32 operations."""
    from points_matching_tpu_torch.ops.kernels.probe_score import PASSES

    nbytes = ransac_score_work(F_h, p1, p2, mask).bytes
    cells = F_h.shape[1] * int(mask.sum())
    per_cell = score_variant_ops_per_cell(gate, products)
    if products == "f32":
        return Work(nbytes, cells * per_cell, "instr")
    return Work(nbytes, cells * 5 * 3 * 2 * PASSES[products], "bf16_tc",
                ((cells * per_cell, "instr"),))


def segment_sum_work(values, plan) -> Work:
    """The segmented sum: the valid entries' values and ``perm`` read once
    (masked entries lie past ``offsets[n]`` and are not read), ``offsets``
    and the kernel's ``pieces`` read once, the output written once; m − 1
    additions an element of a row of m entries."""
    n = plan.num_rows
    lengths = (plan.offsets[1:] - plan.offsets[:-1]).long()
    valid, nonempty = int(lengths.sum()), int((lengths > 0).sum())
    W = math.prod(values.shape[1:])
    es = values.element_size()
    nbytes = es * W * (valid + n) + 4 * valid + 2 * 4 * (n + 1)
    unit = "f64_instr" if values.dtype == torch.float64 else "instr"
    return Work(nbytes, (valid - nonempty) * W, unit)


def dense_ba_iteration_work(num_cameras: int, num_landmarks: int, solver: str = "cholesky",
                            pcg_iterations: int = 50) -> Work:
    """One LM iteration of the dense BA (``ba/lm.bundle_adjust``) on the
    [C, L] grid: a step and the proposed state's cost.  No hand kernel runs
    it (cuBLAS contractions and eager elementwise ops), so this is the
    path's own bound, not a kernel's.

    Operations: the fp32 multiply-adds of its contractions, two flops each,
    from their shapes (every cell of the grid, masked or not, as the grid
    computes them); the elementwise work around them (the projection, the
    damping, the 3×3 inverses, PCG's vector updates) and the retraction's
    3×3 products are left out, so the bound is a floor.  In multiply-adds:

    * ``ba/residuals.residuals_and_jacobians``: R·X (9 a cell), Jl = Jp·R
      (18 a cell);
    * ``ba/schur.build_normal_equations``: U (2·6·6 = 72 a cell), V (18),
      W (36), bc (12), bl (6);
    * Cholesky (``schur_reduce``, ``solve_schur``): Y = W·V⁻¹ (54 a cell),
      S = Y·Wᵀ (108·C a cell), g (18 a cell), the factor of the 6C × 6C
      system ((6C)³/3) and its two triangular solves (2·(6C)²), the
      back-substitution V⁻¹·(bl − Wᵀ·dc) (18 a cell, 9 a landmark);
    * PCG (``solve_schur_pcg``, ``pcg``): g = bc − W·(V⁻¹·bl) (18 a cell, 9
      a landmark), Y (54 a cell), S's diagonal blocks (108 a cell), then
      ``pcg_iterations`` + 1 products with S (the first at x = 0: Wᵀ·x and
      W·(V⁻¹·Wᵀx), 36 a cell; V⁻¹·, 9 a landmark; U·x, 36 a camera) and as
      many preconditioner products (36 a camera), the back-substitution;
    * the proposed state's cost (``ba_cost``): R·X (9 a cell).

    Bytes: the state read once (poses, X, uv, mask) and the poses and X
    written once."""
    C, L = num_cameras, num_landmarks
    cells = C * L
    fma = ((9 + 18) + (72 + 18 + 36 + 12 + 6) + 9) * cells
    if solver == "cholesky":
        n = 6 * C
        fma += (54 + 108 * C + 18 + 18) * cells + 9 * L + n ** 3 // 3 + 2 * n * n
    elif solver == "pcg":
        products = pcg_iterations + 1
        fma += ((18 + 54 + 108 + 18) * cells + 2 * 9 * L
                + products * (36 * cells + 9 * L + 36 * C + 36 * C))
    else:
        raise ValueError(f"unknown solver: {solver!r}")
    state = 4 * (12 * C + 3 * L)
    nbytes = 2 * state + 4 * 2 * cells + cells
    return Work(nbytes, 2 * fma, "flops")
