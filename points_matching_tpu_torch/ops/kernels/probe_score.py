"""P3 / P4 — the RANSAC score probe's variants: K2's inlier counts under the
gate and with the products each variant of the TPU probe computes, batched
over pairs.

Replaces the TPU kernels of ``benchmarks/probe/score_variants.py``:
``build_fn`` (``make_kernel``'s variants over row- and column-major F) and
``build_fn_stacked`` (F rows stacked host-side).  Their nine variants
compute four functions of (gate, products):

| JAX variants | gate | products | here |
| --- | --- | --- | --- |
| ``prod``, ``oneop`` | divide: r²/max(denom, 1e-12) < τ² | fp32 | ``("divide", "f32")`` |
| ``nodiv``, ``stacked``, ``ostack`` | multiply: r² < τ²·max(denom, 1e-12) | fp32 | K2, ``ransac_kernel.ransac_score_hypotheses`` |
| ``def_prec`` | divide | one bf16 pass | ``("divide", "bf16x1")`` |
| ``split3``, ``stack3``, ``ostack3`` | multiply | 3-term bf16 split | ``("multiply", "bf16x3")`` |

CUDA source: ``points_matching_tpu_torch/csrc/probe_score.cu``, in two
designs that the host picks between (``design``): ``warp`` — the fp32
instance on the CUDA cores in the plain version's operation order (its
counts equal plain bit for bit), the bf16 ones on the warp-level tensor
cores (``mma.sync``), 64 hypotheses a block — and, for the bf16 instances
on launches of at most one block an SM, ``warpgroup`` — Hopper's warpgroup
tensor cores (``wgmma``), 128 hypotheses a block, points staged once a
block through an mbarrier ring, the gates overlapping the next step's
products.  The gate runs in fp32 on the CUDA cores.  Not on a path of the
package: ``examples/probe_score_variants_torch.py`` and ``chip_smoke.py``'s
``probes`` phase launch it, to measure what a tensor-core K2 would cost.
"""
from __future__ import annotations

import torch

from points_matching_tpu_torch.ops.kernels import _build
from points_matching_tpu_torch.ops.kernels import work as _work
from points_matching_tpu_torch.ops.kernels.ransac_kernel import _check_inputs as _check_k2_inputs
from points_matching_tpu_torch.utils.sanitize import check_index

Tensor = torch.Tensor

GATES = {"divide": 0, "multiply": 1}
PRODUCTS = {"f32": 0, "bf16x1": 1, "bf16x3": 2}
PASSES = {"f32": 1, "bf16x1": 1, "bf16x3": 3}          # bf16 products a multiply-add
VARIANTS = (("divide", "f32"), ("divide", "bf16x1"), ("multiply", "bf16x3"))
DESIGNS = ("warp", "warpgroup")                    # the C entry's `design` argument
# hypotheses a block (kHypsPerBlock, kTcHyps in probe_score.cu) and points
# a split keeps at least, by design
HYPS_PER_BLOCK = {"warp": 64, "warpgroup": 128}
MIN_SPLIT_POINTS = {"warp": 64, "warpgroup": 32}
# the warpgroup design up to this many of its blocks (pairs × 128
# hypotheses) an SM: on the H100, in turns with the warp design from 1 to 64
# pairs of 512 × 512 (examples/probe_score_variants_torch.py --parent,
# PERF.md), (divide, bf16 × 1) was faster up to 32 pairs (0.97 blocks an
# SM) and (multiply, bf16 × 3) up to 8 (0.24)
WARPGROUP_MAX_BLOCKS_PER_SM = {"bf16x1": 1.0, "bf16x3": 0.25}


def _check_inputs(F_h: Tensor, p1: Tensor, p2: Tensor, mask: Tensor, gate: str,
                  products: str) -> None:
    if (gate, products) not in VARIANTS:
        raise ValueError(f"(gate, products) must be one of {VARIANTS}, got {(gate, products)}; "
                         "('multiply', 'f32') is K2, ransac_score_hypotheses")
    _check_k2_inputs(F_h, p1, p2, mask)


def _dot(w, x, y):
    """w0·x + w1·y + w2 (the homogeneous 1), each operation rounded once."""
    return w[0] * x + w[1] * y + w[2]


def _split(x: Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def variant_products(F_h: Tensor, p1: Tensor, p2: Tensor, products: str):
    """(a1, a2, a3, b1, b2), each [B, H, N]: a = F·p1h, b = Fᵀ·p2h, as the
    variant computes them — fp32 (``f32``), one bf16 pass (``bf16x1``:
    bf16(F)·bf16(p), products exact, fp32 sums) or the 3-term split
    (``bf16x3``: hi·hi + hi·lo + lo·hi, each a dot product of its own, as
    ``split3_dot``)."""
    f = [F_h[:, :, i // 3, i % 3, None] for i in range(9)]     # [B, H, 1] each
    rows = ([f[0], f[1], f[2]], [f[3], f[4], f[5]], [f[6], f[7], f[8]],
            [f[0], f[3], f[6]], [f[1], f[4], f[7]])
    pts = [p1[:, None, :, 0], p1[:, None, :, 1]], [p2[:, None, :, 0], p2[:, None, :, 1]]
    out = []
    for k, w in enumerate(rows):
        x, y = pts[0] if k < 3 else pts[1]
        if products == "f32":
            out.append(_dot(w, x, y))
            continue
        wh, wl = zip(*map(_split, w))
        (xh, xl), (yh, yl) = _split(x), _split(y)
        hh = _dot(wh, xh, yh)
        if products == "bf16x1":
            out.append(hh)
            continue
        hl = wh[0] * xl + wh[1] * yl            # the homogeneous 1 has lo = 0
        lh = _dot(wl, xh, yh)
        out.append(hh + hl + lh)
    return out


def variant_gate(a1, a2, a3, b1, b2, p2: Tensor, mask: Tensor, tau2: float,
                 gate: str) -> Tensor:
    """The gate over [B, H, N] cells, summed to counts [B, H] int32."""
    x2, y2 = p2[:, None, :, 0], p2[:, None, :, 1]
    r = a1 * x2 + a2 * y2 + a3
    denom = a1 * a1 + a2 * a2 + b1 * b1 + b2 * b2
    if gate == "divide":
        ok = (r * r) / denom.clamp_min(1e-12) < tau2
    else:
        ok = r * r < tau2 * denom.clamp_min(1e-12)
    return (ok & mask[:, None, :]).sum(-1, dtype=torch.int32)


def score_variant_plain(F_h: Tensor, p1: Tensor, p2: Tensor, mask: Tensor, threshold: float,
                        gate: str, products: str) -> Tensor:
    """Plain PyTorch score variant: counts [B, H] int32."""
    a = variant_products(F_h, p1, p2, products)
    return variant_gate(*a, p2, mask, float(threshold) ** 2, gate)


def _operands(x: Tensor, products: str):
    """The (F or point) operands whose products a variant sums, in float64:
    the value; its bf16 half; or the (hi, hi, lo) and (hi, lo, hi) of the
    3-term split (the second of each pair meets the first of the other)."""
    if products == "f32":
        return (x.double(),), (x.double(),)
    hi, lo = _split(x)
    if products == "bf16x1":
        return (hi.double(),), (hi.double(),)
    return (hi.double(), hi.double(), lo.double()), (hi.double(), lo.double(), hi.double())


def near_gate_cells(F_h: Tensor, p1: Tensor, p2: Tensor, mask: Tensor, threshold: float,
                    products: str = "f32", ulps: int = 16) -> Tensor:
    """Per hypothesis, the valid cells [B, H] at the gate of the variant
    with these ``products``: where its r² − τ²·denom, in float64 from the
    variant's own products, lies within what ``ulps`` fp32 roundings of the
    magnitudes summed into a, b, r and denom could move it.  A kernel whose
    sums round otherwise than its plain version (the tensor core's fp32
    accumulation, another order) may differ from it by these cells only."""
    u = ulps * 2.0 ** -24
    tau2 = float(threshold) ** 2
    one = torch.ones_like(p1[..., :1])
    fa, _ = _operands(F_h, products)
    _, h1 = _operands(torch.cat([p1, one], -1), products)
    _, h2 = _operands(torch.cat([p2, one], -1), products)

    def dot(eq, fs, hs):
        val = sum(torch.einsum(eq, f, h) for f, h in zip(fs, hs))
        mag = sum(torch.einsum(eq, f.abs(), h.abs()) for f, h in zip(fs, hs))
        return val, mag

    a, sa = dot("bhij,bnj->bhni", fa, h1)
    b, sb = dot("bhji,bnj->bhni", [f[..., :2] for f in fa], h2)
    x2 = torch.cat([p2, one], -1).double()[:, None]       # the gate's fp32 x2, y2
    r, sr = (a * x2).sum(-1), (sa * x2.abs()).sum(-1)
    a, sa = a[..., :2], sa[..., :2]
    den = (a * a).sum(-1) + (b * b).sum(-1)
    sden = 2 * ((a.abs() * sa).sum(-1) + (b.abs() * sb).sum(-1)) + den
    er, eden = u * sr, u * sden
    slack = 2 * r.abs() * er + er * er + tau2 * eden + u * (r * r + tau2 * den)
    near = ((r * r - tau2 * den).abs() <= slack) & mask[:, None, :]
    return near.sum(-1)


def score_variant(F_h: Tensor, p1: Tensor, p2: Tensor, mask: Tensor, threshold: float,
                  gate: str = "multiply", products: str = "bf16x3", _design=None) -> Tensor:
    """Per-hypothesis inlier counts of one score variant.

    Args:
      F_h: [B, H, 3, 3] hypotheses; p1, p2: [B, N, 2] points; mask: [B, N]
        bool validity; threshold: gate in pixels.
      gate, products: one of ``VARIANTS``.
      _design: forces a kernel design (card tests, probes).

    Returns counts [B, H] int32.
    """
    _check_inputs(F_h, p1, p2, mask, gate, products)
    if F_h.device.type == "cpu":
        counts = score_variant_plain(F_h, p1, p2, mask, threshold, gate, products)
    elif F_h.device.type == "cuda":
        counts = _launch(F_h, p1, p2, mask, threshold, gate, products, _design)
        score_variant.launches += 1
    else:
        raise ValueError(f"unsupported device {F_h.device}")
    check_index(counts, p1.shape[1] + 1, "score_variant")
    return counts


def design(B: int, H: int, products: str, num_sms: int) -> str:
    """The kernel design for B pairs of H hypotheses: ``warpgroup`` for the
    bf16 instances while their 128-hypothesis blocks are at most
    ``WARPGROUP_MAX_BLOCKS_PER_SM[products]`` an SM (a launch of a few
    blocks is latency, where the staged ring and the overlap of products
    and gates win), else ``warp``, whose small blocks keep more warps an SM
    on the gate's fp32 chain, the bound of a full card; the fp32 instance
    is ``warp`` only."""
    if products == "f32":
        return "warp"
    blocks = B * -(-H // HYPS_PER_BLOCK["warpgroup"])
    return ("warpgroup" if blocks <= WARPGROUP_MAX_BLOCKS_PER_SM[products] * num_sms
            else "warp")


def splits(design: str, B: int, H: int, N: int, num_sms: int) -> int:
    """Point splits S of a launch: the warp design as K1's train splits
    (its small blocks run several an SM); the warpgroup design one block an
    SM, so the most splits that keep the launch within one wave."""
    tiles = -(-H // HYPS_PER_BLOCK[design])
    if design == "warp":
        return _build.train_splits(B, tiles, N, num_sms, MIN_SPLIT_POINTS[design])
    return _build.one_wave_splits(B * tiles, N, num_sms, MIN_SPLIT_POINTS[design])


def _launch(F_h, p1, p2, mask, threshold, gate, products, forced) -> Tensor:
    if not all(x.is_contiguous() for x in (F_h, p1, p2, mask)):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    if p1.data_ptr() % 8 or p2.data_ptr() % 8:
        raise ValueError("the CUDA kernel needs 8-byte aligned p1 and p2")
    lib = _build.library()
    B, H = F_h.shape[:2]
    N = p1.shape[1]
    sms = _build.sm_count(F_h.device.index)
    d = forced or design(B, H, products, sms)
    if d not in DESIGNS or (d == "warpgroup" and products == "f32"):
        raise ValueError(f"design must be one of {DESIGNS} (warp only for f32), got {d!r}")
    score_variant.last_design = d
    S = splits(d, B, H, N, sms)
    # with S > 1 the splits add their counts atomically
    counts = (torch.zeros if S > 1 else torch.empty)((B, H), dtype=torch.int32,
                                                     device=F_h.device)
    with torch.cuda.device(F_h.device):
        rc = lib.pmt_probe_score(
            F_h.data_ptr(), p1.data_ptr(), p2.data_ptr(), mask.data_ptr(), counts.data_ptr(),
            B, H, N, S, float(threshold) ** 2, GATES[gate], PRODUCTS[products],
            DESIGNS.index(d), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "pmt_probe_score")
    return counts


score_variant.launches = 0
score_variant.last_design = None
score_variant.work = _work.probe_score_work
