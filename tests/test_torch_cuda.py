"""The port's CUDA kernels on the card, against their plain PyTorch versions
(the analogue of tests/test_tpu_compiled.py).  Needs an NVIDIA GPU and nvcc;
everywhere else every test skips.  Imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for sm_90a)")
    from points_matching_tpu_torch.core.device import pin_fp32

    pin_fp32()
    return torch.device("cuda")


def _unit(gen, *shape, dev):
    x = torch.randn(*shape, generator=gen, device=dev)
    return x / x.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
# (1, 512, 512): one pair, 33 train splits; (1, 512, 45): 5 splits of 9
# columns; (1, 70, 7): fewer train rows than one tile or split
@pytest.mark.parametrize("b,n1,n2", [(3, 200, 333), (2, 64, 700), (1, 5, 3),
                                     (1, 512, 512), (1, 512, 45), (1, 70, 7)])
def test_l2_top2_kernel_matches_plain(dev, compute_dtype, b, n1, n2):
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, fused_l2_top2_points, l2_top2_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    q, t = _unit(gen, b, n1, 64, dev=dev), _unit(gen, b, n2, 64, dev=dev)
    t_mask = torch.rand(b, n2, generator=gen, device=dev) > 0.1
    before = fused_l2_top2.launches
    kd, ki = fused_l2_top2(q, t, t_mask, compute_dtype=compute_dtype)
    assert fused_l2_top2.launches == before + 1
    pd, pi = l2_top2_plain(q, t, t_mask, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    # fp32 sums in another order (FFMA chains vs cuBLAS): 1e-5 on distances ≤ 4
    torch.testing.assert_close(kd, pd, atol=1e-5, rtol=0)
    tie = (pd[..., 0] - pd[..., 1]).abs() < 1e-5
    assert bool(((ki[..., 0] == pi[..., 0]) | tie).all())
    pts = torch.rand(b, n2, 2, generator=gen, device=dev) * 900
    _, ki2, kp = fused_l2_top2_points(q, t, t_mask, pts, compute_dtype=compute_dtype)
    torch.testing.assert_close(ki2, ki, atol=0, rtol=0)
    gathered = torch.gather(pts, 1, ki[..., :1].long().expand(-1, -1, 2))
    assert torch.equal(kp, gathered)


def test_l2_top2_kernel_masked_and_duplicates(dev):
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, l2_top2_plain)

    q = torch.eye(8, 64, device=dev)[None]
    t = torch.cat([q, q], 1)
    full = torch.ones(1, 16, dtype=torch.bool, device=dev)
    kd, ki = fused_l2_top2(q, t, full)
    assert torch.equal(ki[0, :, 0].cpu(), torch.arange(8, dtype=torch.int32))
    assert float(kd.abs().max()) < 1e-6
    one = torch.zeros(1, 16, dtype=torch.bool, device=dev)
    one[0, 5] = True
    kd, ki = fused_l2_top2(q, t, one)
    pd, pi = l2_top2_plain(q, t, one)
    assert torch.equal(ki, pi)
    assert bool((kd[..., 1] > 1e20).all())


@pytest.mark.parametrize("n_valid,at", [(0, 0), (1, 0), (1, 500), (2, 505)])
def test_l2_top2_kernel_fewer_than_two_valid_rows(dev, n_valid, at):
    """One pair of 512 × 512 runs 33 train splits; a lone valid row in the
    last split must come out as column 0, and the sentinel (1e30, 0) fill
    what is missing, as in the plain version."""
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, fused_l2_top2_points, l2_top2_plain)

    gen = torch.Generator(device=dev).manual_seed(7)
    q, t = _unit(gen, 1, 512, 64, dev=dev), _unit(gen, 1, 512, 64, dev=dev)
    t_mask = torch.zeros(1, 512, dtype=torch.bool, device=dev)
    t_mask[0, at:at + n_valid] = True
    kd, ki = fused_l2_top2(q, t, t_mask)
    pd, pi = l2_top2_plain(q, t, t_mask)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kd, pd, atol=1e-5, rtol=0)
    assert bool((kd[..., n_valid:] == 1e30).all())
    pts = torch.rand(1, 512, 2, generator=gen, device=dev)
    _, ki2, kp = fused_l2_top2_points(q, t, t_mask, pts)
    assert torch.equal(ki2, ki) and torch.equal(kp, pts[0, ki[0, :, 0].long()][None])


def test_top2_kernels_one_pair_equals_its_batched_rows(dev):
    """The train split depends on the pair count (33 pairs fill the card
    with S = 1; one pair takes 33 splits), and the result must not: each
    pair alone gives its batched rows bit for bit."""
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import fused_hamming_top2
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, fused_l2_top2_points)

    gen = torch.Generator(device=dev).manual_seed(8)
    q, t = _unit(gen, 33, 512, 64, dev=dev), _unit(gen, 33, 512, 64, dev=dev)
    t_mask = torch.rand(33, 512, generator=gen, device=dev) > 0.05
    t[:, 400:] = t[:, :112]                             # tied distances across splits
    pts = torch.rand(33, 512, 2, generator=gen, device=dev)
    for dtype in ("f32", "bf16"):
        batched = fused_l2_top2_points(q, t, t_mask, pts, compute_dtype=dtype)
        for k in (0, 9, 32):
            one = fused_l2_top2_points(q[k:k + 1], t[k:k + 1], t_mask[k:k + 1],
                                       pts[k:k + 1], compute_dtype=dtype)
            assert all(torch.equal(a, b[k:k + 1]) for a, b in zip(one, batched))
            kd, ki = fused_l2_top2(q[k:k + 1], t[k:k + 1], t_mask[k:k + 1],
                                   compute_dtype=dtype)
            assert torch.equal(kd, batched[0][k:k + 1]) and torch.equal(ki, batched[1][k:k + 1])
    hq, ht = _words(gen, 33, 1024, 8, dev=dev), _words(gen, 33, 1024, 8, dev=dev)
    ht[:, 900:] = ht[:, :124]
    hq[:, :300] = ht[:, 600:900]
    hmask = torch.rand(33, 1024, generator=gen, device=dev) > 0.05
    batched = fused_hamming_top2(hq, ht, hmask)
    for k in (0, 32):
        one = fused_hamming_top2(hq[k:k + 1], ht[k:k + 1], hmask[k:k + 1])
        assert all(torch.equal(a, b[k:k + 1]) for a, b in zip(one, batched))


# (2, 300, 777), (1, 33, 2500): ragged tiles, N above one block's share;
# then the paths' shapes: one pair of the SURF slice (512 × 512), the bench
# head's 64 pairs, the SLAM demo's RANSAC (256 × 512), config 4's one pair
# (128 × 256) and its bootstrap at S = 16 (64 pairs) and S = 75 (300)
@pytest.mark.parametrize("b,h,n", [(2, 300, 777), (1, 33, 2500), (1, 512, 512),
                                   (64, 512, 512), (1, 256, 512), (1, 128, 256),
                                   (64, 128, 256), (300, 128, 256)])
def test_ransac_score_kernel_matches_plain(dev, b, h, n):
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import (
        ransac_score_hypotheses, ransac_score_plain)

    gen = torch.Generator(device=dev).manual_seed(1)
    F = torch.randn(b, h, 3, 3, generator=gen, device=dev) * 1e-3
    p1 = torch.rand(b, n, 2, generator=gen, device=dev) * 640
    p2 = p1 + 2 * torch.randn(b, n, 2, generator=gen, device=dev)
    mask = torch.rand(b, n, generator=gen, device=dev) > 0.05
    kc = ransac_score_hypotheses(F, p1, p2, mask, 1.5)
    pc = ransac_score_plain(F, p1, p2, mask, 1.5)
    torch.cuda.synchronize()
    # same association order, --fmad=false: the same gates
    assert torch.equal(kc, pc)


def _score_case(gen, b, h, n, dev, masked=0.05):
    F = torch.randn(b, h, 3, 3, generator=gen, device=dev) * 1e-3
    p1 = torch.rand(b, n, 2, generator=gen, device=dev) * 640
    p2 = p1 + 2 * torch.randn(b, n, 2, generator=gen, device=dev)
    mask = torch.rand(b, n, generator=gen, device=dev) >= masked
    return F, p1, p2, mask


def _each_tile_equals_plain(F, p1, p2, mask, threshold=1.5):
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import (
        TILES, ransac_score_hypotheses, ransac_score_plain)

    want = ransac_score_plain(F, p1, p2, mask, threshold)
    for tile in (None,) + TILES:
        before = ransac_score_hypotheses.launches
        got = ransac_score_hypotheses(F, p1, p2, mask, threshold, _tile=tile)
        assert ransac_score_hypotheses.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want), (tile, int((got - want).abs().max()))
    return want


# H = 1; N = 1; every point masked; H and N off every multiple of the
# 32-hypothesis tile and the 1,024-point round; N above one round of a
# block (C = 1) and above a cluster block's share; no point at all
@pytest.mark.parametrize("b,h,n,masked", [(1, 1, 300, 0.05), (3, 70, 1, 0.0),
                                          (2, 64, 500, 1.0), (2, 33, 1025, 0.05),
                                          (1, 97, 3000, 0.3), (5, 31, 2049, 0.05),
                                          (2, 40, 0, 0.0)])
def test_ransac_score_kernel_edge_cases_each_tile(dev, b, h, n, masked):
    gen = torch.Generator(device=dev).manual_seed(h * 7 + n)
    want = _each_tile_equals_plain(*_score_case(gen, b, h, n, dev, masked))
    if masked == 1.0 or n == 0:
        assert int(want.abs().sum()) == 0


# the paths' one-pair shapes and config 4's bootstrap at S = 16: every tile
# the kernel is built for, and the tile the rule picks
@pytest.mark.parametrize("b,h,n,tile", [(1, 512, 512, (2, 1)), (1, 512, 1024, (2, 1)),
                                        (1, 128, 256, (2, 1)), (64, 128, 256, (8, 4)),
                                        (64, 512, 512, (8, 16))])
def test_ransac_score_every_tile_equals_plain_at_path_shapes(dev, b, h, n, tile):
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import ransac_score_hypotheses

    gen = torch.Generator(device=dev).manual_seed(b + h + n)
    args = _score_case(gen, b, h, n, dev)
    _each_tile_equals_plain(*args)
    ransac_score_hypotheses(*args, 1.5)
    assert ransac_score_hypotheses.last_tile == tile


def _ulps(v, k):
    """float32 ``v`` moved k ulps (toward +inf for k > 0)."""
    for _ in range(abs(k)):
        v = np.nextafter(v, np.float32(np.sign(k) * np.inf))
    return v


def test_ransac_score_kernel_near_gate_and_tiny_denominators(dev):
    """Points placed at Sampson distance τ² of hypothesis 0 and then moved
    -4..4 ulps in x2, so that the plain version's own f32 gate sits within
    1 ulp of its threshold on some cells; copies of hypothesis 0 scaled by
    1e-5, 1e-6 and 1e-7, whose denom falls to and below 1e-12 (there the
    clamp decides); non-finite F and points.  Every tile equals plain."""
    g = np.random.RandomState(11)
    tau, H, M = 1.5, 64, 96
    F64 = g.randn(H, 3, 3) * 1e-3
    for i in range(H // 2, H):
        F64[i] = F64[0] * 10.0 ** -(5 + i % 3)
    f = F64[0]
    x1 = np.c_[g.uniform(0, 640, M), g.uniform(0, 480, M), np.ones(M)]
    line = x1 @ f.T                                   # (a1, a2, a3) of each point
    normal = line[:, :2] / np.hypot(line[:, 0], line[:, 1])[:, None]
    on = np.c_[g.uniform(0, 640, M), np.zeros(M)]
    on[:, 1] = -(line[:, 0] * on[:, 0] + line[:, 2]) / line[:, 1]
    t = np.full(M, tau)
    for _ in range(30):                               # Newton-like, in float64
        p2 = on + t[:, None] * normal
        b = np.c_[p2, np.ones(M)] @ f
        r = np.sum(np.c_[p2, np.ones(M)] * line, 1)
        d = r * r / (line[:, 0] ** 2 + line[:, 1] ** 2 + b[:, 0] ** 2 + b[:, 1] ** 2)
        t = t * np.sqrt(tau * tau / d)
    p2 = (on + t[:, None] * normal).astype(np.float32)
    shifts = range(-4, 5)
    P1 = np.repeat(x1[:, :2].astype(np.float32), len(shifts), 0)
    P2 = np.stack([np.c_[_ulps(p2[:, 0], k), p2[:, 1]] for k in shifts], 1).reshape(-1, 2)
    P1[:3] = [[np.nan, 1.0], [np.inf, 2.0], [-np.inf, np.inf]]   # non-finite points
    F32 = F64.astype(np.float32)
    F32[1, 0, 0], F32[2, 2, 2] = np.nan, np.inf                  # non-finite hypotheses
    mask = np.ones(len(P1), bool)
    mask[5::17] = False
    F_t, p1_t, p2_t, m_t = (torch.from_numpy(np.ascontiguousarray(x))[None].to(dev)
                            for x in (F32, P1, P2, mask))
    want = _each_tile_equals_plain(F_t, p1_t, p2_t, m_t, tau)
    # the case is near the gate: on hypothesis 0 both sides are taken, and
    # some cell's r² is within 1 ulp of τ²·max(denom, 1e-12) (the plain ops)
    f0 = F_t[0, 0]
    xa, ya, xb, yb = p1_t[0, :, 0], p1_t[0, :, 1], p2_t[0, :, 0], p2_t[0, :, 1]
    a1 = f0[0, 0] * xa + f0[0, 1] * ya + f0[0, 2]
    a2 = f0[1, 0] * xa + f0[1, 1] * ya + f0[1, 2]
    a3 = f0[2, 0] * xa + f0[2, 1] * ya + f0[2, 2]
    b1 = f0[0, 0] * xb + f0[1, 0] * yb + f0[2, 0]
    b2 = f0[0, 1] * xb + f0[1, 1] * yb + f0[2, 1]
    r = a1 * xb + a2 * yb + a3
    lhs = r * r
    rhs = (tau * tau) * (a1 * a1 + a2 * a2 + b1 * b1 + b2 * b2).clamp_min(1e-12)
    ulp = torch.nextafter(rhs, torch.full_like(rhs, float("inf"))) - rhs
    assert int(((lhs - rhs).abs() <= ulp).sum()) > 0
    valid = int(m_t.sum())
    assert 0 < int(want[0, 0]) < valid
    # scaled by 1e-7 (i % 3 == 2): denom < 1e-12, the clamp lets every
    # finite valid point through
    tiny = [i for i in range(H // 2, H) if i % 3 == 2]
    assert all(int(want[0, i]) >= valid - 3 for i in tiny)


def test_eight_point_kernel_matches_plain(dev):
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
        minimal_eight_point, minimal_eight_point_plain)

    gen = torch.Generator(device=dev).manual_seed(2)
    sp1 = torch.rand(3, 100, 8, 2, generator=gen, device=dev) * 640
    sp2 = sp1 + torch.randn(3, 100, 8, 2, generator=gen, device=dev) * 5
    kF = minimal_eight_point(sp1, sp2)
    pF = minimal_eight_point_plain(sp1, sp2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(kF).all())
    # same operation order, --fmad=false, IEEE sqrt/div: the same bits
    assert torch.equal(kF, pF)
    spd = torch.full((1, 8, 2), 5.0, device=dev)
    assert bool(torch.isfinite(minimal_eight_point(spd, spd)).all())


def _eight_point_samples(gen, n, dev):
    sp1 = torch.rand(n, 8, 2, generator=gen, device=dev) * torch.tensor([993.0, 660.0],
                                                                        device=dev)
    sp2 = sp1 + torch.randn(n, 8, 2, generator=gen, device=dev) * 5
    return sp1, sp2


# 1, 7, 33, 513: ragged groups and blocks (a block is one warp of 32 / G
# samples); 128: config 4's bootstrap (one pair); 64 × 512: the batched shape
@pytest.mark.parametrize("count", [1, 7, 33, 128, 513, 64 * 512])
@pytest.mark.parametrize("group", [1, 8])
def test_eight_point_kernel_each_group_equals_plain(dev, group, count):
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
        minimal_eight_point, minimal_eight_point_plain)

    sp1, sp2 = _eight_point_samples(torch.Generator(device=dev).manual_seed(count), count,
                                    dev)
    before = minimal_eight_point.launches
    kF = minimal_eight_point(sp1, sp2, _group=group)
    assert minimal_eight_point.launches == before + 1
    pF = minimal_eight_point_plain(sp1, sp2)
    torch.cuda.synchronize()
    assert kF.shape == (count, 3, 3) and bool(torch.isfinite(kF).all())
    assert torch.equal(kF, pF), float((kF - pF).abs().max())


def test_eight_point_one_pair_equals_its_batched_rows(dev):
    """The rule picks G = 8 for one pair (512 samples) and G = 1 for 64
    pairs; the bits must not move, and no forced G moves them either."""
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import minimal_eight_point

    sp1, sp2 = _eight_point_samples(torch.Generator(device=dev).manual_seed(5), 64 * 512, dev)
    sp1, sp2 = sp1.view(64, 512, 8, 2), sp2.view(64, 512, 8, 2)
    batched = minimal_eight_point(sp1, sp2)
    assert minimal_eight_point.last_group == 1
    for k in (0, 17, 63):
        one = minimal_eight_point(sp1[k:k + 1], sp2[k:k + 1])
        assert minimal_eight_point.last_group == 8
        assert torch.equal(one, batched[k:k + 1])
    for group in (1, 8):
        assert torch.equal(minimal_eight_point(sp1, sp2, _group=group), batched)


@pytest.mark.parametrize("group", [1, 8])
def test_eight_point_kernel_degenerate_samples_stay_finite(dev, group):
    """All points equal, all at 0, collinear, four points each twice, a
    1e-6 spread, huge coordinates: finite, and still the plain version's
    bits."""
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (
        minimal_eight_point, minimal_eight_point_plain)

    gen = torch.Generator(device=dev).manual_seed(6)
    r = torch.rand(8, 2, generator=gen, device=dev) * 500
    t = torch.linspace(0, 1, 8, device=dev)[:, None]
    line = torch.cat([t * 300 + 10, t * 200 + 40], 1)
    cases = [torch.full((8, 2), 5.0, device=dev), torch.zeros(8, 2, device=dev), line,
             r[:4].repeat(2, 1), 320 + 1e-6 * r, r * 1e6]
    sp1 = torch.stack(cases)
    sp2 = torch.stack([c.flip(0) for c in cases[:3]] + [c + 3 for c in cases[3:]])
    kF = minimal_eight_point(sp1, sp2, _group=group)
    pF = minimal_eight_point_plain(sp1, sp2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(kF).all())
    assert torch.equal(kF, pF)


def test_wrappers_raise_on_bad_inputs(dev):
    from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import minimal_eight_point
    from points_matching_tpu_torch.ops.kernels.matching_kernel import fused_l2_top2
    from points_matching_tpu_torch.ops.kernels.ransac_kernel import ransac_score_hypotheses

    q = torch.randn(1, 10, 64, device=dev)
    m = torch.ones(1, 10, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        fused_l2_top2(q.transpose(1, 2).contiguous().transpose(1, 2), q, m)  # strided
    # wider than the widest built D: the chunked kernel, no raise
    wide = torch.randn(1, 10, 160, device=dev)
    assert fused_l2_top2(wide, wide, m)[0].shape == (1, 10, 2)
    with pytest.raises(TypeError):
        fused_l2_top2(q.double(), q.double(), m)
    with pytest.raises(ValueError):
        fused_l2_top2(q, q.cpu(), m)
    with pytest.raises(ValueError):
        ransac_score_hypotheses(torch.randn(1, 4, 3, 3, device=dev),
                                torch.randn(1, 10, 2, device=dev)[:, ::2],
                                torch.randn(1, 5, 2, device=dev),
                                torch.ones(1, 5, dtype=torch.bool, device=dev), 1.0)
    with pytest.raises(ValueError):
        minimal_eight_point(torch.randn(4, 7, 2, device=dev), torch.randn(4, 7, 2, device=dev))
    flat = torch.randn(4 * 16 + 2, device=dev)
    odd = flat[2:].view(4, 8, 2)                      # 8-byte aligned, not 16
    with pytest.raises(ValueError):
        minimal_eight_point(odd, odd)
    with pytest.raises(ValueError):
        minimal_eight_point(odd.clone(), odd.clone(), _group=3)
    empty = minimal_eight_point(torch.zeros(0, 8, 2, device=dev), torch.zeros(0, 8, 2, device=dev))
    assert empty.shape == (0, 3, 3)


def _words(gen, *shape, dev):
    w = torch.randint(0, 2**32, shape, generator=gen, device=dev, dtype=torch.int64)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _check_hamming(q, t, t_mask, kd, ki):
    """Distances and both index columns equal the plain version's: column 0
    the lowest index at the minimum, column 1 the lowest other index at the
    runner-up, (1e30, 0) where there is none."""
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import hamming_top2_plain

    pd, pi = hamming_top2_plain(q, t, t_mask)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd)
    assert torch.equal(ki, pi)


# (1, 1024, 1024): one pair, 33 train splits; (1, 300, 40): splits of 16-20
# columns
@pytest.mark.parametrize("b,n1,n2", [(3, 200, 1500), (2, 1030, 77), (1, 5, 1),
                                     (1, 1024, 1024), (1, 300, 40)])
def test_hamming_top2_kernel_matches_plain(dev, b, n1, n2):
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import fused_hamming_top2

    gen = torch.Generator(device=dev).manual_seed(3)
    t = _words(gen, b, n2, 8, dev=dev)
    q = _words(gen, b, n1, 8, dev=dev)
    k = min(n1, n2) // 2
    q[:, :k] = t[:, :k]                                 # exact duplicates
    q[:, k:2 * k] = t[:, :k] ^ 5                        # two flipped bits
    t_mask = torch.rand(b, n2, generator=gen, device=dev) > 0.05
    t_mask[:, 0] = True
    before = fused_hamming_top2.launches
    kd, ki = fused_hamming_top2(q, t, t_mask)
    assert fused_hamming_top2.launches == before + 1
    _check_hamming(q, t, t_mask, kd, ki)


@pytest.mark.parametrize("n_valid", [0, 1])
def test_hamming_top2_kernel_fewer_than_two_valid_rows(dev, n_valid):
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import fused_hamming_top2

    gen = torch.Generator(device=dev).manual_seed(4)
    q, t = _words(gen, 2, 300, 8, dev=dev), _words(gen, 2, 2100, 8, dev=dev)
    t_mask = torch.zeros(2, 2100, dtype=torch.bool, device=dev)
    t_mask[:, 1500:1500 + n_valid] = True               # in the second tile
    kd, ki = fused_hamming_top2(q, t, t_mask)
    _check_hamming(q, t, t_mask, kd, ki)
    assert bool((kd[..., 1] == 1e30).all())
    assert bool((ki[..., 0] == (1500 if n_valid else 0)).all())


def test_hamming_wrapper_raises_on_bad_inputs(dev):
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import fused_hamming_top2

    gen = torch.Generator(device=dev).manual_seed(5)
    q = _words(gen, 1, 10, 8, dev=dev)
    m = torch.ones(1, 10, dtype=torch.bool, device=dev)
    # wider than the widest built W: the chunked kernel, no raise
    wide = _words(gen, 1, 10, 20, dev=dev)
    assert fused_hamming_top2(wide, wide, m)[0].shape == (1, 10, 2)
    with pytest.raises(ValueError):                     # strided
        fused_hamming_top2(_words(gen, 1, 10, 16, dev=dev)[..., ::2], q, m)
    with pytest.raises(TypeError):
        fused_hamming_top2(q.to(torch.int64), q.to(torch.int64), m)
    with pytest.raises(ValueError):
        fused_hamming_top2(q, q.cpu(), m)


def test_match_descriptors_hamming_launches_k4(dev):
    from points_matching_tpu_torch.core.config import MatcherConfig
    from points_matching_tpu_torch.core.types import Descriptors
    from points_matching_tpu_torch.ops import kernels
    from points_matching_tpu_torch.ops.matching import match_descriptors

    gen = torch.Generator(device=dev).manual_seed(6)
    q = _words(gen, 300, 8, dev=dev)
    d1 = Descriptors(data=q, mask=torch.ones(300, dtype=torch.bool, device=dev), binary=True)
    d2 = Descriptors(data=q.flip(0) ^ 1, mask=d1.mask, binary=True)
    for cross_check, expected in ((False, 1), (True, 2)):
        cfg = MatcherConfig(metric="hamming", filter="ratio", cross_check=cross_check)
        kernels.reset_launch_counts()
        m = match_descriptors(d1, d2, cfg)
        assert kernels.launch_counts()["fused_hamming_top2"] == expected
        assert kernels.launch_counts()["fused_l2_top2"] == 0
        cpu = match_descriptors(Descriptors(d1.data.cpu(), d1.mask.cpu(), True),
                                Descriptors(d2.data.cpu(), d2.mask.cpu(), True), cfg)
        assert torch.equal(m.train_idx.cpu(), cpu.train_idx)
        assert torch.equal(m.mask.cpu(), cpu.mask)
        assert int(m.mask.sum()) == 300                 # every row has its 1-bit partner


def test_orb_pipeline_on_cuda_runs_kernels_not_plain(dev, monkeypatch):
    from points_matching_tpu_torch.core.config import RansacConfig, orb_default_config
    from points_matching_tpu_torch.data.render import render_sequence
    from points_matching_tpu_torch.geometry.ransac import sample_minimal_points
    from points_matching_tpu_torch.ops import kernels
    from points_matching_tpu_torch.ops.kernels import (
        eightpoint_kernel, hamming_kernel, ransac_kernel)
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline

    cfg = dataclasses.replace(orb_default_config(), ransac=RansacConfig(num_hypotheses=256))
    imgs, *_ = render_sequence(num_frames=2, num_landmarks=300, image_size=(320, 256))
    g1, g2 = (torch.from_numpy(np.ascontiguousarray(i)).to(dev) for i in imgs)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    with monkeypatch.context() as mp:
        for mod, name in ((hamming_kernel, "hamming_top2_plain"),
                          (eightpoint_kernel, "minimal_eight_point_plain"),
                          (ransac_kernel, "ransac_score_plain")):
            mp.setattr(mod, name, refuse)
        kernels.reset_launch_counts()
        res = two_view_pipeline(g1, g2, torch.Generator(device=dev).manual_seed(0), cfg)
        counts = kernels.launch_counts()
    assert counts["fused_hamming_top2"] == counts["minimal_eight_point"] == \
        counts["ransac_score_hypotheses"] == 1
    assert counts["fused_l2_top2"] == 0
    assert int(res.kps1.mask.sum()) == 1024
    assert not bool(res.kps1.angle.any())               # FAST keypoints stay upright
    samples = sample_minimal_points(torch.Generator(device=dev).manual_seed(1),
                                    res.matches.mask, 256, 8, (res.p1, res.p2))
    gpu = two_view_pipeline(g1, g2, None, cfg, samples=samples)
    cpu = two_view_pipeline(g1.cpu(), g2.cpu(), None, cfg,
                            samples=tuple(s.cpu() for s in samples))
    assert int(gpu.kps1.mask.sum()) == int(cpu.kps1.mask.sum())
    n_cpu = int(cpu.matches.mask.sum())
    assert n_cpu >= 32 and abs(int(gpu.matches.mask.sum()) - n_cpu) <= max(2, n_cpu // 50)
    assert abs(int(gpu.estimate.num_inliers) - int(cpu.estimate.num_inliers)) <= \
        max(2, int(cpu.estimate.num_inliers) // 20)
    assert abs(float((gpu.estimate.F.cpu() * cpu.estimate.F).sum())) >= 0.99


def test_two_view_pipeline_gpu_matches_cpu(dev):
    from points_matching_tpu_torch.core.config import (
        DetectorConfig, MatcherConfig, RansacConfig, TwoViewConfig)
    from points_matching_tpu_torch.data.render import render_sequence
    from points_matching_tpu_torch.geometry.ransac import sample_minimal_points
    from points_matching_tpu_torch.ops import kernels
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline

    cfg = TwoViewConfig(
        detector=DetectorConfig(max_keypoints=128),
        matcher=MatcherConfig(filter="ratio", ratio=0.85),
        ransac=RansacConfig(num_hypotheses=256), use_ransac=True)
    imgs, *_ = render_sequence(num_frames=2, num_landmarks=150, image_size=(256, 192))
    g1, g2 = (torch.from_numpy(np.ascontiguousarray(i)).to(dev) for i in imgs)
    kernels.reset_launch_counts()
    res = two_view_pipeline(g1, g2, torch.Generator(device=dev).manual_seed(0), cfg)
    counts = kernels.launch_counts()
    assert counts["fused_l2_top2"] == counts["minimal_eight_point"] == \
        counts["ransac_score_hypotheses"] == 1
    samples = sample_minimal_points(torch.Generator(device=dev).manual_seed(1),
                                    res.matches.mask, 256, 8, (res.p1, res.p2))
    gpu = two_view_pipeline(g1, g2, None, cfg, samples=samples)
    cpu = two_view_pipeline(g1.cpu(), g2.cpu(), None, cfg,
                            samples=tuple(s.cpu() for s in samples))
    assert int(gpu.kps1.mask.sum()) == int(cpu.kps1.mask.sum())
    assert abs(int(gpu.matches.mask.sum()) - int(cpu.matches.mask.sum())) <= 2
    assert abs(int(gpu.estimate.num_inliers) - int(cpu.estimate.num_inliers)) <= 3
    assert abs(float((gpu.estimate.F.cpu() * cpu.estimate.F).sum())) >= 0.99
    assert dataclasses.is_dataclass(gpu) and gpu.estimate.F.is_cuda


@pytest.mark.parametrize("b,n1,n2,d,masked", [
    (64, 256, 256, 32, 0.05),        # the 32-d synthetic SfM sequences
    (2, 300, 77, 32, 0.1),
    (1, 256, 8192, 64, 0.9),         # a frame against the landmark bank
    (1, 8192, 256, 64, 0.9),         # the bank's cross-check
    (1, 256, 2048, 32, 0.78),        # config 4: a frame against a submap's bank
    (1, 2048, 256, 32, 0.0),         # config 4: the bank's cross-check
    (1, 256, 256, 32, 0.0),          # config 4: frame to frame
])
def test_l2_top2_kernel_sfm_shapes(dev, b, n1, n2, d, masked):
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, l2_top2_plain)

    gen = torch.Generator(device=dev).manual_seed(1)
    q, t = _unit(gen, b, n1, d, dev=dev), _unit(gen, b, n2, d, dev=dev)
    t_mask = torch.rand(b, n2, generator=gen, device=dev) >= masked
    before = fused_l2_top2.launches
    kd, ki = fused_l2_top2(q, t, t_mask)
    assert fused_l2_top2.launches == before + 1
    pd, pi = l2_top2_plain(q, t, t_mask)
    torch.cuda.synchronize()
    # the same tolerances as the 64-d cases above
    torch.testing.assert_close(kd, pd, atol=1e-5, rtol=0)
    tie = (pd[..., 0] - pd[..., 1]).abs() < 1e-5
    assert bool(((ki[..., 0] == pi[..., 0]) | tie).all())
    assert bool(t_mask.gather(1, ki[..., 0].long()).all())     # only valid rows win


def test_incremental_sfm_gpu_matches_cpu(dev):
    from points_matching_tpu_torch.core.config import (
        MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig)
    from points_matching_tpu_torch.data.synthetic import make_tracked_sequence
    from points_matching_tpu_torch.ops import kernels
    from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm
    from points_matching_tpu_torch.utils.evaluation import (
        absolute_trajectory_error, umeyama_alignment)

    # tests/test_sfm.py's 10-frame sequence
    frames, K, gt = make_tracked_sequence(10, device="cpu")
    cfg = SfMConfig(
        two_view=TwoViewConfig(matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
                               ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0)),
        max_cameras=16, max_landmarks=1024, max_observations=8192, pnp_min_inliers=12)
    kernels.reset_launch_counts()
    gpu = run_incremental_sfm([tuple(x.to(dev) for x in f) for f in frames], K, cfg)
    counts = kernels.launch_counts()
    cpu = run_incremental_sfm(frames, K, cfg)
    # K1 at D = 32: the bootstrap's match and three a registered frame; K3
    # and K2 once for the bootstrap's 4 RANSAC candidates (one batch)
    assert counts["fused_l2_top2"] == 1 + 3 * 8
    assert counts["minimal_eight_point"] == counts["ransac_score_hypotheses"] == 1
    assert gpu.trajectory.is_cuda and all(gpu.registered) and all(cpu.registered)
    # tests/test_sfm.py's ATE bound, for both; the aligned trajectories
    # within 2 % of the ~3.2-unit extent of each other
    tg, tc = gpu.trajectory[:10].cpu(), cpu.trajectory[:10]
    for traj in (tg, tc):
        assert float(absolute_trajectory_error(traj, gt).rmse) < 0.05
    s, R, t = umeyama_alignment(tg, tc)
    assert float((s * tg @ R.T + t - tc).norm(dim=-1).max()) < 0.02 * 3.15


# 16, 48, 100: padded with zero columns to 32, 64, 128; 128: its own
# instance; 160 (padded to 192), 256, 512: the chunked kernel
@pytest.mark.parametrize("d", [16, 48, 100, 128, 160, 256, 512])
def test_l2_top2_kernel_any_width(dev, d):
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, fused_l2_top2_points, l2_top2_plain)

    gen = torch.Generator(device=dev).manual_seed(d)
    q, t = _unit(gen, 3, 300, d, dev=dev), _unit(gen, 3, 500, d, dev=dev)
    t_mask = torch.rand(3, 500, generator=gen, device=dev) > 0.1
    before = fused_l2_top2.launches
    kd, ki = fused_l2_top2(q, t, t_mask)
    assert fused_l2_top2.launches == before + 1
    pd, pi = l2_top2_plain(q, t, t_mask)
    torch.cuda.synchronize()
    # the tolerances of the built widths
    torch.testing.assert_close(kd, pd, atol=1e-5, rtol=0)
    tie = (pd[..., 0] - pd[..., 1]).abs() < 1e-5
    assert bool(((ki[..., 0] == pi[..., 0]) | tie).all())
    pts = torch.rand(3, 500, 2, generator=gen, device=dev) * 900
    kd2, ki2, kp = fused_l2_top2_points(q, t, t_mask, pts)
    assert torch.equal(ki2, ki) and torch.equal(kd2, kd)
    assert torch.equal(kp, torch.gather(pts, 1, ki[..., :1].long().expand(-1, -1, 2)))


# 4, 12: padded with zero words to 8, 16; 16: its own instance (512-bit);
# 20 (padded to 24), 24, 32: the chunked kernel
@pytest.mark.parametrize("w", [4, 12, 16, 20, 24, 32])
def test_hamming_top2_kernel_any_width(dev, w):
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import fused_hamming_top2

    gen = torch.Generator(device=dev).manual_seed(w)
    t = _words(gen, 2, 700, w, dev=dev)
    q = _words(gen, 2, 300, w, dev=dev)
    q[:, :100] = t[:, :100]                             # exact duplicates
    q[:, 100:200] = t[:, :100] ^ 5                      # two flipped bits
    t_mask = torch.rand(2, 700, generator=gen, device=dev) > 0.05
    kd, ki = fused_hamming_top2(q, t, t_mask)
    _check_hamming(q, t, t_mask, kd, ki)


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 320])
def test_l2_top2_chunked_one_pair_equals_its_batch_rows(dev, compute_dtype, d):
    """The chunked K1 keeps one fmaf chain a cell over the whole width: one
    pair alone (33 train splits) gives the bits of its rows in a batch of 64
    (one split), and both agree with plain."""
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, l2_top2_plain)

    gen = torch.Generator(device=dev).manual_seed(d)
    q, t = _unit(gen, 64, 512, d, dev=dev), _unit(gen, 64, 512, d, dev=dev)
    t_mask = torch.rand(64, 512, generator=gen, device=dev) > 0.05
    batch = fused_l2_top2(q, t, t_mask, compute_dtype=compute_dtype)
    one = fused_l2_top2(q[:1], t[:1], t_mask[:1], compute_dtype=compute_dtype)
    assert all(torch.equal(a, b[:1]) for a, b in zip(one, batch))
    pd, pi = l2_top2_plain(q, t, t_mask, compute_dtype=compute_dtype)
    torch.testing.assert_close(batch[0], pd, atol=1e-5, rtol=0)
    tie = (pd[..., 0] - pd[..., 1]).abs() < 1e-5
    assert bool(((batch[1][..., 0] == pi[..., 0]) | tie).all())


@pytest.mark.parametrize("w", [24, 32])
def test_hamming_top2_chunked_one_pair_equals_its_batch_rows(dev, w):
    from points_matching_tpu_torch.ops.kernels.hamming_kernel import fused_hamming_top2

    gen = torch.Generator(device=dev).manual_seed(w)
    t = _words(gen, 16, 1024, w, dev=dev)
    q = _words(gen, 16, 1024, w, dev=dev)
    q[:, :200] = t[:, 300:500] ^ 3
    t_mask = torch.rand(16, 1024, generator=gen, device=dev) > 0.05
    batch = fused_hamming_top2(q, t, t_mask)
    one = fused_hamming_top2(q[:1], t[:1], t_mask[:1])
    assert all(torch.equal(a, b[:1]) for a, b in zip(one, batch))
    _check_hamming(q, t, t_mask, *batch)


def test_comm_over_nccl_at_world_size_one(dev):
    """``Comm`` on an NCCL group of one rank, on CUDA tensors: every
    collective is the identity of its input (a sum over one rank), in place
    on the card."""
    import datetime
    import socket

    import torch.distributed as dist

    from points_matching_tpu_torch.parallel.comm import Comm

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        c = Comm(dist.group.WORLD)
        x = torch.arange(6.0, device=dev).reshape(2, 3)
        assert c.size() == 1 and c.index() == 0
        for out in (c.psum(x), c.pmean(x), c.pmax(x), c.pmin(x), c.ring_shift(x),
                    c.all_gather(x, tiled=True), c.reduce_scatter(x),
                    c.all_to_all(x, 0, 1), c.all_gather(x)[0]):
            assert out.device.type == "cuda" and torch.equal(out, x)
        assert torch.equal(x, torch.arange(6.0, device=dev).reshape(2, 3))   # input kept
    finally:
        dist.destroy_process_group()


def test_all_pairs_scores_kernel_matches_plain(dev):
    """64 frames × 256 × 64-d through K1 against the plain version on the
    card: equal counts but at f32 near-ties of the ratio test."""
    from points_matching_tpu_torch.ops import kernels
    from points_matching_tpu_torch.parallel.all_pairs import (
        all_pairs_scores, pair_scores_plain)

    gen = torch.Generator(device=dev).manual_seed(8)
    desc = _unit(gen, 64, 256, 64, dev=dev)
    desc[5] = desc[40] + 0.02 * torch.randn(256, 64, generator=gen, device=dev)
    desc = desc / desc.norm(dim=-1, keepdim=True)
    mask = torch.rand(64, 256, generator=gen, device=dev) > 0.1
    kernels.reset_launch_counts()
    got = all_pairs_scores(desc, mask)
    assert kernels.launch_counts()["fused_l2_top2"] == 64      # one a train frame
    ref = pair_scores_plain(desc, mask, desc, mask)
    torch.cuda.synchronize()
    diff = (got != ref).nonzero().tolist()
    for i, j in diff:
        dist = torch.cdist(desc[i].double(), desc[j].double()) ** 2
        dist = torch.where(mask[j][None], dist, torch.full_like(dist, 1e30))
        two = dist.topk(2, largest=False).values
        ties = mask[i] & ((two[:, 0] - 0.64 * two[:, 1]).abs() <= 1e-5 * two[:, 1])
        assert abs(int(got[i, j]) - int(ref[i, j])) <= int(ties.sum()), (i, j)
    assert len(diff) <= 4, diff
    off = got.clone()
    off.fill_diagonal_(-1)
    assert int(off[5].argmax()) == 40 and int(off[40].argmax()) == 5


def test_close_loops_gpu_matches_cpu(dev):
    """tests/test_loop_closure.py's revisit sequence (the port's generator
    with its settings), drifted: close_loops on the card against the same
    call on the CPU with the same injected RANSAC samples."""
    from points_matching_tpu_torch.core.config import (
        MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig)
    from points_matching_tpu_torch.core.types import Descriptors, Pose
    from points_matching_tpu_torch.data.synthetic import make_tracked_sequence
    from points_matching_tpu_torch.geometry.ransac import sample_index_sets
    from points_matching_tpu_torch.geometry.se3 import se3_exp
    from points_matching_tpu_torch.ops import kernels
    from points_matching_tpu_torch.ops.matching import match_descriptors
    from points_matching_tpu_torch.pipelines.loop_closure import close_loops

    offs = [0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0, -1]
    frames, K, _ = make_tracked_sequence(12, device="cpu", num_landmarks=400,
                                         x_range=(-14.0, 14.0), yaw_step=0.0, t_step=1.2,
                                         offsets=offs)
    cfg = SfMConfig(
        two_view=TwoViewConfig(matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
                               ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0)),
        max_cameras=16, max_landmarks=1024, max_observations=8192, pnp_min_inliers=12)
    gen = torch.Generator().manual_seed(3)
    drift = torch.cumsum(0.02 * torch.randn(12, 6, generator=gen), 0)
    drift[0] = 0.0
    Rd, td = se3_exp(drift)
    t_gt = torch.tensor([[-1.2 * o, 0.0, 0.0] for o in offs])
    poses = Pose(R=Rd, t=(Rd @ t_gt[..., None])[..., 0] + td)
    gframes = [tuple(x.to(dev) for x in f) for f in frames]
    gposes = Pose(R=poses.R.to(dev), t=poses.t.to(dev))
    kernels.reset_launch_counts()
    _, cands = close_loops(gposes, 12, gframes, K, cfg)
    counts = kernels.launch_counts()
    assert cands and any(c.verified for c in cands)
    # all pairs (a launch a train frame), then every candidate verified in
    # one batch: one more K1, K3 and K2 launch each
    assert counts["fused_l2_top2"] == 12 + 1 and counts["minimal_eight_point"] == 1
    assert counts["ransac_score_hypotheses"] == 1
    sgen = torch.Generator(device=dev).manual_seed(1)
    samples = []
    for c in cands:
        (xi, di, mi), (xj, dj, mj) = gframes[c.i], gframes[c.j]
        m = match_descriptors(Descriptors(data=dj, mask=mj), Descriptors(data=di, mask=mi),
                              cfg.two_view.matcher)
        idx = sample_index_sets(sgen, m.mask, 256, 8).long()
        pj, pi = xj[m.query_idx.long()], xi[m.train_idx.long()]
        samples.append((pj[idx], pi[idx]))
    gpu, gc = close_loops(gposes, 12, gframes, K, cfg, f_samples=samples)
    cpu, cc = close_loops(poses, 12, frames, K, cfg,
                          f_samples=[tuple(x.cpu() for x in s_) for s_ in samples])
    assert gc == cc
    assert gpu.t.is_cuda
    torch.testing.assert_close(gpu.R.cpu(), cpu.R, atol=1e-3, rtol=0)
    torch.testing.assert_close(gpu.t.cpu(), cpu.t, atol=1e-3, rtol=0)
    err = lambda p: float((p.t.cpu() - t_gt).norm(dim=-1).mean())  # noqa: E731
    assert err(gpu) < err(poses)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_gpu_matches_cpu(dev, solver):
    """A 60-pose chain with loop edges, solved to convergence on the card
    and on the CPU: the same optimum."""
    from points_matching_tpu_torch.ba.pose_graph import make_odometry_chain, optimize_pose_graph
    from points_matching_tpu_torch.core.types import Pose
    from points_matching_tpu_torch.geometry.se3 import so3_exp

    n = 60
    ang = torch.linspace(0.0, 1.5 * 3.14159, n)
    R = so3_exp(torch.stack([torch.zeros_like(ang), ang, torch.zeros_like(ang)], -1))
    t = torch.stack([2.0 * torch.cos(ang), torch.zeros_like(ang), 2.0 * torch.sin(ang)], -1)
    noise = 0.01 * torch.randn(n - 1, 6, generator=torch.Generator().manual_seed(2))
    g = make_odometry_chain(Pose(R=R, t=t), noise=noise, loop_edges=((0, n - 1), (10, 40)),
                            loop_weight=20.0)
    drifted = Pose(R=g.poses.R @ so3_exp(0.05 * torch.randn(n, 3)), t=g.poses.t + 0.1)
    drifted.R[0], drifted.t[0] = R[0], t[0]
    g0 = g.replace(poses=drifted)
    gg, gs = optimize_pose_graph(g0.to(dev), solver=solver)
    cg, cs = optimize_pose_graph(g0, solver=solver)
    assert gg.poses.t.is_cuda and float(gs.final_cost) < 0.5 * float(gs.initial_cost)
    # both solve in float64 (ba/pose_graph.py): 1e-4 on the f32 poses
    torch.testing.assert_close(gg.poses.R.cpu(), cg.poses.R, atol=1e-4, rtol=0)
    torch.testing.assert_close(gg.poses.t.cpu(), cg.poses.t, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,n1,n2,masked", [
    (1, 512, 32768, 0.9),            # the SLAM demo: a frame against its landmark bank
    (1, 32768, 512, 0.0),            # the bank's cross-check
    (1, 512, 512, 0.0),              # frame to frame (bootstrap, previous frame)
    (5, 512, 512, 0.0),              # a batch of loop verifications
])
def test_l2_top2_kernel_slam_demo_shapes(dev, b, n1, n2, masked):
    """K1 at the shapes ``pipelines/slam.run_slam_demo`` launches (512
    features, D = 64, a bank of 64 × 512 rows) against its plain version."""
    from points_matching_tpu_torch.ops.kernels.matching_kernel import (
        fused_l2_top2, l2_top2_plain)

    gen = torch.Generator(device=dev).manual_seed(3)
    q, t = _unit(gen, b, n1, 64, dev=dev), _unit(gen, b, n2, 64, dev=dev)
    t_mask = torch.rand(b, n2, generator=gen, device=dev) >= masked
    kd, ki = fused_l2_top2(q, t, t_mask)
    pd, pi = l2_top2_plain(q, t, t_mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(kd, pd, atol=1e-5, rtol=0)
    tie = (pd[..., 0] - pd[..., 1]).abs() < 1e-5
    assert bool(((ki[..., 0] == pi[..., 0]) | tie).all())


def test_checkpoint_restores_onto_the_card_bit_for_bit(dev, tmp_path):
    """An SfM map built on the card, saved (copied to the host before
    ``save`` returns) and restored onto the card with the state as
    template: every tensor equal, on the card."""
    from points_matching_tpu_torch.core.config import SfMConfig
    from points_matching_tpu_torch.data.synthetic import make_tracked_sequence
    from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm
    from points_matching_tpu_torch.utils.checkpoint import CheckpointManager

    frames, K, _ = make_tracked_sequence(8, device=dev, num_features=128)
    state = run_incremental_sfm(frames, K, SfMConfig(max_cameras=10, max_landmarks=2048,
                                                     max_observations=8192)).state
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(8, state)
        state.X.add_(1.0)                           # the caller goes on at once
        got = mgr.restore(template=state)
        plain = mgr.restore()
    assert got.X.is_cuda and got.poses.R.is_cuda
    assert torch.equal(got.X + 1.0, state.X)
    for f in dataclasses.fields(state):
        a, b = getattr(got, f.name), getattr(state, f.name)
        if isinstance(b, torch.Tensor) and f.name != "X":
            assert torch.equal(a, b), f.name
    assert torch.equal(got.poses.t, state.poses.t)
    assert plain["X"].device.type == "cpu"


def test_checked_flags_a_nan_on_the_card(dev):
    """``checked(two_view_pipeline)`` on the card: a rendered pair runs
    clean with the unchecked run's F; a NaN in one pixel is flagged."""
    from points_matching_tpu_torch.core.config import named_config
    from points_matching_tpu_torch.data.render import render_sequence
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline
    from points_matching_tpu_torch.utils.sanitize import checked

    imgs, *_ = render_sequence(num_frames=2, num_landmarks=300, image_size=(320, 240), seed=0)
    a, b = (torch.from_numpy(np.ascontiguousarray(i)).to(dev) for i in imgs)
    cfg = named_config("ransac")

    def run(x, y):
        return two_view_pipeline(x, y, torch.Generator(device=dev).manual_seed(0), cfg).estimate.F

    F, err = checked(run)(a, b)
    assert err.get() is None and torch.equal(F, run(a, b))
    bad = a.clone()
    bad[100, 100] = float("nan")
    _, err = checked(run)(bad, b)
    assert err.get().startswith("nan in the output of")


def test_chip_peaks_reads_the_h100_row(dev):
    from points_matching_tpu_torch.ops.kernels.matching_kernel import fused_l2_top2
    from points_matching_tpu_torch.ops.kernels.work import bound
    from points_matching_tpu_torch.utils.profiling import chip_peaks, roofline

    if "H100" not in torch.cuda.get_device_name(dev):
        pytest.skip("the table's row is the H100's")
    peaks = chip_peaks("cuda")
    assert (peaks["flops"], peaks["hbm_gbps"], peaks["instr_per_s"]) == (67e12, 3350.0, 33.5e12)
    assert peaks["popc_per_s"] == 33.5e12 * 16 / 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q, t = _unit(gen, 8, 512, 64, dev=dev), _unit(gen, 8, 512, 64, dev=dev)
    t_mask = torch.rand(8, 512, generator=gen, device=dev) > 0.05
    rep = roofline(fused_l2_top2, q, t, t_mask, timing="graph")
    assert rep.unit == "flops" and rep.bound_s == bound(fused_l2_top2.work(q, t, t_mask),
                                                        peaks)["bound_ms"] / 1e3
    assert 0 < rep.fraction_of_roofline <= 1


def _head_pairs(gen, P, N, D, dev):
    """P pairs of the bench head's workload: train rows are permuted noisy
    copies of the query rows; the train points follow a pure translation
    of the first camera (0.5 px noise), the first 30 % of the queries'
    partners are outliers."""
    q = _unit(gen, P, N, D, dev=dev)
    perm = torch.rand(P, N, generator=gen, device=dev).argsort(-1)
    t = q.gather(1, perm[..., None].expand(P, N, D))
    t = t + 0.1 * torch.randn(P, N, D, generator=gen, device=dev)
    t = (t / t.norm(dim=-1, keepdim=True)).contiguous()
    p1 = torch.rand(P, N, 2, generator=gen, device=dev) * 640
    depth = 4 + 8 * torch.rand(P, N, 1, generator=gen, device=dev)
    X = torch.cat([(p1 - 320) / 512, torch.ones_like(depth)], -1) * depth
    X2 = X + torch.tensor([0.5, 0.05, 0.02], device=dev)
    p2 = X2[..., :2] / X2[..., 2:] * 512 + 320
    p2 = p2 + 0.5 * torch.randn(P, N, 2, generator=gen, device=dev)
    p2[:, :int(0.3 * N)] = torch.rand(P, int(0.3 * N), 2, generator=gen, device=dev) * 640
    p2 = p2.gather(1, perm[..., None].expand(P, N, 2)).contiguous()
    return q, t, p1.contiguous(), p2


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_pair_axis_equals_one_pair_calls(dev, compute_dtype):
    """8 pairs through match_descriptors_points → ransac_fundamental in one
    call and pair by pair, with the same injected samples: the same matches
    and points, equal inlier masks and counts, F within 1e-5."""
    from points_matching_tpu_torch.core.config import MatcherConfig, RansacConfig
    from points_matching_tpu_torch.core.types import Descriptors
    from points_matching_tpu_torch.geometry.ransac import ransac_fundamental, sample_minimal_points
    from points_matching_tpu_torch.ops.matching import match_descriptors_points

    P, N, D, H = 8, 512, 64, 512
    gen = torch.Generator(device=dev).manual_seed(0)
    q, t, p1, p2 = _head_pairs(gen, P, N, D, dev)
    ones = torch.ones(P, N, dtype=torch.bool, device=dev)
    mcfg = MatcherConfig(ratio=0.85, compute_dtype=compute_dtype, compact=False)
    rcfg = RansacConfig(num_hypotheses=H)
    m, q2 = match_descriptors_points(Descriptors(q, ones), Descriptors(t, ones), p2, mcfg)
    samples = sample_minimal_points(gen, m.mask, H, 8, (p1, q2))
    est = ransac_fundamental(None, p1, q2, m.mask, rcfg, samples=samples)
    for i in range(P):
        mi, q2i = match_descriptors_points(Descriptors(q[i], ones[i]), Descriptors(t[i], ones[i]),
                                           p2[i], mcfg)
        assert torch.equal(mi.mask, m.mask[i]) and torch.equal(mi.train_idx, m.train_idx[i])
        assert torch.equal(q2i, q2[i])
        one = ransac_fundamental(None, p1[i], q2i, mi.mask, rcfg,
                                 samples=(samples[0][i], samples[1][i]))
        assert int(one.num_inliers) == int(est.num_inliers[i])
        assert torch.equal(one.inlier_mask, est.inlier_mask[i])
        torch.testing.assert_close(one.F, est.F[i], atol=1e-5, rtol=0)
        assert 2 * int(est.num_inliers[i]) >= int(m.mask[i].sum())


def test_pair_axis_launches_each_kernel_once(dev):
    """A batched call leaves each kernel's launch counter one higher (K1 and
    K4 twice with the cross-check: the second direction)."""
    from points_matching_tpu_torch.core.config import MatcherConfig, RansacConfig
    from points_matching_tpu_torch.core.types import Descriptors
    from points_matching_tpu_torch.geometry.ransac import ransac_fundamental
    from points_matching_tpu_torch.ops.kernels import launch_counts
    from points_matching_tpu_torch.ops.matching import match_descriptors, match_descriptors_points

    P, N, D = 8, 512, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    q, t, p1, p2 = _head_pairs(gen, P, N, D, dev)
    ones = torch.ones(P, N, dtype=torch.bool, device=dev)
    d1, d2 = Descriptors(q, ones), Descriptors(t, ones)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, P, N, 8), generator=gen, device=dev,
                         dtype=torch.int32)
    b1, b2 = (Descriptors(x, ones, binary=True) for x in bits)

    def delta(fn):
        before = launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = launch_counts()
        return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    _, d = delta(lambda: match_descriptors(d1, d2, MatcherConfig()))
    assert d == {"fused_l2_top2": 1}
    _, d = delta(lambda: match_descriptors(d1, d2, MatcherConfig(cross_check=True)))
    assert d == {"fused_l2_top2": 2}
    _, d = delta(lambda: match_descriptors(b1, b2, MatcherConfig(metric="hamming")))
    assert d == {"fused_hamming_top2": 1}
    (m, q2), d = delta(lambda: match_descriptors_points(d1, d2, p2, MatcherConfig(compact=False)))
    assert d == {"fused_l2_top2_points": 1}
    gen_r = torch.Generator(device=dev).manual_seed(2)
    est, d = delta(lambda: ransac_fundamental(gen_r, p1, q2, m.mask, RansacConfig()))
    assert d == {"minimal_eight_point": 1, "ransac_score_hypotheses": 1}
    assert est.F.shape == (P, 3, 3) and bool(torch.isfinite(est.F).all())


@pytest.fixture
def segments16(dev):
    """Config 4's stand-in cut to its first 16 segments of 10 frames
    (overlap 4), 256 features of 32-d, on the card, and the reference
    test's small config."""
    from points_matching_tpu_torch.core.config import (
        BAConfig, MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig)
    from points_matching_tpu_torch.data.synthetic import make_stacked_sequence
    from points_matching_tpu_torch.pipelines.distributed_slam import segment_frames

    kps, desc, mask, K, _ = make_stacked_sequence(num_frames=100, num_landmarks=1200, seed=5,
                                                  corridor=True, device=dev)
    sk, sd, sm, _ = segment_frames(kps, desc, mask, 10, 4)
    cfg = SfMConfig(
        two_view=TwoViewConfig(matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
                               ransac=RansacConfig(num_hypotheses=128, inlier_threshold=2.0)),
        ba=BAConfig(max_iterations=6), max_cameras=10, max_landmarks=1024,
        max_observations=4096, local_ba_window=10)
    return sk[:16], sd[:16], sm[:16], K, cfg


def test_segment_batch_launches_each_kernel_once_a_step(segments16):
    """16 segments built as one batch: K1 once for the bootstrap's match and
    three times a frame step (the frame against its previous frame, against
    its bank and the bank's cross-check, B = 16 each), K3 and K2 once for
    all 16 · 4 bootstrap candidates."""
    from points_matching_tpu_torch.ops import kernels
    from points_matching_tpu_torch.pipelines.distributed_slam import build_submaps

    sk, sd, sm, K, cfg = segments16
    kernels.reset_launch_counts()
    states, regs = build_submaps(sk, sd, sm, K, 0, cfg)
    counts = kernels.launch_counts()
    assert counts["fused_l2_top2"] == 1 + 3 * (sk.shape[1] - 2)
    assert counts["minimal_eight_point"] == counts["ransac_score_hypotheses"] == 1
    assert regs.shape == (16, 10) and bool(regs.all())
    assert states.X.is_cuda and bool(torch.isfinite(states.poses.t).all())


def test_segment_batch_registers_what_each_segment_registers_alone(segments16):
    """The batch against each segment built alone with its own generator
    on the card: the same frames registered, the same number of cameras."""
    from points_matching_tpu_torch.pipelines.distributed_slam import (
        build_submap, build_submaps, segment_seed)

    sk, sd, sm, K, cfg = segments16
    states, regs = build_submaps(sk, sd, sm, K, 0, cfg)
    for s in range(sk.shape[0]):
        gen = torch.Generator(device=sk.device).manual_seed(segment_seed(0, s))
        one, reg = build_submap(sk[s], sd[s], sm[s], K, gen, cfg)
        assert torch.equal(reg, regs[s]), s
        assert int(one.num_cams) == int(states.num_cams[s]), s


# -- the probes' tensor-core kernels (P1-P4) ----------------------------------

PROBE_DESIGNS = ("warp", "warpgroup")     # probe_match.DESIGNS, probe_score.DESIGNS


def _check_probe_match(q, t, t2, design=None):
    """P1 and P2 (in ``design``, or the one the host picks) against their
    plain versions: P1 within 1e-5; P2's indices equal off the rows where
    plain's competing keys lie within 2 quanta, dist within a quantum +
    1e-5 there and 2 quanta + 1e-5 everywhere."""
    from points_matching_tpu_torch.ops.kernels import probe_match as pm

    before = (pm.gemm_rowmin.launches, pm.packed_top2.launches)
    km = pm.gemm_rowmin(q, t, _design=design)
    kd, ki = pm.packed_top2(q, t, t2, _design=design)
    if design:
        assert pm.gemm_rowmin.last_design == pm.packed_top2.last_design == design
    assert (pm.gemm_rowmin.launches, pm.packed_top2.launches) == (before[0] + 1, before[1] + 1)
    pmin = pm.gemm_rowmin_plain(q, t)
    pd, pi = pm.packed_top2_plain(q, t, t2)
    torch.cuda.synchronize()
    torch.testing.assert_close(km, pmin, atol=1e-5, rtol=0)
    near = pm.near_tie_rows(q, t, t2)
    quantum = pm.quantum(q, t2)
    assert torch.equal(ki[~near], pi[~near])
    err = (kd - pd).abs()
    err = torch.where(kd.isnan() & pd.isnan(), 0.0, err)   # no runner-up (N2 = 1)
    if bool((~near).any()):
        assert float(err[~near].max()) <= quantum + 1e-5
    assert float(err.max()) <= 2 * quantum + 1e-5
    return km, kd, ki


# (64, 512, 512, 64): the probes' shape; one pair (32 train splits and the
# merge kernel); ragged shapes that are no multiple of a tile; D = 32, 48,
# 100 and 128 (k-steps of 16, zero-filled past D), and D = 37 (rows loaded
# a float at a time)
@pytest.mark.parametrize("design", PROBE_DESIGNS)
@pytest.mark.parametrize("b,n1,n2,d", [(64, 512, 512, 64), (1, 512, 512, 64), (1, 300, 300, 64),
                                       (3, 200, 333, 48), (2, 70, 7, 64), (1, 129, 1000, 128),
                                       (2, 64, 100, 32), (1, 33, 1, 100), (2, 50, 90, 37)])
def test_probe_match_kernels_match_plain(dev, b, n1, n2, d, design):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, t = _unit(gen, b, n1, d, dev=dev), _unit(gen, b, n2, d, dev=dev)
    m = min(n1, n2) // 2
    t[:, :m] = q[:, :m] + 0.1 * torch.randn(b, m, d, generator=gen, device=dev)
    t = t / t.norm(dim=-1, keepdim=True)
    _check_probe_match(q, t, (t * t).sum(-1), design)


def test_probe_match_host_design_matches_plain(dev):
    """The design the host picks, at 64 pairs and at one pair."""
    from points_matching_tpu_torch.ops.kernels import probe_match as pm

    gen = torch.Generator(device=dev).manual_seed(7)
    for b in (64, 1):
        q, t = _unit(gen, b, 512, 64, dev=dev), _unit(gen, b, 512, 64, dev=dev)
        _check_probe_match(q, t, (t * t).sum(-1))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert pm.gemm_rowmin.last_design == pm.design("gemm_rowmin", b, 512, sms)
        assert pm.packed_top2.last_design == pm.design("packed_top2", b, 512, sms)


# the wgmma kernel's tiling: 1, 65 and 513 query rows (a block is two
# warpgroups of 64) against 1, 9 and 1,000 train rows (a ring stage is 64,
# a split whole 8-column tiles); 3 pairs, so pair offsets of t are no
# multiple of 16 bytes at D = 37 (odd pairs) and the tiles take the ring's
# plain-load path there
@pytest.mark.parametrize("design", PROBE_DESIGNS)
@pytest.mark.parametrize("n1", [1, 65, 513])
@pytest.mark.parametrize("n2,d", [(1, 64), (9, 64), (1000, 64), (90, 37), (1000, 37)])
def test_probe_match_kernels_ragged(dev, n1, n2, d, design):
    gen = torch.Generator(device=dev).manual_seed(3)
    q, t = _unit(gen, 3, n1, d, dev=dev), _unit(gen, 3, n2, d, dev=dev)
    _check_probe_match(q, t, (t * t).sum(-1), design)


def test_probe_match_unaligned_rows_take_the_warpgroup_design(dev):
    """q and t 4 bytes off 16 at D = 64: the host picks the warpgroup
    design, whose ring copies such tiles with plain loads, at any batch;
    the warp design (16-byte row loads) refuses them."""
    from points_matching_tpu_torch.ops.kernels import probe_match as pm

    gen = torch.Generator(device=dev).manual_seed(8)
    for b in (1, 64):
        q, t = (torch.empty(b * 512 * 64 + 1, device=dev)[1:].view(b, 512, 64)
                .copy_(_unit(gen, b, 512, 64, dev=dev)) for _ in range(2))
        assert q.data_ptr() % 16 and q.is_contiguous()
        _check_probe_match(q, t, (t * t).sum(-1))
        assert pm.gemm_rowmin.last_design == pm.packed_top2.last_design == "warpgroup"
        with pytest.raises(ValueError):
            pm.gemm_rowmin(q, t, _design="warp")


@pytest.mark.parametrize("design", PROBE_DESIGNS)
def test_probe_match_tied_keys(dev, design):
    """Train rows repeated (each of 40 rows 8 times): equal products, so
    keys equal but for the column; the lower column is the best."""
    from points_matching_tpu_torch.ops.kernels import probe_match as pm

    gen = torch.Generator(device=dev).manual_seed(4)
    q = _unit(gen, 2, 200, 64, dev=dev)
    t = _unit(gen, 2, 40, 64, dev=dev).repeat_interleave(8, dim=1).contiguous()
    t2 = (t * t).sum(-1)
    _, _, ki = _check_probe_match(q, t, t2, design)
    # the best and the runner-up are two copies of one row, the lower first
    assert bool((ki[..., 0] // 8 == ki[..., 1] // 8).all())
    assert bool((ki[..., 0] < ki[..., 1]).all())
    _, pi = pm.packed_top2_plain(q, t, t2)
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("design", PROBE_DESIGNS)
def test_probe_match_one_pair_equals_its_batch_rows(dev, design):
    """One pair (many train splits, merged) gives its rows of the 64-pair
    launch (one split) to the bit, in either design: the splits' merge is
    exact and each cell's MMA chain is the same."""
    from points_matching_tpu_torch.ops.kernels import probe_match as pm

    gen = torch.Generator(device=dev).manual_seed(1)
    q, t = _unit(gen, 64, 512, 64, dev=dev), _unit(gen, 64, 512, 64, dev=dev)
    t2 = (t * t).sum(-1)
    assert torch.equal(pm.gemm_rowmin(q[:1], t[:1], _design=design),
                       pm.gemm_rowmin(q, t, _design=design)[:1])
    for a, b in zip(pm.packed_top2(q[:1], t[:1], t2[:1], _design=design),
                    pm.packed_top2(q, t, t2, _design=design)):
        assert torch.equal(a, b[:1])


def _probe_scene(gen, b, h, n, dev):
    """Hypotheses around a horizontal-translation F (y2 = y1 on its inliers)
    with perturbations from 1e-6 to 1e-2, points at pixel scale with 0.7 px
    of noise, 5 % masked."""
    p1 = torch.rand(b, n, 2, generator=gen, device=dev) * torch.tensor([640.0, 480.0], device=dev)
    p2 = p1 + torch.tensor([12.0, 0.0], device=dev) \
        + 0.7 * torch.randn(b, n, 2, generator=gen, device=dev)
    F = torch.zeros(3, 3, device=dev)
    F[1, 2], F[2, 1] = -1.0, 1.0
    scale = torch.logspace(-6, -2, h, device=dev)[None, :, None, None]
    F = F + scale * torch.randn(b, h, 3, 3, generator=gen, device=dev)
    F = F / F.norm(dim=(-2, -1), keepdim=True)
    mask = torch.rand(b, n, generator=gen, device=dev) > 0.05
    return F.contiguous(), p1, p2, mask


# each instance in each design it is built in (the fp32 instance: warp only)
PROBE_SCORE_CASES = [("divide", "f32", "warp"), ("divide", "bf16x1", "warp"),
                     ("multiply", "bf16x3", "warp"), ("divide", "bf16x1", "warpgroup"),
                     ("multiply", "bf16x3", "warpgroup")]


@pytest.mark.parametrize("gate,products,design", PROBE_SCORE_CASES)
# (64, 512, 512): the probe's shape; one pair (point splits, atomic
# counts); ragged hypotheses and points
@pytest.mark.parametrize("b,h,n", [(64, 512, 512), (1, 512, 512), (1, 300, 300), (2, 100, 37),
                                   (3, 17, 1000)])
def test_probe_score_kernel_matches_plain(dev, gate, products, design, b, h, n):
    from points_matching_tpu_torch.ops.kernels import probe_score as ps

    gen = torch.Generator(device=dev).manual_seed(2)
    args = (*_probe_scene(gen, b, h, n, dev), 1.5)
    before = ps.score_variant.launches
    kc = ps.score_variant(*args, gate, products, _design=design)
    assert ps.score_variant.last_design == design
    assert ps.score_variant.launches == before + 1
    pc = ps.score_variant_plain(*args, gate, products)
    torch.cuda.synchronize()
    assert int(pc.max()) > n // 2                    # real inlier sets
    if products == "f32":
        # the plain chain in the same operation order, IEEE division: bit for bit
        assert torch.equal(kc, pc)
    else:
        # the tensor core sums a cell's products in its own order
        near = ps.near_gate_cells(*args, products=products)
        assert bool(((kc - pc).abs() <= near).all())


# the wgmma instances' tiling: 1, 65 and 513 hypotheses (a block is two
# warpgroups of 64) over 1, 255 and 257 points (a ring stage is 32); 3 pairs
@pytest.mark.parametrize("gate,products,design", PROBE_SCORE_CASES)
@pytest.mark.parametrize("h", [1, 65, 513])
@pytest.mark.parametrize("n", [1, 255, 257])
def test_probe_score_kernel_ragged(dev, gate, products, design, h, n):
    from points_matching_tpu_torch.ops.kernels import probe_score as ps

    gen = torch.Generator(device=dev).manual_seed(5)
    args = (*_probe_scene(gen, 3, h, n, dev), 1.5)
    kc = ps.score_variant(*args, gate, products, _design=design)
    pc = ps.score_variant_plain(*args, gate, products)
    torch.cuda.synchronize()
    if products == "f32":
        assert torch.equal(kc, pc)
    else:
        assert bool(((kc - pc).abs() <= ps.near_gate_cells(*args, products=products)).all())


@pytest.mark.parametrize("gate,products,design", PROBE_SCORE_CASES)
def test_probe_score_kernel_all_masked(dev, gate, products, design):
    from points_matching_tpu_torch.ops.kernels import probe_score as ps

    gen = torch.Generator(device=dev).manual_seed(6)
    F, p1, p2, mask = _probe_scene(gen, 2, 300, 300, dev)
    counts = ps.score_variant(F, p1, p2, torch.zeros_like(mask), 1.5, gate, products,
                              _design=design)
    assert torch.equal(counts, torch.zeros_like(counts))


def test_probe_wrappers_raise_on_bad_inputs(dev):
    from points_matching_tpu_torch.ops.kernels import probe_match as pm
    from points_matching_tpu_torch.ops.kernels import probe_score as ps

    q = torch.randn(1, 10, 64, device=dev)
    with pytest.raises(ValueError):
        pm.gemm_rowmin(torch.randn(1, 10, 160, device=dev), torch.randn(1, 10, 160, device=dev))
    with pytest.raises(ValueError):
        pm.gemm_rowmin(q.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(ValueError):
        pm.packed_top2(q, q, torch.ones(1, 9, device=dev))
    with pytest.raises(TypeError):
        pm.gemm_rowmin(q.double(), q.double())
    F = torch.randn(1, 4, 3, 3, device=dev)
    p = torch.randn(1, 5, 2, device=dev)
    m = torch.ones(1, 5, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):               # the multiply gate in fp32 is K2
        ps.score_variant(F, p, p, m, 1.0, "multiply", "f32")
    with pytest.raises(ValueError):               # the fp32 instance has no wgmma design
        ps.score_variant(F, p, p, m, 1.0, "divide", "f32", _design="warpgroup")
    with pytest.raises(ValueError):
        pm.gemm_rowmin(q, q, _design="cluster")
    with pytest.raises(ValueError):
        ps.score_variant(F, p.cpu(), p, m, 1.0)


# -- the segmented sum (ops/kernels/segment_sum.py) ----------------------------------

def _seg_case(gen, lengths, width, dtype, dev, masked=0.0):
    """Rows of the given lengths, their entries shuffled over the index, and
    a fraction ``masked`` of extra entries left out by the mask."""
    from points_matching_tpu_torch.ops.kernels import segment_sum as ss

    rows = torch.repeat_interleave(torch.arange(len(lengths)), torch.tensor(lengths))
    extra = int(masked * rows.numel())
    index = torch.cat([rows, torch.randint(0, max(len(lengths), 1), (extra,))])
    mask = torch.cat([torch.ones(rows.numel(), dtype=torch.bool),
                      torch.zeros(extra, dtype=torch.bool)])
    order = torch.randperm(index.numel(), generator=torch.Generator().manual_seed(len(lengths)))
    index, mask = index[order].to(dev), mask[order].to(dev)
    values = torch.randn(index.numel(), width, generator=gen, device=dev, dtype=dtype)
    return values, ss.build_plan(index, len(lengths), mask)


def _check_seg(values, plan):
    """The kernel equal bit for bit to its order in plain PyTorch
    (``segment_sum_ordered``) and within its rounding bound of the plain
    version in float64; a second launch equal to the first bit for bit."""
    from points_matching_tpu_torch.ops.kernels import segment_sum as ss

    before = ss.segment_sum.launches
    got = ss.segment_sum(values, plan)
    assert ss.segment_sum.launches == before + 1
    ref = ss.segment_sum_plain(values.double(), plan)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == values.dtype
    assert torch.equal(got, ss.segment_sum_ordered(values, plan))
    assert bool(((got.double() - ref).abs() <= ss.rounding_bound(values, plan)).all())
    assert torch.equal(ss.segment_sum(values, plan), got)
    return got


@pytest.mark.parametrize("dtype,width", [(torch.float32, 3), (torch.float32, 6),
                                         (torch.float32, 9), (torch.float32, 36),
                                         (torch.float64, 3), (torch.float64, 6),
                                         (torch.float64, 9), (torch.float64, 36)])
def test_segment_sum_kernel_matches_plain_each_instance(dev, dtype, width):
    """Every instance on rows of 0 to 600 entries with a fifth of the
    entries masked (short rows, one piece, several pieces), among them rows
    on each side of a chunk (32) and of a piece (256)."""
    gen = torch.Generator(device=dev).manual_seed(width)
    lengths = [int(x) for x in torch.randint(0, 600, (300,), generator=torch.Generator()
                                             .manual_seed(1))]
    lengths[:8] = [0, 1, 31, 32, 33, 255, 256, 257]
    _check_seg(*_seg_case(gen, lengths, width, dtype, dev, masked=0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_kernel_long_and_empty_segments(dev, dtype):
    """Segments of 0, 1, 31, 32, 33, 255, 256, 257, 2,048 and 131,072
    entries in one plan, at W = 6 and 36."""
    gen = torch.Generator(device=dev).manual_seed(3)
    for width in (6, 36):
        got = _check_seg(*_seg_case(gen, [0, 1, 31, 32, 33, 255, 256, 257, 2048, 131072],
                                    width, dtype, dev))
        assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("shape", [(3, 8, 40, 36), (283, 20, 12, 9), (5, 4541, 2, 6)])
def test_segment_sum_kernel_batch_equals_each_problem_alone(dev, shape):
    """S problems side by side (rows s·n + r, ``flat_rows``, a tenth of the
    entries masked) give each problem the bits it gets alone."""
    from points_matching_tpu_torch.core.types import flat_rows
    from points_matching_tpu_torch.ops.kernels import segment_sum as ss

    S, n, per, width = shape
    gen = torch.Generator(device=dev).manual_seed(S)
    index = torch.randint(0, n, (S, n * per), generator=gen, device=dev)
    mask = torch.rand(S, n * per, generator=gen, device=dev) > 0.1
    values = torch.randn(S, n * per, width, generator=gen, device=dev)
    batch = _check_seg(values.reshape(-1, width),
                       ss.build_plan(flat_rows(index, n), S * n, mask))
    for s in (0, S // 2, S - 1):
        alone = ss.segment_sum(values[s], ss.build_plan(index[s], n, mask[s]))
        assert torch.equal(batch[s * n:(s + 1) * n], alone)


def test_segment_sum_wrapper_raises_on_bad_inputs(dev):
    from points_matching_tpu_torch.ops.kernels import segment_sum as ss

    plan = ss.build_plan(torch.randint(0, 4, (10,), device=dev), 4)
    with pytest.raises(ValueError):                    # no instance of width 5
        ss.segment_sum(torch.randn(10, 5, device=dev), plan)
    with pytest.raises(ValueError):                    # no f16 instance
        ss.segment_sum(torch.randn(10, 3, device=dev, dtype=torch.float16), plan)
    with pytest.raises(ValueError):
        ss.segment_sum(torch.randn(10, 3), plan)
    v = torch.randn(11, 3, device=dev)[1:]             # off 16 bytes: copied, same sums
    assert torch.equal(ss.segment_sum(v, plan), ss.segment_sum(v.clone(), plan))


def _no_scatter_add():
    """A dispatch mode that fails on ``index_add`` and on
    ``index_put(accumulate=True)`` of a CUDA tensor."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoScatterAdd(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__.rstrip("_")
            accumulate = name in ("index_put", "_index_put_impl") and (
                kwargs.get("accumulate") or (len(args) > 3 and args[3]))
            if (name == "index_add" or accumulate) and args[0].is_cuda:
                raise AssertionError(f"{func} on a CUDA tensor")
            return func(*args, **kwargs)

    return NoScatterAdd()


def test_sparse_ba_auto_layout_is_reproducible_and_scatter_free(dev):
    """``bundle_adjust_sparse`` with ``obs_layout='auto'`` on the card: no
    ``index_add_``, the segmented sum launched, two runs equal bit for bit;
    ``'scatter'`` runs the same plans: no ``index_add_``, the same bits."""
    from points_matching_tpu_torch.ba.sparse import bundle_adjust_sparse, make_sparse_ba_state
    from points_matching_tpu_torch.core.config import BAConfig
    from points_matching_tpu_torch.core.types import CameraIntrinsics
    from points_matching_tpu_torch.data.synthetic import make_sparse_ba_problem
    from points_matching_tpu_torch.ops.kernels import segment_sum as ss

    prob = make_sparse_ba_problem(seed=1, num_cameras=16, num_landmarks=2048,
                                  obs_per_landmark=8, device=dev)
    K = CameraIntrinsics.from_matrix(prob["K"])
    state = make_sparse_ba_state(prob["poses"], prob["X"], prob["cam_idx"], prob["lm_idx"],
                                 prob["uv"], prob["obs_mask"])
    cfg = BAConfig(max_iterations=5, rtol=0.0, pcg_iterations=20)
    before = ss.segment_sum.launches
    with _no_scatter_add():
        a, sa = bundle_adjust_sparse(state, K, cfg)
    assert ss.segment_sum.launches > before
    b, sb = bundle_adjust_sparse(state, K, cfg)
    assert torch.equal(a.X, b.X) and torch.equal(a.poses.t, b.poses.t)
    assert torch.equal(sa.final_cost, sb.final_cost)
    with _no_scatter_add():
        c, sc = bundle_adjust_sparse(state, K, dataclasses.replace(cfg, obs_layout="scatter"))
    assert float(sa.final_cost) < float(sa.initial_cost)
    assert torch.equal(a.X, c.X) and torch.equal(sc.final_cost, sa.final_cost)


def test_sparse_ba_float64_on_the_card(dev):
    """A float64 state under the default layout runs the kernel's f64
    instances (W = 36, 6, 9, 3) on the card, reaches no ``index_add_``, gives
    the same bits twice, and ends within 1e-6 of the float64 run on the
    CPU (relative cost)."""
    from points_matching_tpu_torch.ba.sparse import bundle_adjust_sparse, make_sparse_ba_state
    from points_matching_tpu_torch.core.config import BAConfig
    from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose
    from points_matching_tpu_torch.data.synthetic import make_sparse_ba_problem
    from points_matching_tpu_torch.ops.kernels import segment_sum as ss

    prob = make_sparse_ba_problem(seed=2, num_cameras=8, num_landmarks=512,
                                  obs_per_landmark=6, device="cpu")
    K = CameraIntrinsics.from_matrix(prob["K"].double())
    poses = Pose(R=prob["poses"].R.double(), t=prob["poses"].t.double())
    state = make_sparse_ba_state(poses, prob["X"].double(), prob["cam_idx"], prob["lm_idx"],
                                 prob["uv"].double(), prob["obs_mask"])
    cfg = BAConfig(max_iterations=5, rtol=0.0, pcg_iterations=20)
    on_card = dataclasses.replace(
        state, poses=Pose(R=poses.R.to(dev), t=poses.t.to(dev)),
        **{f: getattr(state, f).to(dev) for f in ("X", "cam_idx", "lm_idx", "uv", "obs_mask",
                                                   "cam_fixed", "lm_fixed")})
    Kd = K.to(dev)
    before = ss.segment_sum.launches
    with _no_scatter_add():
        a, sa = bundle_adjust_sparse(on_card, Kd, cfg)
    assert ss.segment_sum.launches > before and a.X.dtype == torch.float64
    b, sb = bundle_adjust_sparse(on_card, Kd, cfg)
    assert torch.equal(a.X, b.X) and torch.equal(sa.final_cost, sb.final_cost)
    _, sc = bundle_adjust_sparse(state, K, cfg)
    assert float(sa.final_cost) < float(sa.initial_cost)
    torch.testing.assert_close(sa.final_cost.cpu(), sc.final_cost, rtol=1e-6, atol=0)


def _dense_ba_gaps(a, b):
    """How far two dense BA results lie apart: the relative cost and the
    largest |ΔX| and |Δt|."""
    (oa, sa), (ob, sb) = a, b
    return (abs(float(sa.final_cost) / float(sb.final_cost.cpu()) - 1),
            float((oa.X.cpu() - ob.X.cpu()).abs().max()),
            float((oa.poses.t.cpu() - ob.poses.t.cpu()).abs().max()))


# the float32 card-vs-CPU gap may be at most this multiple of the largest
# gap that the card's own run shows when its landmarks move by 1e-7 or 1e-6
# relative (six probes): the LM amplifies rounding (the reference's gauge
# masking), so the gap is measured against that amplification
DENSE_BA_PROBE_MULTIPLE = 4


@pytest.mark.parametrize("solver,cost_rtol,x_atol", [("cholesky", 0.1, 2e-2),
                                                     ("pcg", 1e-2, 5e-3)])
def test_dense_ba_gpu_matches_cpu(dev, solver, cost_rtol, x_atol):
    """``bundle_adjust`` on the card at 6 cameras × 64 landmarks.  In float32
    (the path): the cost falls 100-fold and stays finite, the gauge cameras
    stay exactly fixed, two card runs are equal bit for bit, and after 1, 2
    and 20 LM iterations the card lies from the CPU by at most
    ``DENSE_BA_PROBE_MULTIPLE`` times the card's own move under a 1e-7 or
    1e-6 relative move of its landmarks (cost, X, t; at this shape the
    float32 LM moves past tests/test_torch_ba.py's bounds on the CPU alone
    under such a move,
    tests/test_torch_ba.py::test_dense_ba_amplifies_float32_rounding_at_6x64).
    In float64, against the CPU with tests/test_torch_ba.py's bounds: the
    first two LM steps (rtol 0) within 1e-3 (cost, and the X and t updates
    against the largest), the 20-iteration result within the solver's band
    (10 % Cholesky, 1 % PCG) and X, t within its atol."""
    from points_matching_tpu_torch.ba.lm import bundle_adjust
    from points_matching_tpu_torch.core.config import BAConfig
    from points_matching_tpu_torch.data.synthetic import make_perturbed_ba_problem

    def config(it):
        rtol = dict(rtol=0.0) if it < 20 else {}
        return BAConfig(max_iterations=it, solver=solver, pcg_iterations=20, **rtol)

    cfg = config(20)
    state, K = make_perturbed_ba_problem(0, 6, 64)
    on_card, Kd = make_perturbed_ba_problem(0, 6, 64, device=dev)
    g, gs = bundle_adjust(on_card, Kd, cfg)
    g2, gs2 = bundle_adjust(on_card, Kd, cfg)
    assert torch.equal(gs.final_cost, gs2.final_cost) and torch.equal(g.X, g2.X)
    assert torch.equal(g.poses.t, g2.poses.t) and torch.equal(g.poses.R, g2.poses.R)
    c0, c1 = float(gs.initial_cost), float(gs.final_cost)
    assert np.isfinite(c1) and c1 < 0.01 * c0 and g.X.is_cuda
    assert torch.equal(g.poses.t[:2].cpu(), state.poses.t[:2])      # gauge fixed exactly
    probes = [dataclasses.replace(on_card, X=on_card.X * (1 + eps * torch.randn(
        on_card.X.shape, generator=torch.Generator().manual_seed(seed)).to(dev)))
        for eps in (1e-7, 1e-6) for seed in (9, 10, 11)]
    for it in (1, 2, 20):
        card = bundle_adjust(on_card, Kd, config(it))
        gap = _dense_ba_gaps(card, bundle_adjust(state, K, config(it)))
        moved = [_dense_ba_gaps(bundle_adjust(p, Kd, config(it)), card) for p in probes]
        for k, name in enumerate(("cost", "X", "t")):
            most = max(m[k] for m in moved)
            assert gap[k] <= DENSE_BA_PROBE_MULTIPLE * most, (it, name, gap[k], most)

    state, K = make_perturbed_ba_problem(0, 6, 64, dtype=torch.float64)
    on_card, Kd = make_perturbed_ba_problem(0, 6, 64, dtype=torch.float64, device=dev)
    for it in (1, 2):
        g, gs = bundle_adjust(on_card, Kd, config(it))
        c, cs = bundle_adjust(state, K, config(it))
        assert int(gs.iterations) == int(cs.iterations) == it and g.X.dtype == torch.float64
        torch.testing.assert_close(gs.final_cost.cpu(), cs.final_cost, rtol=1e-3, atol=0)
        for a, b, start in ((g.X, c.X, state.X), (g.poses.t, c.poses.t, state.poses.t)):
            d_cpu = b - start
            torch.testing.assert_close(a.cpu() - start, d_cpu, rtol=0,
                                       atol=1e-3 * float(d_cpu.abs().max()))
    g, gs = bundle_adjust(on_card, Kd, cfg)
    c, cs = bundle_adjust(state, K, cfg)
    assert float(gs.final_cost) < 0.01 * float(gs.initial_cost)
    torch.testing.assert_close(gs.final_cost.cpu(), cs.final_cost, rtol=cost_rtol, atol=0)
    torch.testing.assert_close(g.X.cpu(), c.X, rtol=0, atol=x_atol)
    torch.testing.assert_close(g.poses.t.cpu(), c.poses.t, rtol=0, atol=x_atol)


def test_dense_ba_failed_factor_gives_a_nan_step(dev):
    """A reduced system Cholesky cannot factor (U = −I, no coupling, no
    damping): ``cholesky_ex``'s ``info`` turns the step into NaN on the
    card, which the LM loop rejects (tests/test_torch_ba.py), instead of a
    step from a partial factor."""
    from points_matching_tpu_torch.ba import schur

    blocks = schur.NormalEqBlocks(U=-torch.eye(6, device=dev).expand(6, 6, 6).clone(),
                                  V=torch.eye(3, device=dev).expand(64, 3, 3).clone(),
                                  W=torch.zeros(6, 64, 6, 3, device=dev),
                                  bc=torch.ones(6, 6, device=dev),
                                  bl=torch.ones(64, 3, device=dev))
    dc, dl = schur.solve_schur(blocks, torch.tensor(0.0, device=dev))
    assert dc.is_cuda and torch.isnan(dc).all() and torch.isnan(dl).all()


def test_grid_from_obs_on_the_card_is_the_cpu_rule(dev):
    """Duplicate (camera, landmark) pairs, valid and invalid mixed, some
    rows past the grid: two card runs give the same grids, equal to the
    CPU's (the last valid row of a pair wins)."""
    from points_matching_tpu_torch.ba.lm import grid_from_obs

    g = torch.Generator().manual_seed(7)
    C, L, O = 16, 64, 20000
    cam, lm = torch.randint(0, C, (O,), generator=g), torch.randint(0, L, (O,), generator=g)
    uv, mask = torch.randn(O, 2, generator=g), torch.rand(O, generator=g) > 0.3
    cam[::1009], lm[5::1013] = C, L + 1         # rows past the grid, dropped
    want = grid_from_obs(cam, lm, uv, mask, C, L)
    on_card = [grid_from_obs(cam.to(dev), lm.to(dev), uv.to(dev), mask.to(dev), C, L)
               for _ in range(2)]
    for uv_g, m_g in on_card:
        assert torch.equal(uv_g.cpu(), want[0]) and torch.equal(m_g.cpu(), want[1])


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_is_reproducible_and_scatter_free(dev, solver):
    """``optimize_pose_graph`` on the card reaches no scatter-add and gives
    the same bits twice."""
    from points_matching_tpu_torch.ba.pose_graph import make_odometry_chain, optimize_pose_graph
    from points_matching_tpu_torch.core.types import Pose
    from points_matching_tpu_torch.geometry.se3 import so3_exp

    n = 200
    ang = torch.linspace(0.0, 2 * 3.14159, n)
    R = so3_exp(torch.stack([torch.zeros_like(ang), ang, torch.zeros_like(ang)], -1))
    t = torch.stack([5.0 * torch.cos(ang), torch.zeros_like(ang), 5.0 * torch.sin(ang)], -1)
    noise = 0.01 * torch.randn(n - 1, 6, generator=torch.Generator().manual_seed(4))
    g = make_odometry_chain(Pose(R=R, t=t), noise=noise, loop_edges=((0, n - 1), (20, 150)))
    g0 = g.replace(poses=Pose(R=R @ so3_exp(0.03 * torch.randn(n, 3)), t=t + 0.05)).to(dev)
    with _no_scatter_add():
        a, sa = optimize_pose_graph(g0, solver=solver)
    b, sb = optimize_pose_graph(g0, solver=solver)
    assert torch.equal(a.poses.R, b.poses.R) and torch.equal(a.poses.t, b.poses.t)
    assert torch.equal(sa.final_cost, sb.final_cost)
    assert float(sa.final_cost) < 0.5 * float(sa.initial_cost)
