"""The port's pair axis: match → RANSAC F → pose over a leading [P, ...]
axis, held to the port's own one-pair calls (exactly, or F to 1e-6) and to
``jax.vmap`` of the JAX functions (the existing parity tests' tolerances),
the kernels as their plain versions on the CPU.  The JAX references are
computed once a module; RANSAC's minimal sets are the reference's own,
injected (torch's RNG cannot reproduce threefry)."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core.config import MatcherConfig as JMatcherConfig  # noqa: E402
from points_matching_tpu.core.config import RansacConfig as JRansacConfig  # noqa: E402
from points_matching_tpu.core.types import Descriptors as JDescriptors  # noqa: E402
from points_matching_tpu.geometry import ransac as jr  # noqa: E402
from points_matching_tpu.ops import matching as jm  # noqa: E402
from points_matching_tpu_torch.core.config import MatcherConfig, RansacConfig  # noqa: E402
from points_matching_tpu_torch.core.types import Descriptors  # noqa: E402
from points_matching_tpu_torch.geometry.pose import recover_pose  # noqa: E402
from points_matching_tpu_torch.geometry.ransac import (  # noqa: E402
    _stratified_positions,
    ransac_fundamental,
    sample_index_sets,
    sample_minimal_points,
)
from points_matching_tpu_torch.ops import matching as tm  # noqa: E402

P = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _float_pairs(n=96, d=64, seed=0):
    """P pairs of unit descriptors: train = reversed noisy copies of the
    query, each pair with its own masked rows."""
    rng = np.random.RandomState(seed)
    q = rng.randn(P, n, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = q[:, ::-1] + 0.05 * rng.randn(P, n, d).astype(np.float32)
    t = (t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)
    qm = np.stack([np.arange(n) < n - 10 * p for p in range(1, P + 1)])
    tm_ = np.stack([np.arange(n) >= 3 * p for p in range(P)])
    return q, qm, np.ascontiguousarray(t), tm_


def _binary_pairs(n=96, seed=1):
    """P pairs of packed 256-bit descriptors (uint32 words): train =
    reversed copies of the query with 10 % of the bits flipped, some rows
    with no true partner."""
    rng = np.random.RandomState(seed)
    words = lambda *s: rng.randint(0, 2 ** 32, s, dtype=np.uint64).astype(np.uint32)  # noqa: E731
    q = words(P, n, 8)
    flips = np.packbits(rng.rand(P, n, 256) < 0.1, axis=-1,
                        bitorder="little").view(np.uint32)
    t = q[:, ::-1] ^ flips
    t[:, :10] = words(P, 10, 8)
    qm = np.stack([np.arange(n) < n - 7 * p for p in range(1, P + 1)])
    return q, qm, np.ascontiguousarray(t), np.arange(n)[None].repeat(P, 0) >= 4


_MATCH_CASES = [
    ("l2", "f32", dict(filter="ratio", ratio=0.9), False),
    ("l2", "f32", dict(filter="midpoint"), True),
    ("l2", "f32", dict(filter="threshold", threshold=0.6), False),
    ("l2", "f32", dict(filter="ratio", ratio=0.9, cross_check=True), True),
    ("l2", "bf16", dict(filter="ratio", ratio=0.9), True),
    ("l2", "bf16", dict(filter="threshold", threshold=0.6, cross_check=True), False),
    ("hamming", "f32", dict(filter="ratio", ratio=0.8), True),
    ("hamming", "f32", dict(filter="midpoint"), False),
    ("hamming", "f32", dict(filter="threshold", threshold=40.0, cross_check=True), True),
]


def _case_id(case):
    metric, dtype, kw, compact = case
    return "-".join([metric, dtype, *(f"{k}={v}" for k, v in kw.items()), f"compact={compact}"])


def _inputs(metric):
    binary = metric == "hamming"
    q, qm, t, tmask = _binary_pairs() if binary else _float_pairs()
    jd = [JDescriptors(data=jnp.asarray(a), mask=jnp.asarray(m), binary=binary)
          for a, m in ((q, qm), (t, tmask))]
    data = [_t(a.view(np.int32) if binary else a) for a in (q, t)]
    td = [Descriptors(data=x, mask=_t(m), binary=binary) for x, m in zip(data, (qm, tmask))]
    return jd, td


def _one(d: Descriptors, p: int) -> Descriptors:
    return Descriptors(data=d.data[p], mask=d.mask[p], binary=d.binary)


def _assert_matches_equal(a, b):
    for f in ("query_idx", "train_idx", "distance", "mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _assert_matches_close_to_jax(out, ref, metric):
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(out.query_idx.numpy(), np.asarray(ref.query_idx))
    np.testing.assert_array_equal(out.train_idx.numpy(), np.asarray(ref.train_idx))
    # Hamming counts are integers; L2 distances are sqrt of f32 sums taken
    # in another order (tests/test_torch_matching.py's 1e-5)
    np.testing.assert_allclose(out.distance.numpy(), np.asarray(ref.distance),
                               atol=0 if metric == "hamming" else 1e-5)


@pytest.mark.parametrize("case", _MATCH_CASES, ids=_case_id)
def test_batched_match_descriptors(case):
    metric, dtype, kw, compact = case
    (jd1, jd2), (d1, d2) = _inputs(metric)
    cfg = MatcherConfig(metric=metric, compute_dtype=dtype, compact=compact, **kw)
    out = tm.match_descriptors(d1, d2, cfg)
    assert out.mask.shape == (P, d1.capacity) and int(out.mask.sum()) > 10 * P
    # each pair as a one-pair call: the same matches exactly
    per = [tm.match_descriptors(_one(d1, p), _one(d2, p), cfg) for p in range(P)]
    _assert_matches_equal(out, type(out)(*(torch.stack([getattr(m, f) for m in per])
                                           for f in ("query_idx", "train_idx",
                                                     "distance", "mask"))))
    jcfg = JMatcherConfig(metric=metric, compute_dtype=dtype, compact=compact,
                          backend="xla", **kw)
    ref = jax.vmap(lambda a, b: jm.match_descriptors(a, b, jcfg))(jd1, jd2)
    _assert_matches_close_to_jax(out, ref, metric)
    # the statistic per pair
    jmin, jmax = jax.vmap(jm.match_stats)(ref)
    tmin, tmax = tm.match_stats(out)
    np.testing.assert_allclose(tmin.numpy(), np.asarray(jmin), atol=1e-5)
    np.testing.assert_allclose(tmax.numpy(), np.asarray(jmax), atol=1e-5)


@pytest.mark.parametrize("case", [
    ("l2", "f32", dict(filter="ratio", ratio=0.9)),       # K1b
    ("l2", "bf16", dict(filter="ratio", ratio=0.9)),      # K1b
    ("l2", "f32", dict(filter="threshold", threshold=0.6)),
    ("l2", "f32", dict(filter="midpoint")),               # match_descriptors + gather
    ("hamming", "f32", dict(filter="ratio", ratio=0.8)),  # K4 + gather
], ids=lambda c: _case_id((*c, False)))
def test_batched_match_descriptors_points(case):
    metric, dtype, kw = case
    (jd1, jd2), (d1, d2) = _inputs(metric)
    pts = np.random.RandomState(9).uniform(0, 640, (P, d2.capacity, 2)).astype(np.float32)
    cfg = MatcherConfig(metric=metric, compute_dtype=dtype, compact=False, **kw)
    m, got = tm.match_descriptors_points(d1, d2, _t(pts), cfg)
    assert got.shape == (P, d1.capacity, 2)
    for p in range(P):
        mp, gp = tm.match_descriptors_points(_one(d1, p), _one(d2, p), _t(pts[p]), cfg)
        assert torch.equal(m.mask[p], mp.mask) and torch.equal(m.train_idx[p], mp.train_idx)
        assert torch.equal(m.distance[p], mp.distance) and torch.equal(got[p], gp)
        # pts[i] == t_points[train_idx[i]] on EVERY row, filtered rows included
        np.testing.assert_array_equal(got[p].numpy(), pts[p][m.train_idx[p].numpy()])
    jcfg = JMatcherConfig(metric=metric, compute_dtype=dtype, compact=False, **kw)
    ref, jpts = jax.vmap(lambda a, b, t: jm.match_descriptors_points(a, b, t, jcfg))(
        jd1, jd2, jnp.asarray(pts))
    _assert_matches_close_to_jax(m, ref, metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpts))


@pytest.mark.parametrize("wrapper", ["fused_l2_top2", "fused_l2_top2_points",
                                     "fused_hamming_top2"])
def test_batched_match_reaches_the_fused_wrapper(monkeypatch, wrapper):
    """A [P, N, D] match runs K1, K1b or K4 once with B = P (the plain
    version here, the kernel on the card), never ``knn_match``; the
    cross-check is a second launch of the same kernel."""
    metric = "hamming" if wrapper == "fused_hamming_top2" else "l2"
    _, (d1, d2) = _inputs(metric)
    real, shapes = getattr(tm, wrapper), []

    def spy(q, *args, **kw):
        shapes.append(tuple(q.shape))
        return real(q, *args, **kw)

    def no_plain(*args, **kw):
        raise AssertionError("the batched match fell back to knn_match")

    monkeypatch.setattr(tm, wrapper, spy)
    monkeypatch.setattr(tm, "knn_match", no_plain)
    if wrapper == "fused_l2_top2_points":
        pts = torch.zeros(P, d2.capacity, 2)
        tm.match_descriptors_points(d1, d2, pts, MatcherConfig(compact=False))
        assert shapes == [tuple(d1.data.shape)]
    else:
        tm.match_descriptors(d1, d2, MatcherConfig(metric=metric, cross_check=True))
        assert shapes == [tuple(d1.data.shape), tuple(d2.data.shape)]
        assert shapes[0][0] == P


def _outlier_scene(seed, n=128):
    """tests/test_torch_ransac.py's scene with a per-pair seed and
    baseline: 1/3 outliers, 0.3 px noise, 5 padded rows."""
    rng = np.random.RandomState(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    X = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, (n, 1))],
                       axis=1).astype(np.float32)
    p1 = (X / X[:, 2:3]) @ K.T
    X2 = X + np.array([0.3 + 0.1 * seed, 0.05, 0.02 * seed], np.float32)
    p2 = (X2 / X2[:, 2:3]) @ K.T
    p1, p2 = p1[:, :2].astype(np.float32), p2[:, :2].astype(np.float32)
    p2 = p2 + 0.3 * rng.randn(n, 2).astype(np.float32)
    p2[: n // 3] = rng.uniform(0, 640, (n // 3, 2))
    return p1, p2, np.arange(n) < n - 5


H_RANSAC = 128


@pytest.fixture(scope="module")
def ransac_reference():
    """``jax.vmap(ransac_fundamental)`` over P scenes and the minimal sets
    each pair drew with its key."""
    p1, p2, mask = (np.stack(x) for x in zip(*(_outlier_scene(s) for s in range(P))))
    keys = jax.random.split(jax.random.PRNGKey(0), P)
    jcfg = JRansacConfig(num_hypotheses=H_RANSAC, backend="xla")
    args = (jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask))
    ref = jax.jit(jax.vmap(lambda k, a, b, m: jr.ransac_fundamental(k, a, b, m, jcfg)))(
        keys, *args)
    sp1, sp2 = jax.vmap(lambda k, a, b, m: jr.sample_minimal_points(
        k, m, H_RANSAC, 8, (a, b)))(keys, *args)
    return (p1, p2, mask), ref, (_t(sp1), _t(sp2))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_batched_ransac_matches_vmapped_reference(backend, ransac_reference):
    (p1, p2, mask), ref, samples = ransac_reference
    cfg = RansacConfig(num_hypotheses=H_RANSAC, backend=backend)
    out = ransac_fundamental(None, _t(p1), _t(p2), _t(mask), cfg, samples=samples)
    assert out.F.shape == (P, 3, 3) and out.num_inliers.shape == (P,)
    Fj = np.asarray(ref.F)
    for p in range(P):
        # tests/test_torch_ransac.py's tolerances, per pair
        assert abs(np.sum(Fj[p] * out.F[p].numpy())) >= 0.999
        assert abs(int(out.num_inliers[p]) - int(ref.num_inliers[p])) <= 2
        assert int(out.num_inliers[p]) >= 70
        if backend == "xla":
            # the reference's solver chain (eight_point, the [H, N] Sampson
            # gate): the audit to 5 %.  K3's f32 chain differs from it by
            # rounding (ROADMAP Queue 3), which on scene 2 lets a hypothesis
            # 2 inliers richer win; the audit |p1ᵀ F p2| over those two
            # near-gate rows then moves by 17 %, one-pair calls alike
            np.testing.assert_allclose(float(out.residual_mean[p]),
                                       float(ref.residual_mean[p]), rtol=0.05)
        one = ransac_fundamental(None, _t(p1[p]), _t(p2[p]), _t(mask[p]), cfg,
                                 samples=(samples[0][p], samples[1][p]))
        assert torch.equal(one.inlier_mask, out.inlier_mask[p])
        assert int(one.num_inliers) == int(out.num_inliers[p])
        assert torch.equal(one.residual_mean, out.residual_mean[p])
        torch.testing.assert_close(one.F, out.F[p], atol=1e-6, rtol=0)


def test_batched_ransac_seven_point_and_own_draws_equal_per_pair(ransac_reference):
    """The 7-point path over the pair axis, and the port's own sampler: a
    batch of P draws is P one-pair estimates (each pair's sets taken from
    the batch's draw)."""
    (p1, p2, mask), _, _ = ransac_reference
    tp1, tp2, tmask = _t(p1), _t(p2), _t(mask)
    for solver, S in (("7pt", 7), ("8pt", 8)):
        cfg = RansacConfig(num_hypotheses=64, solver=solver)
        samples = sample_minimal_points(torch.Generator().manual_seed(2), tmask, 64, S,
                                        (tp1, tp2))
        assert samples[0].shape == (P, 64, S, 2)
        out = ransac_fundamental(None, tp1, tp2, tmask, cfg, samples=samples)
        drawn = ransac_fundamental(torch.Generator().manual_seed(2), tp1, tp2, tmask, cfg)
        assert torch.equal(drawn.F, out.F) and torch.equal(drawn.inlier_mask, out.inlier_mask)
        for p in range(P):
            one = ransac_fundamental(None, tp1[p], tp2[p], tmask[p], cfg,
                                     samples=(samples[0][p], samples[1][p]))
            assert torch.equal(one.inlier_mask, out.inlier_mask[p]), (solver, p)
            torch.testing.assert_close(one.F, out.F[p], atol=1e-6, rtol=0)
            assert int(out.num_inliers[p]) >= 70, (solver, p)


def test_batched_sampler_buckets_and_independence():
    n, S, H = 61, 8, 300
    mask = torch.ones(P, n, dtype=torch.bool)
    mask[0, ::7] = False
    mask[1, :20] = False
    mask[2, 5::3] = False
    j, slot_idx, bucket = _stratified_positions(torch.Generator().manual_seed(3), mask, H, S)
    assert bucket == -(-n // S)
    assert j.shape == (P, H, S) and slot_idx.shape == (P, S * bucket)
    picks = sample_index_sets(torch.Generator().manual_seed(3), mask, H, S)
    assert picks.shape == (P, H, S)
    for p in range(P):
        assert sorted(slot_idx[p][slot_idx[p] < n - 1].tolist()) == list(range(n - 1))
        # own bucket: pick s is one of the slots of bucket s of this pair's
        # permutation
        for s in range(S):
            members = set(slot_idx[p, s * bucket:(s + 1) * bucket].tolist())
            assert set(picks[p, :, s].tolist()) <= members
        # buckets are disjoint, so a set never repeats an index
        assert all(len(set(row)) == S for row in picks[p].tolist())
        # every bucket has valid slots here, and only valid slots are drawn
        assert bool(mask[p][picks[p]].all())
    # each pair its own permutation
    assert not torch.equal(slot_idx[0], slot_idx[1])
    # a pair's draw depends on its own mask only
    mask2 = mask.clone()
    mask2[1] = True
    picks2 = sample_index_sets(torch.Generator().manual_seed(3), mask2, H, S)
    assert torch.equal(picks2[0], picks[0]) and torch.equal(picks2[2], picks[2])
    assert not torch.equal(picks2[1], picks[1])
    # one pair unbatched is the batch of one, and a batch draws what its
    # pairs' one-pair calls draw in turn from the same generator
    gen = torch.Generator().manual_seed(3)
    for p in range(P):
        assert torch.equal(sample_index_sets(gen, mask[p], H, S), picks[p])
    assert torch.equal(sample_index_sets(torch.Generator().manual_seed(3), mask[:1], H, S)[0],
                       picks[0])


def test_batched_sampler_follows_logits_within_bucket():
    # two slots per bucket, logits log(1) vs log(3) — in every pair, with
    # the heavy half at each pair's own end: the heavier slot is drawn with
    # probability 3/4 within its bucket
    n, S, H = 16, 8, 4000
    logits = torch.zeros(P, n)
    logits[0, n // 2:] = logits[1, :n // 2] = logits[2, n // 2:] = float(np.log(3.0))
    full = torch.ones(P, n, dtype=torch.bool)
    picks = sample_index_sets(torch.Generator().manual_seed(4), full, H, S, logits)
    _, slot_idx, bucket = _stratified_positions(torch.Generator().manual_seed(4), full,
                                                H, S, logits)
    checked = 0
    for p in range(P):
        heavy_rows = logits[p] > 0
        heavy = heavy_rows[slot_idx[p]].reshape(S, bucket)
        mixed = heavy.any(-1) & ~heavy.all(-1)              # buckets with one of each
        frac = heavy_rows[picks[p]].float().mean(0)[mixed]
        # 4000 draws per bucket: binomial sd ≈ 0.007, so ±0.04 is > 5 sd
        np.testing.assert_allclose(frac.numpy(), 0.75, atol=0.04)
        checked += int(mixed.sum())
    assert checked > 0


def test_batched_recover_pose_equals_per_e_calls():
    rng = np.random.RandomState(6)
    n, C = 64, 4
    Es, Rs, ts, p1s, p2s, ws = [], [], [], [], [], []
    for c in range(C):
        a = rng.uniform(-0.2, 0.2, 3)
        th = np.linalg.norm(a)
        k = a / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        t = rng.randn(3)
        t /= np.linalg.norm(t)
        X = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(3, 6, (n, 1))], 1)
        X2 = X @ R.T + t
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        Es.append(tx @ R)
        Rs.append(R)
        ts.append(t)
        p1s.append(X[:, :2] / X[:, 2:])
        p2s.append(X2[:, :2] / X2[:, 2:])
        # the last E has no valid row: every candidate scores 0, the first wins
        ws.append(np.full(n, c < C - 1))
    E, p1n, p2n, w = (_t(np.stack(x).astype(np.float32)) for x in (Es, p1s, p2s, ws))
    pose, X, cheir = recover_pose(E, p1n, p2n, w)
    assert pose.R.shape == (C, 3, 3) and X.shape == (C, n, 3) and cheir.shape == (C, n)
    for c in range(C):
        pc, Xc, ch = recover_pose(E[c], p1n[c], p2n[c], w[c])
        assert torch.equal(ch, cheir[c])
        torch.testing.assert_close(pc.R, pose.R[c], atol=1e-6, rtol=0)
        torch.testing.assert_close(pc.t, pose.t[c], atol=1e-6, rtol=0)
        torch.testing.assert_close(Xc, X[c], atol=1e-5, rtol=1e-6)
    assert bool(cheir[:C - 1].all()) and not bool(cheir[C - 1].any())
    # noise-free scenes: each E's winner is its true motion
    np.testing.assert_allclose(pose.R[:C - 1].numpy(), np.stack(Rs[:C - 1]), atol=1e-4)
    np.testing.assert_allclose(pose.t[:C - 1].numpy(), np.stack(ts[:C - 1]), atol=1e-4)


def _bench_module():
    path = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
    spec = importlib.util.spec_from_file_location("_pmt_bench_pairs", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


HEAD_P, HEAD_N, HEAD_H = 4, 128, 64


@pytest.fixture(scope="module")
def head_reference():
    """The bench head's ``per_pair`` (bench.py:380-390: match_descriptors_points
    → ransac_fundamental) rebuilt from the JAX package's functions, under
    ``jax.vmap`` over HEAD_P pairs of the bench's own workload, cut to
    HEAD_N keypoints and HEAD_H hypotheses."""
    bench = _bench_module()
    bench.NKP = HEAD_N            # this module's copy of the bench only
    d1, d2, p1, p2 = bench._make_workload(HEAD_P, seed=0)
    mcfg = JMatcherConfig(metric="l2", filter="ratio", ratio=bench.RATIO,
                          compute_dtype=bench.MATCH_DTYPE, compact=False)
    rcfg = JRansacConfig(num_hypotheses=HEAD_H)

    def per_pair(a, b, pa, pb, k):
        m = jnp.ones((HEAD_N,), bool)
        matches, q2 = jm.match_descriptors_points(
            JDescriptors(data=a, mask=m), JDescriptors(data=b, mask=m), pb, mcfg)
        est = jr.ransac_fundamental(k, pa, q2, matches.mask, rcfg)
        sets = jr.sample_minimal_points(k, matches.mask, HEAD_H, 8, (pa, q2))
        return matches, q2, est, sets

    keys = jax.random.split(jax.random.PRNGKey(0), HEAD_P)
    out = jax.jit(jax.vmap(per_pair))(d1, d2, p1, p2, keys)
    return (d1, d2, p1, p2), bench, out


def test_bench_head_step_matches_vmapped_per_pair(head_reference):
    (d1, d2, p1, p2), bench, (jmatches, jq2, jest, (sp1, sp2)) = head_reference
    ones = torch.ones(HEAD_P, HEAD_N, dtype=torch.bool)
    mcfg = MatcherConfig(metric="l2", filter="ratio", ratio=bench.RATIO,
                         compute_dtype=bench.MATCH_DTYPE, compact=False)
    m, q2 = tm.match_descriptors_points(Descriptors(_t(d1), ones), Descriptors(_t(d2), ones),
                                        _t(p2), mcfg)
    est = ransac_fundamental(None, _t(p1), q2, m.mask, RansacConfig(num_hypotheses=HEAD_H),
                             samples=(_t(sp1), _t(sp2)))
    np.testing.assert_array_equal(m.mask.numpy(), np.asarray(jmatches.mask))
    np.testing.assert_array_equal(m.train_idx.numpy(), np.asarray(jmatches.train_idx))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq2))
    Fj = np.asarray(jest.F)
    n_m = m.mask.sum(-1)
    for p in range(HEAD_P):
        assert abs(np.sum(Fj[p] * est.F[p].numpy())) >= 0.999
        assert abs(int(est.num_inliers[p]) - int(jest.num_inliers[p])) <= 2
        np.testing.assert_allclose(float(est.residual_mean[p]),
                                   float(jest.residual_mean[p]), rtol=0.05)
        # the bench's quality gate: inliers ≥ half the matches
        assert 2 * int(est.num_inliers[p]) >= int(n_m[p])
