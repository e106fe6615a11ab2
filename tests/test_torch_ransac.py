"""Parity of the PyTorch port's RANSAC path (kernels K3 and K2 as their plain
versions, geometry/ransac.py) with the JAX package, kernels in Pallas
interpret mode.  The minimal sets are injected: torch's RNG cannot
reproduce threefry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core.config import RansacConfig as JRansacConfig  # noqa: E402
from points_matching_tpu.data.synthetic import make_two_view_scene  # noqa: E402
from points_matching_tpu.geometry import ransac as jr  # noqa: E402
from points_matching_tpu.ops.pallas.eightpoint_kernel import (  # noqa: E402
    minimal_eight_point as j_eight,
)
from points_matching_tpu.ops.pallas.ransac_kernel import (  # noqa: E402
    ransac_score_hypotheses as j_score,
)
from points_matching_tpu_torch.core.config import RansacConfig  # noqa: E402
from points_matching_tpu_torch.geometry.ransac import (  # noqa: E402
    _stratified_positions,
    ransac_fundamental,
    sample_index_sets,
)
from points_matching_tpu_torch.ops.kernels.eightpoint_kernel import (  # noqa: E402
    minimal_eight_point,
    minimal_eight_point_plain,
)
from points_matching_tpu_torch.ops.kernels.ransac_kernel import (  # noqa: E402
    ransac_score_hypotheses,
)


def _t(x):
    return torch.from_numpy(np.array(x))


# jit the JAX references: eager dispatch is slower than one compile
_scene = jax.jit(make_two_view_scene, static_argnames=("num_points", "noise"))
j_ransac = jax.jit(jr.ransac_fundamental, static_argnames=("config",))
j_sample = jax.jit(jr.sample_minimal_points,
                   static_argnames=("num_hypotheses", "sample_size"))


def _samples(noise, h=256, seed=0):
    scene = _scene(jax.random.PRNGKey(3), num_points=64, noise=noise)
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.choice(64, 8, replace=False) for _ in range(h)])
    p1, p2 = np.asarray(scene.p1), np.asarray(scene.p2)
    return p1[idx], p2[idx], p1, p2


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_minimal_eight_point_plain_matches_jax_kernel(noise):
    sp1, sp2, p1, p2 = _samples(noise)
    Fj = np.asarray(j_eight(jnp.asarray(sp1), jnp.asarray(sp2), interpret=True))
    Ft = minimal_eight_point(_t(sp1), _t(sp2)).numpy()
    # third witness: the same chain in float64
    F64 = minimal_eight_point_plain(_t(sp1).double(), _t(sp2).double()).numpy()
    err = np.abs(Fj - Ft).max(axis=(1, 2))
    err_j = np.abs(Fj - F64).max(axis=(1, 2))
    err_t = np.abs(Ft - F64).max(axis=(1, 2))
    # Same chain, same constants; only f32 rounding differs (XLA may fuse
    # multiply-adds).  atol 1e-4 on every sample cannot hold, not even
    # noise-free: the shifted 9×9 solve has κ ≈ 1e6 and 4 inverse
    # iterations, so f32 rounding of AᵀA moves F by up to ~3e-3 on
    # near-collinear minimal samples, and the float64 run sits as far from
    # either f32 result (noise 0: JAX–port median 9.9e-5, max 3.6e-3;
    # float64–JAX median 7.6e-5, max 2.0e-3; float64–port median 9.7e-5,
    # max 2.9e-3).  Hence entries within 1e-4 for the typical sample
    # (median), within 1e-2 for 90% of them (the tolerance the JAX package
    # holds its own kernel to, tests/test_pallas_kernels.py) ...
    assert np.median(err) < 1e-4, np.median(err)
    assert np.mean(err < 1e-2) >= 0.9, err
    # ... and the port's f32 chain as close to float64 as the JAX kernel's,
    # at the median and the 90th percentile (measured ratios 0.93–1.27)
    for q in (50, 90):
        assert np.percentile(err_t, q) <= 1.5 * np.percentile(err_j, q), (q, err_t, err_j)
    # ... and as models the two are interchangeable: per-hypothesis inlier
    # counts on the scene agree (K2 plain, 1.5 px gate) up to near-gate
    # flips on the few ill-conditioned samples
    mask = torch.ones(1, 64, dtype=torch.bool)
    cj = ransac_score_hypotheses(_t(Fj)[None], _t(p1)[None], _t(p2)[None], mask, 1.5)
    ct = ransac_score_hypotheses(_t(Ft)[None], _t(p1)[None], _t(p2)[None], mask, 1.5)
    assert np.mean(np.abs((cj - ct).numpy()) <= 2) >= 0.95


def test_minimal_eight_point_plain_degenerate_is_finite():
    # all points identical, and all points on one line: finite garbage F
    # (scored ~0 inliers), never NaN — as the JAX kernel
    spd = np.full((2, 8, 2), 5.0, np.float32)
    spd[1, :, 0] = np.arange(8)
    assert torch.isfinite(minimal_eight_point(_t(spd), _t(spd))).all()


# the last `masked` rows invalid; then H = 1, N = 1 and every row masked
@pytest.mark.parametrize("h,n,masked", [(256, 128, 7), (50, 77, 7), (1, 64, 7),
                                        (16, 1, 0), (40, 64, 64)])
def test_ransac_score_plain_matches_jax_kernel(h, n, masked):
    rng = np.random.RandomState(5)
    F_h = rng.randn(h, 3, 3).astype(np.float32) * 1e-3
    p1 = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    p2 = (p1 + 2.0 * rng.randn(n, 2)).astype(np.float32)
    mask = np.arange(n) < n - masked
    cj = np.asarray(j_score(jnp.asarray(F_h), jnp.asarray(p1), jnp.asarray(p2),
                            jnp.asarray(mask), 1.5, interpret=True, exact=True))
    ct = ransac_score_hypotheses(_t(F_h)[None], _t(p1)[None], _t(p2)[None],
                                 _t(mask)[None], 1.5)[0].numpy()
    # the JAX 'exact' mode is a 3-pass bf16 split (drops lo·lo, ~2⁻³²
    # relative), the port plain fp32: a gate sitting within that of τ² may
    # flip — at most 2 per hypothesis
    assert np.abs(cj - ct).max() <= 2, np.abs(cj - ct).max()
    assert np.mean(cj == ct) >= 0.95
    if masked == n:
        assert not ct.any() and not cj.any()


def _outlier_scene():
    rng = np.random.RandomState(0)
    N = 128
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    X = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(4, 8, (N, 1))],
                       axis=1).astype(np.float32)
    p1 = (X / X[:, 2:3]) @ K.T
    X2 = X + np.array([0.3, 0.05, 0.0], np.float32)
    p2 = (X2 / X2[:, 2:3]) @ K.T
    p1, p2 = p1[:, :2].astype(np.float32), p2[:, :2].astype(np.float32)
    p2 = p2 + 0.3 * rng.randn(N, 2).astype(np.float32)
    p2[: N // 3] = rng.uniform(0, 640, (N // 3, 2))  # outliers
    mask = np.arange(N) < N - 5
    return p1, p2, mask


H_OUTLIER = 128


@pytest.fixture(scope="module")
def outlier_reference():
    """The reference's RANSAC on ``_outlier_scene`` and the minimal sets it
    drew, shared by both backends' cases."""
    p1, p2, mask = _outlier_scene()
    key = jax.random.PRNGKey(0)
    jp1, jp2, jmask = jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask)
    ref = j_ransac(key, jp1, jp2, jmask, JRansacConfig(num_hypotheses=H_OUTLIER, backend="xla"))
    sp1, sp2 = j_sample(key, jmask, H_OUTLIER, 8, (jp1, jp2))   # the sets ref used
    return (p1, p2, mask), ref, (sp1, sp2)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_ransac_fundamental_injected_samples_matches_jax(backend, outlier_reference):
    (p1, p2, mask), ref, (sp1, sp2) = outlier_reference
    H = H_OUTLIER
    out = ransac_fundamental(None, _t(p1), _t(p2), _t(mask),
                             RansacConfig(num_hypotheses=H, backend=backend),
                             samples=(_t(sp1), _t(sp2)))
    Fj, Ft = np.asarray(ref.F), out.F.numpy()
    # both unit-Frobenius: |⟨F_jax, F_torch⟩| = cos of the angle between them
    assert abs(np.sum(Fj * Ft)) >= 0.999
    assert abs(int(out.num_inliers) - int(ref.num_inliers)) <= 2
    assert int(out.num_inliers) >= 70   # the true consensus (~80 inliers)
    np.testing.assert_allclose(float(out.residual_mean), float(ref.residual_mean),
                               rtol=0.05)


def test_ransac_fundamental_seven_point_finds_consensus():
    # the 7pt solver reaches no kernel; its solve is held against JAX's
    # seven_point in test_torch_geometry.py
    p1, p2, mask = _outlier_scene()
    gen = torch.Generator().manual_seed(1)
    out = ransac_fundamental(gen, _t(p1), _t(p2), _t(mask),
                             RansacConfig(num_hypotheses=64, solver="7pt"))
    assert int(out.num_inliers) >= 70


def test_ransac_fundamental_own_sampler_finds_consensus():
    p1, p2, mask = _outlier_scene()
    gen = torch.Generator().manual_seed(0)
    out = ransac_fundamental(gen, _t(p1), _t(p2), _t(mask), RansacConfig(num_hypotheses=128))
    assert int(out.num_inliers) >= 70
    F = out.F.numpy()
    assert np.isclose(np.linalg.norm(F), 1.0, atol=1e-5)
    s = np.linalg.svd(F, compute_uv=False)
    assert s[2] / s[0] < 1e-4


def test_sampler_no_repeats_and_own_bucket():
    n, S, H = 61, 8, 300
    mask = torch.ones(n, dtype=torch.bool)
    mask[::7] = False
    gen = torch.Generator().manual_seed(3)
    j, slot_idx, bucket = _stratified_positions(gen, mask, H, S)
    assert bucket == -(-n // S)
    assert j.shape == (H, S) and int(j.min()) >= 0 and int(j.max()) < bucket
    picks = slot_idx[torch.arange(S)[None] * bucket + j]
    # own bucket: pick s is one of the slots of bucket s of the permutation
    for s in range(S):
        members = set(slot_idx[s * bucket:(s + 1) * bucket].tolist())
        assert set(picks[:, s].tolist()) <= members
    # buckets are disjoint, so a set never repeats an index
    for row in picks.tolist():
        assert len(set(row)) == S
    # every bucket here has valid slots, and only valid slots are drawn
    assert bool(mask[picks].all())
    # the public sampler draws the same way
    picks2 = sample_index_sets(torch.Generator().manual_seed(3), mask, H, S)
    np.testing.assert_array_equal(picks2.numpy(), picks.numpy())


def test_sampler_follows_logits_within_bucket():
    # two slots per bucket, logits log(1) vs log(3): the heavier slot is
    # drawn with probability 3/4 within its bucket
    n, S, H = 16, 8, 4000
    logits = torch.zeros(n)
    logits[n // 2:] = float(np.log(3.0))
    gen = torch.Generator().manual_seed(4)
    picks = sample_index_sets(gen, torch.ones(n, dtype=torch.bool), H, S, logits)
    j, slot_idx, bucket = _stratified_positions(torch.Generator().manual_seed(4),
                                                torch.ones(n, dtype=torch.bool), H, S,
                                                logits)
    heavy = (slot_idx >= n // 2).reshape(S, bucket)
    mixed = heavy.any(-1) & ~heavy.all(-1)              # buckets with one of each
    frac = (picks >= n // 2).float().mean(0)[mixed]
    if mixed.any():
        # 4000 draws per bucket: binomial sd ≈ 0.007, so ±0.04 is > 5 sd
        np.testing.assert_allclose(frac.numpy(), 0.75, atol=0.04)
