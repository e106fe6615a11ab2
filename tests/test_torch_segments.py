"""The segment axis of the port's incremental SfM (``pipelines/sfm.py``,
``pipelines/distributed_slam.build_submap``): a batch of S segments computes,
bit for bit, what each segment computes alone, the meaning of the JAX
package's ``jax.vmap`` over segments.  On the CPU, on one thread (as the
world-size tests of tests/test_torch_distributed_slam.py run), at S = 3,
T = 8, N = 64 features of 32-d.  No JAX here: the reference is the port's
own one-segment call."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from points_matching_tpu_torch.ba.sparse import (  # noqa: E402
    SparseBAState, bundle_adjust_sparse, make_sparse_ba_state)
from points_matching_tpu_torch.core.config import (  # noqa: E402
    BAConfig, MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig)
from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose  # noqa: E402
from points_matching_tpu_torch.data.synthetic import (  # noqa: E402
    make_sparse_ba_problem, make_stacked_sequence)
from points_matching_tpu_torch.geometry.pnp import ransac_pnp  # noqa: E402
from points_matching_tpu_torch.geometry.ransac import sample_index_sets  # noqa: E402
from points_matching_tpu_torch.geometry.triangulate import triangulate_dlt  # noqa: E402
from points_matching_tpu_torch.pipelines import distributed_slam as tds  # noqa: E402
from torch_dist_worker import one_thread  # noqa: E402

S, T, N = 3, 8, 64


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _gens(seed: int = 0):
    return [torch.Generator().manual_seed(tds.segment_seed(seed, s)) for s in range(S)]


def _config() -> SfMConfig:
    """tests/test_distributed_slam.py's small config, cut to 64 features:
    64 hypotheses, 12 inliers make a keyframe."""
    return SfMConfig(
        two_view=TwoViewConfig(matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
                               ransac=RansacConfig(num_hypotheses=64, inlier_threshold=2.0)),
        ba=BAConfig(max_iterations=6), max_cameras=T, max_landmarks=256,
        max_observations=1024, local_ba_window=T, pnp_hypotheses=64, keyframe_min_inliers=12)


def _assert_state_row(one, batch, s: int) -> None:
    """Every field of a one-segment state equals row s of the batch's."""
    for f in dataclasses.fields(one):
        a, b = getattr(one, f.name), getattr(batch, f.name)
        if f.name == "poses":
            assert torch.equal(a.R, b.R[s]) and torch.equal(a.t, b.t[s]), (s, f.name)
        else:
            assert torch.equal(a, b[s]), (s, f.name)


def test_batched_build_equals_each_segment_alone():
    """``build_submaps`` (all S segments as one batch, segment s drawing
    from its own generator) against ``build_submap`` on each segment alone:
    the same registrations, poses, landmarks, observation lists and counts
    to the bit."""
    kps, desc, mask, K, _ = make_stacked_sequence(num_frames=20, num_landmarks=90, n_feat=N,
                                                  device="cpu")
    sk, sd, sm, _ = tds.segment_frames(kps, desc, mask, T, 4)
    sk, sd, sm = sk[:S], sd[:S], sm[:S]
    cfg = _config()
    states, regs = tds.build_submaps(sk, sd, sm, K, 0, cfg)
    assert regs.shape == (S, T) and regs.all()
    for s, gen in enumerate(_gens()):
        one, reg = tds.build_submap(sk[s], sd[s], sm[s], K, gen, cfg)
        assert torch.equal(reg, regs[s])
        _assert_state_row(one, states, s)
        assert int(one.num_obs) > 0 and int(one.num_lms) > 0


def _pnp_problem(g):
    """S problems of 96 correspondences each: points in front of a camera
    near the origin, a third of the rows outliers, a few rows masked."""
    X = torch.rand(S, 96, 3, generator=g) * torch.tensor([4.0, 3.0, 4.0]) + torch.tensor(
        [-2.0, -1.5, 5.0])
    w = 0.05 * torch.randn(S, 3, generator=g)
    from points_matching_tpu_torch.geometry.se3 import se3_exp
    R, t = se3_exp(torch.cat([0.2 * torch.randn(S, 3, generator=g), w], -1))
    Xc = (R[:, None] * X[..., None, :]).sum(-1) + t[:, None]
    uv = Xc[..., :2] / Xc[..., 2:3] + 0.002 * torch.randn(S, 96, 2, generator=g)
    out = torch.rand(S, 96, generator=g) < 0.33
    uv = torch.where(out[..., None], torch.rand(S, 96, 2, generator=g) - 0.5, uv)
    mask = torch.rand(S, 96, generator=g) > 0.05
    logits = torch.where(torch.arange(96) < 48, 2.0, 0.0).expand(S, 96)
    prior = Pose(R=R, t=t + 0.01)
    return X, uv, mask, logits, prior


def test_batched_ransac_pnp_and_triangulation_equal_per_segment_calls():
    X, uv, mask, logits, prior = _pnp_problem(torch.Generator().manual_seed(1))
    kw = dict(num_hypotheses=64, inlier_threshold=0.01, sample_logits=logits, prior_pose=prior)
    got = ransac_pnp(_gens(), X, uv, mask, **kw)
    assert got.num_inliers.shape == (S,)
    for s, gen in enumerate(_gens()):
        one = ransac_pnp(gen, X[s], uv[s], mask[s], num_hypotheses=64, inlier_threshold=0.01,
                         sample_logits=logits[s], prior_pose=prior[s])
        assert torch.equal(one.pose.R, got.pose.R[s]) and torch.equal(one.pose.t, got.pose.t[s])
        assert torch.equal(one.inlier_mask, got.inlier_mask[s])
        assert torch.equal(one.num_inliers, got.num_inliers[s])
        assert int(one.num_inliers) > 40
    # two views of the same points: segment s's prior pose and its PnP pose
    P1, P2 = prior.matrix34(), got.pose.matrix34()
    Xt, ok = triangulate_dlt(P1, P2, uv, uv + 0.01)
    for s in range(S):
        Xo, oko = triangulate_dlt(P1[s], P2[s], uv[s], uv[s] + 0.01)
        assert torch.equal(Xo, Xt[s]) and torch.equal(oko, ok[s])


def _ba_batch(noise):
    """S sparse BA problems (tests/test_torch_ba.py's generator, one seed
    each), their landmarks moved by ``noise[s]``, stacked on a segment
    axis; and the S one-problem states."""
    g = torch.Generator().manual_seed(0)
    ones = []
    for s in range(S):
        p = make_sparse_ba_problem(seed=s, num_cameras=8, num_landmarks=64,
                                   obs_per_landmark=4, device="cpu")
        X = p["X"] + noise[s] * torch.randn(p["X"].shape, generator=g)
        ones.append(make_sparse_ba_state(p["poses"], X, p["cam_idx"], p["lm_idx"], p["uv"],
                                         p["obs_mask"], num_fixed_cameras=2))
    K = CameraIntrinsics.from_matrix(p["K"])
    stacked = SparseBAState(
        poses=Pose(R=torch.stack([o.poses.R for o in ones]),
                   t=torch.stack([o.poses.t for o in ones])),
        **{k: torch.stack([getattr(o, k) for o in ones])
           for k in ("X", "cam_idx", "lm_idx", "uv", "obs_mask", "cam_fixed", "lm_fixed")})
    return stacked, ones, K


def test_batched_lm_segments_stop_at_their_own_iteration():
    """Problems that converge after different numbers of LM iterations:
    each keeps its state, damping and cost once it has stopped, and
    equals its own one-problem run, iteration count included."""
    cfg = BAConfig(max_iterations=12, pcg_iterations=16, huber_delta=3.0, rtol=1e-2)
    batch, ones, K = _ba_batch([0.002, 0.05, 0.3])
    out, st = bundle_adjust_sparse(batch, K, cfg)
    assert st.iterations.tolist() == [8, 5, 12]          # the last one is cut at the most
    for s, one in enumerate(ones):
        o, so = bundle_adjust_sparse(one, K, cfg)
        assert torch.equal(o.poses.R, out.poses.R[s]) and torch.equal(o.poses.t, out.poses.t[s])
        assert torch.equal(o.X, out.X[s])
        for f in ("iterations", "initial_cost", "final_cost", "lam"):
            assert torch.equal(getattr(so, f), getattr(st, f)[s]), f


def test_inactive_segment_is_left_untouched():
    cfg = BAConfig(max_iterations=6, pcg_iterations=16, huber_delta=3.0, rtol=1e-4)
    batch, ones, K = _ba_batch([0.05, 0.05, 0.05])
    active = torch.tensor([True, False, True])
    out, st = bundle_adjust_sparse(batch, K, cfg, active=active)
    assert torch.equal(out.poses.R[1], batch.poses.R[1])
    assert torch.equal(out.poses.t[1], batch.poses.t[1]) and torch.equal(out.X[1], batch.X[1])
    assert int(st.iterations[1]) == 0 and torch.equal(st.final_cost[1], st.initial_cost[1])
    assert torch.equal(st.lam[1], torch.tensor(cfg.damping_init))
    for s in (0, 2):
        o, so = bundle_adjust_sparse(ones[s], K, cfg)
        assert torch.equal(o.X, out.X[s]) and torch.equal(so.iterations, st.iterations[s])
        assert float(so.final_cost) < float(so.initial_cost)


def test_sampler_with_one_generator_a_segment():
    """[S, C, N] masks with S generators: entry (s, c) draws, in row-major
    order, from generator s — what S calls on [C, N] draw; a count of
    generators that is not the first axis' raises."""
    g = torch.Generator().manual_seed(3)
    mask = torch.rand(S, 4, 50, generator=g) > 0.2
    logits = torch.randn(S, 4, 50, generator=g)
    got = sample_index_sets(_gens(7), mask, 16, 8, logits)
    assert got.shape == (S, 4, 16, 8)
    for s, gen in enumerate(_gens(7)):
        assert torch.equal(sample_index_sets(gen, mask[s], 16, 8, logits[s]), got[s])
    with pytest.raises(ValueError, match="generators"):
        sample_index_sets(_gens()[:2], mask, 16, 8)


def test_on_axis_sequence_keeps_the_corridor_in_view():
    """``make_stacked_sequence(on_axis=True)`` (config 4 at KITTI 00's
    length): the camera's centre stays at (0.3 i, 0, 0) and every frame of
    a long corridor sees its ``n_feat`` landmarks; on the reference's path,
    whose centre swings off the axis by 0.3 i·sin(yaw), frames 650 on lose
    them."""
    kw = dict(num_frames=700, num_landmarks=7000, n_feat=64, seed=5, corridor=True)
    _, _, mask, _, gt = make_stacked_sequence(device="cpu", on_axis=True, **kw)
    axis = torch.zeros(700, 3, dtype=torch.float64)
    axis[:, 0] = 0.3 * torch.arange(700)
    torch.testing.assert_close(torch.from_numpy(gt).double(), axis, atol=1e-3, rtol=0)
    assert bool((mask.sum(-1) == 64).all())
    _, _, drifted, _, _ = make_stacked_sequence(device="cpu", **kw)
    assert int(drifted[640:].sum(-1).min()) < 64
