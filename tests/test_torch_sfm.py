"""Parity of the port's incremental SfM (``pipelines/sfm.py``) with the JAX
package: the bootstrap and one registration step from the same state with
the reference's own minimal sets injected, the whole slice on
tests/test_sfm.py's 10-frame 32-d sequence, and image → trajectory through
the port's frontend on the CPU."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core.types import Descriptors as JDescriptors  # noqa: E402
from points_matching_tpu.geometry.ransac import sample_index_sets  # noqa: E402
from points_matching_tpu.ops.matching import match_descriptors as j_match  # noqa: E402
from points_matching_tpu.pipelines import sfm as jsfm  # noqa: E402
from points_matching_tpu.utils.evaluation import absolute_trajectory_error as j_ate  # noqa: E402
from points_matching_tpu_torch.core.config import SfMConfig, TwoViewConfig  # noqa: E402
from points_matching_tpu_torch.core.convert import (  # noqa: E402
    config_from_dict,
    intrinsics_from_numpy,
    sfm_state_from_numpy,
)
from points_matching_tpu_torch.data.synthetic import make_tracked_sequence  # noqa: E402
from points_matching_tpu_torch.pipelines import sfm as tsfm  # noqa: E402
from points_matching_tpu_torch.utils.evaluation import absolute_trajectory_error  # noqa: E402
from test_sfm import _make_sequence, _sfm_config  # noqa: E402

ATE_BOUND = 0.05          # tests/test_sfm.py's bound: 1.5 % of a ~3.2-unit sweep
_index_sets = jax.jit(sample_index_sets, static_argnums=(2, 3))
_match = jax.jit(j_match, static_argnums=2)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def seq():
    frames, K, gt, _ = _make_sequence(num_frames=10)
    jcfg = _sfm_config()
    tcfg = config_from_dict(dataclasses.asdict(jcfg), SfMConfig)
    tframes = [tuple(_t(a) for a in f) for f in frames]
    return frames, K, np.asarray(gt), jcfg, tframes, intrinsics_from_numpy(K, device="cpu"), tcfg


@pytest.fixture(scope="module")
def bootstrapped(seq):
    """The reference's bootstrap (its first key split, as run_incremental_sfm
    does) and the port's, fed the same four candidates' minimal sets."""
    frames, K, _, jcfg, tframes, tK, tcfg = seq
    _, k0 = jax.random.split(jax.random.PRNGKey(0))
    jstate, jst = jsfm.bootstrap_two_view(jsfm.init_sfm_state(jcfg, 256, 32),
                                          *frames[0], *frames[1], K, k0, jcfg)
    m = _match(JDescriptors(data=frames[0][1], mask=frames[0][2]),
                JDescriptors(data=frames[1][1], mask=frames[1][2]), jcfg.two_view.matcher)
    H = jcfg.two_view.ransac.num_hypotheses
    idx = np.stack([np.asarray(_index_sets(k, m.mask, H, 8)) for k in
                    jax.random.split(k0, jcfg.bootstrap_candidates)])
    tstate, tst = tsfm.bootstrap_two_view(tsfm.init_sfm_state(tcfg, 256, 32, device="cpu"),
                                          *tframes[0], *tframes[1], tK, None, tcfg,
                                          f_samples=_t(idx))
    return jstate, jst, tstate, tst


def _bench_sequence(num_frames):
    """bench.py's ``_make_sfm_sequence`` (the JAX bench's ``sfm`` section)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
    spec = importlib.util.spec_from_file_location("_pmt_bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    frames, fx, (w, h) = bench._make_sfm_sequence(num_frames)
    return [f[:3] for f in frames], (fx, fx, w / 2, h / 2), None


@pytest.mark.parametrize("source", ["test_sfm", "bench"])
def test_make_tracked_sequence_matches_reference(seq, source):
    """The port's generator gives the reference generators' sequences: the
    same numpy draws, so descriptors and masks are equal; the rotations come
    from two so3_exp implementations in f32, so pixels agree to 1e-3 and
    centres to 1e-5."""
    if source == "test_sfm":
        frames, K, gt = seq[0], seq[1], seq[2]
        k = (K.fx, K.fy, K.cx, K.cy)
        tframes, tK, tgt = make_tracked_sequence(10, device="cpu")
    else:
        frames, k, gt = _bench_sequence(6)
        tframes, tK, tgt = make_tracked_sequence(6, device="cpu", num_landmarks=600,
                                                 x_range=(-6.0, 10.0), yaw_step=0.01,
                                                 t_step=0.12)
    assert [float(v) for v in (tK.fx, tK.fy, tK.cx, tK.cy)] == [float(v) for v in k]
    assert len(tframes) == len(frames)
    for (xy, d, m), (txy, td, tm) in zip(frames, tframes):
        assert np.array_equal(tm.numpy(), np.asarray(m)) and int(tm.sum()) > 100
        np.testing.assert_array_equal(td.numpy(), np.asarray(d))
        np.testing.assert_allclose(txy.numpy(), np.asarray(xy), rtol=0, atol=1e-3)
    if gt is not None:
        np.testing.assert_allclose(tgt.numpy(), np.asarray(gt), rtol=0, atol=1e-5)


def test_bootstrap_two_view_with_injected_samples(bootstrapped):
    jstate, jst, tstate, tst = bootstrapped
    assert int(tst.num_pnp_inliers) == int(jst.num_pnp_inliers)
    assert int(tst.num_new_landmarks) == int(jst.num_new_landmarks) > 100
    assert bool(tst.registered) == bool(jst.registered)
    # unit-baseline pose from E: 1e-4 absolute
    np.testing.assert_allclose(tst.pose.R.numpy(), np.asarray(jst.pose.R), atol=1e-4)
    np.testing.assert_allclose(tst.pose.t.numpy(), np.asarray(jst.pose.t), atol=1e-4)
    n = int(jstate.num_lms)
    assert int(tstate.num_lms) == n and int(tstate.num_obs) == int(jstate.num_obs)
    for k in ("lm_mask", "obs_cam", "obs_lm", "obs_mask", "prev_lm"):
        assert np.array_equal(getattr(tstate, k).numpy(), np.asarray(getattr(jstate, k))), k
    # triangulated landmarks (depths ~6–14 at a unit baseline): 1e-3 relative
    np.testing.assert_allclose(tstate.X[:n].numpy(), np.asarray(jstate.X)[:n],
                               rtol=1e-3, atol=1e-3)


def test_register_frame_from_the_same_state(seq, bootstrapped):
    frames, K, _, jcfg, tframes, tK, tcfg = seq
    jstate = bootstrapped[0]
    tstate = sfm_state_from_numpy(jstate, device="cpu")
    key = jax.random.PRNGKey(11)
    jnew, jst = jax.jit(jsfm.register_frame, static_argnames="config")(
        jstate, *frames[2], K, key, config=jcfg)
    # the reference draws its PnP sets from the correspondence mask with its
    # first subkey; the port's association gives the same mask
    a = tsfm.associate(tstate, tframes[2][1], tframes[2][2], tcfg)
    k_pnp, _ = jax.random.split(key)
    idx = np.asarray(_index_sets(k_pnp, jnp.asarray(a.corr_m.numpy()),
                                       jcfg.pnp_hypotheses, 6, jnp.asarray(a.logits.numpy())))
    tnew, tst = tsfm.register_frame(tstate, *tframes[2], tK, None, tcfg, pnp_samples=_t(idx))
    assert bool(tst.registered) and bool(jst.registered)
    assert int(tst.num_pnp_inliers) == int(jst.num_pnp_inliers)
    assert int(tst.num_new_landmarks) == int(jst.num_new_landmarks)
    # GN-refined pose in world units of the bootstrap baseline: 1e-4 absolute
    np.testing.assert_allclose(tst.pose.R.numpy(), np.asarray(jst.pose.R), atol=1e-4)
    np.testing.assert_allclose(tst.pose.t.numpy(), np.asarray(jst.pose.t), atol=1e-4)
    for k in ("num_cams", "num_lms", "num_obs"):
        assert int(getattr(tnew, k)) == int(getattr(jnew, k)), k
    for k in ("cam_mask", "lm_mask", "obs_cam", "obs_lm", "obs_mask", "prev_lm"):
        assert np.array_equal(getattr(tnew, k).numpy(), np.asarray(getattr(jnew, k))), k


def test_incremental_sfm_both_packages(seq):
    frames, K, gt, jcfg, tframes, tK, tcfg = seq
    jres = jsfm.run_incremental_sfm(frames, K, jcfg, ba_every=4)
    tres = tsfm.run_incremental_sfm(tframes, tK, tcfg, ba_every=4)
    assert all(jres.registered) and all(tres.registered)
    j = float(j_ate(jnp.asarray(np.asarray(jres.trajectory)[:10]), jnp.asarray(gt)).rmse)
    t = float(absolute_trajectory_error(tres.trajectory[:10], _t(gt)).rmse)
    assert j < ATE_BOUND and t < ATE_BOUND, (j, t)
    # map size within 10 % of the reference's (other random draws)
    assert abs(int(tres.state.num_lms) - int(jres.state.num_lms)) <= \
        0.1 * int(jres.state.num_lms)


def test_image_to_trajectory_on_the_cpu():
    from points_matching_tpu_torch.core.config import (
        DescriptorConfig, DetectorConfig, MatcherConfig, RansacConfig)
    from points_matching_tpu_torch.core.types import CameraIntrinsics
    from points_matching_tpu_torch.data.render import render_sequence
    from points_matching_tpu_torch.ops.descriptors import extract_descriptors
    from points_matching_tpu_torch.ops.detect import detect_keypoints

    n = 8
    imgs, gt, _, (fx, fy, cx, cy) = render_sequence(
        num_frames=n, num_landmarks=400, image_size=(256, 192), seed=0, loop=True)
    dcfg = DetectorConfig(kind="hessian", threshold=100.0, max_keypoints=256)
    frames = []
    for im in imgs:
        g = torch.from_numpy(np.ascontiguousarray(im))
        kp = detect_keypoints(g, dcfg)
        d = extract_descriptors(g, kp, DescriptorConfig(kind="surf"))
        frames.append((kp.xy, d.data, kp.mask & d.mask))
    K = CameraIntrinsics(*(torch.tensor(v, dtype=torch.float32) for v in (fx, fy, cx, cy)))
    cfg = SfMConfig(two_view=TwoViewConfig(
        matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
        ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0)),
        max_cameras=16, max_landmarks=2048, max_observations=8192)
    res = tsfm.run_incremental_sfm(frames, K, cfg, seed=0)
    assert all(res.registered), res.registered
    extent = float(np.ptp(gt, axis=0).max())
    ate = float(absolute_trajectory_error(res.trajectory[:n], _t(gt.astype(np.float32))).rmse)
    assert ate < 0.10 * extent, (ate, extent)


def test_camera_centers_are_minus_r_transpose_t():
    # The reference's camera_centers contracts "cij,ci->cj" over Rᵀ, which
    # gives −R·t, not the −Rᵀ·t its docstring names (the two agree only for
    # small rotations, as in its test sequences).  The port returns −Rᵀ·t.
    from points_matching_tpu_torch.core.types import Pose
    from points_matching_tpu_torch.geometry.se3 import so3_exp

    R = so3_exp(torch.tensor([[0.0, 0.5, 0.0], [0.3, -0.2, 0.1]]))
    t = torch.tensor([[1.0, 0.0, 0.0], [0.5, 2.0, -1.0]])
    c = tsfm.camera_centers(Pose(R=R, t=t), torch.tensor([True, False]))
    torch.testing.assert_close(c[0], -(R[0].T @ t[0]), rtol=0, atol=1e-7)
    assert not c[1].any()
    # the centre maps to the camera origin
    torch.testing.assert_close(R[0] @ c[0] + t[0], torch.zeros(3), rtol=0, atol=1e-6)
