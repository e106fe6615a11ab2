"""Parity of the port's loop closure (``pipelines/loop_closure.py``) and
all-pairs scores (``parallel/all_pairs.py``) with the JAX package, on
tests/test_loop_closure.py's revisit sequence: the same candidates, the
same verification with the reference's own RANSAC draws injected, and the
same corrected trajectory; plus the reference test's own bounds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core.config import (  # noqa: E402
    MatcherConfig as JMatcherConfig,
    RansacConfig as JRansacConfig,
    SfMConfig as JSfMConfig,
    TwoViewConfig as JTwoViewConfig,
)
from points_matching_tpu.core.types import CameraIntrinsics as JK  # noqa: E402
from points_matching_tpu.core.types import Descriptors as JDescriptors  # noqa: E402
from points_matching_tpu.core.types import Pose as JPose  # noqa: E402
from points_matching_tpu.geometry.ransac import sample_index_sets  # noqa: E402
from points_matching_tpu.geometry.se3 import se3_exp as j_se3_exp  # noqa: E402
from points_matching_tpu.ops.matching import match_descriptors as j_match  # noqa: E402
from points_matching_tpu.parallel.all_pairs import all_pairs_scores as j_all_pairs  # noqa: E402
from points_matching_tpu.pipelines import loop_closure as jlc  # noqa: E402
from points_matching_tpu_torch.core.config import SfMConfig  # noqa: E402
from points_matching_tpu_torch.core.convert import (  # noqa: E402
    config_from_dict,
    frames_from_numpy,
    intrinsics_from_numpy,
    loop_candidates_from_list,
    pose_from_numpy,
)
from points_matching_tpu_torch.parallel.all_pairs import all_pairs_scores  # noqa: E402
from points_matching_tpu_torch.pipelines import loop_closure as tlc  # noqa: E402

_index_sets = jax.jit(sample_index_sets, static_argnums=(2, 3))
_match = jax.jit(j_match, static_argnums=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _revisit_sequence(num_frames=12, num_landmarks=400, n_feat=256, seed=0):
    """tests/test_loop_closure.py's ``_revisit_sequence``, copied: the camera
    pans right then returns to the start — frame N-1 revisits frame 0's
    view.  Numpy frames, intrinsics (fx, fy, cx, cy), poses (R, t) and the
    offsets."""
    rng = np.random.RandomState(seed)
    w, h, fx = 640, 480, 500.0
    X = rng.uniform([-14, -3, 6], [14, 3, 14], (num_landmarks, 3)).astype(np.float32)
    desc_gt = rng.randn(num_landmarks, 32).astype(np.float32)
    desc_gt /= np.linalg.norm(desc_gt, axis=-1, keepdims=True)

    # out-and-back translation: 0 … peak … back to 0
    half = num_frames // 2
    offsets = list(range(half)) + list(range(half - 2, -2, -1))[: num_frames - half]
    Rs, ts, frames = [], [], []
    for i in range(num_frames):
        o = offsets[i]
        R = np.eye(3, dtype=np.float32)
        t = np.asarray([-1.2 * o, 0.0, 0.0], np.float32)
        Rs.append(R), ts.append(t)
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * fx + np.asarray([w / 2, h / 2])
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
              (uv[:, 1] >= 0) & (uv[:, 1] < h)
        idx = np.nonzero(vis)[0]
        rng.shuffle(idx)
        idx = idx[:n_feat]
        k = len(idx)
        xy = np.zeros((n_feat, 2), np.float32)
        dd = np.zeros((n_feat, 32), np.float32)
        mm = np.zeros((n_feat,), bool)
        xy[:k] = uv[idx] + 0.3 * rng.randn(k, 2)
        d = desc_gt[idx] + 0.05 * rng.randn(k, 32).astype(np.float32)
        dd[:k] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        mm[:k] = True
        frames.append((xy, dd, mm))
    return frames, (fx, fx, w / 2, h / 2), (np.stack(Rs), np.stack(ts)), offsets


def _sfm_config():
    """tests/test_sfm.py's ``_sfm_config``, copied."""
    return JSfMConfig(
        two_view=JTwoViewConfig(
            matcher=JMatcherConfig(metric="l2", filter="ratio", ratio=0.8),
            ransac=JRansacConfig(num_hypotheses=256, inlier_threshold=2.0),
        ),
        max_cameras=16, max_landmarks=1024, max_observations=8192, pnp_min_inliers=12)


def _reference_samples(jframes, pairs, keys, jcfg):
    """The minimal sets the reference's RANSAC draws for each (i, j) pair
    with its key: its match of frame j to frame i, its index sets, gathered."""
    out = []
    for (i, j), key in zip(pairs, keys):
        (xi, di, mi), (xj, dj, mj) = jframes[i], jframes[j]
        m = _match(JDescriptors(data=dj, mask=mj), JDescriptors(data=di, mask=mi),
                   jcfg.two_view.matcher)
        n = xj.shape[0]
        pj = np.asarray(xj)[np.clip(np.asarray(m.query_idx), 0, n - 1)]
        pi = np.asarray(xi)[np.clip(np.asarray(m.train_idx), 0, n - 1)]
        idx = np.asarray(_index_sets(key, m.mask, jcfg.two_view.ransac.num_hypotheses, 8))
        out.append((_t(pj[idx]), _t(pi[idx])))
    return out


@pytest.fixture(scope="module")
def seq():
    frames, k, (R, t), offsets = _revisit_sequence()
    jframes = [tuple(jnp.asarray(a) for a in f) for f in frames]
    jK = JK(*(jnp.float32(v) for v in k))
    jcfg = _sfm_config()
    tcfg = config_from_dict(dataclasses.asdict(jcfg), SfMConfig)
    return dict(frames=frames, jframes=jframes, tframes=frames_from_numpy(frames, device="cpu"),
                jK=jK, tK=intrinsics_from_numpy(jK, device="cpu"), R=R, t=t, offsets=offsets,
                jcfg=jcfg, tcfg=tcfg)


def test_detect_loop_candidates_match_reference(seq):
    jdesc = jnp.stack([f[1] for f in seq["jframes"]])
    jmask = jnp.stack([f[2] for f in seq["jframes"]])
    jc = jlc.detect_loop_candidates(jdesc, jmask, min_gap=5, min_score=30)
    tc = tlc.detect_loop_candidates(torch.stack([f[1] for f in seq["tframes"]]),
                                    torch.stack([f[2] for f in seq["tframes"]]),
                                    min_gap=5, min_score=30)
    assert jc, "no loop candidates found"
    assert tc == loop_candidates_from_list(jc)
    # the reference test's bound: the strongest loop connects two frames at
    # (nearly) the same pose
    off = seq["offsets"]
    assert abs(off[tc[0].i] - off[tc[0].j]) <= 1, (tc[0].i, tc[0].j)


def test_verify_loop_with_the_reference_samples(seq, closed):
    jf, tf = seq["jframes"], seq["tframes"]
    key = jax.random.PRNGKey(0)
    # the reference's batched verification (the vmap close_loops ran, so
    # its compile is reused) with frames 11 and 1 in every slot
    n = len(closed[2])
    ok_b, rel_b, ninl_b = jlc._verify_loops_batched(
        *(jnp.stack([a] * n) for a in (*jf[11], *jf[1])), seq["jK"],
        jnp.stack([key] * n), seq["jcfg"], 30)
    ok_j, R_j, ninl_j = ok_b[0], rel_b.R[0], ninl_b[0]
    samples = _reference_samples(jf, [(11, 1)], [key], seq["jcfg"])[0]
    ok, rel, ninl = tlc.verify_loop(*tf[11], *tf[1], seq["tK"], seq["tcfg"], None,
                                    samples=samples)
    assert ok == bool(ok_j) and ninl == int(ninl_j)
    # the rotation from E of the same inlier set: 1e-4
    np.testing.assert_allclose(rel.R.numpy(), np.asarray(R_j), atol=1e-4)
    # the reference test's bounds: verified, > 50 inliers, frames 11 and 1
    # share (nearly) the same camera pose
    assert ok and ninl > 50
    ang = np.degrees(np.arccos(np.clip((np.trace(rel.R.numpy()) - 1) / 2, -1, 1)))
    assert ang < 5.0, f"relative rotation {ang} deg"


@pytest.fixture(scope="module")
def closed(seq):
    """Both packages' close_loops from the same drifted trajectory (the
    reference test's drift), the port fed the reference's RANSAC draws."""
    C = len(seq["frames"])
    drift = jnp.cumsum(0.02 * jax.random.normal(jax.random.PRNGKey(3), (C, 6)), axis=0)
    Rd, td = j_se3_exp(drift.at[0].set(0.0))
    R0, t0 = jnp.asarray(seq["R"]), jnp.asarray(seq["t"])
    drifted = JPose(R=Rd @ R0, t=jnp.einsum("cij,cj->ci", Rd, t0) + td)
    jcorr, jc = jlc.close_loops(drifted, C, seq["jframes"], seq["jK"], seq["jcfg"],
                                min_gap=5, min_score=30)
    keys = jax.random.split(jax.random.PRNGKey(0), len(jc))
    samples = _reference_samples(seq["jframes"], [(c.i, c.j) for c in jc], keys, seq["jcfg"])
    tcorr, tc = tlc.close_loops(pose_from_numpy(drifted, device="cpu"), C, seq["tframes"],
                                seq["tK"], seq["tcfg"], min_gap=5, min_score=30,
                                f_samples=samples)
    return drifted, jcorr, jc, tcorr, tc


def test_close_loops_with_the_reference_samples(seq, closed):
    drifted, jcorr, jc, tcorr, tc = closed
    # the same candidates, flags and inlier counts
    assert tc == loop_candidates_from_list(jc)
    assert any(c.verified for c in tc)
    # the pose graph from the same edges: corrected poses to 1e-3
    np.testing.assert_allclose(tcorr.R.numpy(), np.asarray(jcorr.R), atol=1e-3)
    np.testing.assert_allclose(tcorr.t.numpy(), np.asarray(jcorr.t), atol=1e-3)
    # the reference test's bound: closing the loop reduces the drift
    err = lambda p: float(np.linalg.norm(np.asarray(p) - seq["t"], axis=-1).mean())  # noqa: E731
    assert err(tcorr.t) < err(drifted.t), (err(tcorr.t), err(drifted.t))


def test_all_pairs_scores_match_reference():
    """12 frames × 64 rows × 32-d with some rows masked, near-duplicate
    frames planted: the counts equal the reference's at mesh=None; a count
    that differs must be an f32 near-tie of the ratio test."""
    rng = np.random.RandomState(4)
    n, k, d = 12, 64, 32
    desc = rng.randn(n, k, d).astype(np.float32)
    desc[6] = desc[2] + 0.05 * rng.randn(k, d)          # near-duplicate frames
    desc[9, :40] = desc[3, :40] + 0.1 * rng.randn(40, d)
    desc[5, 10] = desc[5, 11]                           # a duplicated train row
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = rng.rand(n, k) > 0.15
    ref = np.asarray(j_all_pairs(jnp.asarray(desc), jnp.asarray(mask), ratio=0.8))
    got = all_pairs_scores(_t(desc), _t(mask), ratio=0.8).numpy()
    assert got.dtype == np.int32 and got.shape == (n, n)
    assert ref[2, 6] > 40 and ref[3, 9] > 20        # the planted pairs score
    # rows at a near-tie: |best − 0.64·second| ≤ 1e-5·second, in float64
    d64 = desc.astype(np.float64)
    diff = np.argwhere(got != ref)
    for i, j in diff:
        dist = ((d64[i][:, None] - d64[j][None]) ** 2).sum(-1)
        dist = np.where(mask[j][None], dist, 1e30)
        two = np.sort(dist, -1)[:, :2]
        ties = mask[i] & (np.abs(two[:, 0] - 0.64 * two[:, 1]) <= 1e-5 * two[:, 1])
        assert abs(int(got[i, j]) - int(ref[i, j])) <= int(ties.sum()), (i, j)
    assert len(diff) <= 2, diff
