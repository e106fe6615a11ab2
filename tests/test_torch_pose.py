"""Parity of the port's pose geometry (se3, the rotational 3×3 SVD, E ↔ F,
DLT triangulation, pose from E, PnP) with the JAX package on the same
numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core.types import Pose as JPose  # noqa: E402
from points_matching_tpu.data.synthetic import make_two_view_scene  # noqa: E402
from points_matching_tpu.geometry import eigen as je  # noqa: E402
from points_matching_tpu.geometry import fundamental as jf  # noqa: E402
from points_matching_tpu.geometry import pnp as jpnp  # noqa: E402
from points_matching_tpu.geometry import pose as jpose  # noqa: E402
from points_matching_tpu.geometry import se3 as jse3  # noqa: E402
from points_matching_tpu.geometry import triangulate as jtri  # noqa: E402
from points_matching_tpu.geometry.ransac import sample_index_sets  # noqa: E402
from points_matching_tpu_torch.core.types import Pose  # noqa: E402
from points_matching_tpu_torch.data import synthetic as tsyn  # noqa: E402
from points_matching_tpu_torch.geometry import eigen as te  # noqa: E402
from points_matching_tpu_torch.geometry import fundamental as tf  # noqa: E402
from points_matching_tpu_torch.geometry import pnp as tpnp  # noqa: E402
from points_matching_tpu_torch.geometry import pose as tpose  # noqa: E402
from points_matching_tpu_torch.geometry import se3 as tse3  # noqa: E402
from points_matching_tpu_torch.geometry import triangulate as ttri  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _rot(w):
    return np.asarray(jse3.so3_exp(jnp.asarray(w, jnp.float32)))


@pytest.fixture(scope="module")
def scene():
    s = jax.jit(make_two_view_scene, static_argnames=("num_points", "noise"))(
        jax.random.PRNGKey(3), num_points=96, noise=0.3)
    return {k: np.asarray(v) for k, v in s._asdict().items() if k != "pose"} | dict(
        R=np.asarray(s.pose.R), t=np.asarray(s.pose.t))


def _twists():
    rng = np.random.RandomState(0)
    w = rng.randn(16, 3).astype(np.float32)
    w[:4] *= 1e-5                                            # Taylor branch
    w[4] = 0.0                                               # θ = 0
    axis = w[5] / np.linalg.norm(w[5])
    w[5] = axis * (np.pi - 1e-4)                             # θ near π
    w[6] = axis * np.pi
    return w


_so3_exp, _so3_log = jax.jit(jse3.so3_exp), jax.jit(jse3.so3_log)
_triangulate, _pnp_dlt = jax.jit(jtri.triangulate_dlt), jax.jit(jpnp.pnp_dlt)
_e_from_f = jax.jit(jf.essential_from_fundamental)
_f_from_e = jax.jit(jf.fundamental_from_essential)
_index_sets = jax.jit(sample_index_sets, static_argnums=(2, 3))
_se3_exp, _se3_log = jax.jit(jse3.se3_exp), jax.jit(jse3.se3_log)


def test_so3_exp_log_and_se3():
    w = _twists()
    # so3_exp: 1e-6 absolute (entries ≤ 1, f32 trig of both libraries)
    R_j = np.asarray(_so3_exp(jnp.asarray(w)))
    R_t = tse3.so3_exp(_t(w)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-6)
    assert torch.isfinite(tse3.so3_exp(torch.zeros(3))).all()
    # so3_log on the same rotations, the near-π rows included: 1e-4
    # absolute (the near-π branch recovers the axis through a square root)
    np.testing.assert_allclose(tse3.so3_log(_t(R_j)).numpy(),
                               np.asarray(_so3_log(jnp.asarray(R_j))), atol=1e-4)
    # log(exp(w)) = w away from π; 1e-5 absolute
    np.testing.assert_allclose(tse3.so3_log(_t(R_t)).numpy()[:5], w[:5], atol=1e-5)
    xi = np.concatenate([np.random.RandomState(1).randn(16, 3).astype(np.float32), w], -1)
    Rj, tj = _se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(_t(xi))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    # se3_log: away from π, 1e-4 absolute
    np.testing.assert_allclose(tse3.se3_log(Rt[:5], tt[:5]).numpy(),
                               np.asarray(_se3_log(Rj[:5], tj[:5])), atol=1e-4)


def test_svd3_rotational_and_nearest_rotation(scene):
    A = np.random.RandomState(2).randn(8, 3, 3).astype(np.float32)
    Uj, sj, Vtj = (np.asarray(x) for x in jax.jit(je.svd3_rotational)(jnp.asarray(A)))
    Ut, st, Vtt = (x.numpy() for x in te.svd3_rotational(_t(A)))
    # distinct singular values: same construction and trip counts, the
    # factors agree to 1e-5 absolute
    np.testing.assert_allclose(Ut, Uj, atol=1e-5)
    np.testing.assert_allclose(st, sj, atol=1e-5)
    np.testing.assert_allclose(Vtt, Vtj, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Ut), 1.0, atol=1e-5)
    # the construction itself reconstructs A to ~3e-3 (8 inverse-iteration
    # steps for v₃, in both packages)
    np.testing.assert_allclose(Ut @ (st[..., None] * Vtt), A, atol=5e-3)
    # an essential matrix (σ1 = σ2): the top pair of singular vectors is any
    # basis of its plane, so only the factorization itself is compared
    E = (scene["E"] / np.linalg.norm(scene["E"])).astype(np.float32)
    U, s, Vt = (x.numpy() for x in te.svd3_rotational(_t(E)))
    np.testing.assert_allclose(U @ (s[:, None] * Vt), E, atol=5e-3)
    np.testing.assert_allclose(s, np.asarray(je.svd3_rotational(jnp.asarray(E))[1]), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(np.stack([U, Vt])), 1.0, atol=1e-5)
    M = A + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(te.nearest_rotation_so3(_t(M)).numpy(),
                               np.asarray(jax.jit(je.nearest_rotation_so3)(jnp.asarray(M))),
                               atol=1e-5)


def test_essential_fundamental_round_trip(scene):
    K, F = scene["K"], scene["F"]
    Ej = np.asarray(_e_from_f(jnp.asarray(F), jnp.asarray(K),
                                                  jnp.asarray(K)))
    Et = tf.essential_from_fundamental(_t(F), _t(K), _t(K)).numpy()
    np.testing.assert_allclose(Et, Ej, atol=1e-5)                # entries O(1)
    Fj = np.asarray(_f_from_e(jnp.asarray(Ej), jnp.asarray(K),
                                                  jnp.asarray(K)))
    Ft = tf.fundamental_from_essential(_t(Ej), _t(K), _t(K)).numpy()
    np.testing.assert_allclose(Ft, Fj, atol=1e-5)                # unit Frobenius norm
    np.testing.assert_allclose(Ft, F, atol=1e-4)


def test_triangulate_dlt_and_recover_pose(scene):
    K, p1, p2 = scene["K"], scene["p1"], scene["p2"]
    P1 = K @ np.eye(3, 4, dtype=np.float32)
    P2 = K @ np.concatenate([scene["R"], scene["t"][:, None]], -1)
    Xj, okj = _triangulate(*(jnp.asarray(a) for a in (P1, P2, p1, p2)))
    Xt, okt = ttri.triangulate_dlt(*(_t(a) for a in (P1, P2, p1, p2)))
    # 0.3 px noise at depths 4–12: points agree to 1e-3 relative
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-3, atol=1e-3)
    assert np.array_equal(okt.numpy(), np.asarray(okj)) and okt.all()
    np.testing.assert_allclose(Xt.numpy(), scene["X"], rtol=0.05, atol=0.05)

    Kinv = np.linalg.inv(K)
    n1 = (p1 @ Kinv[:2, :2].T + Kinv[:2, 2]).astype(np.float32)
    n2 = (p2 @ Kinv[:2, :2].T + Kinv[:2, 2]).astype(np.float32)
    E = scene["E"] / np.linalg.norm(scene["E"])
    w = (np.random.RandomState(4).rand(96) > 0.1).astype(np.float32)
    pj, Xj, gj = jax.jit(jpose.recover_pose)(*(jnp.asarray(a) for a in (E, n1, n2, w)))
    pt, Xt, gt = tpose.recover_pose(*(_t(a) for a in (E, n1, n2, w)))
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=1e-5)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-5)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-3, atol=1e-3)
    assert np.array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_allclose(pt.R.numpy(), scene["R"], atol=1e-3)
    # the port's own scene generator: same construction, its own draws
    s = tsyn.make_two_view_scene(torch.Generator().manual_seed(0), num_points=64)
    assert torch.allclose(tsyn.essential_from_pose(s.pose.R, s.pose.t), s.E)
    x2 = torch.cat([s.p2, torch.ones(64, 1)], -1)
    x1 = torch.cat([s.p1, torch.ones(64, 1)], -1)
    assert float((x2 @ s.F * x1).sum(-1).abs().max()) < 1e-3


def _pnp_problem(seed, n, outliers=0):
    rng = np.random.RandomState(seed)
    X = (rng.uniform(-2, 2, (n, 3)) + [0, 0, 8]).astype(np.float32)
    R = _rot([0.05, 0.15, -0.1])
    t = np.asarray([0.2, 0.1, -0.3], np.float32)
    Xc = X @ R.T + t
    uvn = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    uvn[:outliers] = rng.uniform(-0.5, 0.5, (outliers, 2))
    return X, uvn, R, t


def test_pnp_dlt_exact_and_refine():
    X, uvn, R, t = _pnp_problem(0, 32)
    pj = _pnp_dlt(jnp.asarray(X), jnp.asarray(uvn))
    pt = tpnp.pnp_dlt(_t(X), _t(uvn))
    np.testing.assert_allclose(pt.R.numpy(), R, atol=1e-3)        # exact data
    np.testing.assert_allclose(pt.t.numpy(), t, atol=1e-2)
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=1e-4)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-3)
    # refinement from a perturbed pose, half the rows weighted out: the
    # closed-form Jacobian against the reference's jacfwd, 1e-5 absolute
    R0 = _rot([0.02, -0.01, 0.03]) @ R
    t0 = t + np.asarray([0.05, -0.02, 0.1], np.float32)
    w = (np.arange(32) % 2).astype(np.float32)
    rj = jax.jit(jpnp.pnp_refine)(JPose(R=jnp.asarray(R0), t=jnp.asarray(t0)),
                                  jnp.asarray(X), jnp.asarray(uvn), jnp.asarray(w))
    rt = tpnp.pnp_refine(Pose(R=_t(R0), t=_t(t0)), _t(X), _t(uvn), _t(w))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-5)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-5)
    np.testing.assert_allclose(rt.R.numpy(), R, atol=1e-5)


_ransac_pnp_j = jax.jit(jpnp.ransac_pnp, static_argnames=(
    "num_hypotheses", "sample_size", "refine_iterations", "refine_top_k"))


def test_ransac_pnp_with_injected_samples():
    N, H = 128, 64
    X, uvn, R, _ = _pnp_problem(1, N, outliers=N // 3)
    mask = np.ones(N, bool)
    mask[-8:] = False
    # the outliers are the first N // 3 rows: weight the rest up, as SfM
    # registration weights its tracked rows
    logits = np.where(np.arange(N) >= N // 3, 2.0, 0.0).astype(np.float32)
    prior = JPose(R=jnp.asarray(_rot([0.0, 0.1, 0.0])), t=jnp.zeros(3))
    key = jax.random.PRNGKey(7)
    res_j = _ransac_pnp_j(key, jnp.asarray(X), jnp.asarray(uvn), jnp.asarray(mask),
                          num_hypotheses=H, inlier_threshold=0.01,
                          sample_logits=jnp.asarray(logits), prior_pose=prior)
    # the reference's own draws: sample_index_sets shares sample_minimal_points' core
    idx = np.asarray(_index_sets(key, jnp.asarray(mask), H, 6, jnp.asarray(logits)))
    res_t = tpnp.ransac_pnp(None, _t(X), _t(uvn), _t(mask), num_hypotheses=H,
                            inlier_threshold=0.01, sample_logits=_t(logits),
                            prior_pose=Pose(R=_t(prior.R), t=_t(prior.t)),
                            samples=(_t(X[idx]), _t(uvn[idx])))
    assert int(res_t.num_inliers) == int(res_j.num_inliers) > N // 2
    assert np.array_equal(res_t.inlier_mask.numpy(), np.asarray(res_j.inlier_mask))
    np.testing.assert_allclose(res_t.pose.R.numpy(), np.asarray(res_j.pose.R), atol=1e-5)
    np.testing.assert_allclose(res_t.pose.t.numpy(), np.asarray(res_j.pose.t), atol=1e-5)
    np.testing.assert_allclose(res_t.pose.R.numpy(), R, atol=1e-3)
    # and with the port's own sampler
    res_g = tpnp.ransac_pnp(torch.Generator().manual_seed(0), _t(X), _t(uvn), _t(mask),
                            num_hypotheses=H, inlier_threshold=0.01)
    assert int(res_g.num_inliers) >= int(res_j.num_inliers) - 2


def test_top_k_tie_rule():
    rng = np.random.RandomState(5)
    counts = rng.randint(0, 6, 200).astype(np.int32)         # many ties
    for k in (1, 8, 50):
        _, jtop = jax.lax.top_k(jnp.asarray(counts), k)
        assert np.array_equal(tpnp.top_k_first(_t(counts), k).numpy(), np.asarray(jtop))


def test_intrinsics_and_pose_types(scene):
    from points_matching_tpu.core.types import CameraIntrinsics as JK
    from points_matching_tpu_torch.core.convert import intrinsics_from_numpy, pose_from_numpy

    Kj = JK.from_matrix(jnp.asarray(scene["K"]))
    Kt = intrinsics_from_numpy(scene["K"], device="cpu")
    np.testing.assert_array_equal(Kt.matrix().numpy(), np.asarray(Kj.matrix()))
    xy = scene["p1"]
    np.testing.assert_allclose(Kt.normalize_points(_t(xy)).numpy(),
                               np.asarray(Kj.normalize_points(jnp.asarray(xy))), atol=1e-6)
    X = scene["X"]
    np.testing.assert_allclose(Kt.project(_t(X)).numpy(), np.asarray(Kj.project(jnp.asarray(X))),
                               rtol=1e-6, atol=1e-3)                  # pixels ~ 1e2
    a = JPose(R=jnp.asarray(scene["R"]), t=jnp.asarray(scene["t"]))
    b = JPose(R=jnp.asarray(_rot([0.1, 0.2, -0.3])), t=jnp.asarray([1.0, -2.0, 0.5]))
    ta, tb = pose_from_numpy(a, device="cpu"), pose_from_numpy(b, device="cpu")
    # compositions of unit rotations and O(1) translations: 1e-6 absolute
    for got, want in ((ta.compose(tb), a.compose(b)), (ta.inverse(), a.inverse())):
        np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-6)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-6)
    np.testing.assert_allclose(ta.transform(_t(X)).numpy(),
                               np.asarray(a.transform(jnp.asarray(X))), atol=1e-5)
    np.testing.assert_array_equal(ta.matrix34().numpy(), np.asarray(a.matrix34()))
    eye = Pose.identity((3,), device="cpu")
    assert eye.R.shape == (3, 3, 3) and not eye.t.any()


def test_trajectory_evaluation():
    from points_matching_tpu.utils import evaluation as jev
    from points_matching_tpu_torch.utils import evaluation as tev

    rng = np.random.RandomState(3)
    gt = rng.randn(20, 3).astype(np.float32)
    est = (2.5 * gt @ _rot([0.3, 0.1, -0.2]).T + [1.0, -2.0, 0.5]
           + 0.05 * rng.randn(20, 3)).astype(np.float32)
    mask = np.arange(20) % 7 != 3
    for align_scale in (True, False):
        j = jev.absolute_trajectory_error(jnp.asarray(est), jnp.asarray(gt),
                                          jnp.asarray(mask), align_scale)
        t = tev.absolute_trajectory_error(_t(est), _t(gt), _t(mask), align_scale)
        # a 3×3 SVD in each library: 1e-4 relative
        for name in ("rmse", "mean", "median_like", "scale"):
            np.testing.assert_allclose(float(getattr(t, name)), float(getattr(j, name)),
                                       rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(t.aligned.numpy(), np.asarray(j.aligned), atol=1e-4)
    np.testing.assert_allclose(float(tev.relative_pose_error(_t(est), _t(gt), 2)),
                               float(jev.relative_pose_error(jnp.asarray(est),
                                                             jnp.asarray(gt), 2)), rtol=1e-5)
