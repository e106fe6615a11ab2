"""Parity of the PyTorch port's geometry core (Hartley normalization, the
fixed-step eigen-solvers, 8/7-point F, Sampson distance, residual audit,
epilines) with the JAX package on ``data/synthetic.py`` scenes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.data.synthetic import make_two_view_scene  # noqa: E402
from points_matching_tpu.geometry import eigen as je  # noqa: E402
from points_matching_tpu.geometry import fundamental as jf  # noqa: E402
from points_matching_tpu.geometry.normalize import hartley_normalize as j_hartley  # noqa: E402
from points_matching_tpu_torch.geometry import eigen as te  # noqa: E402
from points_matching_tpu_torch.geometry import fundamental as tf  # noqa: E402
from points_matching_tpu_torch.geometry.normalize import hartley_normalize  # noqa: E402

# f32 on both sides; the quantities compared here are well conditioned
# (full scenes, not minimal samples), so 1e-4 relative covers the
# different summation orders of the two frameworks.
RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


# jit the JAX references: eager dispatch of their unrolled solves is slow
_scene = jax.jit(make_two_view_scene, static_argnames=("num_points", "noise"))
_seven_point = jax.jit(jf.seven_point)
_find_fundamental = jax.jit(jf.find_fundamental)
_eight_point = jax.jit(jf.eight_point)
_eigvecs = jax.jit(je.smallest_eigvecs_psd, static_argnames=("k", "iters"))


@pytest.fixture(scope="module")
def scene():
    s = _scene(jax.random.PRNGKey(0), num_points=96, noise=0.3)
    p1, p2 = np.asarray(s.p1), np.asarray(s.p2)
    w = (np.random.RandomState(0).rand(96) > 0.2).astype(np.float32)
    return p1, p2, w


def _close(a, b, atol_scale=1.0):
    a, b = np.asarray(a), np.asarray(b)
    # entries that are ~0 by construction compare against the array's scale
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * atol_scale * np.abs(b).max())


def test_hartley_normalize(scene):
    p1, _, w = scene
    jn, jT = j_hartley(jnp.asarray(p1), jnp.asarray(w))
    tn, tT = hartley_normalize(_t(p1), _t(w))
    _close(tn.numpy(), jn)
    _close(tT.numpy(), jT)


def test_smallest_eigvecs_psd(scene):
    p1, p2, w = scene
    A = np.asarray(jf._constraint_rows(*j_hartley(jnp.asarray(p1))[:1],
                                       *j_hartley(jnp.asarray(p2))[:1]))
    M = (A.T @ A).astype(np.float32)
    Ms = np.stack([M, M + np.diag(np.arange(9, dtype=np.float32))])
    for k, iters in ((1, 4), (2, 6)):
        jv = np.asarray(_eigvecs(jnp.asarray(Ms), k=k, iters=iters))
        tv = te.smallest_eigvecs_psd(_t(Ms), k=k, iters=iters).numpy()
        # same start vector and trip count: same vectors, same signs
        _close(tv, jv)


def test_project_rank2():
    F = np.random.RandomState(1).randn(16, 3, 3).astype(np.float32)
    jr = np.asarray(je.project_rank2(jnp.asarray(F)))
    tr = te.project_rank2(_t(F)).numpy()
    _close(tr, jr)
    assert np.all(np.abs(np.linalg.det(tr.astype(np.float64))) < 1e-5)


def test_eight_point_weighted(scene):
    p1, p2, w = scene
    jF = np.asarray(_eight_point(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)))
    tF = tf.eight_point(_t(p1), _t(p2), _t(w)).numpy()
    _close(tF, jF)


def test_seven_point(scene):
    p1, p2, _ = scene
    sl = np.stack([np.arange(7) * 3 + i for i in range(4)])      # 4 samples
    jF, jv = (np.asarray(a) for a in _seven_point(jnp.asarray(p1[sl]),
                                                    jnp.asarray(p2[sl])))
    tF, tv = tf.seven_point(_t(p1[sl]), _t(p2[sl]))
    np.testing.assert_array_equal(tv.numpy(), jv)
    # roots of a cubic from f32 determinants: compare the valid candidates
    # as directions, to 1e-3
    for j, t, v in zip(jF.reshape(-1, 9), tF.numpy().reshape(-1, 9), jv.reshape(-1)):
        if v:
            assert abs(np.dot(j, t)) > 1 - 1e-3


def test_find_fundamental_dispatch(scene):
    p1, p2, w = scene
    for mask in (w > 0, np.arange(96) < 7):
        jF, jv = (np.asarray(a) for a in _find_fundamental(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask)))
        tF, tv = tf.find_fundamental(_t(p1), _t(p2), _t(mask))
        np.testing.assert_array_equal(tv.numpy(), jv)
        for j, t, v in zip(jF.reshape(3, 9), tF.numpy().reshape(3, 9), jv):
            if v:
                assert abs(np.dot(j, t)) > 1 - 1e-3


def test_sampson_audit_epilines(scene):
    p1, p2, w = scene
    F = np.asarray(_eight_point(jnp.asarray(p1), jnp.asarray(p2), jnp.ones(len(p1))))
    Fh = np.stack([F, F + 1e-3 * np.random.RandomState(2).randn(3, 3).astype(np.float32)])
    jd = np.asarray(jf.sampson_distance(jnp.asarray(Fh), jnp.asarray(p1)[None],
                                        jnp.asarray(p2)[None]))
    td = tf.sampson_distance(_t(Fh), _t(p1)[None], _t(p2)[None]).numpy()
    _close(td, jd)
    for form in ("reference", "standard"):
        jr, jm = jf.epipolar_residual_audit(jnp.asarray(F), jnp.asarray(p1),
                                            jnp.asarray(p2), jnp.asarray(w), form=form)
        tr, tm = tf.epipolar_residual_audit(_t(F), _t(p1), _t(p2), _t(w), form=form)
        _close(tr.numpy(), jr)
        np.testing.assert_allclose(float(tm), float(jm), rtol=RTOL)
    for which in (1, 2):
        jl = np.asarray(jf.compute_epilines(jnp.asarray(p1), which, jnp.asarray(F)))
        tl = tf.compute_epilines(_t(p1), which, _t(F)).numpy()
        _close(tl, jl)


def test_from_homogeneous_matches_reference():
    """``from_homogeneous`` against the JAX package's on the same points,
    with last coordinates of ordinary size, within ``eps`` of 0 on both
    sides, and exactly 0: the same division, the same clamp."""
    from points_matching_tpu.geometry.homogeneous import from_homogeneous as j_from_h
    from points_matching_tpu_torch.geometry.homogeneous import from_homogeneous, to_homogeneous

    x = np.random.RandomState(3).randn(4, 16, 4).astype(np.float32)
    x[0, :4, -1] = [1e-14, -1e-14, 0.0, 2e-12]
    got = from_homogeneous(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_from_h(jnp.asarray(x))))
    np.testing.assert_array_equal(
        from_homogeneous(_t(x), eps=1e-3).numpy(), np.asarray(j_from_h(jnp.asarray(x), 1e-3)))
    p = _t(x[..., :3])
    assert torch.equal(from_homogeneous(to_homogeneous(p)), p)
    assert got[0, 0, 0] == x[0, 0, 0] / np.float32(1e-12)
    assert got[0, 1, 0] == x[0, 1, 0] / np.float32(-1e-12)
