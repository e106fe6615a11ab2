"""Parity of the port's TUM / KITTI loaders (``data/datasets.py``) with the
JAX package's, on tests/test_datasets.py's fixture trees, trees with gaps
in the ground truth or without it, and rendered sequences written by
``write_tum_format`` / ``write_kitti_format``.

Tolerances: paths, timestamps, ground-truth centres and quaternions (NaN
rows included) and K equal to the bit; the world→camera poses (float32 on
both sides) to 1e-6; the quaternion helpers to 1e-12."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from points_matching_tpu.data import datasets as jd  # noqa: E402
from points_matching_tpu.data.render import render_sequence, write_tum_format  # noqa: E402
from points_matching_tpu_torch.data import datasets as td  # noqa: E402
from points_matching_tpu_torch.data.render import write_kitti_format  # noqa: E402
from test_datasets import _write_kitti, _write_tum  # noqa: E402


def _tum_gaps(tmp_path):
    """Ground truth for every other frame only, the rest 30 ms off: NaN rows."""
    root = _write_tum(tmp_path, n=6)
    lines = ["# ground truth"]
    for i in range(6):
        ts = 1000.0 + 0.033 * i + (0.005 if i % 2 == 0 else 0.03)
        lines.append(f"{ts:.6f} {0.1 * i:.4f} 0.2 -0.1 0.0 0.0 0.1 0.995")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(lines))
    return root


def _tum_no_gt(tmp_path):
    root = _write_tum(tmp_path)
    os.remove(os.path.join(root, "groundtruth.txt"))
    return root


def _rendered(tmp_path, fmt):
    imgs, pos, quats, K = render_sequence(num_frames=6, num_landmarks=120,
                                          image_size=(96, 64), seed=3, loop=True)
    root = str(tmp_path / fmt)
    if fmt == "tum":
        write_tum_format(root, imgs, pos, quats)
    else:
        write_kitti_format(root, imgs, pos, quats, K)
    return root, K


def _kitti_bare(tmp_path):
    """Images only: KITTI 00's default K, 10 Hz times, no ground truth."""
    root = _write_kitti(tmp_path)
    for p in ("sequences/00/calib.txt", "sequences/00/times.txt", "poses/00.txt"):
        os.remove(os.path.join(root, p))
    return root


TUM_TREES = {
    "fixture": lambda p: (_write_tum(p), {}),
    "gaps": lambda p: (_tum_gaps(p), {}),
    "no_gt": lambda p: (_tum_no_gt(p), {}),
    "rendered": lambda p: (lambda r: (r[0], {"intrinsics": r[1]}))(_rendered(p, "tum")),
}
KITTI_TREES = {
    "fixture": _write_kitti,
    "bare": _kitti_bare,
    "rendered": lambda p: _rendered(p, "kitti")[0],
}


def _assert_same(t, j):
    assert t.image_paths == j.image_paths
    for name in ("timestamps", "gt_positions", "gt_quats"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype == np.float64, name
        assert np.array_equal(a, b, equal_nan=True), name
    for k in ("fx", "fy", "cx", "cy"):
        tk, jk = getattr(t.K, k), getattr(j.K, k)
        assert tk.dtype == torch.float32 and tk.shape == ()
        assert tk.item() == float(jk), k
    tp, jp = t.world_to_camera_poses(device="cpu"), j.world_to_camera_poses()
    np.testing.assert_allclose(tp.R.numpy(), np.asarray(jp.R), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-6, rtol=0)
    assert tp.R.dtype == tp.t.dtype == torch.float32


@pytest.mark.parametrize("max_frames", [None, 3])
@pytest.mark.parametrize("tree", sorted(TUM_TREES))
def test_tum_loader_equals_jax(tmp_path, tree, max_frames):
    root, kw = TUM_TREES[tree](tmp_path)
    t = td.load_tum_sequence(root, max_frames=max_frames, device="cpu", **kw)
    j = jd.load_tum_sequence(root, max_frames=max_frames, **kw)
    _assert_same(t, j)
    assert len(t) == (max_frames or len(j))
    if tree == "gaps":
        assert np.isnan(t.gt_positions[1::2]).all() and np.isfinite(t.gt_positions[::2]).all()
    if tree == "no_gt":
        assert np.isnan(t.gt_positions).all() and np.isnan(t.gt_quats).all()


@pytest.mark.parametrize("max_frames", [None, 2])
@pytest.mark.parametrize("tree", sorted(KITTI_TREES))
def test_kitti_loader_equals_jax(tmp_path, tree, max_frames):
    root = KITTI_TREES[tree](tmp_path)
    t = td.load_kitti_sequence(root, "00", max_frames=max_frames, device="cpu")
    j = jd.load_kitti_sequence(root, "00", max_frames=max_frames)
    _assert_same(t, j)
    if tree == "bare":
        assert (t.K.fx.item(), t.K.cx.item()) == (np.float32(718.856), np.float32(607.1928))
        assert np.isnan(t.gt_positions).all()


def test_rendered_kitti_tree_holds_the_render(tmp_path):
    """write_kitti_format writes what load_kitti_sequence reads back: the
    renderer's K, 10 Hz timestamps and its camera centres."""
    imgs, pos, quats, K = render_sequence(num_frames=6, num_landmarks=120,
                                          image_size=(96, 64), seed=3, loop=True)
    root = str(tmp_path / "kitti")
    write_kitti_format(root, imgs, pos, quats, K)
    seq = td.load_kitti_sequence(root, device="cpu")
    assert [v.item() for v in (seq.K.fx, seq.K.fy, seq.K.cx, seq.K.cy)] == \
        [float(np.float32(v)) for v in K]
    np.testing.assert_allclose(seq.timestamps, 0.1 * np.arange(6), atol=1e-12)
    np.testing.assert_allclose(seq.gt_positions, pos, atol=1e-6)


def test_quaternion_helpers_equal_jax():
    rng = np.random.RandomState(2)
    q = rng.randn(64, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.sign(q[:, 3:4])                 # qw >= 0, the canonical form
    q[0] = 0.0                              # zero quaternion → identity
    R_t, R_j = td._quat_to_rot(q), jd._quat_to_rot(q)
    np.testing.assert_allclose(R_t, R_j, atol=1e-12, rtol=0)
    np.testing.assert_allclose(R_t[0], np.eye(3), atol=1e-12)
    np.testing.assert_allclose(td._rot_to_quat(R_t[1:]), jd._rot_to_quat(R_j[1:]),
                               atol=1e-12, rtol=0)
    # the round trip q → R → q (1/qw amplifies the rounding where qw is small)
    np.testing.assert_allclose(td._rot_to_quat(R_t[1:]), q[1:], atol=1e-9)


def test_loaders_need_a_device(tmp_path):
    """No loader puts K on the CPU unless asked: ``device`` is a required
    keyword."""
    tum, kitti = _write_tum(tmp_path), _write_kitti(tmp_path)
    with pytest.raises(TypeError):
        td.load_tum_sequence(tum)
    with pytest.raises(TypeError):
        td.load_kitti_sequence(kitti)
    seq = td.load_kitti_sequence(kitti, device="cpu")
    with pytest.raises(TypeError):
        seq.world_to_camera_poses()
