"""The SLAM demo's slice as a whole on the CPU: a rendered KITTI-format tree
(8 frames, 320 × 240, an out-and-back path with a revisit) read by both
packages' loaders, through both frontends (Hessian threshold 400, 128
features), then the port's ``pipelines/slam.run_slam_demo`` (the body of
``examples/slam_demo_torch.py``) against the JAX functions in the order
``examples/slam_demo.py:main`` calls them: ``run_incremental_sfm`` →
``close_loops``.

The two packages draw other RANSAC samples, so the trajectories are held
after a Sim(3) alignment: ``TRAJ_TOL`` of the extent, RMS (readings on this
tree: 1.1 % before loop closure, 0.7 % after).  Registrations must be
equal.  The reference's
``camera_centers`` returns −R·t instead of −Rᵀ·t (``ROADMAP.md``, reference-
side facts), so its centres are computed here from its poses."""
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core import config as jc  # noqa: E402
from points_matching_tpu.data.datasets import load_kitti_sequence as j_load  # noqa: E402
from points_matching_tpu.data.images import load_batch as j_load_batch  # noqa: E402
from points_matching_tpu.ops.descriptors import extract_descriptors as j_describe  # noqa: E402
from points_matching_tpu.ops.detect import detect_keypoints as j_detect  # noqa: E402
from points_matching_tpu.pipelines.loop_closure import close_loops as j_close_loops  # noqa: E402
from points_matching_tpu.pipelines.sfm import run_incremental_sfm as j_sfm  # noqa: E402
from points_matching_tpu_torch.data.datasets import load_kitti_sequence  # noqa: E402
from points_matching_tpu_torch.data.render import render_sequence, write_kitti_format  # noqa: E402
from points_matching_tpu_torch.pipelines.slam import run_slam_demo, slam_config  # noqa: E402
from points_matching_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from points_matching_tpu_torch.utils.evaluation import umeyama_alignment  # noqa: E402

N, SIZE, FEATURES, STEP = 8, (320, 240), 128, 0.25
TRAJ_TOL = 0.03           # RMS aligned gap, as a fraction of the extent
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    imgs, pos, quats, K = render_sequence(
        num_frames=N, num_landmarks=400, image_size=SIZE, seed=0, loop=True, step=STEP,
        x_span=(-6.0, 6.0 + STEP * (N // 2 - 1)))
    root = str(tmp_path_factory.mktemp("kitti"))
    write_kitti_format(root, imgs, pos, quats, K)
    return root


def _centres(R, t):
    """World-frame camera centres −Rᵀ·t."""
    return -np.einsum("nji,nj->ni", np.asarray(R, np.float64), np.asarray(t, np.float64))


@pytest.fixture(scope="module")
def jax_run(tree):
    """``examples/slam_demo.py:main`` with ``--kitti --frames 8 --features
    128 --loop-closure`` on the CPU, step by step."""
    seq = j_load(tree, "00", max_frames=N)
    images = j_load_batch(seq.image_paths)
    cfg = jc.SfMConfig(
        two_view=jc.TwoViewConfig(
            detector=jc.DetectorConfig(kind="hessian", threshold=400.0, max_keypoints=FEATURES),
            matcher=jc.MatcherConfig(metric="l2", filter="ratio", ratio=0.85),
            ransac=jc.RansacConfig(num_hypotheses=256, inlier_threshold=2.0)),
        max_cameras=max(16, N + 2), max_landmarks=64 * FEATURES,
        max_observations=256 * FEATURES)
    det = jax.jit(j_detect, static_argnums=1)
    desc = jax.jit(j_describe, static_argnums=2)
    frames = []
    for i in range(N):
        img = jnp.asarray(images[i])
        kps = det(img, cfg.two_view.detector)
        d = desc(img, kps, cfg.two_view.descriptor)
        frames.append((kps.xy, d.data, d.mask))
    res = j_sfm(frames, seq.K, cfg, ba_every=4)
    st = res.state
    corrected, cands = j_close_loops(st.poses, int(st.num_cams), frames, seq.K, cfg)
    n_reg = sum(res.registered)
    return dict(seq=seq, cfg=cfg, registered=list(res.registered),
                counts=[int(np.asarray(f[2]).sum()) for f in frames],
                before=_centres(st.poses.R, st.poses.t)[:n_reg],
                after=_centres(corrected.R, corrected.t)[:n_reg],
                verified=[c.verified for c in cands])


@pytest.fixture(scope="module")
def port_run(tree, tmp_path_factory):
    seq = load_kitti_sequence(tree, "00", max_frames=N, device="cpu")
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    run = run_slam_demo(seq, device="cpu", features=FEATURES, loop_closure=True,
                        checkpoint_dir=ckpt, verbose=False)
    return seq, run, ckpt


def _gap(a, b) -> float:
    a, b = (torch.as_tensor(np.asarray(x), dtype=torch.float64) for x in (a, b))
    s, R, t = umeyama_alignment(a, b)
    return float((s * a @ R.T + t - b).norm(dim=-1).square().mean().sqrt())


def test_loaders_and_configs_agree(jax_run, port_run):
    seq, run, _ = port_run
    j = jax_run["seq"]
    assert seq.image_paths == j.image_paths
    assert np.array_equal(seq.gt_positions, j.gt_positions)
    assert [v.item() for v in (seq.K.fx, seq.K.fy, seq.K.cx, seq.K.cy)] == \
        [float(v) for v in (j.K.fx, j.K.fy, j.K.cx, j.K.cy)]
    assert dataclasses.asdict(slam_config(FEATURES, N)) == dataclasses.asdict(jax_run["cfg"])
    assert run.numbers["decoder"] in ("native", "pil")


def test_frontends_fill_the_same_capacity(jax_run, port_run):
    _, run, _ = port_run
    counts = [int(f[2].sum()) for f in run.frames]
    assert counts == jax_run["counts"] == [FEATURES] * N


def test_registrations_equal_the_reference(jax_run, port_run):
    _, run, _ = port_run
    assert run.result.registered == jax_run["registered"]
    assert run.numbers["registered"] == N


def test_trajectories_agree_with_the_reference(jax_run, port_run):
    seq, run, _ = port_run
    extent = run.numbers["extent"]
    before = run.result.trajectory[:N].numpy()
    assert _gap(before, jax_run["before"]) < TRAJ_TOL * extent
    assert _gap(run.trajectory, jax_run["after"]) < TRAJ_TOL * extent
    # both within the gates of tests/test_sequence_100.py: 10 % of the extent
    assert run.numbers["ate_before_closure"] < 0.1 * extent
    assert run.numbers["ate"] < 0.1 * extent
    assert run.numbers["loops_verified"] >= 1 and any(jax_run["verified"])


def test_checkpoint_of_the_map_restores_bit_for_bit(port_run):
    _, run, ckpt = port_run
    state = run.result.state
    with CheckpointManager(ckpt) as mgr:
        assert mgr.latest_step() == N
        got = mgr.restore(template=state)
    for f in dataclasses.fields(state):
        a, b = getattr(got, f.name), getattr(state, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert torch.equal(got.poses.R, state.poses.R) and torch.equal(got.poses.t, state.poses.t)


def test_distributed_path_at_world_size_one(port_run):
    """``--distributed`` in one process (no mesh): 2 segments of 5 with an
    overlap of 3, under config 4's gates."""
    seq, _, _ = port_run
    run = run_slam_demo(seq, device="cpu", features=FEATURES, distributed=True,
                        segment_len=5, overlap=3, verbose=False)
    nums = run.numbers
    assert nums["segments"] == 2 and nums["mesh"] == [1, 1] and nums["world_size"] == 1
    assert nums["registered"] == nums["registered_slots"] == 10
    assert nums["cameras_valid"] == nums["cameras"] == 7
    assert nums["ate"] < 0.1 * nums["extent"]
    assert nums["ba_final_cost"] <= nums["ba_initial_cost"]


def _demo_module():
    path = os.path.join(REPO, "examples", "slam_demo_torch.py")
    spec = importlib.util.spec_from_file_location("_slam_demo_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_prints_one_json_line(tree, monkeypatch):
    demo = _demo_module()
    monkeypatch.setattr(sys, "argv", ["slam_demo_torch.py", "--kitti", tree, "--frames", "4",
                                      "--features", str(FEATURES), "--device", "cpu"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = demo.main()
    nums = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and nums["registered"] == nums["frames"] == 4
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", ["slam_demo_torch.py", "--kitti", tree])
        with pytest.raises(RuntimeError):            # the default device is the card
            demo.main()


def test_new_modules_import_without_jax():
    code = textwrap.dedent("""
        import importlib, importlib.util, sys
        sys.modules["jax"] = None          # any `import jax` now raises
        for name in ("data.datasets", "utils.checkpoint", "utils.profiling",
                     "utils.sanitize", "utils.metrics", "utils.logging", "pipelines.slam",
                     "ops.kernels.work"):
            importlib.import_module("points_matching_tpu_torch." + name)
        spec = importlib.util.spec_from_file_location("demo", "examples/slam_demo_torch.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m.startswith("points_matching_tpu")
               and not m.startswith("points_matching_tpu_torch")]
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
