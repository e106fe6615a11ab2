"""The PyTorch port's two-view slice against the JAX pipeline, plus the
package-level contracts: configs equal field for field, no JAX import, no
silent CPU fallback for a CUDA request."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core import config as jc  # noqa: E402
from points_matching_tpu.data.render import render_sequence  # noqa: E402
from points_matching_tpu.geometry.ransac import sample_minimal_points  # noqa: E402
from points_matching_tpu.pipelines.two_view import two_view_pipeline as j_pipeline  # noqa: E402
from points_matching_tpu_torch.core import config as tc  # noqa: E402
from points_matching_tpu_torch.core.convert import config_from_dict  # noqa: E402
from points_matching_tpu_torch.core.device import resolve_device  # noqa: E402
from points_matching_tpu_torch.pipelines.two_view import (  # noqa: E402
    run_two_view_demo, two_view_pipeline)

H_RANSAC = 256


def _small(cfg):
    return dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=128))


def _ransac_config(backend):
    # the demo's --config ransac, cut to 128 kp and 256 hypotheses
    return _small(dataclasses.replace(
        jc.surf_parity_config(),
        matcher=jc.MatcherConfig(metric="l2", filter="ratio", ratio=0.85, backend=backend),
        ransac=jc.RansacConfig(num_hypotheses=H_RANSAC, backend=backend),
        use_ransac=True))


@pytest.fixture(scope="module")
def pair():
    imgs, *_ = render_sequence(num_frames=2, num_landmarks=150, image_size=(256, 192),
                               seed=0)
    return np.array(imgs[0]), np.array(imgs[1])


@pytest.fixture(scope="module")
def jax_ransac_run(pair):
    """The JAX pipeline (XLA backend) once, plus the minimal sets it drew."""
    key = jax.random.PRNGKey(0)
    cfg = _ransac_config("xla")
    res = jax.device_get(j_pipeline(jnp.asarray(pair[0]), jnp.asarray(pair[1]), key, cfg))
    sp1, sp2 = sample_minimal_points(key, jnp.asarray(res.matches.mask), H_RANSAC, 8,
                                     (jnp.asarray(res.p1), jnp.asarray(res.p2)))
    return res, (torch.from_numpy(np.array(sp1)), torch.from_numpy(np.array(sp2)))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_two_view_ransac_slice_matches_jax(pair, jax_ransac_run, backend):
    ref, samples = jax_ransac_run
    cfg = config_from_dict(dataclasses.asdict(_ransac_config(backend)))
    out = two_view_pipeline(torch.from_numpy(pair[0]), torch.from_numpy(pair[1]), None,
                            cfg, samples=samples)
    assert int(out.kps1.mask.sum()) == int(ref.kps1.mask.sum())
    assert int(out.kps2.mask.sum()) == int(ref.kps2.mask.sum())
    n_ref = int(ref.matches.mask.sum())
    assert n_ref >= 40
    # f32 near-ties in the ratio test may flip a match or two
    assert abs(int(out.matches.mask.sum()) - n_ref) <= 2
    i_ref = int(ref.estimate.num_inliers)
    assert abs(int(out.estimate.num_inliers) - i_ref) <= max(1, 0.05 * i_ref)
    # unit-Frobenius F: |⟨F_jax, F_torch⟩| is the cosine between them
    assert abs(float(np.sum(np.asarray(ref.estimate.F) * out.estimate.F.numpy()))) >= 0.99
    assert out.residuals.shape == ref.residuals.shape
    assert out.epilines2.shape == ref.epilines2.shape
    assert float(out.dist_min) == pytest.approx(float(ref.dist_min), abs=1e-5)
    assert float(out.dist_max) == pytest.approx(float(ref.dist_max), abs=1e-5)


def test_two_view_reference_config_matches_jax(pair):
    """surf_parity_config(): midpoint filter, no RANSAC, find_fundamental."""
    cfg = _small(jc.surf_parity_config())
    ref = jax.device_get(j_pipeline(jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                                    jax.random.PRNGKey(0), cfg))
    out = two_view_pipeline(torch.from_numpy(pair[0]), torch.from_numpy(pair[1]),
                            config=config_from_dict(dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(out.matches.mask.numpy(), np.asarray(ref.matches.mask))
    assert abs(float(np.sum(np.asarray(ref.estimate.F) * out.estimate.F.numpy()))) >= 0.999
    assert int(out.estimate.num_inliers) == pytest.approx(int(ref.estimate.num_inliers),
                                                          abs=2)


def _all_config_classes():
    return [c for c in vars(jc).values()
            if isinstance(c, type) and dataclasses.is_dataclass(c)]


@pytest.mark.parametrize("cls", _all_config_classes(), ids=lambda c: c.__name__)
def test_config_fields_and_defaults_equal(cls):
    port = getattr(tc, cls.__name__)
    names = [f.name for f in dataclasses.fields(cls)]
    assert [f.name for f in dataclasses.fields(port)] == names
    # defaults, nested configs included
    assert dataclasses.asdict(cls()) == dataclasses.asdict(port())
    assert port.__dataclass_params__.frozen


def test_config_from_dict_round_trip():
    for make in ("surf_parity_config", "orb_default_config"):
        j = getattr(jc, make)()
        t = config_from_dict(dataclasses.asdict(j))
        assert t == getattr(tc, make)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    sfm = config_from_dict(dataclasses.asdict(jc.SfMConfig()), tc.SfMConfig)
    assert sfm == tc.SfMConfig()
    with pytest.raises(TypeError):
        config_from_dict({"no_such_field": 1}, tc.RansacConfig)


def test_package_imports_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now raises
        sys.modules["flax"] = None
        import points_matching_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules if m.startswith("points_matching_tpu")
               and not m.startswith("points_matching_tpu_torch")]
        assert not bad, bad
        print(len(names))
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=repo)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-fallback path is not reachable")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    # nothing but "cpu" maps to the CPU: the defaults ask for CUDA and raise
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        run_two_view_demo("no-such-1.png", "no-such-2.png", verbose=False)
    with pytest.raises(ValueError):
        resolve_device("auto")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("make", ["pose", "landmarks", "sfm_state", "converter"])
def test_constructors_need_a_device(make):
    """No constructor of the port puts tensors on the CPU unless asked:
    ``device`` is a required keyword."""
    from points_matching_tpu_torch.core.config import SfMConfig
    from points_matching_tpu_torch.core.convert import pose_from_numpy
    from points_matching_tpu_torch.core.types import Landmarks, Pose
    from points_matching_tpu_torch.pipelines.sfm import init_sfm_state

    call = {"pose": lambda **kw: Pose.identity((2,), **kw),
            "landmarks": lambda **kw: Landmarks.empty(4, **kw),
            "sfm_state": lambda **kw: init_sfm_state(SfMConfig(), 8, 32, **kw),
            "converter": lambda **kw: pose_from_numpy(
                Pose(R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32)), **kw)}[make]
    with pytest.raises(TypeError):
        call()
    out = call(device="cpu")
    first = out.R if hasattr(out, "R") else (out.xyz if hasattr(out, "xyz") else out.X)
    assert first.device.type == "cpu"
