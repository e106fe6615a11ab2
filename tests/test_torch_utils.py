"""The port's utilities (``points_matching_tpu_torch/utils``: checkpoint,
profiling, sanitize, metrics, logging) against the JAX package's, on the
CPU: the counterpart of each test in tests/test_utils.py, plus what the
port's own designs promise.  The sharded restore runs as a job of the 4-rank
gloo group in tests/test_torch_parallel.py (``checkpoint``).

Tolerances: checkpoints restore bit for bit; metrics equal the JAX
package's to 1e-12; the roofline's flop count equals XLA's for a matmul."""
import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.utils import metrics as jm  # noqa: E402
from points_matching_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from points_matching_tpu.utils.profiling import chip_peaks as j_chip_peaks  # noqa: E402
from points_matching_tpu.utils.profiling import roofline as j_roofline  # noqa: E402
from points_matching_tpu_torch.core.types import Pose  # noqa: E402
from points_matching_tpu_torch.utils import checkpoint as tck  # noqa: E402
from points_matching_tpu_torch.utils import metrics as tm  # noqa: E402
from points_matching_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from points_matching_tpu_torch.utils.profiling import (  # noqa: E402
    chip_peaks, roofline, stage, trace)
from points_matching_tpu_torch.utils.sanitize import (  # noqa: E402
    SanitizerError, check_finite, check_index, checked, debug_mode, debug_nans_enabled)


def _state():
    return {"X": torch.arange(12.0).reshape(4, 3),
            "mask": torch.tensor([True, False, True, True]),
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal_trees(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal_trees(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a == b


# -- checkpoint -----------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """tests/test_utils.py::test_checkpoint_roundtrip, and the same states
    through the JAX package's (Orbax) manager restore to the same values."""
    state = _state()
    state2 = {"X": state["X"] * 2, "mask": ~state["mask"], "step": state["step"] * 2}
    with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
        assert mgr.save(0, state)
        mgr.wait()
        assert mgr.save(1, state2)
        mgr.wait()
        assert mgr.latest_step() == 1 and mgr.all_steps() == [0, 1]
        restored = mgr.restore(1, template=state)
        restored0 = mgr.restore(0, template=state)
        latest = mgr.restore()
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    with JCheckpointManager(str(tmp_path / "orbax")) as jmgr:
        jmgr.save(0, jstate)
        jmgr.wait()
        jmgr.save(1, {k: jnp.asarray(v.numpy()) for k, v in state2.items()})
        jmgr.wait()
        jrestored = jmgr.restore(1, template=jstate)
        jrestored0 = jmgr.restore(0, template=jstate)
    for got, ref, want in ((restored, jrestored, state2), (restored0, jrestored0, state)):
        _equal_trees(got, want)
        for k in state:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    # without a template: the plain tree on the CPU
    _equal_trees(latest, state2)


def test_checkpoint_restore_missing_raises(tmp_path):
    with CheckpointManager(str(tmp_path / "empty")) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore()
        with pytest.raises(FileNotFoundError):
            mgr.restore(3)


@pytest.fixture(scope="module")
def sfm_run():
    """A short SfM run on the CPU (6 synthetic frames)."""
    from points_matching_tpu_torch.core.config import SfMConfig
    from points_matching_tpu_torch.data.synthetic import make_tracked_sequence
    from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm

    frames, K, _ = make_tracked_sequence(6, device="cpu", num_landmarks=200,
                                         num_features=128)
    cfg = SfMConfig(max_cameras=8, max_landmarks=1024, max_observations=4096)
    return run_incremental_sfm(frames, K, cfg, seed=0)


def test_checkpoint_sfm_state_roundtrip(tmp_path, sfm_run):
    """An ``SfMState`` (a dataclass holding a ``Pose`` dataclass) saved as
    plain containers, loaded with ``weights_only=True`` and rebuilt from
    the template bit for bit; without a template, dicts of its fields."""
    state = sfm_run.state
    with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
        mgr.save(6, state)
        got = mgr.restore(template=state)
        plain = mgr.restore()
    _equal_trees(got, state)
    assert isinstance(plain, dict) and isinstance(plain["poses"], dict)
    assert torch.equal(plain["poses"]["R"], state.poses.R)
    # the file holds no pickled class: it loads with weights_only=True
    path = os.path.join(str(tmp_path / "ckpt"), "6", "rank0of1.pt")
    assert torch.load(path, weights_only=True)["step"] == 6


class _Pair(NamedTuple):
    a: torch.Tensor
    b: list


def test_checkpoint_template_structures(tmp_path):
    """Tuples, NamedTuples, dataclasses, numpy arrays and scalars come back
    as the template has them, each tensor with the template's dtype."""
    state = {"pose": Pose(R=torch.eye(3).expand(2, 3, 3).clone(), t=torch.ones(2, 3)),
             "pair": _Pair(torch.arange(3), [torch.zeros(2), 5]),
             "tup": (torch.tensor([1.5]), "name"), "np": np.arange(4.0), "none": None}
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(0, state)
        got = mgr.restore(0, template=state)
        half = mgr.restore(0, template=dict(state, pose=Pose(R=state["pose"].R.double(),
                                                               t=state["pose"].t.double())))
    assert isinstance(got["pair"], _Pair) and isinstance(got["tup"], tuple)
    _equal_trees({k: v for k, v in got.items() if k != "np"},
                 {k: v for k, v in state.items() if k != "np"})
    assert isinstance(got["np"], np.ndarray) and np.array_equal(got["np"], state["np"])
    assert half["pose"].R.dtype == torch.float64
    with pytest.raises(ValueError):
        with CheckpointManager(str(tmp_path / "c")) as mgr:
            mgr.restore(0, template=dict(state, pair=_Pair(torch.arange(4), [torch.zeros(2), 5])))


def test_checkpoint_save_copies_before_returning(tmp_path):
    """The caller may change its state as soon as ``save`` returns."""
    state = _state()
    want = {k: v.clone() for k, v in state.items()}
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(0, state)
        state["X"].add_(100.0)
        state["mask"].fill_(False)
        _equal_trees(mgr.restore(0, template=want), want)
        with pytest.raises(FileExistsError):
            mgr.save(0, state)
        mgr.save(0, state, force=True)
        _equal_trees(mgr.restore(0, template=want), state)


def test_checkpoint_max_to_keep(tmp_path):
    d = str(tmp_path / "c")
    with CheckpointManager(d, max_to_keep=2) as mgr:
        for step in range(5):
            mgr.save(step, {"x": torch.full((2,), float(step))})
        mgr.wait()
        assert mgr.all_steps() == [3, 4]
        assert float(mgr.restore()["x"][0]) == 4.0
    assert sorted(os.listdir(d)) == ["3", "4"]


def test_checkpoint_interrupted_save_leaves_no_step(tmp_path, monkeypatch):
    d = str(tmp_path / "c")
    with CheckpointManager(d) as mgr:
        mgr.save(0, _state())
        mgr.wait()

        def broken_save(obj, path):
            with open(path, "wb") as f:
                f.write(b"half a checkpoint")
            raise OSError("disk full")

        monkeypatch.setattr(tck.torch, "save", broken_save)
        mgr.save(1, _state())
        with pytest.raises(OSError, match="disk full"):
            mgr.wait()
        monkeypatch.undo()
        assert mgr.all_steps() == [0] and mgr.latest_step() == 0
        assert os.listdir(os.path.join(d, "1")) == []          # no file, no temporary
        _equal_trees(mgr.restore(template=_state()), _state())


# -- profiling ----------------------------------------------------------------

def test_roofline_report_runs():
    """tests/test_utils.py::test_roofline_report_runs: the same matmul, its
    flop count equal to XLA's cost analysis of the JAX version."""
    a = torch.ones(512, 512)
    b = torch.ones(512, 512)
    rep = roofline(lambda x, y: x @ y, a, b, iters=3)
    assert rep.wall_s > 0 and rep.peak_tflops > 0
    assert rep.flops == 2 * 512 ** 3
    assert rep.bytes_accessed == 3 * 512 * 512 * 4
    assert rep.unit == "flops" and rep.bound_by == "operations"
    assert 0 < rep.fraction_of_roofline and rep.bound_s > 0
    jrep = j_roofline(lambda x, y: x @ y, jnp.ones((512, 512)), jnp.ones((512, 512)), iters=3)
    if jrep.flops is not None:
        assert rep.flops == jrep.flops
    str(rep)


def test_roofline_of_a_kernel_reads_its_work_count():
    """A kernel wrapper's counts come from ``ops/kernels/work.py`` (the
    flop counter sees none of a ctypes launch): K1 on 2 pairs with a
    quarter of the train rows masked counts only the valid rows."""
    from points_matching_tpu_torch.ops.kernels.matching_kernel import fused_l2_top2
    from points_matching_tpu_torch.ops.kernels.work import bound, l2_top2_work

    g = torch.Generator().manual_seed(0)
    q, t = torch.randn(2, 64, 32, generator=g), torch.randn(2, 48, 32, generator=g)
    t_mask = torch.ones(2, 48, dtype=torch.bool)
    t_mask[:, :12] = False
    rep = roofline(fused_l2_top2, q, t, t_mask, iters=2)
    valid = 2 * 36
    assert rep.flops == 2 * 64 * valid * 32 and rep.unit == "flops"
    assert rep.bytes_accessed == 4 * (2 * 64 + valid) * 32 + 2 * 48 + 16 * 2 * 64
    w = l2_top2_work(q, t, t_mask)
    assert rep.bound_s == bound(w, chip_peaks("cpu"))["bound_ms"] / 1e3


def test_chip_peaks_known():
    peaks = chip_peaks("cpu")
    assert peaks["flops"] > 0 and peaks["hbm_gbps"] > 0
    ref = j_chip_peaks()                   # the JAX test process runs on the CPU
    assert (peaks["flops"], peaks["hbm_gbps"]) == (ref["flops"], ref["hbm_gbps"])
    assert peaks["instr_per_s"] > 0 and peaks["popc_per_s"] > 0


def test_trace_records_the_stages(tmp_path):
    with trace(str(tmp_path / "tr")):
        with stage("pmt.test_stage"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "pmt.test_stage" in names
    assert any(n and "mm" in n for n in names)


# -- sanitize --------------------------------------------------------------------

def test_checked_flags_nan():
    def bad(x):
        return torch.sqrt(x - 10.0)               # negative → NaN

    _, err = checked(bad)(torch.tensor(1.0))
    with pytest.raises(SanitizerError, match="nan.*sqrt"):
        err.throw()
    out, err = checked(bad)(torch.tensor(11.0))  # clean input passes
    err.throw()
    assert err.get() is None
    np.testing.assert_allclose(out.numpy(), 1.0)


def test_checked_flags_oob_gather():
    """An out-of-range index is flagged with its op, and the run goes on
    with it clamped, as the JAX version's gather does."""
    x = torch.arange(4.0)
    out, err = checked(lambda x, i: x[i])(x, torch.tensor([7]))
    with pytest.raises(SanitizerError, match="out-of-bounds index in index"):
        err.throw()
    ref = jax.jit(lambda x, i: x[i])(jnp.arange(4.0), jnp.asarray([7]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    _, err = checked(lambda x, i: torch.gather(x, 0, i))(x, torch.tensor([1, -1]))
    with pytest.raises(SanitizerError, match="gather"):
        err.throw()
    # a mask spans its dimensions: the index after it addresses dimension 2
    y, m = torch.arange(24.0).reshape(2, 3, 4), torch.tensor([[1, 0, 1], [0, 1, 0]]).bool()
    out, err = checked(lambda y, i: y[m, i])(y, torch.tensor([3, 0, 1]))
    assert err.get() is None and torch.equal(out, y[m, torch.tensor([3, 0, 1])])
    _, err = checked(lambda y, i: y[m, i])(y, torch.tensor([4, 0, 1]))
    assert err.get() == "out-of-bounds index in index (index check)"
    _, err = checked(lambda a, b: a // b)(torch.tensor([4, 2]), torch.tensor([2, 0]))
    with pytest.raises(SanitizerError, match="division by zero"):
        err.throw()


def test_checked_reports_the_first_failure():
    def two_faults(x):
        y = torch.log(x)                           # NaN first
        return y, x[torch.tensor([9])]

    _, err = checked(two_faults)(torch.tensor([-1.0, 2.0]))
    assert err.get().startswith("nan in the output of log")
    _, err = checked(two_faults, errors={"index"})(torch.tensor([-1.0, 2.0]))
    assert err.get().startswith("out-of-bounds index in index")


def test_check_finite_and_index_record_only_inside_checked():
    x = torch.tensor([1.0, float("inf")])
    check_finite(x, "outside")                     # no checked run: nothing
    check_index(torch.tensor([5]), 2, "outside")

    def fn(x):
        check_finite(x[:1], "head")
        check_index(torch.tensor([1]), 2, "fine")
        check_finite(x, "kernel output")
        return x

    _, err = checked(fn)(x)
    with pytest.raises(SanitizerError, match="kernel output"):
        err.throw()


@pytest.fixture(scope="module")
def graft_pair():
    import __graft_entry__ as ge

    from points_matching_tpu_torch.core.config import TwoViewConfig
    from points_matching_tpu_torch.core.convert import config_from_dict

    _, (img1, img2, _) = ge.entry()
    cfg = config_from_dict(dataclasses.asdict(ge._small_config()), TwoViewConfig)
    return torch.from_numpy(np.array(img1)), torch.from_numpy(np.array(img2)), cfg


def test_checked_frontend_clean(graft_pair):
    """detect → describe → match (kernel K1 through its wrapper) runs clean
    under the checks, and the checks change no bit of the result."""
    from points_matching_tpu_torch.ops.descriptors import extract_descriptors
    from points_matching_tpu_torch.ops.detect import detect_keypoints
    from points_matching_tpu_torch.ops.matching import match_descriptors

    img1, img2, cfg = graft_pair

    def frontend(a, b):
        k1, k2 = detect_keypoints(a, cfg.detector), detect_keypoints(b, cfg.detector)
        d1 = extract_descriptors(a, k1, cfg.descriptor)
        d2 = extract_descriptors(b, k2, cfg.descriptor)
        return match_descriptors(d1, d2, cfg.matcher).distance

    out, err = checked(frontend)(img1, img2)
    err.throw()
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, frontend(img1, img2))


def test_checked_two_view_pipeline_clean_and_flags_a_nan(graft_pair):
    """The whole two-view pipeline, RANSAC (K3, K2) included, runs clean
    under the checks with the same result; a NaN in one input pixel is
    flagged at the first op it reaches."""
    from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline

    img1, img2, cfg = graft_pair

    def run(a, b):
        return two_view_pipeline(a, b, torch.Generator().manual_seed(0), cfg).estimate.F

    F, err = checked(run)(img1, img2)
    err.throw()
    assert torch.equal(F, run(img1, img2))
    bad = img1.clone()
    bad[40, 50] = float("nan")
    _, err = checked(run)(bad, img2)
    with pytest.raises(SanitizerError, match="nan in the output of convolution"):
        err.throw()


def test_debug_mode_restores_flags():
    before = debug_nans_enabled()
    with debug_mode(nans=True):
        assert debug_nans_enabled() is True
        torch.sqrt(torch.tensor(4.0))
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(torch.tensor(-4.0))
        with debug_mode(nans=False):
            assert debug_nans_enabled() is False
            torch.sqrt(torch.tensor(-4.0))          # not trapped
        assert debug_nans_enabled() is True
    assert debug_nans_enabled() == before
    torch.sqrt(torch.tensor(-4.0))                  # not trapped after the block


# -- metrics, logging ----------------------------------------------------------

def test_metrics_equal_jax():
    rng = np.random.RandomState(4)
    gt = np.cumsum(rng.randn(50, 3), 0)
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    est = 0.5 * gt @ R.T + np.array([1.0, -2.0, 0.5]) + 0.05 * rng.randn(50, 3)
    np.testing.assert_allclose(tm.align_trajectories(est, gt),
                               jm.align_trajectories(est, gt), atol=1e-12, rtol=0)
    for align in (True, False):
        a, b = tm.ate_rmse(est, gt, align), jm.ate_rmse(est, gt, align)
        assert abs(a - b) <= 1e-12
    assert tm.ate_rmse(est, gt) < 0.25 < tm.ate_rmse(est, gt, align=False)


def test_metrics_registry_and_timer():
    m, jmet = tm.Metrics(), jm.Metrics()
    for reg in (m, jmet):
        reg.log("a", 1)
        reg.log("a", 3)
        reg.log("b", 2.5)
    assert m.summary() == jmet.summary() and m.dump_json() == jmet.dump_json()
    assert m.last("a") == 3 and m.mean("a") == 2 and m.last("zz") is None
    with tm.Timer(m, "t"):
        pass
    assert m.last("t") >= 0


def test_get_logger_once():
    from points_matching_tpu_torch.utils.logging import get_logger

    a, b = get_logger("pmt_test"), get_logger("pmt_test")
    assert a is b and len(a.handlers) == 1 and not a.propagate
