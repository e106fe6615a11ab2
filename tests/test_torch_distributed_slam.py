"""The port's distributed SLAM (``pipelines/distributed_slam.py``, BASELINE
config 4) against the JAX package on the CPU: the host steps (segments,
Sim(3), the merge) on the same inputs, both submaps built as one batch with
the reference's RANSAC draws injected, and the whole pipeline on
tests/test_distributed_slam.py's 16-frame sequence at world sizes 1 (this
process), 2 (data) and 4 (2 data × 2 model; gloo workers,
``tests/torch_dist_worker.py``).  World size 1 builds both segments as one
batch, each rank of world size 2 one segment alone.  The workers start
first and run while the references compute."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.core.types import Descriptors as JDescriptors  # noqa: E402
from points_matching_tpu.geometry.ransac import sample_index_sets  # noqa: E402
from points_matching_tpu.ops.matching import match_descriptors as j_match  # noqa: E402
from points_matching_tpu.pipelines import distributed_slam as jds  # noqa: E402
from points_matching_tpu_torch.core.config import SfMConfig  # noqa: E402
from points_matching_tpu_torch.core.convert import (  # noqa: E402
    config_from_dict, intrinsics_from_numpy)
from points_matching_tpu_torch.data.synthetic import make_stacked_sequence  # noqa: E402
from points_matching_tpu_torch.pipelines import distributed_slam as tds  # noqa: E402
from points_matching_tpu_torch.pipelines.sfm import associate  # noqa: E402
from points_matching_tpu_torch.utils.evaluation import (  # noqa: E402
    absolute_trajectory_error, umeyama_alignment)
from test_distributed_slam import (  # noqa: E402
    _make_stacked_sequence, _random_rotations, _small_config)
from torch_dist_worker import Spawned, one_thread  # noqa: E402

SEG, OVERLAP, SEED = 10, 4, 0
SLAM_FRAMES = 8           # the SLAM demo's tree (tests/test_torch_slam_demo.py's)
ATE_BOUND = 0.05        # tests/test_distributed_slam.py's bound (extent 4.5)
_index_sets = jax.jit(sample_index_sets, static_argnums=(2, 3))
_match = jax.jit(j_match, static_argnums=2)


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def seq():
    kps, dsc, msk, K, gt = _make_stacked_sequence(num_frames=16)
    jcfg = _small_config(SEG)
    return dict(kps=_np(kps), desc=_np(dsc), mask=_np(msk), K=K, gt=np.asarray(gt),
                jcfg=jcfg, cfg=config_from_dict(dataclasses.asdict(jcfg), SfMConfig),
                tK=intrinsics_from_numpy(K, device="cpu"))


@pytest.fixture(scope="module")
def workers(seq, tmp_path_factory):
    """World sizes 4 and 2 in one 4-rank group, started now and joined by
    the first test that needs them; the same group also runs the SLAM
    demo's ``--distributed`` path on a rendered KITTI-format tree."""
    from points_matching_tpu_torch.data.render import render_sequence, write_kitti_format

    imgs, pos, quats, K = render_sequence(num_frames=SLAM_FRAMES, num_landmarks=400,
                                          image_size=(320, 240), seed=0, loop=True,
                                          x_span=(-6.0, 6.75))
    tree = str(tmp_path_factory.mktemp("kitti"))
    write_kitti_format(tree, imgs, pos, quats, K)
    inputs = dict(jobs=["dslam", "slam_demo"], kps=seq["kps"], desc=seq["desc"],
                  mask=seq["mask"], K=_np(seq["K"].matrix()),
                  config=dataclasses.asdict(seq["jcfg"]),
                  kw=dict(segment_len=SEG, overlap=OVERLAP, seed=SEED),
                  slam_tree=tree, slam_frames=SLAM_FRAMES, slam_features=128)
    return Spawned(4, inputs, tmp_path_factory.mktemp("dslam"))


@pytest.fixture(scope="module")
def jax_submaps(seq, workers):
    """The reference's segments and submaps (``build_submaps``, no mesh) and
    its merge of them."""
    sk, sd, sm, _ = jds.segment_frames(jnp.asarray(seq["kps"]), jnp.asarray(seq["desc"]),
                                       jnp.asarray(seq["mask"]), SEG, OVERLAP)
    states, regs = jds.build_submaps(sk, sd, sm, seq["K"], jax.random.PRNGKey(SEED),
                                     seq["jcfg"])
    states, regs = jax.device_get((states, regs))
    return dict(segments=(sk, sd, sm), states=states, regs=_np(regs),
                merged=jds.merge_submaps(states, regs, OVERLAP))


@pytest.fixture(scope="module")
def ws1(seq, workers):
    """World size 1: the port in this process, no mesh, on one thread as
    in the workers (so that the submaps are the same computation)."""
    with one_thread():
        return tds.run_distributed_slam(
            torch.from_numpy(seq["kps"]), torch.from_numpy(seq["desc"]),
            torch.from_numpy(seq["mask"]), seq["tK"], seq["cfg"], segment_len=SEG,
            overlap=OVERLAP, seed=SEED)


# -- host steps ------------------------------------------------------------------

@pytest.mark.parametrize("segment_len,overlap", [(10, 4), (6, 3), (8, 4)])
def test_segment_frames_matches_jax(seq, segment_len, overlap):
    args = [seq[k] for k in ("kps", "desc", "mask")]
    want = jds.segment_frames(*(jnp.asarray(a) for a in args), segment_len, overlap)
    got = tds.segment_frames(*(torch.from_numpy(a) for a in args), segment_len, overlap)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    # the overlap frames are shared by consecutive segments
    np.testing.assert_array_equal(got[0][0, -overlap:].numpy(), got[0][1, :overlap].numpy())


@pytest.mark.parametrize("segment_len,overlap", [(10, 2), (4, 4), (40, 4)])
def test_segment_frames_rejects_what_jax_rejects(seq, segment_len, overlap):
    args = [torch.from_numpy(seq[k]) for k in ("kps", "desc", "mask")]
    with pytest.raises(ValueError):
        jds.segment_frames(*(jnp.asarray(a.numpy()) for a in args), segment_len, overlap)
    with pytest.raises(ValueError):
        tds.segment_frames(*args, segment_len, overlap)


def _sim3_case(collinear: bool):
    """tests/test_distributed_slam.py's two Sim(3) cases."""
    if collinear:
        rng = np.random.RandomState(1)
        J = 4
        R_l = _random_rotations(rng, 1).repeat(J, axis=0)
        t_l = -np.einsum("jik,jk->ji", R_l, np.outer(np.arange(J), [1.0, 0.0, 0.0]))
        c, R_a, t_a = 0.8, _random_rotations(rng, 1)[0], np.asarray([1.0, 2.0, 3.0])
    else:
        rng = np.random.RandomState(0)
        J = 5
        R_l = _random_rotations(rng, J)
        t_l = rng.randn(J, 3)
        c, R_a, t_a = 1.7, _random_rotations(rng, 1)[0], np.asarray([0.3, -1.0, 2.0])
    return R_l, t_l, c, R_a, t_a


@pytest.mark.parametrize("collinear", [False, True], ids=["roundtrip", "collinear"])
def test_sim3_from_shared_frames_matches_jax(collinear):
    R_l, t_l, c, R_a, t_a = _sim3_case(collinear)
    R_g, t_g = tds._apply_sim3_to_poses(R_l, t_l, c, R_a, t_a)
    jR_g, jt_g = jds._apply_sim3_to_poses(R_l, t_l, c, R_a, t_a)
    np.testing.assert_allclose(R_g, jR_g, atol=1e-6)
    np.testing.assert_allclose(t_g, jt_g, atol=1e-6)
    valid = np.ones(len(R_l), bool)
    got = tds.sim3_from_shared_frames(R_l, t_l, R_g, t_g, valid)
    want = jds.sim3_from_shared_frames(R_l, t_l, R_g, t_g, valid)
    for g, w, truth in zip(got, want, (c, R_a, t_a)):
        np.testing.assert_allclose(g, w, atol=1e-6)
        np.testing.assert_allclose(g, truth, atol=1e-5)


def test_sim3_needs_two_shared_frames():
    R_l, t_l, c, R_a, t_a = _sim3_case(False)
    R_g, t_g = tds._apply_sim3_to_poses(R_l, t_l, c, R_a, t_a)
    one = np.zeros(len(R_l), bool)
    one[2] = True
    with pytest.raises(ValueError, match=">= 2 shared"):
        tds.sim3_from_shared_frames(R_l, t_l, R_g, t_g, one)


def test_merge_submaps_of_the_reference_submaps_equals_its_merge(jax_submaps):
    """The port's merge fed the reference's own submaps: poses to 1e-6, the
    validity, observation and landmark-mask arrays exactly, landmarks to
    1e-6."""
    R, t, valid, merged = tds.merge_submaps(jax_submaps["states"], jax_submaps["regs"],
                                            OVERLAP)
    jR, jt, jvalid, jmerged = jax_submaps["merged"]
    np.testing.assert_allclose(R, jR, atol=1e-6)
    np.testing.assert_allclose(t, jt, atol=1e-6)
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.all()
    assert set(merged) == set(jmerged)
    for k in ("obs_cam", "obs_lm", "obs_uv", "obs_mask", "lm_valid"):
        assert merged[k].dtype == jmerged[k].dtype, k
        np.testing.assert_array_equal(merged[k], jmerged[k], err_msg=k)
    np.testing.assert_allclose(merged["X"], jmerged["X"], atol=1e-6)


@pytest.fixture(scope="module")
def injected_batch(seq, jax_submaps):
    """Both segments built by the port as one batch (``build_submap`` over
    the segment axis) with the reference's own minimal sets injected for
    each: segment s's bootstrap candidates' and every frame's PnP draws,
    from the keys ``build_submaps`` gives segment s."""
    jcfg, cfg, K = seq["jcfg"], seq["cfg"], seq["tK"]
    sk, sd, sm = (_np(x) for x in jax_submaps["segments"])
    S = sk.shape[0]
    H = jcfg.two_view.ransac.num_hypotheses
    f_idx, step_keys = [], []
    for s, key in enumerate(jax.random.split(jax.random.PRNGKey(SEED), S)):
        key, k0 = jax.random.split(key)
        m = _match(JDescriptors(data=jnp.asarray(sd[s, 0]), mask=jnp.asarray(sm[s, 0])),
                   JDescriptors(data=jnp.asarray(sd[s, 1]), mask=jnp.asarray(sm[s, 1])),
                   jcfg.two_view.matcher)
        f_idx.append(np.stack([_np(_index_sets(k, m.mask, H, 8))
                               for k in jax.random.split(k0, jcfg.bootstrap_candidates)]))
        keys, k = {}, key
        for i in range(2, SEG):
            k, ki = jax.random.split(k)
            keys[i] = jax.random.split(ki)[0]
        step_keys.append(keys)

    def pnp_samples(i, state):
        a = associate(state, torch.from_numpy(sd[:, i]), torch.from_numpy(sm[:, i]), cfg)
        return torch.from_numpy(np.stack([
            _np(_index_sets(step_keys[s][i], jnp.asarray(a.corr_m[s].numpy()),
                            jcfg.pnp_hypotheses, 6, jnp.asarray(a.logits[s].numpy())))
            for s in range(S)]))

    return tds.build_submap(torch.from_numpy(sk), torch.from_numpy(sd), torch.from_numpy(sm),
                            K, None, cfg, f_samples=torch.from_numpy(np.stack(f_idx)),
                            pnp_samples=pnp_samples)


@pytest.mark.parametrize("segment", [0, 1])
def test_build_submap_with_injected_draws_matches_jax(jax_submaps, injected_batch, segment):
    """Each segment of the port's batched build with the reference's draws
    injected (``injected_batch``) against the reference's ``vmap`` build:
    the same frames registered, the same map sizes, camera centres within
    1.5e-2 of each other.  One registration from one state agrees to 1e-4
    (tests/test_torch_sfm.py); over the segment's windowed BAs and its
    full-window BA (f32 LM with PCG in both packages) the centres drift
    apart by up to 7.7e-3, 0.3 % of the segment's 2.7-unit extent."""
    states, regs = injected_batch
    js, s = jax_submaps["states"], segment
    np.testing.assert_array_equal(regs[s].numpy(), jax_submaps["regs"][s])
    assert regs[s].all()
    for f in ("num_cams", "num_lms", "num_obs"):
        assert int(getattr(states, f)[s]) == int(getattr(js, f)[s]), f
    n = int(states.num_cams[s])
    R, t = states.poses.R[s, :n], states.poses.t[s, :n]
    c = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    jR, jt = _np(js.poses.R[s])[:n], _np(js.poses.t[s])[:n]
    jc = -np.einsum("cji,cj->ci", jR, jt)
    np.testing.assert_allclose(c.numpy(), jc, atol=1.5e-2)


# -- the whole pipeline at world sizes 1, 2 and 4 --------------------------------

def _runs(ws1, workers):
    res = workers.results()
    return {1: dict(trajectory=ws1.trajectory, cam_valid=ws1.cam_valid,
                    regs=ws1.registered_per_segment, X=ws1.X,
                    initial_cost=float(ws1.ba_stats.initial_cost),
                    final_cost=float(ws1.ba_stats.final_cost)),
            **{ws: [r["dslam"][f"ws{ws}"] for r in res] for ws in (2, 4)}}


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_run_distributed_slam_passes_the_reference_gates(seq, ws1, workers, ws):
    """tests/test_distributed_slam.py's gates at every world size: every
    frame of both segments registered, every camera valid, ATE under 0.05,
    the global BA's cost does not rise."""
    runs = _runs(ws1, workers)[ws]
    for run in ([runs] if ws == 1 else runs):
        assert run["regs"].shape == (2, SEG) and run["regs"].all()
        assert run["cam_valid"].all()
        traj = torch.from_numpy(run["trajectory"]).float()
        gt = torch.from_numpy(seq["gt"][:len(traj)]).float()
        ate = float(absolute_trajectory_error(traj, gt, torch.from_numpy(run["cam_valid"])).rmse)
        assert ate < ATE_BOUND, ate
        assert run["final_cost"] <= run["initial_cost"]


@pytest.mark.parametrize("ws", [2, 4])
def test_world_sizes_agree(ws1, workers, ws):
    """Each segment draws from its own generator, seeded from (seed,
    segment), so the submaps do not depend on the world size.  World size 2
    (data only) then runs the same global BA as one process: equal
    trajectories.  World size 4 splits the global BA's observations over 2
    model ranks, whose f32 partial sums round in another order: aligned
    trajectories within 1e-4 (~0.002 % of the extent), costs within 1e-4."""
    runs = _runs(ws1, workers)
    one = runs[1]
    for run in runs[ws]:
        np.testing.assert_array_equal(run["regs"], one["regs"])
        np.testing.assert_array_equal(run["cam_valid"], one["cam_valid"])
        if ws == 2:
            np.testing.assert_array_equal(run["trajectory"], one["trajectory"])
            assert run["final_cost"] == one["final_cost"]
        else:
            a, b = (torch.from_numpy(r["trajectory"]).double() for r in (run, one))
            s, R, t = umeyama_alignment(a, b)
            assert float((s * a @ R.T + t - b).norm(dim=-1).max()) < 1e-4
            np.testing.assert_allclose(run["final_cost"], one["final_cost"], rtol=1e-4)
        np.testing.assert_allclose(run["initial_cost"], one["initial_cost"], rtol=1e-6)


def test_stacked_sequence_matches_the_reference():
    """The port's copy of the config-4 stand-in's generator
    (``data/synthetic.make_stacked_sequence``, which ``chip_smoke.py`` runs)
    gives the reference's masks and descriptors exactly and its pixels and
    centres to f32 rounding, on a short corridor and on the default box."""
    for kw in (dict(num_frames=24, num_landmarks=600, n_feat=128, seed=5, corridor=True),
               dict(num_frames=16)):
        kps, dsc, msk, K, gt = _make_stacked_sequence(**kw)
        tkps, tdsc, tmsk, tK, tgt = make_stacked_sequence(device="cpu", **kw)
        np.testing.assert_array_equal(tmsk.numpy(), _np(msk))
        np.testing.assert_array_equal(tdsc.numpy(), _np(dsc))
        np.testing.assert_allclose(tkps.numpy(), _np(kps), rtol=0, atol=1e-3)
        np.testing.assert_allclose(tgt, gt, rtol=0, atol=1e-5)
        assert [float(v) for v in (tK.fx, tK.fy, tK.cx, tK.cy)] == \
            [float(v) for v in (K.fx, K.fy, K.cx, K.cy)]


def test_slam_demo_distributed_under_torchrun(workers):
    """``pipelines/slam.run_slam_demo(distributed=True)`` with ``torchrun``'s
    variables set (the 4-rank group): a 2 × 2 data × model mesh, 2 segments
    of 5 with an overlap of 3; every rank returns the same result, under
    config 4's gates."""
    res = [r["slam_demo"] for r in workers.results()]
    for r in res:
        nums = r["numbers"]
        assert nums["world_size"] == 4 and nums["mesh"] == [2, 2] and nums["segments"] == 2
        assert r["regs"].all() and nums["registered"] == nums["registered_slots"] == 10
        assert nums["cameras_valid"] == nums["cameras"] == 7
        assert nums["ate"] < 0.1 * nums["extent"]
        assert nums["ba_final_cost"] <= nums["ba_initial_cost"]
        np.testing.assert_array_equal(r["trajectory"], res[0]["trajectory"])
