"""The port's parallel layer (``points_matching_tpu_torch/parallel``) against
single-process results and the JAX package, on the CPU: real processes in
one gloo group (``tests/torch_dist_worker.py``), the JAX references on this
process's faked 8-device mesh.

One group of 4 ranks runs every job of the module (meshes of 4 ranks, and
2-rank axes of a 2 × 2 mesh for world size 2), and a second group of 2
ranks is the counterpart of tests/test_multihost.py; both start before the
references are computed and are joined with a deadline.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.ba.lm import bundle_adjust as j_bundle_adjust  # noqa: E402
from points_matching_tpu.core import config as jc  # noqa: E402
from points_matching_tpu.geometry.ransac import sample_minimal_points  # noqa: E402
from points_matching_tpu.parallel import all_pairs_scores as j_all_pairs  # noqa: E402
from points_matching_tpu.parallel import distributed_bundle_adjust as j_dist_ba  # noqa: E402
from points_matching_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh  # noqa: E402
from points_matching_tpu.parallel.sharded_ba import (  # noqa: E402
    distributed_bundle_adjust_sparse as j_dist_sparse)
from points_matching_tpu.pipelines.staged_two_view import (  # noqa: E402
    staged_two_view as j_staged)
from points_matching_tpu_torch.ba.lm import bundle_adjust, make_ba_state  # noqa: E402
from points_matching_tpu_torch.ba.sparse import bundle_adjust_sparse  # noqa: E402
from points_matching_tpu_torch.core.config import BAConfig, TwoViewConfig  # noqa: E402
from points_matching_tpu_torch.core.convert import (  # noqa: E402
    config_from_dict, intrinsics_from_numpy, pose_from_numpy)
from points_matching_tpu_torch.parallel import Comm, all_pairs_scores  # noqa: E402
from points_matching_tpu_torch.parallel.pipeline import pipeline_stages  # noqa: E402
from points_matching_tpu_torch.pipelines.staged_two_view import staged_two_view  # noqa: E402
from points_matching_tpu_torch.pipelines.two_view import two_view_pipeline  # noqa: E402
from test_parallel import _ba_setup, _random_descriptors  # noqa: E402
from test_pipeline_parallel import _pair_batch, _staged_config, _wire  # noqa: E402
from test_sparse_ba import _problem_pair  # noqa: E402
from torch_dist_worker import (  # noqa: E402
    Spawned, one_thread, pipeline_test_stages, sparse_problem)

RATIO = 0.9
ONE_ITER = dict(max_iterations=1)
RAGGED = dict(max_iterations=4, rtol=0.0, pcg_iterations=25)


def _np(x):
    return np.array(x)


def _ns(**kw):
    return types.SimpleNamespace(**kw)


def _sparse_inputs(state):
    return _ns(poses=_ns(R=_np(state.poses.R), t=_np(state.poses.t)), X=_np(state.X),
               cam_idx=_np(state.cam_idx), lm_idx=_np(state.lm_idx), uv=_np(state.uv),
               obs_mask=_np(state.obs_mask), cam_fixed=_np(state.cam_fixed),
               lm_fixed=_np(state.lm_fixed))


def _orb_config():
    return dataclasses.replace(
        _staged_config(),
        detector=jc.DetectorConfig(kind="fast", threshold=5.0, max_keypoints=64,
                                   num_octaves=1, layers_per_octave=2, border=8),
        descriptor=jc.DescriptorConfig(kind="orb"),
        matcher=jc.MatcherConfig(metric="hamming", filter="ratio", ratio=0.95))


@pytest.fixture(scope="module")
def problems():
    """Every input of the module's jobs (numpy), from the JAX tests' own
    generators."""
    d, m = _random_descriptors(jax.random.PRNGKey(42), 16)
    m = m.at[3, :4].set(False)                          # a few masked rows
    _, one, K = _problem_pair(seed=3, noise=0.3)
    one = one.replace(X=one.X + 0.08 * jax.random.normal(jax.random.PRNGKey(11), one.X.shape))
    _, ragged, _ = _problem_pair(seed=9, cameras=4, landmarks=21, drop=0.3)
    assert ragged.num_observations % 4 != 0            # the case under test
    dense, K_dense = _ba_setup()
    img1, img2, keys = _pair_batch()
    return dict(desc=_np(d), mask=_np(m), ratio=RATIO,
                one_state=_sparse_inputs(one), ragged_state=_sparse_inputs(ragged),
                K=_np(K.matrix()), one_cfg=ONE_ITER, ragged_cfg=RAGGED,
                dense_state=dict(poses=_ns(R=_np(dense.poses.R), t=_np(dense.poses.t)),
                                 X=_np(dense.X), uv=_np(dense.uv), mask=_np(dense.mask)),
                K_dense=_np(K_dense.matrix()),
                wires={mb: {k: _np(v) for k, v in _wire(mb, key=mb).items()}
                       for mb in (1, 4, 9)},
                img1=_np(img1), img2=_np(img2), keys=_np(keys),
                jax_state=dict(one=one, ragged=ragged, dense=dense, K=K, K_dense=K_dense))


@pytest.fixture(scope="module")
def jax_staged(problems):
    """The JAX staged pipeline (``mesh=None``: the reference shows it equal
    to its 4-stage mesh) for SURF and ORB, and the minimal sets its RANSAC
    drew from each pair's key."""
    out = {}
    img1, img2, keys = (jnp.asarray(problems[k]) for k in ("img1", "img2", "keys"))
    for name, cfg in (("surf", _staged_config()), ("orb", _orb_config())):
        w = jax.device_get(jax.jit(lambda a, b, k, c=cfg: j_staged(a, b, k, c))(img1, img2, keys))
        sp = [sample_minimal_points(keys[i], jnp.asarray(w["mmask"][i] != 0),
                                    cfg.ransac.num_hypotheses, 8,
                                    (jnp.asarray(w["p1"][i]), jnp.asarray(w["p2"][i])))
              for i in range(img1.shape[0])]
        out[name] = dict(wire=w, config=dataclasses.asdict(cfg),
                         sp1=np.stack([_np(s[0]) for s in sp]),
                         sp2=np.stack([_np(s[1]) for s in sp]))
    return out


@pytest.fixture(scope="module")
def ranks(problems, jax_staged, tmp_path_factory):
    """The 4-rank group's results, one dict a rank, and the 2-rank group's."""
    inputs = {k: v for k, v in problems.items() if k != "jax_state"}
    inputs["staged"] = {
        name: dict(config=ref["config"], sp1=ref["sp1"], sp2=ref["sp2"],
                   img1=problems["img1"], img2=problems["img2"],
                   seeds=np.arange(problems["img1"].shape[0]))
        for name, ref in jax_staged.items()}
    inputs["jobs"] = ["init", "comm", "ring", "sparse_ba", "dense_ba", "pipeline", "staged",
                      "checkpoint"]
    inputs["ckpt_dir"] = str(tmp_path_factory.mktemp("ckpt"))
    four = Spawned(4, inputs, tmp_path_factory.mktemp("ranks4"))
    two = Spawned(2, {"jobs": ["init", "multihost"]}, tmp_path_factory.mktemp("ranks2"))
    return four.results(), two.results()


# -- Comm -------------------------------------------------------------------

def test_comm_noop_backend():
    c = Comm(None)
    x = torch.arange(4.0)
    assert c.size() == 1 and c.index() == 0
    for out in (c.psum(x), c.pmean(x), c.pmax(x), c.pmin(x), c.ring_shift(x),
                c.reduce_scatter(x), c.all_to_all(x, 0, 0), c.ppermute(x, [(0, 0)]),
                c.broadcast(x), c.all_gather(x, tiled=True)):
        assert torch.equal(out, x)
    assert torch.equal(c.all_gather(x), x[None])


def test_initialize_distributed_from_the_environment(ranks):
    four, two = ranks
    assert [r["init"] for r in four] == [dict(rank=i, world=4, backend="gloo")
                                         for i in range(4)]
    assert [r["init"]["world"] for r in two] == [2, 2]


def test_two_process_host_local_to_global_and_psum(ranks):
    """The counterpart of tests/test_multihost.py: 2 processes, each feeding
    its own 4 rows; the global array holds both blocks and one cross-process
    sum gives 4·3·1 + 4·3·2 = 36 on both."""
    _, two = ranks
    want = torch.cat([torch.full((4, 3), 1.0), torch.full((4, 3), 2.0)])
    for r in two:
        assert torch.equal(r["multihost"]["global_rows"], want)
        assert float(r["multihost"]["total"]) == 36.0


def _xs(world):
    return [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(world)]


@pytest.mark.parametrize("name", ["psum", "pmean", "pmax", "pmin", "gather",
                                  "gather_tiled1", "reduce_scatter", "all_to_all",
                                  "ppermute", "ring1", "ring_back", "broadcast",
                                  "gather_bool"])
def test_comm_collectives_match_single_process(ranks, name):
    four, _ = ranks
    xs = _xs(4)
    ys = [torch.arange(8.0).reshape(4, 2) + 100 * r for r in range(4)]
    total = sum(ys)
    for r, res in enumerate(four):
        want = {
            "psum": sum(xs), "pmean": sum(xs) / 4, "pmax": torch.stack(xs).amax(0),
            "pmin": torch.stack(xs).amin(0), "gather": torch.stack(xs),
            "gather_tiled1": torch.cat(xs, 1), "reduce_scatter": total[r:r + 1],
            "all_to_all": torch.cat([y[r:r + 1] for y in ys], 1),
            # 0→1, 1→2, 2→0: rank 3 receives nothing (zeros)
            "ppermute": {0: xs[2], 1: xs[0], 2: xs[1], 3: torch.zeros(2, 3)}[r],
            "ring1": xs[(r - 1) % 4], "ring_back": xs[(r + 1) % 4], "broadcast": xs[2],
            "gather_bool": torch.tensor([[True, True], [False, True]] * 2),
        }[name]
        assert res["comm"]["index"] == r and res["comm"]["size"] == 4
        assert res["comm"][name].dtype == want.dtype
        assert torch.equal(res["comm"][name], want), (name, r)


def test_comm_on_a_mesh_axis(ranks):
    """The data axis of a 2 × 2 mesh: ranks {0, 2} and {1, 3}; ``shard``
    gives data rank d the d-th half of the leading axis, ``replicated``
    rank 0's value everywhere."""
    four, _ = ranks
    xs = _xs(4)
    for r, res in enumerate(four):
        assert torch.equal(res["comm"]["shard"], torch.arange(8.0)[4 * (r // 2):4 * (r // 2) + 4])
        assert torch.equal(res["comm"]["replicated"], xs[0])
        peer = (r + 2) % 4
        assert res["comm"]["sub_index"] == r // 2 and res["comm"]["sub_size"] == 2
        assert torch.equal(res["comm"]["sub_psum"], xs[r] + xs[peer])
        assert torch.equal(res["comm"]["sub_ring"], xs[peer])


def test_fault_hook_perturbs_psum(ranks):
    """The counterpart of tests/test_parallel.py::test_fault_injection_hook_perturbs_psum:
    a hook doubling every psum input doubles the sum and leaves other
    collectives alone."""
    four, _ = ranks
    for res in four:
        assert torch.equal(res["comm"]["clean"], torch.full((3,), 4.0))
        assert torch.equal(res["comm"]["faulty"], torch.full((3,), 8.0))
        assert torch.equal(res["comm"]["faulty_max"], torch.ones(3))


# -- all pairs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ring_refs(problems):
    """The single-process scores and the reference's 8-way ring, once for
    every world size."""
    desc, mask = (torch.from_numpy(problems[k]) for k in ("desc", "mask"))
    mesh = make_mesh((8,), (DATA_AXIS,))
    return (all_pairs_scores(desc, mask, RATIO),
            _np(j_all_pairs(jnp.asarray(problems["desc"]), jnp.asarray(problems["mask"]),
                            mesh=mesh, ratio=RATIO)))


@pytest.mark.parametrize("ws", [2, 4])
def test_ring_all_pairs_matches_single_process_and_jax(ranks, ring_refs, ws):
    four, _ = ranks
    single, ref = ring_refs
    for res in four:
        got = res["ring"][f"ws{ws}"]
        assert torch.equal(got, single)
        # the reference's GEMM sums in another order: differences only at
        # f32 near-ties of the ratio test (none on this input)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_ring_all_pairs_rejects_indivisible(ranks):
    four, _ = ranks
    for res in four:
        assert res["ring"]["indivisible"] is not None
        assert "must divide the data axis" in res["ring"]["indivisible"]


def test_all_pairs_with_no_mesh_is_the_ring_on_one_rank(problems):
    """``mesh=None`` keeps the single-process answer: every ordered pair of
    the reference's block function."""
    from points_matching_tpu_torch.parallel.all_pairs import pair_scores_plain

    desc, mask = (torch.from_numpy(problems[k]) for k in ("desc", "mask"))
    assert torch.equal(all_pairs_scores(desc, mask, RATIO),
                       pair_scores_plain(desc, mask, desc, mask, RATIO))


# -- sharded BA ----------------------------------------------------------------

def _port_sparse(problems, name, cfg, dtype=torch.float32):
    with one_thread():
        return bundle_adjust_sparse(*sparse_problem(problems[f"{name}_state"], problems["K"],
                                                    dtype), BAConfig(**cfg))


def _jax_sparse(problems, name, cfg):
    js = problems["jax_state"]
    return j_dist_sparse(js[name], js["K"], make_mesh((8,), (MODEL_AXIS,)), jc.BAConfig(**cfg))


@pytest.fixture(scope="module")
def sparse_refs(problems):
    """The sharded sparse BA's references, once for every world size: the
    port's one process (float64 for both problems; float32 for both) and
    the reference's 8-way runs (float32)."""
    cfgs = dict(one=ONE_ITER, ragged=RAGGED)
    return dict(
        float64={n: _port_sparse(problems, n, c, torch.float64) for n, c in cfgs.items()},
        float32={n: _port_sparse(problems, n, c) for n, c in cfgs.items()},
        jax={n: _jax_sparse(problems, n, c) for n, c in cfgs.items()})


@pytest.mark.parametrize("ws", [2, 4])
@pytest.mark.parametrize("name,cfg", [("one", ONE_ITER), ("ragged", RAGGED)])
def test_sharded_sparse_ba_is_exact_in_float64(ranks, sparse_refs, ws, name, cfg):
    """In float64 the observation-sharded sums equal one process's to
    rounding (cost rtol 1e-9, X atol 1e-9): the sharding, the masked
    padding of the ragged case (O does not divide 4) and the reductions are
    exact.  In float32 the same steps differ by up to ~5e-4 after one
    iteration: 50 PCG steps amplify the reductions' rounding (the f32 cost
    itself is 2e-3 from the f64 one on this problem)."""
    four, _ = ranks
    out, st = sparse_refs["float64"][name]
    for res in four:
        got = res["sparse_ba"][f"{name}_ws{ws}_float64"]
        assert got["iterations"] == int(st.iterations)
        np.testing.assert_allclose(got["final_cost"], float(st.final_cost), rtol=1e-9)
        np.testing.assert_allclose(got["X"].numpy(), out.X.numpy(), atol=1e-9)
        assert got["final_cost"] < got["initial_cost"]


@pytest.mark.parametrize("ws", [2, 4])
def test_sharded_sparse_ba_one_iteration(ranks, sparse_refs, ws):
    """One float32 LM iteration against one process and against the
    reference's observation-sharded BA on 8 devices: cost rtol 3e-3, X atol
    1e-3 (measured: 5.1e-4 from one process; the port's one process is
    1.0e-3 from the reference's, whose own 8-way run is 1.0e-4 from its one
    device)."""
    four, _ = ranks
    out, st = sparse_refs["float32"]["one"]
    jout, jst = sparse_refs["jax"]["one"]
    for res in four:
        got = res["sparse_ba"][f"one_ws{ws}_float32"]
        assert got["iterations"] == 1
        for want_cost, want_X in ((float(st.final_cost), out.X.numpy()),
                                  (float(jst.final_cost), _np(jout.X))):
            np.testing.assert_allclose(got["final_cost"], want_cost, rtol=3e-3)
            np.testing.assert_allclose(got["X"].numpy(), want_X, atol=1e-3)
        assert got["final_cost"] < got["initial_cost"]
    key = f"one_ws{ws}_float32"
    assert all(torch.equal(r["sparse_ba"][key]["X"], four[0]["sparse_ba"][key]["X"])
               for r in four)                   # every rank holds the same answer


@pytest.mark.parametrize("ws", [2, 4])
def test_sharded_sparse_ba_pads_ragged_observation_axis(ranks, sparse_refs, ws):
    """The counterpart of tests/test_sparse_ba.py's ragged case in float32:
    4 iterations, final cost within 1e-2 of one process and of the
    reference's 8-way run (measured 2.9e-3; exactness is the float64
    test's)."""
    four, _ = ranks
    _, st = sparse_refs["float32"]["ragged"]
    _, jst = sparse_refs["jax"]["ragged"]
    for res in four:
        got = res["sparse_ba"][f"ragged_ws{ws}_float32"]
        assert got["final_cost"] < got["initial_cost"]
        np.testing.assert_allclose(got["final_cost"], float(st.final_cost), rtol=1e-2)
        np.testing.assert_allclose(got["final_cost"], float(jst.final_cost), rtol=1e-2)


def test_sparse_ba_group_none_is_bit_for_bit(problems):
    """``group=None`` reduces nothing: the result equals the call without
    the argument, bit for bit."""
    state, K = sparse_problem(problems["one_state"], problems["K"], torch.float32)
    a, sa = bundle_adjust_sparse(state, K, BAConfig(max_iterations=2))
    b, sb = bundle_adjust_sparse(state, K, BAConfig(max_iterations=2), group=None)
    assert torch.equal(a.X, b.X) and torch.equal(a.poses.R, b.poses.R)
    assert torch.equal(sa.final_cost, sb.final_cost)


def _port_dense(problems, it):
    d = problems["dense_state"]
    state = make_ba_state(pose_from_numpy(d["poses"], device="cpu"), torch.from_numpy(d["X"]),
                          torch.from_numpy(d["uv"]), torch.from_numpy(d["mask"]))
    return bundle_adjust(state, intrinsics_from_numpy(problems["K_dense"], device="cpu"),
                         BAConfig(max_iterations=it))


@pytest.fixture(scope="module")
def dense_refs(problems):
    """For 1 and 5 LM iterations, once for every world size: the port's one
    process, the reference's 8-way landmark-sharded run and its one
    device."""
    js = problems["jax_state"]
    mesh = make_mesh((1, 8), (DATA_AXIS, MODEL_AXIS))
    return {it: (*_port_dense(problems, it),
                 j_dist_ba(js["dense"], js["K_dense"], mesh, jc.BAConfig(max_iterations=it)),
                 j_bundle_adjust(js["dense"], js["K_dense"], jc.BAConfig(max_iterations=it))[1])
            for it in (1, 5)}


@pytest.mark.parametrize("ws", [2, 4])
def test_sharded_dense_ba_matches_single_process_and_jax(ranks, dense_refs, ws):
    """tests/test_parallel.py's tolerances against the port's one process:
    one LM iteration to rtol 1e-4 in cost and 1e-3 in X; after 5, where
    accept/reject may flip on rounding, both costs fall and agree to 10 %.
    Against the reference (its 8-way and one-device runs) the first
    iteration is held to rtol 1e-3: the two packages' one-process costs are
    2.3e-4 apart already (f32 Cholesky of the reduced system)."""
    four, _ = ranks
    for it in (1, 5):
        out, st, (jout, jst), jref = dense_refs[it]
        for res in four:
            got = res["dense_ba"][f"ws{ws}_it{it}"]
            assert got["final_cost"] < got["initial_cost"]
            np.testing.assert_allclose(got["final_cost"], float(st.final_cost),
                                       rtol=1e-4 if it == 1 else 0.1)
            for want in (float(jst.final_cost), float(jref.final_cost)):
                np.testing.assert_allclose(got["final_cost"], want,
                                           rtol=1e-3 if it == 1 else 0.1)
            if it == 1:
                np.testing.assert_allclose(got["X"].numpy(), out.X.numpy(), atol=1e-3)
                np.testing.assert_allclose(got["X"].numpy(), _np(jout.X), atol=1e-3)


def test_sharded_dense_ba_rejects_indivisible(ranks):
    four, _ = ranks
    for res in four:
        assert "must divide the model axis" in res["dense_ba"]["indivisible"]


# -- pipeline ------------------------------------------------------------------

def _compose(fns, xs):
    outs = []
    for m in range(next(iter(xs.values())).shape[0]):
        x = {k: v[m] for k, v in xs.items()}
        for f in fns:
            x = f(x)
        outs.append(x)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("mb", [1, 4, 9])
def test_pipeline_stages_equal_the_composition(ranks, problems, stages, mb):
    """GPipe over 2 and 4 ranks equals the sequential composition exactly,
    on every rank; the reference's own stages, written in torch."""
    four, _ = ranks
    xs = {k: torch.from_numpy(v) for k, v in problems["wires"][mb].items()}
    fns = pipeline_test_stages()[:stages]
    want = _compose(fns, xs)
    assert all(torch.equal(v, want[k]) for k, v in pipeline_stages(fns, xs).items())
    for res in four:
        got = res["pipeline"][f"s{stages}_m{mb}"]
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_pipeline_stage_that_changes_the_wire_raises():
    """Every stage must keep the wire's leaves, shapes and dtypes (over ranks
    the wire travels in buffers sized from stage 0's input): a stage that
    changes a dtype or a shape, or drops a leaf, raises with the leaf's
    name, on one process as on a mesh."""
    xs = {"a": torch.zeros(2, 3), "b": torch.zeros(2, 4, dtype=torch.int32)}
    for bad, leaf in ((lambda w: dict(w, a=w["a"].double()), "a"),
                      (lambda w: dict(w, b=w["b"][:2]), "b"),
                      (lambda w: {"a": w["a"]}, "b")):
        with pytest.raises(ValueError, match=f"stage 1 changed the wire's leaves \\['{leaf}'\\]"):
            pipeline_stages([lambda w: dict(w), bad], xs)


def test_pipeline_stage_count_mismatch_raises(ranks):
    four, _ = ranks
    for res in four:
        assert "stage axis" in res["pipeline"]["mismatch"]


# -- staged two-view -------------------------------------------------------------

def _port_cfg(ref):
    return config_from_dict(ref["config"], TwoViewConfig)


@pytest.mark.parametrize("name", ["surf", "orb"])
def test_staged_two_view_four_stages_equal_one_process(ranks, problems, jax_staged, name):
    """4 ranks (one stage each) give the wire of the composed stages on one
    process, leaf for leaf (the same eager ops on the same inputs)."""
    four, _ = ranks
    ref = jax_staged[name]
    samples = (torch.from_numpy(ref["sp1"]), torch.from_numpy(ref["sp2"]))
    img1, img2 = (torch.from_numpy(problems[k]) for k in ("img1", "img2"))
    seeds = torch.arange(img1.shape[0])
    with one_thread():
        one = staged_two_view(img1, img2, seeds, _port_cfg(ref), samples=samples)
    for res in four:
        got = res["staged"][name]
        assert set(got) == set(one)
        for k in one:
            assert torch.equal(got[k], one[k]), k
    assert int(one["kmask1"].sum()) > 0 and int(one["mmask"].sum()) > 0


@pytest.mark.parametrize("name", ["surf", "orb"])
def test_staged_two_view_equals_two_view_pipeline(ranks, problems, jax_staged, name):
    """Each pair of the 4-stage run equals ``two_view_pipeline`` on it with
    the same minimal sets: keypoints, matches and inliers exactly, F to
    1e-5."""
    four, _ = ranks
    ref = jax_staged[name]
    cfg = _port_cfg(ref)
    got = four[0]["staged"][name]
    for i in range(problems["img1"].shape[0]):
        with one_thread():
            res = two_view_pipeline(torch.from_numpy(problems["img1"][i]),
                                    torch.from_numpy(problems["img2"][i]), None, cfg,
                                    samples=(torch.from_numpy(ref["sp1"][i]),
                                             torch.from_numpy(ref["sp2"][i])))
        assert torch.equal(got["xy1"][i], res.kps1.xy)
        assert torch.equal(got["kmask2"][i] != 0, res.kps2.mask)
        assert torch.equal(got["mmask"][i] != 0, res.matches.mask)
        assert torch.equal(got["p1"][i], res.p1) and torch.equal(got["p2"][i], res.p2)
        assert int(got["num_inliers"][i]) == int(res.estimate.num_inliers)
        torch.testing.assert_close(got["F"][i], res.estimate.F, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["surf", "orb"])
def test_staged_two_view_matches_jax(ranks, jax_staged, name):
    """Against the reference's staged pipeline with its own RANSAC draws
    injected, to tests/test_torch_two_view.py's tolerances: equal keypoint
    counts, matches within 2, inliers within 5 %, |⟨F_jax, F_torch⟩| ≥ 0.99."""
    four, _ = ranks
    ref = jax_staged[name]["wire"]
    got = four[0]["staged"][name]
    assert got["desc1"].dtype == (torch.int32 if name == "orb" else torch.float32)
    for i in range(got["F"].shape[0]):
        for k in ("kmask1", "kmask2"):
            assert int(got[k][i].sum()) == int(ref[k][i].sum())
        n_ref = int(ref["mmask"][i].sum())
        assert abs(int(got["mmask"][i].sum()) - n_ref) <= 2
        i_ref = int(ref["num_inliers"][i])
        assert i_ref >= 8
        assert abs(int(got["num_inliers"][i]) - i_ref) <= max(1, 0.05 * i_ref)
        assert abs(float(np.sum(np.asarray(ref["F"][i]) * got["F"][i].numpy()))) >= 0.99


# -- checkpoint (utils/checkpoint.py) ---------------------------------------

def test_checkpoint_restore_sharded(ranks):
    """tests/test_utils.py::test_checkpoint_restore_sharded on the 4-rank
    group: a [16, 4] tensor sharded over a ``model`` axis of 4, each rank
    saving and restoring its own shard, the shards' gather equal to the
    reference test's input; a step only rank 0 wrote never counts."""
    four, _ = ranks
    x = np.arange(64.0).reshape(16, 4)
    for rank, r in enumerate(four):
        out = r["checkpoint"]
        assert torch.equal(out["restored"], out["local"])
        np.testing.assert_array_equal(out["restored"].numpy(), x[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(out["gathered"].numpy(), x)
        assert out["steps"] == [0] and out["latest"] == 0
