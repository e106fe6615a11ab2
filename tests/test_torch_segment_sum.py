"""The sort-once segmented sum (``ops/kernels/segment_sum.py``) and the
layouts of the port's sparse BA and pose graph that run through it, against
numpy and the JAX package on the same seeded inputs, on the CPU (the
kernel's plain version; ``tests/test_torch_cuda.py`` holds the kernel to it
on the card)."""
import dataclasses
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from points_matching_tpu.ba import sparse as jsp  # noqa: E402
from points_matching_tpu.core.config import BAConfig as JBAConfig  # noqa: E402
from points_matching_tpu.core.types import CameraIntrinsics as JK  # noqa: E402
from points_matching_tpu.data.synthetic import make_sparse_ba_problem  # noqa: E402
from points_matching_tpu_torch.ba import pose_graph as tpg  # noqa: E402
from points_matching_tpu_torch.ba import sparse as tsp  # noqa: E402
from points_matching_tpu_torch.core.config import BAConfig  # noqa: E402
from points_matching_tpu_torch.core.convert import sparse_ba_state_from_numpy  # noqa: E402
from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose, flat_rows  # noqa: E402
from points_matching_tpu_torch.ops.kernels import segment_sum as ss  # noqa: E402
from points_matching_tpu_torch.ops.kernels.work import segment_sum_work  # noqa: E402


def _case(name):
    """(index [*B, O], n rows, mask) of a plan case, from a seeded numpy
    generator."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "random":            # 40 rows, a third of them never hit
        rows = rng.choice(40, 27, replace=False)
        return rng.choice(rows, 700), 40, rng.rand(700) > 0.2
    if name == "one_row":           # every entry on row 7: three pieces
        return np.full(600, 7), 10, np.ones(600, bool)
    if name == "all_masked":
        return rng.randint(0, 12, 300), 12, np.zeros(300, bool)
    if name == "no_entries":
        return np.zeros(0, np.int64), 5, np.zeros(0, bool)
    if name == "padded":            # 3 problems of 8 rows, the last 10 of 50 padding
        idx = rng.randint(0, 8, (3, 50))
        mask = np.ones((3, 50), bool)
        mask[:, 40:] = False
        return flat_rows(torch.from_numpy(idx), 8).numpy(), 24, mask
    if name == "lengths":           # rows on each side of a chunk and a piece, shuffled,
        lengths = np.array(LENGTHS)  # then a masked tail of 50
        idx = np.concatenate([rng.permutation(np.repeat(np.arange(lengths.size), lengths)),
                              rng.randint(0, lengths.size, 50)])
        return idx, lengths.size, np.arange(idx.size) < lengths.sum()
    raise ValueError(name)


LENGTHS = (0, 1, 31, 32, 33, 255, 256, 257, 131072)   # entries a row of the "lengths" case


@pytest.mark.parametrize("name", ["random", "one_row", "all_masked", "no_entries", "padded",
                                  "lengths"])
def test_plan_matches_numpy_stable_argsort_and_bincount(name):
    index, n, mask = _case(name)
    plan = ss.build_plan(torch.from_numpy(index), n, torch.from_numpy(mask))
    keys = np.where(mask, index, n).reshape(-1)
    valid = keys[keys < n]
    np.testing.assert_array_equal(plan.perm.numpy(), np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(
        plan.offsets.numpy(), np.concatenate([[0], np.cumsum(np.bincount(valid, minlength=n))]))
    # pieces of PIECE entries for the long rows only
    counts = np.bincount(valid, minlength=n)
    starts = np.concatenate([[0], np.cumsum(np.where(counts > ss.SHORT,
                                                     -(-counts // ss.PIECE), 0))])
    np.testing.assert_array_equal(plan.pieces.numpy(), starts)
    # each piece's row: the row whose pieces hold it; n past the last piece
    rows = np.searchsorted(starts, np.arange(ss.max_pieces(keys.size, n)), side="right") - 1
    np.testing.assert_array_equal(plan.piece_rows.numpy(), rows)
    assert all(x.dtype == torch.int32 and x.is_contiguous() for x in plan[:4])
    assert plan.scratch == {}
    assert plan.num_rows == n and plan.num_entries == keys.size
    assert starts[-1] <= ss.max_pieces(keys.size, n) == plan.piece_rows.shape[0]
    assert (plan.piece_rows.numpy()[starts[-1]:] == n).all()


@pytest.mark.parametrize("width", [3, 6, 9, 36])
def test_segment_sum_matches_jax_segment_sum(width):
    """The plain segmented sum against ``jax.ops.segment_sum`` of the
    masked values (f32, 1e-6 relative to each row's absolute sum)."""
    index, n, mask = _case("random")
    v = np.random.RandomState(width).randn(index.size, width).astype(np.float32)
    got = ss.segment_sum(torch.from_numpy(v),
                         ss.build_plan(torch.from_numpy(index), n, torch.from_numpy(mask)))
    ref = jax.ops.segment_sum(jnp.where(jnp.asarray(mask)[:, None], jnp.asarray(v), 0.0),
                              jnp.asarray(index), num_segments=n)
    scale = np.zeros((n, width), np.float32)
    np.add.at(scale, index[mask], np.abs(v[mask]))
    assert np.all(np.abs(got.numpy() - np.asarray(ref)) <= 1e-6 * scale)
    assert got.shape == (n, width)


def test_segment_sum_of_a_batch_equals_each_problem_alone():
    """3 problems of 8 rows side by side (``flat_rows``, padding masked)
    give each problem the bits it gets alone."""
    index, n, mask = _case("padded")
    local = index - 8 * np.arange(3)[:, None]
    v = np.random.RandomState(1).randn(3, 50, 6, 6).astype(np.float32)
    batch = ss.segment_sum(torch.from_numpy(v.reshape(150, 6, 6)),
                           ss.build_plan(torch.from_numpy(index), n, torch.from_numpy(mask)))
    for s in range(3):
        alone = ss.segment_sum(torch.from_numpy(v[s]), ss.build_plan(
            torch.from_numpy(local[s]), 8, torch.from_numpy(mask[s])))
        assert torch.equal(batch[8 * s:8 * (s + 1)], alone)


def test_segment_sum_plain_in_float64_and_its_checks():
    """f64 rows (the pose graph's) sum in entry order, as index_add_ over
    the unsorted index does; a CPU call launches nothing and makes no
    scratch; bad inputs raise."""
    index, n, mask = _case("random")
    v = torch.from_numpy(np.random.RandomState(2).randn(index.size, 6))
    plan = ss.build_plan(torch.from_numpy(index), n, torch.from_numpy(mask))
    before = ss.segment_sum.launches
    got = ss.segment_sum(v, plan)
    ref = torch.zeros(n, 6, dtype=torch.float64).index_add_(
        0, torch.from_numpy(index[mask]), v[torch.from_numpy(mask)])
    assert got.dtype == torch.float64 and torch.equal(got, ref)
    assert ss.segment_sum.launches == before and plan.scratch == {}
    with pytest.raises(ValueError):
        ss.segment_sum(v[:-1], plan)
    with pytest.raises(TypeError):
        ss.segment_sum(v.long(), plan)
    with pytest.raises(ValueError):                    # values and plan on two devices
        ss.segment_sum(v.to("meta"), plan)


def test_rounding_bound_counts_the_kernels_roundings():
    """The card's tolerance (kernel against the float64 plain sum): γ of the
    kernel's (32 − 1) + (8 − 1) + (pieces − 1) roundings at f32 (a chunk's,
    a piece's, the row's) plus γ of the reference's m − 1 at f64, times
    Σ|v|; a row that lost one chunk of 32 entries lies beyond it."""
    index, n, _ = _case("one_row")
    v = torch.from_numpy(np.random.RandomState(6).randn(index.size, 3).astype(np.float32))
    plan = ss.build_plan(torch.from_numpy(index), n)
    bound = ss.rounding_bound(v, plan)
    u, u64 = 2.0 ** -24, 2.0 ** -53
    k, m = 31 + 7 + 3 - 1, index.size
    want = (k * u / (1 - k * u) + (m - 1) * u64 / (1 - (m - 1) * u64)) * v.abs().double().sum(0)
    torch.testing.assert_close(bound[7], want, rtol=1e-12, atol=0)
    assert bound.dtype == torch.float64 and not bound[torch.arange(n) != 7].any()
    exact = ss.segment_sum_plain(v.double(), plan)
    dropped = exact[7] - v[ss.PIECE:ss.PIECE + 32].double().sum(0)
    assert bool(((dropped - exact[7]).abs() > bound[7]).all())


def _order_by_loops(v, plan):
    """The kernel's order written out entry by entry in numpy (the module
    docstring): chunks of 32 from 0 in entry order, chunks in pieces of 8
    from 0, pieces from 0, each add rounded to the values' dtype."""
    perm, offsets = plan.perm.numpy(), plan.offsets.numpy()
    zero = np.zeros(v.shape[1:], v.dtype)
    out = []
    for r in range(plan.num_rows):
        rows = v[perm[offsets[r]:offsets[r + 1]]]
        row = zero
        for p in range(0, len(rows), 256):
            piece = zero
            for c in range(p, min(p + 256, len(rows)), 32):
                chunk = zero
                for e in rows[c:min(c + 32, p + 256, len(rows))]:
                    chunk = chunk + e
                piece = piece + chunk
            row = row + piece
        out.append(row)
    return np.stack(out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sum_ordered_adds_in_the_kernels_order(dtype):
    """``segment_sum_ordered`` against the order written out as loops, bit
    for bit: rows of 0 to 1,100 entries (one chunk, a partial piece,
    several pieces), a fifth of the entries masked."""
    lengths = np.array([0, 1, 2, 31, 32, 33, 64, 255, 256, 257, 300, 600, 1100])
    rng = np.random.RandomState(11)
    index = rng.permutation(np.repeat(np.arange(lengths.size), lengths))
    mask = rng.rand(index.size) > 0.2
    v = (rng.randn(index.size, 3) * 10.0 ** rng.randint(-3, 4, (index.size, 1))).astype(dtype)
    plan = ss.build_plan(torch.from_numpy(index), lengths.size, torch.from_numpy(mask))
    got = ss.segment_sum_ordered(torch.from_numpy(v), plan)
    assert got.dtype == torch.from_numpy(v).dtype
    np.testing.assert_array_equal(got.numpy(), _order_by_loops(v, plan))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_ordered_within_rounding_bound_of_plain(dtype):
    """The kernel's order against the float64 plain sum within
    ``rounding_bound``, at rows of 0, 1, 31, 32, 33, 255, 256, 257 and
    131,072 entries with a masked tail; W = 36."""
    index, n, mask = _case("lengths")
    v = torch.from_numpy(np.random.RandomState(12).randn(index.size, 36)).to(dtype)
    plan = ss.build_plan(torch.from_numpy(index), n, torch.from_numpy(mask))
    got = ss.segment_sum_ordered(v, plan)
    ref = ss.segment_sum_plain(v.double(), plan)
    assert got.shape == (n, 36) and got.dtype == dtype
    assert bool(((got.double() - ref).abs() <= ss.rounding_bound(v, plan)).all())
    assert not got[0].any() and torch.equal(got[1], v[int(plan.perm[plan.offsets[1]])])


def test_segment_sum_ordered_batch_equals_each_problem_alone_and_repeats():
    """In the kernel's order, 3 problems side by side give each problem the
    bits it gets alone (rows of up to 600 entries: several pieces), and two
    calls give the same bits."""
    S, n, O = 3, 6, 900
    rng = np.random.RandomState(13)
    idx = rng.randint(0, n, (S, O))
    mask = rng.rand(S, O) > 0.1
    v = rng.randn(S, O, 9).astype(np.float32)
    batch_plan = ss.build_plan(flat_rows(torch.from_numpy(idx), n), S * n,
                               torch.from_numpy(mask))
    batch = ss.segment_sum_ordered(torch.from_numpy(v.reshape(S * O, 9)), batch_plan)
    assert torch.equal(batch, ss.segment_sum_ordered(torch.from_numpy(v.reshape(S * O, 9)),
                                                     batch_plan))
    for s in range(S):
        alone = ss.segment_sum_ordered(torch.from_numpy(v[s]), ss.build_plan(
            torch.from_numpy(idx[s]), n, torch.from_numpy(mask[s])))
        assert torch.equal(batch[s * n:(s + 1) * n], alone)


def test_segment_sum_work_counts_valid_entries():
    index, n, mask = _case("random")
    v = torch.zeros(index.size, 9)
    plan = ss.build_plan(torch.from_numpy(index), n, torch.from_numpy(mask))
    w = segment_sum_work(v, plan)
    valid, rows = int(mask.sum()), len(np.unique(index[mask]))
    assert w.bytes == 4 * 9 * (valid + n) + 4 * valid + 8 * (n + 1)
    assert w.ops == (valid - rows) * 9 and w.unit == "instr"
    assert segment_sum_work(v.double(), plan).unit == "f64_instr"


# -- the sparse BA's layouts ----------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    """tests/test_sparse_ba.py::test_sorted_layout_matches_scatter's setup:
    a corridor problem with a third of the observations dropped and the
    landmarks perturbed; the JAX package's sorted layout run on it (one jit)."""
    p = make_sparse_ba_problem(seed=7, num_cameras=6, num_landmarks=64, obs_per_landmark=4)
    rng = np.random.RandomState(7)
    mask = np.array(p["obs_mask"]) & (rng.rand(np.asarray(p["obs_mask"]).size) > 0.3)
    X = np.asarray(p["X"]) + 0.03 * rng.randn(64, 3).astype(np.float32)
    js = jsp.make_sparse_ba_state(p["poses"], jnp.asarray(X), p["cam_idx"], p["lm_idx"],
                                  p["uv"], jnp.asarray(mask))
    K = np.asarray(p["K"])
    jK = JK(*(jnp.float32(K[i, j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2))))
    cfg = dict(max_iterations=8, rtol=0.0, pcg_iterations=20)
    jo, jst = jax.jit(jsp.bundle_adjust_sparse, static_argnames="config")(
        js, jK, config=JBAConfig(obs_layout="sorted", **cfg))
    tK = CameraIntrinsics(*(torch.tensor(K[i, j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2))))
    return dict(js=js, tK=tK, cfg=cfg, jo=jo, jst=jst)


@pytest.mark.parametrize("layout", ["sorted", "scatter", "auto"])
def test_sparse_bundle_adjust_layouts_match_reference_sorted(problem, layout):
    """The port's ``bundle_adjust_sparse`` in each layout against the JAX
    package's ``'sorted'`` layout, within tests/test_torch_ba.py's sparse
    bounds (costs 1 %, structure 5e-3) and test_sparse_ba.py's (poses
    5e-3, seen landmarks 2e-2)."""
    ts = sparse_ba_state_from_numpy(problem["js"], device="cpu")
    to, tst = tsp.bundle_adjust_sparse(ts, problem["tK"],
                                       BAConfig(obs_layout=layout, **problem["cfg"]))
    jo, jst = problem["jo"], problem["jst"]
    np.testing.assert_allclose(float(tst.initial_cost), float(jst.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(tst.final_cost), float(jst.final_cost), rtol=1e-2)
    assert float(tst.final_cost) < 0.2 * float(tst.initial_cost)
    np.testing.assert_allclose(to.poses.t.numpy(), np.asarray(jo.poses.t), atol=5e-3)
    seen = np.zeros(64, bool)
    seen[np.asarray(problem["js"].lm_idx)[np.asarray(problem["js"].obs_mask)]] = True
    np.testing.assert_allclose(to.X.numpy()[seen], np.asarray(jo.X)[seen], atol=2e-2)
    assert torch.equal(to.cam_idx, ts.cam_idx) and torch.equal(to.lm_idx, ts.lm_idx)


def test_sparse_layouts_agree_bit_for_bit_on_the_cpu(problem):
    """Every layout runs the plans (the reference's two layouts give the
    same bits): 'sorted' and 'scatter' equal bit for bit; an unknown layout
    raises."""
    ts = sparse_ba_state_from_numpy(problem["js"], device="cpu")
    out = {}
    for layout in ("sorted", "scatter"):
        out[layout] = tsp.bundle_adjust_sparse(ts, problem["tK"],
                                               BAConfig(obs_layout=layout, **problem["cfg"]))
    (a, sa), (b, sb) = out["sorted"], out["scatter"]
    assert torch.equal(a.X, b.X) and torch.equal(a.poses.t, b.poses.t)
    assert torch.equal(sa.final_cost, sb.final_cost)
    with pytest.raises(ValueError):
        tsp.bundle_adjust_sparse(ts, problem["tK"], BAConfig(obs_layout="onehot"))


def test_sparse_normal_equations_carry_the_plans(problem):
    """``sparse_plans`` builds one plan a side; the normal equations carry
    them into the solve (and build the same ones when given none); their
    sums equal ``index_add_`` over the observation index in observation
    order, bit for bit on the CPU."""
    ts = sparse_ba_state_from_numpy(problem["js"], device="cpu")
    r, Jc, Jl = tsp.sparse_residuals_and_jacobians(ts, problem["tK"])
    w = ts.obs_mask.float()
    plans = tsp.sparse_plans(ts)
    assert plans[0].num_rows == ts.num_cameras and plans[1].num_rows == ts.num_landmarks
    assert int(plans[0].offsets[-1]) == int(ts.obs_mask.sum())
    eq = tsp.build_sparse_normal_equations(ts, r, Jc, Jl, w, plans=plans)
    own = tsp.build_sparse_normal_equations(ts, r, Jc, Jl, w)
    assert eq.cam_plan is plans[0] and eq.lm_plan is plans[1]
    for a, b in zip(own.cam_plan[:4] + own.lm_plan[:4], plans[0][:4] + plans[1][:4]):
        assert torch.equal(a, b)
    valid = ts.obs_mask
    for name, index, n in (("U", eq.cam, ts.num_cameras), ("V", eq.lm, ts.num_landmarks)):
        blocks = (Jc.transpose(-1, -2) @ Jc if name == "U" else Jl.transpose(-1, -2) @ Jl)
        got = tsp._seg_sum(blocks * w[:, None, None], index, n, eq.cam_plan if name == "U"
                           else eq.lm_plan)
        ref = torch.zeros_like(got).index_add_(0, index[valid], (blocks * w[:, None, None])[valid])
        assert torch.equal(got, ref), name
    for name in ("U", "V", "bc", "bl"):
        assert torch.equal(getattr(eq, name), getattr(own, name)), name
    lam = torch.tensor(1e-2)
    for a, b in zip(tsp.solve_sparse_schur_pcg(eq, lam, 10), tsp.solve_sparse_schur_pcg(own, lam, 10)):
        assert torch.equal(a, b)


# -- the pose graph -----------------------------------------------------------------

class _Scatter(NamedTuple):
    index: torch.Tensor
    n: int


def _scatter_sums(monkeypatch):
    """The pose graph's sums as they were before the plans: ``index_add_``
    over the unsorted index, in entry order."""
    monkeypatch.setattr(tpg, "build_plan", lambda index, n, mask=None: _Scatter(index.long(), n))
    monkeypatch.setattr(tpg, "segment_sum", lambda v, p: torch.zeros(
        (p.n, *v.shape[1:]), dtype=v.dtype).index_add_(0, p.index, v))


def _chain():
    from points_matching_tpu_torch.geometry.se3 import so3_exp

    rng = np.random.RandomState(4)
    P = 24
    ang = torch.from_numpy(np.linspace(0, 2 * np.pi, P, endpoint=False))
    R = so3_exp(torch.stack([torch.zeros_like(ang), ang, torch.zeros_like(ang)], -1))
    c = torch.stack([5 * torch.cos(ang), torch.zeros_like(ang), 5 * torch.sin(ang)], -1)
    gt = Pose(R=R.float(), t=(-(R @ c[..., None])[..., 0]).float())
    g = tpg.make_odometry_chain(gt, noise=torch.from_numpy(0.02 * rng.randn(P - 1, 6)),
                                loop_edges=((0, P - 1), (3, 20)))
    start = Pose(R=so3_exp(torch.from_numpy(0.05 * rng.randn(P, 3))).float() @ gt.R,
                 t=gt.t + torch.from_numpy(0.1 * rng.randn(P, 3)).float())
    return g.replace(poses=start)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_through_the_plan_equals_its_scatter_result(monkeypatch, solver):
    """``optimize_pose_graph`` (float64 inside) through the plans against the
    same graph summed by ``index_add_`` in edge order, its result before the
    plans: equal bit for bit on the CPU."""
    g = _chain()
    got, gst = tpg.optimize_pose_graph(g, solver=solver, pcg_iterations=40)
    _scatter_sums(monkeypatch)
    ref, rst = tpg.optimize_pose_graph(g, solver=solver, pcg_iterations=40)
    assert torch.equal(got.poses.R, ref.poses.R) and torch.equal(got.poses.t, ref.poses.t)
    assert torch.equal(gst.final_cost, rst.final_cost)
    assert int(gst.iterations) == int(rst.iterations)
    assert float(gst.final_cost) < 1e-2 * float(gst.initial_cost)


def test_pose_graph_dense_blocks_equal_index_put_accumulate():
    """The dense system's blocks through the (row pose, column pose) plan
    equal ``index_put_(accumulate=True)`` of the four block lists into
    [6P, 6P], in float64, bit for bit."""
    g = _chain()
    P, E = g.num_poses, g.num_edges
    rng = np.random.RandomState(5)
    Hii, Hjj, Hij = (torch.from_numpy(rng.randn(E, 6, 6)) for _ in range(3))
    blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])
    got = ss.segment_sum(blocks, tpg._block_plan(g)).reshape(P, P, 6, 6).transpose(1, 2)
    H = torch.zeros(6 * P, 6 * P, dtype=torch.float64)
    k = torch.arange(6)
    ei, ej = g.edges_i.long(), g.edges_j.long()
    for rows, cols, b in ((ei, ei, Hii), (ej, ej, Hjj), (ei, ej, Hij),
                          (ej, ei, Hij.transpose(-1, -2))):
        r = (rows[:, None] * 6 + k)[:, :, None].expand_as(b)
        c = (cols[:, None] * 6 + k)[:, None, :].expand_as(b)
        H.index_put_((r, c), b, accumulate=True)
    assert torch.equal(got.reshape(6 * P, 6 * P), H)


def test_sparse_batch_plans_equal_each_problem_alone(problem):
    """The BA's plans over a batch of 3 copies of the problem (one with
    other observations dropped) give each problem its own plan's sums."""
    ts = sparse_ba_state_from_numpy(problem["js"], device="cpu")
    masks = [ts.obs_mask, ts.obs_mask & (torch.arange(ts.num_observations) % 3 != 0),
             ts.obs_mask]
    batch = dataclasses.replace(
        ts, poses=Pose(R=ts.poses.R.expand(3, -1, -1, -1), t=ts.poses.t.expand(3, -1, -1)),
        X=ts.X.expand(3, -1, -1), cam_idx=ts.cam_idx.expand(3, -1),
        lm_idx=ts.lm_idx.expand(3, -1), uv=ts.uv.expand(3, -1, -1),
        obs_mask=torch.stack(masks), cam_fixed=ts.cam_fixed.expand(3, -1),
        lm_fixed=ts.lm_fixed.expand(3, -1))
    v = torch.from_numpy(np.random.RandomState(3).randn(3, ts.num_observations, 6, 6)
                         .astype(np.float32))
    cp, lp = tsp.sparse_plans(batch)
    U, V = ss.segment_sum(v.reshape(-1, 6, 6), cp), ss.segment_sum(v[..., :3, :3].reshape(-1, 3, 3), lp)
    C, L = ts.num_cameras, ts.num_landmarks
    for s in range(3):
        one = dataclasses.replace(ts, obs_mask=masks[s])
        c1, l1 = tsp.sparse_plans(one)
        assert torch.equal(U[s * C:(s + 1) * C], ss.segment_sum(v[s], c1))
        assert torch.equal(V[s * L:(s + 1) * L], ss.segment_sum(v[s, :, :3, :3].contiguous(), l1))
