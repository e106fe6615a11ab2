"""Worker processes of the port's multi-process CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_distributed_slam.py``).

``spawn`` starts ``world`` processes of this file that join one gloo
process group from the ``torchrun`` environment variables
(``initialize_distributed``, every group with a timeout), run the named
jobs on the inputs the test wrote, save one result file per rank and exit.
The test process computes the JAX references; this file imports no JAX, so
the workers never start an XLA runtime.

    python tests/torch_dist_worker.py <inputs.pt> <out_dir>   (RANK, ... set)
"""
import os
import socket
import subprocess
import sys
import time

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Spawned:
    """``world`` worker processes started on ``inputs``; ``results()``
    waits for them (at most ``timeout`` seconds, then kills them all)."""

    def __init__(self, world: int, inputs: dict, tmpdir, timeout: float = 240.0):
        self.world, self.timeout, self.dir = world, timeout, str(tmpdir)
        path = os.path.join(self.dir, "inputs.pt")
        torch.save(inputs, path)
        port = _free_port()
        self.procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                       OMP_NUM_THREADS="1")
            env.pop("XLA_FLAGS", None)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), path, self.dir],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                cwd=_REPO))
        self._results = None

    def results(self) -> list:
        if self._results is not None:
            return self._results
        deadline = time.monotonic() + self.timeout
        outs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                outs.append(out)
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
                p.communicate()
            raise RuntimeError(f"workers timed out after {self.timeout} s")
        for rank, (p, out) in enumerate(zip(self.procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"worker {rank} failed ({p.returncode}):\n{out[-4000:]}")
        self._results = [torch.load(os.path.join(self.dir, f"rank{r}.pt"), weights_only=False)
                         for r in range(self.world)]
        return self._results


class one_thread:
    """torch on one thread in this process, as in the workers, for results
    held against theirs bit for bit."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


# ---------------------------------------------------------------------------
# jobs: fn(inputs, rank, world) -> a picklable result
# ---------------------------------------------------------------------------

JOBS = {}


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def _t(x, dtype=None):
    t = torch.as_tensor(x)
    return t if dtype is None else t.to(dtype)


def _meshes():
    """The meshes a 4-rank job uses: 1-D meshes of 4 and a 2 × 2 one."""
    from points_matching_tpu_torch.parallel.mesh import make_mesh

    return dict(data4=make_mesh((4,), ("data",)), model4=make_mesh((4,), ("model",)),
                stage4=make_mesh((4,), ("stage",)),
                dm22=make_mesh((2, 2), ("data", "model")),
                ds22=make_mesh((2, 2), ("data", "stage")))


@job
def init(inp, rank, world):
    import torch.distributed as dist

    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                backend=str(dist.get_backend()))


@job
def multihost(inp, rank, world):
    """The counterpart of tests/multihost_worker.py: each process feeds its
    own rows, the global array is their all_gather, one cross-process sum."""
    from points_matching_tpu_torch.parallel import Comm, host_local_to_global, make_mesh

    mesh = make_mesh((world,), ("data",))
    local = torch.full((4, 3), float(rank + 1))
    g = host_local_to_global(mesh, "data", local)
    total = Comm(mesh.get_group("data")).psum(g[4 * rank:4 * rank + 4].sum())
    return dict(global_rows=g, total=total)


@job
def comm(inp, rank, world):
    import torch.distributed as dist

    from points_matching_tpu_torch.parallel.comm import Comm, set_fault_hook
    from points_matching_tpu_torch.parallel.mesh import axis_comm, replicated, shard

    m = _meshes()
    c = Comm(dist.group.WORLD)
    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    y = torch.arange(8.0).reshape(4, 2) + 100 * rank
    out = dict(index=c.index(), size=c.size(), psum=c.psum(x), pmean=c.pmean(x),
               pmax=c.pmax(x), pmin=c.pmin(x), gather=c.all_gather(x),
               gather_tiled1=c.all_gather(x, axis=1, tiled=True),
               reduce_scatter=c.reduce_scatter(y), all_to_all=c.all_to_all(y, 0, 1),
               ppermute=c.ppermute(x, [(0, 1), (1, 2), (2, 0)]),
               ring1=c.ring_shift(x, 1), ring_back=c.ring_shift(x, -1),
               broadcast=c.broadcast(x, src=2),
               gather_bool=c.all_gather(torch.tensor([rank % 2 == 0, True])))
    sub = axis_comm(m["dm22"], "data")               # ranks {0, 2} and {1, 3}
    out.update(sub_index=sub.index(), sub_size=sub.size(), sub_psum=sub.psum(x),
               sub_ring=sub.ring_shift(x), shard=shard(torch.arange(8.0), m["dm22"]),
               replicated=replicated(x, m["data4"]))
    ones = torch.ones(3)
    out["clean"] = c.psum(ones)
    set_fault_hook(lambda name, v: v * 2.0 if name == "psum" else v)
    try:
        out["faulty"] = c.psum(ones)
        out["faulty_max"] = c.pmax(ones)             # another collective: untouched
    finally:
        set_fault_hook(None)
    return out


@job
def ring(inp, rank, world):
    from points_matching_tpu_torch.parallel.all_pairs import all_pairs_scores

    m = _meshes()
    desc, mask = _t(inp["desc"]), _t(inp["mask"], torch.bool)
    out = dict(ws2=all_pairs_scores(desc, mask, inp["ratio"], mesh=m["dm22"]["data"]),
               ws4=all_pairs_scores(desc, mask, inp["ratio"], mesh=m["data4"]))
    try:
        all_pairs_scores(desc[:6], mask[:6], inp["ratio"], mesh=m["data4"])
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _summary(out, stats):
    return dict(R=out.poses.R, t=out.poses.t, X=out.X, iterations=int(stats.iterations),
                initial_cost=float(stats.initial_cost), final_cost=float(stats.final_cost))


def sparse_problem(d, K, dtype):
    """A sparse BA problem from numpy fields, in ``dtype`` (float32 or
    float64: in float64 the sharded sums must equal one process's to
    rounding, which shows them exact)."""
    import dataclasses

    from points_matching_tpu_torch.core.convert import (
        intrinsics_from_numpy, sparse_ba_state_from_numpy)
    from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose

    st = sparse_ba_state_from_numpy(d, device="cpu")
    st = dataclasses.replace(st, X=st.X.to(dtype), uv=st.uv.to(dtype),
                             poses=Pose(R=st.poses.R.to(dtype), t=st.poses.t.to(dtype)))
    k = intrinsics_from_numpy(K, device="cpu")
    return st, CameraIntrinsics(*(getattr(k, f).to(dtype) for f in ("fx", "fy", "cx", "cy")))


@job
def sparse_ba(inp, rank, world):
    from points_matching_tpu_torch.core.config import BAConfig
    from points_matching_tpu_torch.parallel.sharded_ba import distributed_bundle_adjust_sparse

    m = _meshes()
    out = {}
    for name, cfg_kw in (("one", inp["one_cfg"]), ("ragged", inp["ragged_cfg"])):
        for dtype in (torch.float32, torch.float64):
            state, K = sparse_problem(inp[f"{name}_state"], inp["K"], dtype)
            for ws, mesh in ((2, m["dm22"]["model"]), (4, m["model4"])):
                res = distributed_bundle_adjust_sparse(state, K, mesh, BAConfig(**cfg_kw))
                out[f"{name}_ws{ws}_{str(dtype)[6:]}"] = _summary(*res)
    return out


@job
def dense_ba(inp, rank, world):
    import dataclasses

    from points_matching_tpu_torch.ba.lm import make_ba_state
    from points_matching_tpu_torch.core.config import BAConfig
    from points_matching_tpu_torch.core.convert import intrinsics_from_numpy, pose_from_numpy
    from points_matching_tpu_torch.parallel.sharded_ba import distributed_bundle_adjust

    m = _meshes()
    d = inp["dense_state"]
    K = intrinsics_from_numpy(inp["K_dense"], device="cpu")
    state = make_ba_state(pose_from_numpy(d["poses"], device="cpu"), _t(d["X"]), _t(d["uv"]),
                          _t(d["mask"], torch.bool))
    out = {}
    for ws, mesh in ((2, m["dm22"]["model"]), (4, m["model4"])):
        for it in (1, 5):
            out[f"ws{ws}_it{it}"] = _summary(*distributed_bundle_adjust(
                state, K, mesh, BAConfig(max_iterations=it)))
    odd = dataclasses.replace(state, X=state.X[:63], uv=state.uv[:, :63],
                              mask=state.mask[:, :63])
    try:
        distributed_bundle_adjust(odd, K, m["model4"])
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def pipeline_test_stages():
    """tests/test_pipeline_parallel.py's four stages, in torch."""
    def frontend(w):
        return {**w, "x": torch.tanh(w["x"]), "n": w["n"] + 1}

    def matching(w):
        return {**w, "w": w["x"].sum(0) + w["w"], "n": w["n"] * 2}

    def geometry(w):
        return {**w, "x": w["x"] * w["w"][None, :], "n": w["n"] + 3}

    def refine(w):
        return {**w, "x": w["x"] - w["x"].mean(), "w": 2.0 * w["w"]}

    return [frontend, matching, geometry, refine]


@job
def pipeline(inp, rank, world):
    from points_matching_tpu_torch.parallel.pipeline import pipeline_stages

    m = _meshes()
    fns = pipeline_test_stages()
    out = {}
    for mb, wire in inp["wires"].items():
        xs = {k: _t(v) for k, v in wire.items()}
        out[f"s4_m{mb}"] = pipeline_stages(fns, xs, m["stage4"])
        out[f"s2_m{mb}"] = pipeline_stages(fns[:2], xs, m["ds22"]["stage"])
    try:
        pipeline_stages(fns[:3], {k: _t(v) for k, v in inp["wires"][4].items()}, m["stage4"])
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


@job
def staged(inp, rank, world):
    from points_matching_tpu_torch.core.config import TwoViewConfig
    from points_matching_tpu_torch.core.convert import config_from_dict
    from points_matching_tpu_torch.pipelines.staged_two_view import staged_two_view

    m = _meshes()
    out = {}
    for name, case in inp["staged"].items():
        cfg = config_from_dict(case["config"], TwoViewConfig)
        samples = (_t(case["sp1"]), _t(case["sp2"]))
        out[name] = staged_two_view(_t(case["img1"]), _t(case["img2"]), _t(case["seeds"]),
                                    cfg, mesh=m["stage4"], samples=samples)
    return out


@job
def checkpoint(inp, rank, world):
    """The counterpart of tests/test_utils.py's sharded restore: a tensor
    sharded over a 4-rank ``model`` axis, each rank saving and restoring its
    own shard; then a step only rank 0 wrote, which must not count."""
    import torch.distributed as dist

    from points_matching_tpu_torch.parallel.mesh import host_local_to_global, make_mesh, shard
    from points_matching_tpu_torch.utils.checkpoint import CheckpointManager

    mesh = make_mesh((world,), ("model",))
    x = torch.arange(64.0).reshape(16, 4)
    local = shard(x, mesh, "model")
    with CheckpointManager(inp["ckpt_dir"]) as mgr:
        mgr.save(0, {"X": local})
        mgr.wait()
        dist.barrier()
        restored = mgr.restore(0, template={"X": torch.zeros_like(local)})
        if rank == 0:
            mgr.save(1, {"X": local + 1})
            mgr.wait()
        dist.barrier()
        steps, latest = mgr.all_steps(), mgr.latest_step()
    gathered = host_local_to_global(mesh, "model", restored["X"])
    dist.barrier()
    return dict(local=local, restored=restored["X"], gathered=gathered, steps=steps,
                latest=latest)


@job
def dslam(inp, rank, world):
    """Config 4's pipeline on the 16-frame sequence at world size 4 (2 data ×
    2 model) and at world size 2 (data only: the 2 × 2 mesh's data axis,
    two independent pairs of ranks)."""
    from points_matching_tpu_torch.core.config import SfMConfig
    from points_matching_tpu_torch.core.convert import config_from_dict, intrinsics_from_numpy
    from points_matching_tpu_torch.pipelines.distributed_slam import run_distributed_slam

    m = _meshes()
    cfg = config_from_dict(inp["config"], SfMConfig)
    K = intrinsics_from_numpy(inp["K"], device="cpu")
    args = (_t(inp["kps"]), _t(inp["desc"]), _t(inp["mask"], torch.bool), K, cfg)
    out = {}
    for name, mesh in (("ws4", m["dm22"]), ("ws2", m["dm22"]["data"])):
        res = run_distributed_slam(*args, mesh=mesh, **inp["kw"])
        out[name] = dict(trajectory=res.trajectory, cam_valid=res.cam_valid,
                         regs=res.registered_per_segment, X=res.X,
                         initial_cost=float(res.ba_stats.initial_cost),
                         final_cost=float(res.ba_stats.final_cost))
    return out


@job
def slam_demo(inp, rank, world):
    """The SLAM demo's ``--distributed`` path as ``torchrun`` starts it:
    ``WORLD_SIZE`` > 1 and a group already joined, so every rank runs on a
    data × model mesh of the group (2 segments on 4 ranks: 2 × 2)."""
    from points_matching_tpu_torch.data.datasets import load_kitti_sequence
    from points_matching_tpu_torch.pipelines.slam import run_slam_demo

    seq = load_kitti_sequence(inp["slam_tree"], max_frames=inp["slam_frames"], device="cpu")
    run = run_slam_demo(seq, device="cpu", features=inp["slam_features"], distributed=True,
                        segment_len=5, overlap=3, verbose=False)
    return dict(numbers=run.numbers, trajectory=run.trajectory,
                regs=run.result.registered_per_segment)


def main() -> int:
    import torch.distributed as dist

    from points_matching_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    path, out_dir = sys.argv[1], sys.argv[2]
    initialize_distributed(device="cpu", timeout=GROUP_TIMEOUT_S)
    rank, world = dist.get_rank(), dist.get_world_size()
    inp = torch.load(path, weights_only=False)
    results = {name: JOBS[name](inp, rank, world) for name in inp["jobs"]}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
