"""Host-clock times of the paths that run the BA's and the pose graph's sums,
for one checkout of the repository, so that two trees can be timed in
turns in one call on the card (``chip_smoke.py``'s helpers of that tree):

* the pose graph at P = 4,541 (``chip_smoke.py``'s circuit, 1,000 PCG
  steps): ms per Gauss-Newton iteration, two runs;
* ``bundle_adjust_sparse`` at 64 × 16,384 × 131,072 (10 LM iterations of
  25 PCG steps, the default ``obs_layout``): ms per LM iteration, two runs;
* config 4's stand-in at world size 1 over NCCL: seconds, the submaps'
  seconds and the global BA's ms per LM iteration, two runs after a
  warm-up;
* the host's eager launch time (µs) at the start and at the end.

    python examples/profile_paths_torch.py [TREE]

TREE is a checkout (default: this one), for example an earlier commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists;
its kernels are built into its own ``build/kernels``.  Run trees in turns
(A, B, B, A, ...), each in its own process.  Prints one line, ``PATHS``
and a JSON object.
"""
import json
import os
import sys
import time


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, tree)
    os.chdir(tree)

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from points_matching_tpu_torch.ba.pose_graph import make_odometry_chain, optimize_pose_graph
    from points_matching_tpu_torch.ba.sparse import bundle_adjust_sparse, make_sparse_ba_state
    from points_matching_tpu_torch.core.config import BAConfig
    from points_matching_tpu_torch.core.device import pin_fp32
    from points_matching_tpu_torch.core.types import CameraIntrinsics
    from points_matching_tpu_torch.data.synthetic import make_sparse_ba_problem
    from points_matching_tpu_torch.ops.kernels import _build
    from points_matching_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    pin_fp32()
    dev = torch.device("cuda")
    _build.library()
    out = dict(tree=tree, dispatch_us_start=cs._dispatch_us(dev))

    def timed(fn, per):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / per(res)

    P = 4541
    g = make_odometry_chain(cs._circuit_poses(P, 500, dev),
                            torch.Generator(device=dev).manual_seed(P), odom_noise=0.01,
                            loop_edges=tuple((i, i + 500) for i in range(0, P - 500, 500)),
                            loop_weight=20.0)
    g0 = g.replace(poses=cs._drifted_start(g))
    optimize_pose_graph(g0, max_iterations=1, pcg_iterations=1000)
    out["pose_graph_ms_per_iteration"] = [
        timed(lambda: optimize_pose_graph(g0, pcg_iterations=1000),
              lambda r: int(r[1].iterations)) for _ in range(2)]

    prob = make_sparse_ba_problem(seed=1, num_cameras=64, num_landmarks=16384,
                                  obs_per_landmark=8, device=dev)
    K = CameraIntrinsics.from_matrix(prob["K"])
    state = make_sparse_ba_state(prob["poses"], prob["X"], prob["cam_idx"], prob["lm_idx"],
                                 prob["uv"], prob["obs_mask"])
    bundle_adjust_sparse(state, K, BAConfig(max_iterations=1, rtol=0.0, pcg_iterations=25))
    cfg = BAConfig(max_iterations=10, rtol=0.0, pcg_iterations=25)
    out["ba_ms_per_iteration"] = [
        timed(lambda: bundle_adjust_sparse(state, K, cfg), lambda r: int(r[1].iterations))
        for _ in range(2)]

    initialize_distributed(init_method=f"tcp://localhost:{cs._free_port()}", world_size=1,
                           rank=0, timeout=60, force=True)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cs._config4_run(dev, mesh)
        for _ in range(2):
            res, _, sec = cs._config4_run(dev, mesh)
            out.setdefault("config4_s", []).append(sec)
            out.setdefault("config4_submaps_s", []).append(res.stage_seconds["submaps"])
            out.setdefault("config4_global_ba_ms_per_iteration", []).append(
                res.stage_seconds["global_ba"] / int(res.ba_stats.iterations) * 1e3)
    finally:
        dist.destroy_process_group()
    out["dispatch_us_end"] = cs._dispatch_us(dev)
    print("PATHS " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
