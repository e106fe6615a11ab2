"""Run-to-run noise on the card: which operations of the port's paths PyTorch
calls nondeterministic, and whether two runs of each path give the same
bits.

Each path runs twice as the program runs it, and once more under
``torch.use_deterministic_algorithms(True, warn_only=True)``, which warns
at every operation that PyTorch knows to be nondeterministic on the card
(and swaps in deterministic versions of others, such as ``index_add_``, and
fills fresh ``torch.empty`` memory with NaN).  The paths:

* ``sfm``        — ``chip_smoke.py``'s SfM slice: 100 rendered frames,
                   Hessian/SURF on the card, ``run_incremental_sfm``
                   (``ba_every=4``, ``chunk_size=16``; local BAs);
* ``loop``       — ``close_loops`` on that run's poses (all-pairs scores,
                   verification, the pose graph);
* ``config4``    — config 4's stand-in (272 frames, 16 segments in one
                   batch) through ``run_distributed_slam`` at world size 1
                   over NCCL;
* ``config4_full`` — config 4 at KITTI 00's length (4,541 frames, 283
                   segments in one batch), world size 1 (``--no-full`` skips it).

For each path: whether the two plain runs are equal bit for bit (and the
largest difference of their outputs), whether the deterministic-mode run
equals them, and every warning message with its count.  A control first:
``torch.histc`` and ``put_(accumulate=True)`` of a CUDA tensor, which
PyTorch flags, under the same capture (``control``): if neither warns, an
empty list means nothing.  Prints one JSON
line at the end and writes it to ``--out`` when given.  Never on the main
path: the program runs with the deterministic mode off.

    python examples/probe_determinism_torch.py [--no-full] [--out readings.json]
"""
import argparse
import collections
import json
import os
import subprocess
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _outputs(path: str, out) -> dict:
    """The tensors a path's run is compared by, on the host."""
    if path == "sfm":
        return dict(trajectory=out.trajectory.cpu(), X=out.state.X.cpu())
    if path == "loop":
        poses, _ = out
        return dict(R=poses.R.cpu(), t=poses.t.cpu())
    import torch

    return dict(trajectory=torch.as_tensor(out.trajectory),
                final_cost=torch.as_tensor(float(out.ba_stats.final_cost)))


def _compare(a: dict, b: dict) -> dict:
    import torch

    return dict(equal=all(torch.equal(a[k], b[k]) for k in a),
                max_abs_diff={k: float((a[k].double() - b[k].double()).abs().max())
                              for k in a})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-full", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from points_matching_tpu_torch.core.device import pin_fp32, resolve_device
    from points_matching_tpu_torch.ops import kernels as K
    from points_matching_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from points_matching_tpu_torch.pipelines.loop_closure import close_loops
    from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = resolve_device("cuda")
    pin_fp32()

    def alerts(fn):
        """(fn(), Counter of the first lines of its nondeterminism warnings)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                out = fn()
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        return out, collections.Counter(str(w.message).splitlines()[0] for w in caught
                                        if "deterministic" in str(w.message))

    x = torch.rand(1000, device=dev)
    _, control = alerts(lambda: (torch.histc(x, bins=10), torch.zeros(10, device=dev).put_(
        torch.arange(10, device=dev), x[:10], accumulate=True)))
    print(f"control (histc, put_ on the card): {dict(control)}")

    frames, Kc, _, _ = cs._rendered_frames(dev, 100)
    cfg = cs._sfm_config(8192, 65536)
    sfm_res = {}

    def sfm():
        out = run_incremental_sfm(frames, Kc, cfg, seed=0, ba_every=4, chunk_size=16)
        sfm_res.setdefault("first", out)
        return out

    def loop():
        st = sfm_res["first"].state
        return close_loops(st.poses, int(st.num_cams), frames, Kc, cfg, seed=0)

    def config4(seq):
        def run():
            initialize_distributed(init_method=f"tcp://localhost:{cs._free_port()}",
                                   world_size=1, rank=0, timeout=60, force=True)
            try:
                return cs._config4_run(dev, make_mesh((1, 1), ("data", "model")), seq)[0]
            finally:
                dist.destroy_process_group()
        return run

    paths = [("sfm", sfm), ("loop", loop), ("config4", config4(cs.CONFIG4))]
    if not args.no_full:
        paths.append(("config4_full", config4(cs.CONFIG4_FULL)))
    report = {}
    for name, fn in paths:
        K.reset_launch_counts()
        runs = [_outputs(name, fn())]
        launches = K.launch_counts()
        runs.append(_outputs(name, fn()))
        out, msgs = alerts(fn)
        runs.append(_outputs(name, out))
        report[name] = dict(two_runs=_compare(runs[0], runs[1]),
                            deterministic_mode_vs_first=_compare(runs[0], runs[2]),
                            warnings=dict(msgs), segment_sum_launches=launches["segment_sum"])
        print(f"{name}: two runs equal {report[name]['two_runs']['equal']} "
              f"{report[name]['two_runs']['max_abs_diff']}; deterministic mode equal "
              f"{report[name]['deterministic_mode_vs_first']['equal']}; segmented-sum "
              f"launches {launches['segment_sum']}; warnings {len(msgs)}")
        for m, c in msgs.items():
            print(f"  {c} x {m}")
    line = json.dumps(dict(device=smi, control=dict(control), paths=report))
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
