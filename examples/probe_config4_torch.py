"""Config 4's run-to-run spread on the card, from which ``chip_smoke.py``'s
``RUN_GAP_TOL`` is set: the stand-in (272 frames, 16 segments) run
``--ws1`` times at world size 1 over NCCL and ``--ws2`` times at world size 2
(two processes on the one card over gloo, ``chip_smoke.py --dslam-worker``),
then the largest and the root-mean-square aligned distance between every
two trajectories, grouped as ws1-ws1, ws1-ws2 and ws2-ws2, beside each
run's ATE; for the world-size-1 runs also the same gaps at the stages
before the global BA: each submap's own cameras (segment by segment,
aligned apart; the largest over the segments) and the merged trajectory
that the global BA starts from (``merge_submaps``' output, recorded by
wrapping it).  Also the share of a submap bank's 2,048
rows that are valid when a frame is associated against it (world size 1),
which ``chip_smoke.py``'s config-4 K1 case masks to.  Since the BAs sum
through the segmented-sum kernel (a fixed order, no atomics), two runs of
one world size give the same bits; world sizes 1 and 2 still differ by the
order of the ranks' partial sums, and the gaps measure by how much.

    python examples/probe_config4_torch.py [--ws1 4] [--ws2 3] [--out readings.json]

Prints the readings as one JSON line at the end (and writes them to
``--out`` when given).
"""
import argparse
import itertools
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ws1", type=int, default=4)
    ap.add_argument("--ws2", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import points_matching_tpu_torch.pipelines.distributed_slam as ds
    import points_matching_tpu_torch.pipelines.sfm as sfm
    from points_matching_tpu_torch.core.device import pin_fp32, resolve_device
    from points_matching_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = resolve_device("cuda")
    pin_fp32()

    shares = []
    match = sfm.match_descriptors

    def counted(frame, bank, *a, **kw):
        if bank.mask.shape[-1] == 2048:
            shares.append(float(bank.mask.float().mean()))
        return match(frame, bank, *a, **kw)

    stages = []
    merge = ds.merge_submaps

    def recorded(states, regs, overlap):
        R_g, t_g, valid, merged = merge(states, regs, overlap)
        R, t = (x.detach().cpu().double() for x in (states.poses.R, states.poses.t))
        sub = -(R.transpose(-1, -2) @ t[..., None])[..., 0]          # [S, C, 3]
        stages.append(dict(submaps=sub.numpy(), cams=states.cam_mask.cpu().numpy(),
                           merged=-np.einsum("cji,cj->ci", R_g, t_g)[valid]))
        return R_g, t_g, valid, merged

    ds.merge_submaps = recorded
    initialize_distributed(init_method=f"tcp://localhost:{cs._free_port()}", world_size=1,
                           rank=0, timeout=60, force=True)
    mesh = make_mesh((1, 1), ("data", "model"))
    runs = []
    for i in range(args.ws1):
        sfm.match_descriptors = counted if i == 0 else match
        res, gt, sec = cs._config4_run(dev, mesh)
        g = cs._config4_gates(f"ws1 run {i}", res.trajectory, res.cam_valid,
                              res.registered_per_segment, float(res.ba_stats.initial_cost),
                              float(res.ba_stats.final_cost), gt)
        runs.append(("ws1", np.asarray(res.trajectory), sec, g["ate"]))
        print(f"ws1 run {i}: {sec:.3f} s")
    sfm.match_descriptors = match
    ds.merge_submaps = merge
    dist.destroy_process_group()
    for i in range(args.ws2):
        ws2, wall = cs._config4_ws2()
        g = cs._config4_gates(f"ws2 run {i}", ws2["trajectory"], ws2["cam_valid"], ws2["regs"],
                              ws2["initial_cost"], ws2["final_cost"], gt)
        runs.append(("ws2", np.asarray(ws2["trajectory"]), ws2["seconds"], g["ate"]))
        print(f"ws2 run {i}: {ws2['seconds']:.3f} s ({wall:.3f} s with the start)")

    extent = float(np.linalg.norm(gt[:len(runs[0][1])].max(0) - gt[:len(runs[0][1])].min(0)))
    gaps = {k: dict(max=[], rms=[]) for k in ("ws1-ws1", "ws1-ws2", "ws2-ws2")}
    for (ka, ta, *_), (kb, tb, *_) in itertools.combinations(runs, 2):
        pair = gaps["-".join(sorted((ka, kb)))]
        pair["max"].append(cs._aligned_gap(ta, tb))
        pair["rms"].append(cs._aligned_gap(ta, tb, rms=True))
    out = dict(device=smi, extent=extent, gaps=gaps,
               largest={k: {m: max(v[m]) for m in v} for k, v in gaps.items() if v["max"]},
               runs=[dict(world_size=k, seconds=s, ate=a) for k, _, s, a in runs],
               bank_valid_share=dict(associations=len(shares), mean=float(np.mean(shares)),
                                     min=float(np.min(shares)), max=float(np.max(shares))))
    for k, v in gaps.items():
        for m in ("max", "rms"):
            if v[m]:
                print(f"{k} {m}: {len(v[m])} pairs, aligned gaps {[round(g, 4) for g in v[m]]}, "
                      f"largest {max(v[m]):.4f} ({max(v[m]) / extent:.4%} of the extent "
                      f"{extent:.2f})")
    before = dict(submaps=dict(max=[], rms=[]), merged=dict(max=[], rms=[]))
    for a, b in itertools.combinations(stages, 2):
        for m in ("max", "rms"):
            rms = m == "rms"
            before["submaps"][m].append(max(
                cs._aligned_gap(a["submaps"][s][a["cams"][s]], b["submaps"][s][b["cams"][s]], rms)
                for s in range(len(a["cams"]))))
            before["merged"][m].append(cs._aligned_gap(a["merged"], b["merged"], rms))
    out["ws1_before_global_ba"] = before
    for k, v in before.items():
        for m, g in v.items():
            print(f"ws1-ws1 {k} {m}: {[round(x, 5) for x in g]}")
    print(f"ATE (RMSE) of the runs: {[round(a, 4) for *_, a in runs]}")
    print(f"bank rows valid at association: mean {out['bank_valid_share']['mean']:.4f} over "
          f"{len(shares)} associations (min {min(shares):.4f}, max {max(shares):.4f})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
