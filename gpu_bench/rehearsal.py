"""A tiny copy of the benchmark for rehearsals on the CPU: every traffic
mix and cell shrunk to a few pairs, keypoints and images, so that each
driver runs end to end through the port's plain versions in seconds.  A
rehearsal's result says ``"rehearsal": true`` and carries no device
metric; its numbers say nothing of the card.

    python3 gpu_bench/rehearsal.py DIR     # writes the copy into DIR
"""
from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from gpu_bench import generators  # noqa: E402

TINY_CHECK = dict(consensus_pairs=4, check_images=8)
TINY_TRACE = dict(lead=1, batches=2)


def tiny_copy(dst: str, root: str = ROOT) -> str:
    """Copy ``BENCHMARK.json`` and ``gpu_bench/`` into ``dst`` with every
    traffic mix (to its generator's ``TINY``) and cell file shrunk; link
    the port beside them.  Returns ``dst``."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(root, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(root, "gpu_bench"), os.path.join(dst, "gpu_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"), dirs_exist_ok=True)
    port = os.path.join(dst, "points_matching_tpu_torch")
    if not os.path.exists(port):
        os.symlink(os.path.join(root, "points_matching_tpu_torch"), port)
    def shrink(cell):
        cell["check"].update({k: v for k, v in TINY_CHECK.items() if k in cell["check"]})
        cell["trace"] = dict(TINY_TRACE)

    base = os.path.join(dst, "gpu_bench")
    traffic = os.path.join(base, "traffic")
    for name in os.listdir(traffic):
        if name.endswith(".json"):
            edit_json(os.path.join(traffic, name), lambda mix: mix.update(
                generators.load(os.path.join(traffic, mix["generator"] + ".py")).TINY))
    for name in os.listdir(os.path.join(base, "workloads")):
        edit_json(os.path.join(base, "workloads", name), shrink)
    return dst


RING_CELL = "retrieval-ring4"


def add_ring_cell(root: str) -> str:
    """Add a four-chip cell of the ring (``all_pairs_scores`` over a mesh of
    one rank a chip) to the tiny copy in ``root``: no cell of
    ``BENCHMARK.json`` takes the multi-chip path today, and a rehearsal
    runs it in four processes over gloo.  Returns the cell's name."""
    base = os.path.join(root, "gpu_bench")
    with open(os.path.join(base, "traffic", "sweep_ring.json"), "w") as f:
        json.dump(dict(generator="image_set", shared_rows=0.25, shared_noise=[0.05, 0.3],
                       in_flight=2, **generators.load(
                           os.path.join(base, "traffic", "image_set.py")).TINY), f)
    with open(os.path.join(base, "workloads", RING_CELL + ".json"), "w") as f:
        json.dump(dict(check=dict(batches=2, check_images=TINY_CHECK["check_images"],
                                  limits=dict(score_margin=1e-5)), trace=TINY_TRACE), f)

    def add(bench):
        bench["workloads"].append(dict(name=RING_CELL, config="retrieval_surf64",
                                       traffic="sweep_ring", chips=4, why="the ring"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "retrieval-8k" in m.get("workloads", []):
                m["workloads"].append(RING_CELL)
    edit_json(os.path.join(root, "BENCHMARK.json"), add)
    return RING_CELL


def edit_json(path: str, change) -> None:
    """Apply ``change`` to the JSON object in ``path`` and write it back."""
    with open(path) as f:
        data = json.load(f)
    change(data)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


if __name__ == "__main__":
    print(tiny_copy(sys.argv[1]))
