"""The all-pairs retrieval sweep: every ordered pair of an image set scored
by ``all_pairs_scores``, sweeps back to back, the [N, N] scores read to the
host.  On one chip ``mesh=None`` (the ring's one step); on several, the
images split over the ``data`` axis of a mesh of one rank a chip, each
rank scoring its block against every block as the ring passes them on.

The check judges the sweeps the seed samples from the window: the rows of
``check_images`` query images (drawn from the seed) against every image,
beside the float64 reference (``gpu_bench/reference/all_pairs.py``):

* ``score_margin``: a cell whose score differs from the reference's by
  ``n`` is explained only by ``n`` of its rows at a near-tie of the ratio
  test; over the differing cells, the largest relative margin
  |best − ratio²·second| / (ratio²·second) that explaining them needs (the
  n-th smallest of the cell's rows); 0 when no cell differs.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from gpu_bench import generators
from gpu_bench.reference import all_pairs as ref_all_pairs
from gpu_bench.work import arith
from points_matching_tpu_torch.parallel.all_pairs import all_pairs_scores
from points_matching_tpu_torch.parallel.mesh import make_mesh

UNEXPLAINED = 1e30


class Driver:
    spans = ("bench.sweep",)
    batch_word, unit_word = "sweeps", "ordered pairs"

    def __init__(self, spec: dict, dev, seed: int):
        self.config, self.mix, self.cell = spec["config"], spec["traffic"], spec["workload"]
        self.generator = spec["generator"]
        self.dev, self.seed = torch.device(dev), seed
        self.N, self.K = self.mix["images"], self.mix["keypoints"]
        self.D = self.config["descriptor"]["dim"]
        self.ratio = self.config["matcher"]["ratio"]
        self.world = spec["cell"]["chips"]
        self.on_card = self.dev.type == "cuda"
        self.mesh = None

    def setup(self) -> None:
        """The pool of distinct image sets from the seed (on the device),
        pinned host buffers, and warm-up sweeps."""
        gen = torch.Generator(device=self.dev).manual_seed(generators.derive_seed(self.seed, 1))
        make = generators.load(self.generator).make
        self.pool = [make(self.mix, self.D, gen, self.dev) for _ in range(self.mix["pool"])]
        if self.world > 1:
            self.mesh = make_mesh((self.world,), ("data",))
        self.slots = [torch.empty(self.N, self.N, dtype=torch.int32, pin_memory=self.on_card)
                      for _ in range(self.mix["in_flight"])]
        self._next = 0
        for _ in range(self.mix["warmup"]):
            self.complete(self.enqueue())

    def setup_notes(self) -> dict:
        return dict(images=self.N, keypoints=self.K, pool=len(self.pool),
                    in_flight=self.mix["in_flight"], warmup=self.mix["warmup"])

    def _program(self, s: dict):
        with torch.profiler.record_function("bench.sweep"):
            return all_pairs_scores(s["desc"], s["mask"], self.ratio, mesh=self.mesh)

    def enqueue(self, traced: bool = False) -> dict:
        """Enqueue the stream's next batch (the pool's batches in turn,
        warm-up included) and its copy to the host."""
        k, self._next = self._next, self._next + 1
        t_enq = time.perf_counter()
        scores = self._program(self.pool[k % len(self.pool)])
        slot = self.slots[k % len(self.slots)]
        slot.copy_(scores, non_blocking=True)
        event = None
        if self.on_card:
            event = torch.cuda.Event()
            event.record()
        return dict(k=k, t_enq=t_enq, units=self.N * self.N, traced=traced, event=event,
                    slot=slot)

    def complete(self, item: dict) -> None:
        """Wait for the sweep's scores on the host."""
        if item["event"] is not None:
            item["event"].synchronize()
        item["t_done"] = time.perf_counter()
        item["event"] = None
        item["scores"] = item.pop("slot").clone()

    def end_to_end(self, win) -> Dict[str, float]:
        return dict(scored_pairs_per_s=win.units / (win.t_end - win.t0), sweeps=win.batches,
                    sweep_s_mean=(win.t_end - win.t0) / max(win.batches, 1))

    def counters(self) -> Dict[str, float]:
        return {}

    def work(self) -> dict:
        """The frozen work of one sweep on this rank: its share of them all."""
        w = arith.all_pairs(self.N, self.K, self.D, self.N * self.K)
        return dict(all_pairs=arith.Work(w.bytes / self.world, w.ops / self.world, w.unit))

    def release(self) -> None:
        self.slots = self.mesh = None

    def outputs(self, item: dict) -> dict:
        return dict(pool=item["k"] % len(self.pool), scores=item["scores"])

    def sample_rows(self, j: int) -> torch.Tensor:
        """The query images the check judges in the j-th judged sweep."""
        rng = random.Random(generators.derive_seed(self.seed, 6, j))
        rows = sorted(rng.sample(range(self.N), min(self.N, self.cell["check"]["check_images"])))
        return torch.tensor(rows, device=self.dev)

    def control_outputs(self, j: int) -> dict:
        """The control in the program's place on the j-th judged sweep (the
        pool's sets in turn): the reference in TF32 on the judged query
        images' rows (the rest left at -1)."""
        pool_index, rows = j % len(self.pool), self.sample_rows(j)
        s = self.pool[pool_index]
        r = ref_all_pairs.scores(s["desc"][rows], s["mask"][rows], s["desc"], s["mask"],
                                 self.ratio, "tf32")
        scores = torch.full((self.N, self.N), -1, dtype=torch.int32)
        scores[rows.cpu()] = r["scores"].int().cpu()
        return dict(pool=pool_index, scores=scores)

    def check(self, kept: List[dict]) -> Dict[str, float]:
        return self.judge([self.outputs(i) for i in kept])

    def judge(self, outs: List[dict]) -> Dict[str, float]:
        r2 = self.ratio * self.ratio
        worst, differing = 0.0, 0
        for j, o in enumerate(outs):
            s = self.pool[o["pool"]]
            rows = self.sample_rows(j)
            ref = ref_all_pairs.scores(s["desc"][rows], s["mask"][rows], s["desc"], s["mask"],
                                       self.ratio, "f64")
            got = o["scores"].to(self.dev)[rows].long()
            delta = (got - ref["scores"]).abs()                          # [Q, N]
            differing += int((delta > 0).sum())
            margin = (ref["best"] - r2 * ref["second"]).abs() / (r2 * ref["second"])
            ok = s["mask"][rows][:, None, :] & torch.isfinite(margin)
            margin = torch.where(ok, margin, torch.full_like(margin, UNEXPLAINED))
            # the n-th smallest row margin of a cell off by n
            need = margin.sort(-1).values.gather(-1, (delta - 1).clamp(0, self.K - 1)[..., None])
            need = torch.where(delta > self.K, UNEXPLAINED, need[..., 0])
            need = torch.where(delta == 0, 0.0, need)
            worst = max(worst, min(float(need.max()), UNEXPLAINED))
        return dict(score_margin=worst, cells_differing=differing)
