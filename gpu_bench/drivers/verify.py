"""Batched two-view verification: a batch of image pairs through
``match_descriptors_points`` (ratio-test matching, the matched train
points) and ``ransac_fundamental`` (F, inlier masks, counts), as the JAX
bench head's step runs, with one ``torch.Generator`` a pair.

The check judges every pair of the batches the seed samples from the
window, against the plain reference (``gpu_bench/reference``):

* ``match_margin``: over the rows whose match (kept or not, train row)
  differs from the float64 reference's, the largest relative margin of the
  reference's decision (|best − ratio²·second| / (ratio²·second) where the
  ratio test's outcome differs, |d(program's row) − best| / best where the
  kept row differs); 0 when none differs.  Rounding moves only rows at a
  near-tie.
* ``points_wrong``: rows whose matched point is not their train row's
  point (exact).
* ``gate_margin``: over the correspondences whose inlier flag differs from
  the float64 Sampson gate under the pair's own F, the largest
  |d − τ²| / τ² (an inlier flag on a row that is not a match: unexplained).
* ``pairs_malformed``: pairs whose count is not the sum of their inlier
  mask, or whose F is not finite, of unit norm and of rank 2 (exact).
* ``consensus_short``: 1 − Σ inliers of the program's F / Σ inliers of the
  reference RANSAC's F, both under the float64 gate on the reference's
  matches, over ``consensus_pairs`` pairs the seed samples.  The reference
  draws its own minimal sets, so this holds the program's F to the
  consensus RANSAC reaches with the cell's hypotheses: the one number a
  wrong F that is consistent with its own mask and count (a broken
  sampler, K3, K2 or winner) moves.

Printed beside them and not compared: how many rows and gates differed.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from gpu_bench import generators, host
from gpu_bench.reference import matching as ref_matching
from gpu_bench.reference import ransac as ref_ransac
from gpu_bench.work import arith
from points_matching_tpu_torch.core.config import MatcherConfig, RansacConfig
from points_matching_tpu_torch.core.types import Descriptors
from points_matching_tpu_torch.geometry.ransac import ransac_fundamental
from points_matching_tpu_torch.ops.matching import match_descriptors_points

Tensor = torch.Tensor
UNEXPLAINED = 1e30


class Driver:
    spans = ("bench.match", "bench.ransac")
    batch_word, unit_word = "batches", "pairs"

    def __init__(self, spec: dict, dev, seed: int):
        self.config, self.mix, self.cell = spec["config"], spec["traffic"], spec["workload"]
        self.generator = spec["generator"]
        self.dev, self.seed = torch.device(dev), seed
        self.P, self.N, self.H = self.mix["pairs"], self.mix["keypoints"], self.mix["hypotheses"]
        self.D = self.config["descriptor"]["dim"]
        m, r = self.config["matcher"], self.config["ransac"]
        self.ratio, self.tau, self.refits = m["ratio"], r["inlier_threshold"], r["refit_iterations"]
        self.mcfg = MatcherConfig(metric=m["metric"], filter="ratio", ratio=m["ratio"],
                                  cross_check=False, compact=False,
                                  compute_dtype=self.config["descriptor"]["compute_dtype"])
        self.rcfg = RansacConfig(num_hypotheses=self.H, sample_size=r["sample_size"],
                                 solver=r["solver"], inlier_threshold=self.tau, refit=True,
                                 refit_iterations=self.refits)
        self.on_card = self.dev.type == "cuda"

    # ---- set-up ----------------------------------------------------------
    def setup(self) -> None:
        """The pool of distinct batches from the seed (on the device), a
        generator a pair, pinned host buffers, and warm-up batches through
        the timed path."""
        gen = torch.Generator(device=self.dev).manual_seed(generators.derive_seed(self.seed, 1))
        make = generators.load(self.generator).make
        self.pool = [make(self.mix, self.D, gen, self.dev) for _ in range(self.mix["pool"])]
        self.gens = [torch.Generator(device=self.dev).manual_seed(
            generators.derive_seed(self.seed, 2, i)) for i in range(self.P)]
        pin = self.on_card
        self.slots = [dict(F=torch.empty(self.P, 3, 3, pin_memory=pin),
                           inliers=torch.empty(self.P, self.N, dtype=torch.bool, pin_memory=pin),
                           count=torch.empty(self.P, dtype=torch.int32, pin_memory=pin))
                      for _ in range(self.mix["in_flight"])]
        self._ops, self._valid = None, [0, 0]
        self._next = 0
        for _ in range(self.mix["warmup"]):
            self.complete(self.enqueue())

    def setup_notes(self) -> dict:
        return dict(pairs=self.P, keypoints=self.N, hypotheses=self.H, pool=len(self.pool),
                    in_flight=self.mix["in_flight"], warmup=self.mix["warmup"])

    # ---- the timed path --------------------------------------------------
    def _program(self, b: dict):
        with torch.profiler.record_function("bench.match"):
            m, pts = match_descriptors_points(Descriptors(b["q"], b["q_mask"]),
                                              Descriptors(b["t"], b["t_mask"]), b["p2"], self.mcfg)
        with torch.profiler.record_function("bench.ransac"):
            est = ransac_fundamental(self.gens, b["p1"], pts, m.mask, self.rcfg)
        return m, pts, est

    def enqueue(self, traced: bool = False) -> dict:
        """Enqueue the stream's next batch (the pool's batches in turn,
        warm-up included) and its copy to the host."""
        k, self._next = self._next, self._next + 1
        t_enq = time.perf_counter()
        m, pts, est = self._program(self.pool[k % len(self.pool)])
        slot = self.slots[k % len(self.slots)]
        slot["F"].copy_(est.F, non_blocking=True)
        slot["inliers"].copy_(est.inlier_mask, non_blocking=True)
        slot["count"].copy_(est.num_inliers, non_blocking=True)
        event = None
        if self.on_card:
            event = torch.cuda.Event()
            event.record()
        return dict(k=k, t_enq=t_enq, units=self.P, traced=traced, event=event, slot=slot,
                    train_idx=m.train_idx, mask=m.mask, pts=pts)

    def complete(self, item: dict) -> None:
        """Wait for the batch's F, inlier masks and counts on the host."""
        if item["event"] is not None:
            item["event"].synchronize()
        item["t_done"] = time.perf_counter()
        item["event"] = None
        slot = item.pop("slot")
        item.update(F=slot["F"].clone(), inliers=slot["inliers"].clone(),
                    count=slot["count"].clone())
        if item["traced"]:
            self._valid[0] += int(item["mask"].sum())
            self._valid[1] += 1

    # ---- what the window measured ---------------------------------------
    def end_to_end(self, win) -> Dict[str, float]:
        lat = sorted(win.latencies)
        return dict(verified_pairs_per_s=win.units / (win.t_end - win.t0),
                    verify_batch_p95_ms=_quantile(lat, 0.95) * 1e3,
                    verify_batch_p50_ms=_quantile(lat, 0.5) * 1e3, batches=len(lat))

    def counters(self) -> Dict[str, float]:
        """The aten ops one batch dispatches (after the window)."""
        if self._ops is None:
            self._ops = host.count_ops(lambda: self._program(self.pool[0]))
            if self.on_card:
                torch.cuda.synchronize(self.dev)
        return dict(aten_ops_per_batch=self._ops)

    def work(self) -> dict:
        """The frozen work of one batch: the L2 top-2 over every pair, and
        the Sampson gate over the traced batches' matched points (what the
        scorer must gate)."""
        out = dict(l2_top2=arith.l2_top2(self.P, self.N, self.N, self.D, self.P * self.N, 2))
        if self._valid[1]:
            out["sampson_gate"] = arith.sampson_gate(self.P, self.H, self.N,
                                                     self._valid[0] / self._valid[1])
        return out

    def release(self) -> None:
        self.slots = None
        self.gens = None

    # ---- the check -------------------------------------------------------
    def outputs(self, item: dict) -> dict:
        """The program's outputs of a kept batch, as the judge reads them."""
        return dict(pool=item["k"] % len(self.pool), train_idx=item["train_idx"],
                    mask=item["mask"], pts=item["pts"],
                    F=item["F"].to(self.dev), inliers=item["inliers"].to(self.dev),
                    count=item["count"].to(self.dev))

    def control_outputs(self, j: int) -> dict:
        """The control in the program's place on the j-th judged batch (the
        pool's batches in turn): the reference in TF32, its own draws."""
        pool_index = j % len(self.pool)
        b = self.pool[pool_index]
        m = ref_matching.ratio_match(b["q"], b["t"], b["q_mask"], b["t_mask"], b["p2"],
                                     self.ratio, "tf32")
        gen = torch.Generator(device=self.dev).manual_seed(
            generators.derive_seed(self.seed, 4, j))
        r = ref_ransac.ransac(gen, b["p1"], m["pts"], m["keep"], self.H, self.tau, self.refits,
                              "tf32")
        return dict(pool=pool_index, train_idx=m["idx"], mask=m["keep"], pts=m["pts"],
                    F=r["F"].float(), inliers=r["inliers"], count=r["count"])

    def check(self, kept: List[dict]) -> Dict[str, float]:
        return self.judge([self.outputs(i) for i in kept])

    def judge(self, outs: List[dict]) -> Dict[str, float]:
        tau2 = self.tau * self.tau
        r2 = self.ratio * self.ratio
        match_margin, gate_margin, points_wrong, malformed = 0.0, 0.0, 0, 0
        rows_differing = gates_differing = 0
        refs = {}
        for o in outs:
            b = self.pool[o["pool"]]
            if o["pool"] not in refs:
                refs[o["pool"]] = ref_matching.ratio_match(
                    b["q"], b["t"], b["q_mask"], b["t_mask"], b["p2"], self.ratio, "f64")
            ref = refs[o["pool"]]
            keep, idx = o["mask"], o["train_idx"].long()
            # matching
            diff_keep = keep != ref["keep"]
            diff_idx = keep & ref["keep"] & (idx != ref["idx"])
            rows_differing += int((diff_keep | diff_idx).sum())
            if bool(diff_keep.any()):
                bd, sd = ref["best"][diff_keep], ref["second"][diff_keep]
                m = (bd - r2 * sd).abs() / (r2 * sd)
                match_margin = max(match_margin, _nan_max(m))
            if bool(diff_idx.any()):
                d = ref_matching.distance_at(b["q"], b["t"], idx)[diff_idx]
                bd = ref["best"][diff_idx]
                match_margin = max(match_margin, _nan_max((d - bd).abs() / bd))
            want = b["p2"].gather(1, idx[..., None].expand(*idx.shape, 2))
            points_wrong += int((o["pts"] != want).any(-1).sum())
            # the inlier gate under the program's own F
            d = ref_ransac.sampson(o["F"].double(), b["p1"], o["pts"], "f64")
            gate = (d < tau2) & keep
            diff = gate != o["inliers"]
            gates_differing += int(diff.sum())
            if bool(diff.any()):
                m = torch.where(keep, (d - tau2).abs() / tau2,
                                torch.full_like(d, UNEXPLAINED))[diff]
                gate_margin = max(gate_margin, _nan_max(m))
            malformed += _malformed(o["F"], o["inliers"], o["count"])
        short = self._consensus(outs, refs)
        return dict(match_margin=match_margin, points_wrong=points_wrong,
                    gate_margin=gate_margin, pairs_malformed=malformed, consensus_short=short,
                    rows_differing=rows_differing, gates_differing=gates_differing)

    def _consensus(self, outs: List[dict], refs: dict) -> float:
        """1 − Σ inliers of the judged F / Σ inliers of the reference
        RANSAC's F (float64 gate, the reference's matches), over
        ``consensus_pairs`` pairs the seed draws from the judged batches."""
        rng = random.Random(generators.derive_seed(self.seed, 5))
        cells = [(j, p) for j in range(len(outs)) for p in range(self.P)]
        picks = sorted(rng.sample(cells, min(len(cells), self.cell["check"]["consensus_pairs"])))
        gen = torch.Generator(device=self.dev).manual_seed(generators.derive_seed(self.seed, 3))
        n_prog = n_ref = 0
        for j in sorted({j for j, _ in picks}):
            pairs = torch.tensor([p for jj, p in picks if jj == j], device=self.dev)
            o, b = outs[j], self.pool[outs[j]["pool"]]
            ref = refs[o["pool"]]
            p1, p2, keep = b["p1"][pairs], ref["pts"][pairs], ref["keep"][pairs]
            r = ref_ransac.ransac(gen, p1, p2, keep, self.H, self.tau, self.refits, "f64")
            n_ref += int(ref_ransac.gate(r["F"], p1, p2, keep, self.tau, "f64").sum())
            n_prog += int(ref_ransac.gate(o["F"][pairs].double(), p1, p2, keep, self.tau,
                                          "f64").sum())
        return 1.0 - n_prog / max(n_ref, 1)


def _quantile(sorted_values: List[float], q: float) -> float:
    """Linear-interpolated quantile of sorted values."""
    if not sorted_values:
        return float("nan")
    x = q * (len(sorted_values) - 1)
    i = int(x)
    j = min(i + 1, len(sorted_values) - 1)
    return sorted_values[i] + (sorted_values[j] - sorted_values[i]) * (x - i)


def _nan_max(x: Tensor) -> float:
    """The largest value, a NaN counting as unexplained."""
    x = torch.where(torch.isnan(x), torch.full_like(x, UNEXPLAINED), x)
    return min(float(x.max()), UNEXPLAINED)


def _malformed(F: Tensor, inliers: Tensor, count: Tensor) -> int:
    """Pairs whose count is not their mask's sum, or whose F is not finite,
    unit-norm (to 1e-4) and rank 2 (σ3/σ1 ≤ 1e-4)."""
    F = F.double()
    bad = count.long() != inliers.sum(-1)
    finite = torch.isfinite(F).flatten(1).all(-1)
    bad |= ~finite
    Ff = torch.where(finite[:, None, None], F, torch.zeros_like(F))
    sv = torch.linalg.svdvals(Ff)
    bad |= (Ff.flatten(1).norm(dim=-1) - 1.0).abs() > 1e-4
    bad |= sv[:, 2] > 1e-4 * sv[:, 0]
    return int(bad.sum())
