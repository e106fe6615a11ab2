"""The check catches what it must: a run on the CPU (the harness's look for
a chip skipped: a rehearsal of the tiny copy) with the timed path broken
underneath comes out not correct, once for each fault a cell can have (a
step that returns its previous state, half of the batch left out and the
rest's answers reused, the exchange between chips left out, an answer
altered where it is produced, and RANSAC's search broken with F, mask and
count kept consistent); and the control (the reference in TF32, put in
the program's place) fails the check at the limits the cell states."""
import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpu_bench import faults, harness, rehearsal  # noqa: E402
from gpu_bench.drivers import retrieval, verify  # noqa: E402

SEED = 2**35 + 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = rehearsal.tiny_copy(str(tmp_path_factory.mktemp("bench")))
    rehearsal.add_ring_cell(root)
    return root


def _run(root, cell):
    return harness.run_cell(cell, SEED, 0.3, False, dev="cpu", root=root)


def _stale(fn):
    """``fn`` returning its previous call's answer (the first call's own)."""
    last = {}

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return wrapped


def _halve_matches(fn):
    """Matching on the first half of the pairs; the rest reuse its answers."""
    def wrapped(d1, d2, pts, cfg):
        h = d1.data.shape[0] // 2
        m, p = fn(dataclasses.replace(d1, data=d1.data[:h], mask=d1.mask[:h]),
                  dataclasses.replace(d2, data=d2.data[:h], mask=d2.mask[:h]), pts[:h], cfg)
        twice = lambda x: torch.cat([x, x])                      # noqa: E731
        return dataclasses.replace(m, **{f.name: twice(getattr(m, f.name))
                                         for f in dataclasses.fields(m)}), twice(p)
    return wrapped


def _alter_match(fn):
    """One kept row of pair 0 matched to another train row (its point with it)."""
    def wrapped(d1, d2, pts, cfg):
        m, p = fn(d1, d2, pts, cfg)
        i = int(m.mask[0].nonzero()[0])
        j = (int(m.train_idx[0, i]) + 1) % pts.shape[1]
        m.train_idx[0, i] = j
        p[0, i] = pts[0, j]
        return m, p
    return wrapped


def _alter_estimate(field):
    def outer(fn):
        def wrapped(*args, **kwargs):
            est = fn(*args, **kwargs)
            if field == "F":
                est.F[0] = est.F[1]
            else:
                est.num_inliers[0] += 1
            return est
        return wrapped
    return outer


VERIFY_FAULTS = {
    "previous_state": dict(match_descriptors_points=_stale, ransac_fundamental=_stale),
    "half_the_batch": dict(match_descriptors_points=_halve_matches),
    "altered_match": dict(match_descriptors_points=_alter_match),
    "altered_F": dict(ransac_fundamental=_alter_estimate("F")),
    "altered_count": dict(ransac_fundamental=_alter_estimate("count")),
}


def _scores_stale(fn):
    return _stale(fn)


def _scores_half(fn):
    def wrapped(desc, mask, ratio, **kwargs):
        s = fn(desc, mask, ratio, **kwargs)
        s[:, s.shape[1] // 2:] = 0
        return s
    return wrapped


def _scores_altered(fn):
    def wrapped(desc, mask, ratio, **kwargs):
        s = fn(desc, mask, ratio, **kwargs)
        s += (torch.arange(s.numel()).reshape(s.shape) == 5).to(s.dtype)
        return s
    return wrapped


RETRIEVAL_FAULTS = {"previous_state": _scores_stale, "half_the_batch": _scores_half,
                    "altered_score": _scores_altered}


def test_the_sound_path_is_correct(root):
    for cell in ("verify-8k", "retrieval-8k", "verify-wide", "retrieval-ring4"):
        assert _run(root, cell)["correct"] is True, cell


@pytest.mark.parametrize("cell", ["verify-8k", "verify-wide"])
@pytest.mark.parametrize("fault", sorted(VERIFY_FAULTS))
def test_a_broken_verification_is_not_correct(root, monkeypatch, cell, fault):
    for name, breaker in VERIFY_FAULTS[fault].items():
        monkeypatch.setattr(verify, name, breaker(getattr(verify, name)))
    r = _run(root, cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", ["verify-8k", "verify-wide"])
@pytest.mark.parametrize("fault", sorted(faults.SEARCH))
def test_a_broken_search_is_not_correct(root, cell, fault):
    """F, its mask and its count agree, so only ``consensus_short`` can
    tell: a 64th of the hypotheses, or the scorer's counts lost."""
    with faults.planted(fault):
        r = _run(root, cell)
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["consensus_short"]["value"] > r["checks"]["consensus_short"]["limit"]


@pytest.mark.parametrize("fault", sorted(RETRIEVAL_FAULTS))
def test_a_broken_sweep_is_not_correct(root, monkeypatch, fault):
    monkeypatch.setattr(retrieval, "all_pairs_scores",
                        RETRIEVAL_FAULTS[fault](retrieval.all_pairs_scores))
    r = _run(root, "retrieval-8k")
    assert r["correct"] is False, r["checks"]


def test_a_ring_without_its_exchange_is_not_correct(root, monkeypatch):
    """Rank 0's blocks never reach rank 1 (a rank that receives nothing
    gets zeros): the scores of rank 1's images against rank 0's are wrong."""
    from points_matching_tpu_torch.parallel import comm

    rehearsal.edit_json(os.path.join(root, "gpu_bench", "workloads", "retrieval-ring4.json"),
                        lambda cell: cell["check"].update(check_images=16))
    comm.set_fault_hook(lambda name, x: torch.zeros_like(x) if name == "ppermute" else x)
    try:
        r = _run(root, "retrieval-ring4")
    finally:
        comm.set_fault_hook(None)
    assert r["correct"] is False, r["checks"]


def _control_checks(root, cell, dev):
    """The control's numbers on the cell's inputs, judged at its limits."""
    spec = harness.resolve(harness.load_benchmark(root), cell, root)
    driver = harness.driver_for(spec, dev, SEED)
    driver.setup()
    driver.release()
    outs = [driver.control_outputs(j) for j in range(spec["workload"]["check"]["batches"])]
    return harness.judge(driver.judge(outs), spec["workload"]["check"]["limits"])


@pytest.mark.parametrize("cell", ["verify-8k", "verify-wide"])
def test_the_control_fails_the_check(tmp_path, cell):
    """The reference in TF32 in the program's place fails at least one of
    the cell's limits, here on 4 pairs of 2,048 correspondences (enough
    near the Sampson gate that TF32 moves some of them across it)."""
    root = rehearsal.tiny_copy(str(tmp_path / "bench"))
    for name in ("pairs_8k", "pairs_wide"):
        rehearsal.edit_json(os.path.join(root, "gpu_bench", "traffic", name + ".json"),
                        lambda mix: mix.update(keypoints=2048))
    checks = _control_checks(root, cell, "cpu")
    assert not all(c["ok"] for c in checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["verify-8k", "retrieval-8k", "verify-wide"])
def test_the_control_fails_the_check_at_the_cells_size(cell):
    """The same at the cell's own size, on the card (the retrieval cell's
    TF32 control flips rows at a near-tie a few times in a million: too
    rarely for the rehearsal's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's own size")
    checks = _control_checks(ROOT, cell, "cuda:0")
    assert not all(c["ok"] for c in checks.values()), checks
