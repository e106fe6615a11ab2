"""Loop detection, verification and pose-graph closure — port of
``points_matching_tpu/pipelines/loop_closure.py`` (BASELINE config 3's
"pose-graph loop closure").

Loop detection is the all-pairs covisibility sweep (``parallel/all_pairs``,
kernel K1 on the card): frame-descriptor sets score against each other,
and candidates are high-scoring pairs at least ``min_gap`` frames apart.
The candidates are verified as one batch by two-view geometry (match on K1
→ RANSAC F on K3 and K2 → E → pose from E, with a parallax gate; each
kernel launched once for all candidates); verified loops become
pose-graph edges whose relative pose comes from E, with the translation
scale borrowed from the current trajectory (monocular scale is
unobservable from one pair).  The odometry chain and the loop edges are
optimised by ``ba/pose_graph`` and the corrected poses written back.

Host reads: the score matrix once (candidate selection is host logic, as
in the reference), the verification results once for all candidates, then
the pose graph's stopping test once per Gauss-Newton iteration.

Random samples: each candidate's RANSAC draws from a ``torch.Generator``
seeded from ``seed`` on the run's device, or takes injected minimal sets
(``f_samples``), so that the tests can feed the reference's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from points_matching_tpu_torch.ba.pose_graph import PoseGraph, optimize_pose_graph
from points_matching_tpu_torch.core.config import SfMConfig
from points_matching_tpu_torch.core.types import CameraIntrinsics, Descriptors, Pose, take
from points_matching_tpu_torch.geometry.fundamental import essential_from_fundamental
from points_matching_tpu_torch.geometry.pose import recover_pose
from points_matching_tpu_torch.geometry.ransac import ransac_fundamental
from points_matching_tpu_torch.ops.matching import match_descriptors
from points_matching_tpu_torch.parallel.all_pairs import all_pairs_scores

Tensor = torch.Tensor
Samples = Tuple[Tensor, Tensor]


@dataclasses.dataclass
class LoopCandidate:
    i: int
    j: int                      # j ≤ i - min_gap
    score: int                  # covisibility match count
    verified: bool = False
    num_inliers: int = 0


def detect_loop_candidates(
    desc: Tensor,                # [N, K, D] per-frame descriptors
    mask: Tensor,                # [N, K]
    min_gap: int = 5,
    min_score: int = 30,
    max_candidates: int = 5,
    ratio: float = 0.8,
) -> List[LoopCandidate]:
    """Covisibility-based loop candidates: high match-count pairs at least
    ``min_gap`` frames apart (per query frame, its best partner only — the
    first on ties), strongest first (a stable sort)."""
    scores = all_pairs_scores(desc, mask, ratio=ratio).cpu().numpy()   # one read
    n = scores.shape[0]
    cands: List[LoopCandidate] = []
    for i in range(n):
        far = np.arange(n) <= i - min_gap
        if not far.any():
            continue
        row = np.where(far, scores[i], -1)
        j = int(row.argmax())
        if row[j] >= min_score:
            cands.append(LoopCandidate(i=i, j=j, score=int(row[j])))
    cands.sort(key=lambda c: -c.score)
    return cands[:max_candidates]


def verify_loops(
    kps_i: Tensor, desc_i: Tensor, mask_i: Tensor,
    kps_j: Tensor, desc_j: Tensor, mask_j: Tensor,
    K: CameraIntrinsics,
    config: SfMConfig,
    generator: Optional[torch.Generator],
    min_inliers: int = 30,
    f_samples: Optional[Sequence[Samples]] = None,
) -> Tuple[Tensor, Pose, Tensor]:
    """Geometric verification of C candidates (inputs stacked [C, ...]) as
    one batch over the candidate axis, the port of the reference's
    ``_verify_loops_batched``: frame j's features matched to frame i's →
    RANSAC F → E → (R, t̂) → the parallax gate → the ``ok`` rule, each
    kernel launched once for all C.  Returns (ok [C], pose_i←j [C] with
    unit or zero translation, inliers [C]), on the device: nothing is read
    on the host.  ``f_samples``: one injected (sp1, sp2) [H, 8, 2] pair per
    candidate (then ``generator`` is not used)."""
    C = kps_i.shape[0]
    if f_samples is not None and len(f_samples) != C:
        raise ValueError(f"{len(f_samples)} sample sets for {C} candidates")
    samples = None if f_samples is None else \
        tuple(torch.stack([s[k] for s in f_samples]) for k in range(2))
    m = match_descriptors(Descriptors(data=desc_j, mask=mask_j),
                          Descriptors(data=desc_i, mask=mask_i), config.two_view.matcher)
    n = kps_j.shape[-2]
    pj = torch.take_along_dim(kps_j, m.query_idx.long().clamp(0, n - 1)[..., None], dim=-2)
    pi = torch.take_along_dim(kps_i, m.train_idx.long().clamp(0, n - 1)[..., None], dim=-2)
    est = ransac_fundamental(generator, pj, pi, m.mask, config.two_view.ransac,
                             samples=samples)
    Km = K.matrix()
    E = essential_from_fundamental(est.F, Km, Km)
    w = m.mask & est.inlier_mask
    pjn, pin = K.normalize_points(pj), K.normalize_points(pi)
    pose, _, cheir = recover_pose(E, pjn, pin, w)

    # Parallax gate: for a true revisit (near-zero baseline) the essential
    # translation direction is numerically meaningless — the inlier rays
    # barely move.  Median angular ray motion below ~0.6° ⇒ constrain the
    # loop edge to t = 0 instead of a garbage direction.
    def rays(p):
        r = torch.cat([p, torch.ones_like(p[..., :1])], -1)
        return r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)

    ri_rot = rays(pjn) @ pose.R.transpose(-1, -2)   # frame-j rays in frame i
    cosang = (rays(pin) * ri_rot).sum(-1).clamp(-1.0, 1.0)
    ang = torch.where(w, torch.arccos(cosang), torch.inf)
    k = (w.sum(-1, dtype=torch.int64) // 2).clamp_min(0)
    low_parallax = take(torch.sort(ang, -1).values, k) < 0.01   # [C]

    t = torch.where(low_parallax[..., None], torch.zeros_like(pose.t), pose.t)
    cheir_ok = cheir.sum(-1, dtype=torch.int32) >= min_inliers // 2
    ok = (est.num_inliers >= min_inliers) & (low_parallax | cheir_ok)
    return ok, Pose(R=pose.R, t=t), est.num_inliers


def verify_loop(
    kps_i: Tensor, desc_i: Tensor, mask_i: Tensor,
    kps_j: Tensor, desc_j: Tensor, mask_j: Tensor,
    K: CameraIntrinsics,
    config: SfMConfig,
    generator: Optional[torch.Generator],
    min_inliers: int = 30,
    samples: Optional[Samples] = None,
) -> Tuple[bool, Optional[Pose], int]:
    """Single-candidate wrapper (one read of the device at the end)."""
    ok, rel, ninl = verify_loops(
        *(x[None] for x in (kps_i, desc_i, mask_i, kps_j, desc_j, mask_j)), K, config,
        generator, min_inliers, None if samples is None else [samples])
    flat = torch.cat([ok.float(), ninl.float()]).cpu()
    if not bool(flat[0]):
        return False, None, int(flat[1])
    return True, rel[0], int(flat[1])


def close_loops(
    poses: Pose,                 # [C_max] current world→camera estimates
    num_cams: int,
    frames: Sequence[Tuple[Tensor, Tensor, Tensor]],  # (kps_xy, desc, mask)
    K: CameraIntrinsics,
    config: SfMConfig,
    seed: int = 0,
    min_gap: int = 5,
    min_score: int = 30,
    loop_weight: float = 10.0,
    f_samples: Optional[Sequence[Samples]] = None,
) -> Tuple[Pose, List[LoopCandidate]]:
    """Detect, verify and close loops over a registered trajectory, on the
    poses' device.

    Returns (corrected poses, the candidate list with verification flags).
    Odometry edges come from the current estimates (weight 1); verified
    loop edges get ``loop_weight``.  Monocular translation scale for each
    loop edge is set to the current-estimate baseline of that pair.
    ``f_samples``: one injected (sp1, sp2) per candidate, in the order
    ``detect_loop_candidates`` returns them.
    """
    C = num_cams
    dev = poses.t.device
    K = K.to(dev)
    desc = torch.stack([f[1] for f in frames[:C]])
    mask = torch.stack([f[2] for f in frames[:C]])
    cands = detect_loop_candidates(desc, mask, min_gap=min_gap, min_score=min_score,
                                   ratio=config.two_view.matcher.ratio)
    if not cands:
        return poses, cands

    # verification of every candidate on the device, read once
    kps = [f[0] for f in frames[:C]]

    def stack(xs, side):
        return torch.stack([xs[getattr(c, side)] for c in cands])

    generator = None if f_samples is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    ok_b, rel_b, ninl_b = verify_loops(
        stack(kps, "i"), stack(desc, "i"), stack(mask, "i"),
        stack(kps, "j"), stack(desc, "j"), stack(mask, "j"), K, config, generator,
        30, f_samples)
    t_norm = torch.linalg.vector_norm(rel_b.t, dim=-1)
    flags = torch.stack([ok_b.float(), ninl_b.float(), t_norm], -1).cpu().numpy()

    verified = []
    for n_c, c in enumerate(cands):
        c.verified = bool(flags[n_c, 0])
        c.num_inliers = int(flags[n_c, 1])
        if c.verified:
            verified.append((n_c, c))
    if not verified:
        return poses, cands

    # odometry chain from the current estimates, then the loop edges:
    # rel is cam_j → cam_i with |t| = 1 (or exactly 0 for a low-parallax
    # revisit); the translation scale is the current estimate's baseline
    # in float64, the pose graph's precision (ba/pose_graph.py)
    P = Pose(R=poses.R[:C].double(), t=poses.t[:C].double())
    idx = torch.arange(C - 1, device=dev)
    Z_odom = P[idx].compose(P[idx + 1].inverse())
    li = torch.stack([torch.full((), c.i, device=dev) for _, c in verified])
    lj = torch.stack([torch.full((), c.j, device=dev) for _, c in verified])
    rows = [n_c for n_c, _ in verified]
    R_loop = torch.stack([rel_b.R[n] for n in rows]).double()
    t_dir = torch.stack([rel_b.t[n] * float(flags[n, 2] > 0.5) for n in rows]).double()
    scale = torch.linalg.vector_norm(P[li].compose(P[lj].inverse()).t, dim=-1)
    Z = Pose(R=torch.cat([Z_odom.R, R_loop]), t=torch.cat([Z_odom.t, t_dir * scale[:, None]]))
    E = C - 1 + len(verified)
    g = PoseGraph(
        poses=P,
        edges_i=torch.cat([idx, li]).to(torch.int32),
        edges_j=torch.cat([idx + 1, lj]).to(torch.int32),
        Z=Z,
        weight=torch.cat([torch.ones(C - 1, dtype=torch.float64, device=dev),
                          torch.full((len(verified),), loop_weight, dtype=torch.float64,
                                     device=dev)]),
        mask=torch.ones(E, dtype=torch.bool, device=dev),
        fixed=torch.arange(C, device=dev) == 0)
    g_opt, _ = optimize_pose_graph(g)

    # write the corrected poses back into the fixed-capacity pose array
    full_R, full_t = poses.R.clone(), poses.t.clone()
    full_R[:C] = g_opt.poses.R.to(poses.R.dtype)
    full_t[:C] = g_opt.poses.t.to(poses.t.dtype)
    return Pose(R=full_R, t=full_t), cands
