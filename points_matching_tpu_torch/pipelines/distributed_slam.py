"""Distributed SLAM by parallel submaps (BASELINE config 4: "KITTI 00 full
sequence — distributed SLAM with keyframes and map blocks sharded over
hosts") — port of ``points_matching_tpu/pipelines/distributed_slam.py``.

1. **Split** the sequence into S overlapping segments (``segment_frames``).
2. **Build submaps in parallel** (``build_submaps``): the segments are
   divided over the mesh's ``data`` ranks in contiguous blocks; each rank
   builds its segments as one batch with the port's incremental SfM over a
   leading segment axis (one bootstrap → one ``register_frame`` a frame step
   with a windowed BA every ``ba_every`` frames for the segments that
   registered → a full-window BA), and the submaps are all-gathered.  The
   reference vmaps one ``lax.scan`` over the segments; here the frame steps
   are a host loop and each kernel launches once a step for all segments.
   Segment s draws from its own ``torch.Generator``, seeded from (seed, s),
   and computes what it computes alone, so the world size changes no
   submap.
3. **Align** consecutive submaps on the host with a Sim(3) from the overlap
   frames they share, and merge them into one global problem
   (``merge_submaps``; numpy, copied from the reference).
4. **Gate** the merged observations by reprojection error on the host, then
   **refine globally** with sparse BA: observation-sharded over the mesh's
   ``model`` group when it has one (``parallel/sharded_ba.py``), on one
   process otherwise.

Every rank of the mesh returns the same result.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from points_matching_tpu_torch.ba.lm import LMStats
from points_matching_tpu_torch.ba.sparse import bundle_adjust_sparse, make_sparse_ba_state
from points_matching_tpu_torch.core.config import SfMConfig
from points_matching_tpu_torch.core.device import pin_fp32
from points_matching_tpu_torch.core.types import CameraIntrinsics, Pose
from points_matching_tpu_torch.geometry.ransac import Generators
from points_matching_tpu_torch.parallel.comm import pack, unpack
from points_matching_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_comm,
    has_axis,
)
from points_matching_tpu_torch.parallel.sharded_ba import distributed_bundle_adjust_sparse
from points_matching_tpu_torch.pipelines.sfm import (
    SfMState,
    bootstrap_two_view,
    camera_centers,
    init_sfm_state,
    local_bundle_adjust,
    register_frames_chunk,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Stages 1-2: submap building (device)
# ---------------------------------------------------------------------------

def build_submap(
    kps_xy: Tensor,     # [*B, T, N, 2]
    desc: Tensor,       # [*B, T, N, D]
    fmask: Tensor,      # [*B, T, N]
    K: CameraIntrinsics,
    generator: Optional[Generators],
    config: SfMConfig,
    ba_every: int = 4,
    f_samples: Optional[Tensor] = None,
    pnp_samples: Optional[Callable[[int, SfMState], Tensor]] = None,
) -> Tuple[SfMState, Tensor]:
    """One segment → one submap, or a batch of segments ([S, T, ...]
    inputs, S generators) → S submaps: bootstrap on frames 0-1,
    registration of the rest with a windowed BA after frame i with
    ``i % ba_every == 0`` for each segment that registered it, then a BA
    over the whole segment.  Returns (state, registered [*B, T] bool).

    ``f_samples`` [*B, candidates, H, 8] injects the bootstrap's minimal
    sets and ``pnp_samples(i, state)`` frame i's PnP sets ([*B, H, 6]; the
    reference's draws in the parity tests); then ``generator`` is not used
    for them."""
    T, N, D = desc.shape[-3:]
    state = init_sfm_state(config, N, D, device=desc.device, batch=desc.shape[:-3])

    def frame(i):
        return kps_xy[..., i, :, :], desc[..., i, :, :], fmask[..., i, :]

    state, st0 = bootstrap_two_view(state, *frame(0), *frame(1), K, generator, config,
                                    f_samples=f_samples)
    state, sts = register_frames_chunk(state, [frame(i) for i in range(2, T)], range(2, T),
                                       K, generator, config, ba_every,
                                       config.local_ba_window, pnp_samples=pnp_samples)
    state, _ = local_bundle_adjust(state, K, config, window=T)
    return state, torch.cat([torch.stack([st0.registered] * 2, -1), sts.registered], -1)


def segment_seed(seed: int, segment: int) -> int:
    """The generator seed of segment ``segment`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, segment]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def _leaves(st: SfMState):
    out = []
    for f in dataclasses.fields(SfMState):
        v = getattr(st, f.name)
        out += [v.R, v.t] if f.name == "poses" else [v]
    return out


def _from_leaves(leaves) -> SfMState:
    it = iter(leaves)
    fields = {}
    for f in dataclasses.fields(SfMState):
        fields[f.name] = Pose(R=next(it), t=next(it)) if f.name == "poses" else next(it)
    return SfMState(**fields)


def build_submaps(kps_xy: Tensor, desc: Tensor, fmask: Tensor, K: CameraIntrinsics,
                  seed: int, config: SfMConfig, mesh=None, ba_every: int = 4
                  ) -> Tuple[SfMState, Tensor]:
    """All S submaps ([S, T, ...] segment inputs) → (states stacked [S, ...],
    registered [S, T]).  With a mesh, data rank r builds segments
    [r·S/n, (r+1)·S/n) (S must divide the axis) as one batch and the states
    are all-gathered over ``data``, in one packed buffer."""
    S = kps_xy.shape[0]
    comm = axis_comm(mesh, DATA_AXIS)
    n = comm.size()
    if S % n:
        raise ValueError(f"num segments ({S}) must divide the data axis ({n})")
    b = S // n
    mine = slice(comm.index() * b, (comm.index() + 1) * b)
    gens = [torch.Generator(device=desc.device).manual_seed(segment_seed(seed, s))
            for s in range(S)[mine]]
    local, regs = build_submap(kps_xy[mine], desc[mine], fmask[mine], K, gens, config,
                               ba_every)
    if not has_axis(mesh, DATA_AXIS):
        return local, regs
    leaves = _leaves(local) + [regs]
    buf, spec = pack(leaves)
    parts = comm.all_gather(buf)                                  # [n, bytes]
    per_rank = [unpack(parts[r], spec) for r in range(n)]
    full = [torch.cat([p[k] for p in per_rank]) for k in range(len(leaves))]
    return _from_leaves(full[:-1]), full[-1]


# ---------------------------------------------------------------------------
# Stage 3: Sim(3) submap alignment (host)
# ---------------------------------------------------------------------------

def sim3_from_shared_frames(
    R_l: np.ndarray, t_l: np.ndarray,   # [J, 3, 3], [J, 3] local submap poses
    R_g: np.ndarray, t_g: np.ndarray,   # [J, 3, 3], [J, 3] same frames, global
    valid: np.ndarray,                  # [J] both-registered mask
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Sim(3) (c, R_a, t_a) with x_global = c·R_a·x_local + t_a from J
    overlap frames posed in both systems (world→camera poses).  Each frame
    votes R_a = R_gjᵀ·R_lj and the chordal mean fuses the votes; the scale
    is the ratio of the camera centres' spreads and the translation comes
    from their means, which stays well posed when the centres are collinear
    (straight driving), where centre-only Umeyama loses the roll."""
    idx = np.flatnonzero(valid)
    if idx.size < 2:
        raise ValueError(f"need >= 2 shared registered frames, got {idx.size}")
    R_l, t_l, R_g, t_g = R_l[idx], t_l[idx], R_g[idx], t_g[idx]

    M = np.einsum("jki,jkl->il", R_g, R_l)  # Σ R_gᵀ R_l
    U, _, Vt = np.linalg.svd(M)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R_a = U @ D @ Vt

    C_l = -np.einsum("jki,jk->ji", R_l, t_l)  # centres = -Rᵀ t
    C_g = -np.einsum("jki,jk->ji", R_g, t_g)
    mu_l, mu_g = C_l.mean(0), C_g.mean(0)
    spread_l = np.linalg.norm(C_l - mu_l, axis=-1).sum()
    spread_g = np.linalg.norm(C_g - mu_g, axis=-1).sum()
    c = float(spread_g / max(spread_l, 1e-12)) if spread_l > 1e-9 else 1.0
    t_a = mu_g - c * R_a @ mu_l
    return c, R_a, t_a


def _apply_sim3_to_poses(R: np.ndarray, t: np.ndarray, c: float, R_a: np.ndarray,
                         t_a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """World→camera poses re-expressed after x_g = c·R_a·x_l + t_a (the
    camera frame rescaled by c with the landmarks): R' = R·R_aᵀ,
    t' = c·t − R·R_aᵀ·t_a."""
    R_new = R @ R_a.T
    t_new = c * t - np.einsum("cij,j->ci", R_new, t_a)
    return R_new, t_new


# ---------------------------------------------------------------------------
# Stages 3-4: merge + global BA
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistributedSlamResult:
    poses: Pose                         # [C_g] global world→camera
    cam_valid: np.ndarray               # [C_g] bool
    X: Tensor                           # [L_g, 3] merged landmarks (after BA)
    trajectory: np.ndarray              # [C_g, 3] camera centres
    registered_per_segment: np.ndarray  # [S, T]
    ba_stats: Optional[LMStats]
    # host seconds of the stages, each ended by a read of the device:
    # submaps (build + gather), merge (+ outlier gate), global_ba
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def merge_submaps(states, regs, overlap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Chain Sim(3) alignments and fuse the submaps into one global problem.

    ``states`` is any stacked [S, ...] SfM state (the port's, or the
    reference's), ``regs`` [S, T].  Returns (R_g [C_g, 3, 3], t_g [C_g, 3],
    cam_valid [C_g]) and a dict of merged observation and landmark arrays.
    Segment s's local frame j is global frame s·(T − overlap) + j, so
    overlap frames coincide and both submaps' observations attach to one
    global camera."""
    regs = _np(regs).astype(bool)
    S, T = regs.shape
    stride = T - overlap
    C_g = (S - 1) * stride + T
    cam_mask = _np(states.cam_mask)
    C_cap = cam_mask.shape[1]
    X_all = _np(states.X)
    L_cap = X_all.shape[1]

    R_all = _np(states.poses.R)      # [S, C_cap, 3, 3]
    t_all = _np(states.poses.t)

    # camera SLOTS are registration-ordered (a frame that fails PnP does not
    # advance num_cams), so build the frame↔slot maps per segment; the
    # bootstrap always takes slots 0-1
    frame2slot = np.full((S, T), -1, np.int64)
    slot2frame = np.full((S, C_cap), -1, np.int64)
    for s in range(S):
        slot = 0
        for j in range(T):
            if j < 2 or regs[s, j]:
                frame2slot[s, j] = slot
                slot2frame[s, slot] = j
                slot += 1

    def frame_poses(seg):
        """Per-FRAME poses [T, 3, 3] / [T, 3] (slot 0's where unregistered)."""
        sl = np.clip(frame2slot[seg], 0, C_cap - 1)
        return R_all[seg, sl], t_all[seg, sl]

    # chain the Sim(3)s: segment 0 defines the global frame
    transforms = [(1.0, np.eye(3), np.zeros(3))]
    R_geo = np.tile(np.eye(3), (C_g, 1, 1))
    t_geo = np.zeros((C_g, 3))
    cam_valid = np.zeros((C_g,), bool)

    def place(seg, c, R_a, t_a, start_j):
        Rf, tf = frame_poses(seg)
        Rn, tn = _apply_sim3_to_poses(Rf, tf, c, R_a, t_a)
        base = seg * stride
        for j in range(start_j, T):
            gi = base + j
            if regs[seg, j] and frame2slot[seg, j] >= 0 and not cam_valid[gi]:
                R_geo[gi], t_geo[gi] = Rn[j], tn[j]
                cam_valid[gi] = True

    place(0, *transforms[0], 0)
    for s in range(1, S):
        # overlap frames: local j < overlap of segment s are global frames
        # already placed by segment s − 1
        gi0 = s * stride
        Rf, tf = frame_poses(s)
        both = np.logical_and(
            np.logical_and(regs[s, :overlap], frame2slot[s, :overlap] >= 0),
            cam_valid[gi0: gi0 + overlap],
        )
        c, R_a, t_a = sim3_from_shared_frames(
            Rf[:overlap], tf[:overlap],
            R_geo[gi0: gi0 + overlap], t_geo[gi0: gi0 + overlap], both,
        )
        transforms.append((c, R_a, t_a))
        place(s, c, R_a, t_a, overlap)

    # landmarks: segment s's slot l is global slot s·L_cap + l
    lm_mask = _np(states.lm_mask)
    X_parts, lmask_parts = [], []
    for s in range(S):
        c, R_a, t_a = transforms[s]
        X_parts.append(X_all[s] @ (c * R_a).T + t_a)
        lmask_parts.append(lm_mask[s])
    X_g = np.concatenate(X_parts)
    lm_valid = np.concatenate(lmask_parts)

    # observations: local SLOT → local frame → global camera index
    oc_local = _np(states.obs_cam)                                 # [S, O] slots
    frames_of = np.take_along_axis(slot2frame, np.clip(oc_local, 0, C_cap - 1), axis=1)
    obs_cam = (frames_of + (np.arange(S) * stride)[:, None]).reshape(-1)
    obs_lm = (_np(states.obs_lm) + (np.arange(S) * L_cap)[:, None]).reshape(-1)
    obs_uv = _np(states.obs_uv).reshape(-1, 2)
    obs_mask = np.logical_and(_np(states.obs_mask).reshape(-1), frames_of.reshape(-1) >= 0)
    obs_cam = np.clip(obs_cam, 0, C_g - 1)
    # drop observations of frames that never got a global pose
    obs_mask = np.logical_and(obs_mask, cam_valid[obs_cam])

    merged = dict(obs_cam=obs_cam.astype(np.int32), obs_lm=obs_lm.astype(np.int32),
                  obs_uv=obs_uv.astype(np.float32), obs_mask=obs_mask,
                  X=X_g.astype(np.float32), lm_valid=lm_valid)
    return R_geo, t_geo, cam_valid, merged


def segment_frames(kps_xy, desc, fmask, segment_len: int, overlap: int):
    """[F, ...] frame arrays (tensors or numpy) → [S, T, ...] overlapping
    segments, and the number of frames used (trailing frames that do not
    fill a segment are dropped)."""
    if overlap < 3:
        raise ValueError("need overlap >= 3 to estimate inter-submap Sim(3)")
    if segment_len <= overlap:
        raise ValueError("segment_len must exceed overlap")
    F = kps_xy.shape[0]
    stride = segment_len - overlap
    S = (F - overlap) // stride
    if S < 1:
        raise ValueError(f"sequence too short: {F} frames < {segment_len}")
    used = (S - 1) * stride + segment_len
    idx = np.arange(S)[:, None] * stride + np.arange(segment_len)[None, :]

    def take(x):
        return x[torch.from_numpy(idx).to(x.device)] if isinstance(x, torch.Tensor) else x[idx]

    return take(kps_xy), take(desc), take(fmask), used


def run_distributed_slam(
    kps_xy: Tensor,     # [F, N, 2]
    desc: Tensor,       # [F, N, D]
    fmask: Tensor,      # [F, N]
    K: CameraIntrinsics,
    config: SfMConfig = SfMConfig(),
    mesh=None,
    segment_len: int = 16,
    overlap: int = 4,
    seed: int = 0,
    global_ba: bool = True,
    ba_config=None,
    outlier_gate_px: float = 10.0,
) -> DistributedSlamResult:
    """Segment → submaps (over ``data``) → Sim(3) merge → outlier gate →
    global sparse BA (over ``model``), on the frames' device.

    The merge leaves outliers (duplicate landmarks from the overlaps,
    residual misalignment, per-submap mismatches), so before the global
    solve an observation whose reprojection error exceeds
    ``outlier_gate_px`` (or whose landmark sits behind its camera) is
    masked, and the BA defaults to a Huber loss (δ = 3 px), ≥ 20 LM
    iterations and ≥ 50 PCG steps unless ``ba_config`` overrides it."""
    pin_fp32()
    dev = desc.device
    K = K.to(dev)
    t0 = time.perf_counter()
    seg_k, seg_d, seg_m, _ = segment_frames(kps_xy, desc, fmask, segment_len, overlap)
    states, regs = build_submaps(seg_k, seg_d, seg_m, K, seed, config, mesh)
    regs = _np(regs).astype(bool)                  # waits for the submaps
    t1 = time.perf_counter()
    R_g, t_g, cam_valid, merged = merge_submaps(states, regs, overlap)
    C_g = R_g.shape[0]

    # ---- outlier gate (host) ---------------------------------------------
    fx, fy, cx, cy = (float(v) for v in (K.fx, K.fy, K.cx, K.cy))
    Xo = merged["X"][merged["obs_lm"]]
    Ro, to = R_g[merged["obs_cam"]], t_g[merged["obs_cam"]]
    Xc = np.einsum("oij,oj->oi", Ro, Xo) + to
    z = Xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * Xc[:, 0] / z + cx
        v = fy * Xc[:, 1] / z + cy
    err = np.hypot(u - merged["obs_uv"][:, 0], v - merged["obs_uv"][:, 1])
    keep = np.logical_and(z > 1e-3, np.nan_to_num(err, nan=np.inf) <= outlier_gate_px)
    merged["obs_mask"] = np.logical_and(merged["obs_mask"], keep)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev, dtype=dtype)

    poses = Pose(R=t(R_g), t=t(t_g))
    valid = t(cam_valid, torch.bool)
    t2 = time.perf_counter()
    ba_stats = None
    X_out = t(merged["X"])
    if global_ba:
        ba_state = make_sparse_ba_state(
            poses, X_out, t(merged["obs_cam"], torch.int32), t(merged["obs_lm"], torch.int32),
            t(merged["obs_uv"]), t(merged["obs_mask"], torch.bool),
            cam_fixed=~valid | (torch.arange(C_g, device=dev) <= 1))
        # the windowed budget of SfMConfig.ba assumes a warm start; the
        # merged problem starts cold, so it gets an offline budget
        cfg = ba_config if ba_config is not None else dataclasses.replace(
            config.ba,
            huber_delta=max(config.ba.huber_delta, 3.0),
            max_iterations=max(config.ba.max_iterations, 20),
            pcg_iterations=max(config.ba.pcg_iterations, 50),
            rtol=min(config.ba.rtol, 1e-6),
        )
        if has_axis(mesh, MODEL_AXIS):
            out, ba_stats = distributed_bundle_adjust_sparse(ba_state, K, mesh, cfg)
        else:
            out, ba_stats = bundle_adjust_sparse(ba_state, K, cfg)
        poses = Pose(R=torch.where(valid[:, None, None], out.poses.R, poses.R),
                     t=torch.where(valid[:, None], out.poses.t, poses.t))
        X_out = out.X

    traj = _np(camera_centers(poses, valid))
    seconds = dict(submaps=t1 - t0, merge=t2 - t1, global_ba=time.perf_counter() - t2)
    return DistributedSlamResult(poses=poses, cam_valid=cam_valid, X=X_out, trajectory=traj,
                                 registered_per_segment=regs, ba_stats=ba_stats,
                                 stage_seconds=seconds)
