"""Incremental SfM on one GPU — port of ``points_matching_tpu/pipelines/sfm.py``
(BASELINE config 3 without loop closure).

The map lives on the device in fixed-capacity tensors with validity masks
(world→camera poses, append-only landmark slots, an observation list).
Each registered frame: match to the previous frame and to the landmark bank
(kernel K1, three launches with the bank's cross-check), RANSAC PnP with a
motion prior, observation append, triangulation of new landmarks; every
``ba_every`` frames a windowed sparse BA.  The bootstrap runs match →
RANSAC F (kernels K3 and K2, once for all its candidates) → E → pose →
triangulation.

The reference jits each step and scans a chunk of frames on the device;
here the steps are eager PyTorch and the chunk is a host loop.  The host
reads the device in three places only: the LM loop's stopping test (once an
iteration), whether the frame that is due a local BA registered (once such
a frame), and the chunk's per-frame stats (once a chunk).

Rows a fixed-capacity append rejects get the position ``capacity``
(``_append_positions``); every write then goes to a copy with one spare
row that is sliced off (``core/types.put_rows``), the reference's
``mode="drop"``.
Rejects are never clamped onto a real slot, where they would race a
valid write.  Where two valid rows write one slot, the later row wins
(``put_rows_last``), as the reference's scatter does on the CPU.

Every step also takes a leading segment axis: a state with fields
[S, ...] (``init_sfm_state(..., batch=(S,))``) and frames [S, N, ...] are S
independent maps advanced together, the port of the reference's ``vmap``
over segments (``pipelines/distributed_slam.py``).  Each segment draws from
its own generator (a sequence of S), matches against its own bank, appends
into its own rows and gets its own windowed BA; each kernel launches once
for all S.  A state without the axis is the same code with no leading
index.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from points_matching_tpu_torch.ba.sparse import bundle_adjust_sparse, make_sparse_ba_state
from points_matching_tpu_torch.core.config import SfMConfig
from points_matching_tpu_torch.core.device import pin_fp32
from points_matching_tpu_torch.core.types import (
    CameraIntrinsics,
    Descriptors,
    Pose,
    put_rows,
    put_rows_last,
    take,
    take_rows,
)
from points_matching_tpu_torch.geometry.fundamental import essential_from_fundamental
from points_matching_tpu_torch.geometry.pnp import ransac_pnp
from points_matching_tpu_torch.geometry.pose import recover_pose
from points_matching_tpu_torch.geometry.ransac import Generators, ransac_fundamental
from points_matching_tpu_torch.geometry.triangulate import triangulate_dlt
from points_matching_tpu_torch.ops.matching import match_descriptors

Tensor = torch.Tensor


@dataclasses.dataclass
class SfMState:
    """Device-resident incremental-SfM map (all capacities fixed).  Every
    field may carry leading segment axes [*B] (one map per index).

    Attributes:
      poses:    Pose [C] world→camera per registered frame.
      cam_mask: [C] bool — registered frames.
      X:        [L, 3] landmark positions; lm_mask [L] bool.
      lm_desc:  [L, D] last-seen descriptor per landmark.
      obs_cam/obs_lm/obs_uv/obs_mask: [O]-capacity observation list.
      prev_kps_xy / prev_desc / prev_mask: the previous registered frame's
        features; prev_lm [N] int32 the landmark slot each of its keypoints
        observes, or -1 (track association).
      num_cams / num_lms / num_obs: 0-d int32 write cursors.
    """

    poses: Pose
    cam_mask: Tensor
    X: Tensor
    lm_mask: Tensor
    lm_desc: Tensor
    obs_cam: Tensor
    obs_lm: Tensor
    obs_uv: Tensor
    obs_mask: Tensor
    prev_kps_xy: Tensor
    prev_desc: Tensor
    prev_mask: Tensor
    prev_lm: Tensor
    num_cams: Tensor
    num_lms: Tensor
    num_obs: Tensor

    def replace(self, **kw) -> "SfMState":
        return dataclasses.replace(self, **kw)


def init_sfm_state(config: SfMConfig, num_features: int, desc_dim: int, *,
                   device, batch: Tuple[int, ...] = ()) -> SfMState:
    """An empty map, or ``batch`` of them ([*batch, ...] fields)."""
    C, L, O = config.max_cameras, config.max_landmarks, config.max_observations
    f32, i32 = torch.float32, torch.int32

    def zeros(*shape, dtype=f32):
        return torch.zeros((*batch, *shape), dtype=dtype, device=device)

    return SfMState(
        poses=Pose.identity((*batch, C), device=device),
        cam_mask=zeros(C, dtype=torch.bool),
        X=zeros(L, 3), lm_mask=zeros(L, dtype=torch.bool), lm_desc=zeros(L, desc_dim),
        obs_cam=zeros(O, dtype=i32), obs_lm=zeros(O, dtype=i32), obs_uv=zeros(O, 2),
        obs_mask=zeros(O, dtype=torch.bool),
        prev_kps_xy=zeros(num_features, 2), prev_desc=zeros(num_features, desc_dim),
        prev_mask=zeros(num_features, dtype=torch.bool),
        prev_lm=torch.full((*batch, num_features), -1, dtype=i32, device=device),
        num_cams=zeros(dtype=i32), num_lms=zeros(dtype=i32), num_obs=zeros(dtype=i32),
    )


# ---------------------------------------------------------------------------
# Fixed-capacity appends (scatter with drop-on-overflow), per leading index:
# a position tensor [*B, m] addresses the rows of [*B, n, ...]
# ---------------------------------------------------------------------------

def _lead(x: Tensor, like: Tensor) -> Tensor:
    """``x`` [*B] with trailing unit axes to broadcast against ``like``."""
    return x.reshape(*x.shape, *(1,) * (like.dim() - x.dim()))


def _append_positions(capacity: int, cursor: Tensor, rows_mask: Tensor) -> Tensor:
    """Target slot per input row: cursor + rank among the valid rows, or
    ``capacity`` (out of range on purpose) for invalid and overflowing
    rows, which every write below drops."""
    rank = torch.cumsum(rows_mask.to(torch.int32), -1) - 1
    pos = cursor[..., None] + rank
    ok = rows_mask & (pos < capacity)
    return torch.where(ok, pos, capacity).long()


def _count(mask: Tensor) -> Tensor:
    return mask.sum(-1, dtype=torch.int32)


def _append_obs(state_obs, cam, lm: Tensor, uv: Tensor, ok: Tensor):
    """Append (cam, lm, uv) for the rows ``ok`` [*B, m] to the observation
    list; ``cam`` is one camera slot per leading index ([*B] or a number)."""
    obs_cam, obs_lm, obs_uv, obs_mask, cursor = state_obs
    cap = obs_cam.shape[-1]
    sp = _append_positions(cap, cursor, ok)
    if isinstance(cam, torch.Tensor):
        cam = cam[..., None]
    return (put_rows(obs_cam, sp, cam), put_rows(obs_lm, sp, lm.to(torch.int32)),
            put_rows(obs_uv, sp, uv), put_rows(obs_mask, sp, True),
            torch.clamp_max(cursor + _count(ok), cap).to(torch.int32))


def _gather(x: Tensor, idx: Tensor, n: int) -> Tensor:
    return take_rows(x, idx.long().clamp(0, n - 1))


class StepStats(NamedTuple):
    registered: Tensor       # bool — frame accepted
    num_pnp_inliers: Tensor
    num_new_landmarks: Tensor
    pose: Pose


def bootstrap_two_view(
    state: SfMState,
    kps1_xy: Tensor, desc1: Tensor, mask1: Tensor,
    kps2_xy: Tensor, desc2: Tensor, mask2: Tensor,
    K: CameraIntrinsics,
    generator: Optional[Generators],
    config: SfMConfig,
    f_samples: Optional[Tensor] = None,
) -> Tuple[SfMState, StepStats]:
    """Initialize the map from the first two frames: match → RANSAC F →
    E → pose recovery (cheirality) → triangulation.

    ``config.bootstrap_candidates`` independent RANSAC runs are scored by
    their cheirality-consistent landmark count (the first wins a tie), not
    by epipolar inliers: a low-parallax F with many inliers can still put
    many points behind a camera.  The candidates run as one batch over a
    candidate axis (one launch of each kernel; the reference vmaps them), no
    sequential retries; with a segment axis ([S, N, ...] frames, S
    generators) all S·C candidates are that one batch.  ``f_samples``
    [*B, candidates, H, 8] injects the minimal sets as row indices into the
    match list.
    """
    tv = config.two_view
    matches = match_descriptors(Descriptors(data=desc1, mask=mask1),
                                Descriptors(data=desc2, mask=mask2), tv.matcher)
    lead = kps1_xy.shape[:-2]
    n1 = kps1_xy.shape[-2]
    p1 = _gather(kps1_xy, matches.query_idx, n1)
    p2 = _gather(kps2_xy, matches.train_idx, n1)
    p1n, p2n = K.normalize_points(p1), K.normalize_points(p2)
    Km = K.matrix()

    C = config.bootstrap_candidates
    m = p1.shape[-2]

    def cands(x):                                                 # [*B, C, M, ...]
        return x[..., None, :, :].expand(*lead, C, m, x.shape[-1])

    samples = None
    if f_samples is not None:
        idx = f_samples.long().flatten(-3)                        # [*B, C·H·8]
        samples = tuple(take_rows(p, idx).reshape(*f_samples.shape, 2) for p in (p1, p2))
    est = ransac_fundamental(generator, cands(p1), cands(p2),
                             matches.mask[..., None, :].expand(*lead, C, m), tv.ransac,
                             samples=samples)
    E = essential_from_fundamental(est.F, Km, Km)                 # [*B, C, 3, 3]
    w = matches.mask[..., None, :] & est.inlier_mask
    pose_c, X_c, cheir = recover_pose(E, cands(p1n), cands(p2n), w)
    z = X_c[..., 2]
    # depth sanity: drop points behind / too far (dimensionless |t| = 1)
    good_c = w & cheir & (z > 0.05) & (z < 100.0)                 # [*B, C, N]
    b = good_c.sum(-1).argmax(-1)                                 # first on ties
    n_inl, X_cam1, good = take(est.num_inliers, b), take(X_c, b), take(good_c, b)
    pose2 = Pose(R=take(pose_c.R, b), t=take(pose_c.t, b))

    L_cap = state.X.shape[-2]
    safe = _append_positions(L_cap, state.num_lms, good)
    ok = safe < L_cap
    d_new = _gather(desc1, matches.query_idx, n1)
    X_new = put_rows(state.X, safe, X_cam1)
    lm_mask = put_rows(state.lm_mask, safe, True)
    lm_desc = put_rows(state.lm_desc, safe, d_new)
    num_lms = torch.clamp_max(state.num_lms + _count(good), L_cap).to(torch.int32)

    obs = (state.obs_cam, state.obs_lm, state.obs_uv, state.obs_mask, state.num_obs)
    obs = _append_obs(obs, 0, safe, p1, ok)
    obs = _append_obs(obs, 1, safe, p2, ok)

    poses = Pose(R=state.poses.R.clone(), t=state.poses.t.clone())
    poses.R[..., 1, :, :] = pose2.R
    poses.t[..., 1, :] = pose2.t
    cam_mask = state.cam_mask | (torch.arange(state.cam_mask.shape[-1],
                                              device=kps1_xy.device) < 2)

    # track association for frame 2's keypoints: train index → landmark slot
    n2 = kps2_xy.shape[-2]
    t_idx = matches.train_idx.long().clamp(0, n2 - 1)
    prev_lm = put_rows_last(
        torch.full((*lead, n2), -1, dtype=torch.int32, device=kps2_xy.device),
        torch.where(ok, t_idx, n2), torch.where(ok, safe, -1).to(torch.int32))

    n_new = _count(good)
    new_state = state.replace(
        poses=poses, cam_mask=cam_mask, X=X_new, lm_mask=lm_mask, lm_desc=lm_desc,
        obs_cam=obs[0], obs_lm=obs[1], obs_uv=obs[2], obs_mask=obs[3], num_obs=obs[4],
        num_lms=num_lms, prev_kps_xy=kps2_xy, prev_desc=desc2, prev_mask=mask2,
        prev_lm=prev_lm, num_cams=torch.full_like(state.num_cams, 2))
    stats = StepStats(registered=n_new >= config.keyframe_min_inliers,
                      num_pnp_inliers=n_inl, num_new_landmarks=n_new, pose=pose2)
    return new_state, stats


class Association(NamedTuple):
    """A frame's 2D↔3D correspondences: the track rows (frame ↔ previous
    frame, then the previous keypoint's landmark) followed by the bank rows
    (frame → landmark bank).  Every field has the frame's leading axes."""

    m2d_mask: Tensor      # [N] frame ↔ previous-frame match survived
    q2: Tensor            # [N] frame keypoint of each track row
    p2: Tensor            # [N] previous-frame keypoint of each track row
    tracked: Tensor       # [N] the previous keypoint observes a landmark
    corr_q: Tensor        # [2N] frame keypoint per correspondence
    corr_l: Tensor        # [2N] landmark slot per correspondence
    corr_m: Tensor        # [2N] validity
    logits: Tensor        # [2N] minimal-set sampling log-weights


def associate(state: SfMState, desc: Tensor, fmask: Tensor, config: SfMConfig
              ) -> Association:
    """Match a frame to the previous frame (tracks) and to the landmark
    bank (threshold + mutual cross-check, ``config.map_matcher``); with a
    segment axis each segment's frame against its own previous frame and
    bank, three K1 launches for all of them."""
    L = state.X.shape[-2]
    n = desc.shape[-2]
    frame = Descriptors(data=desc, mask=fmask)
    m2d = match_descriptors(frame, Descriptors(data=state.prev_desc, mask=state.prev_mask),
                            config.two_view.matcher)
    q2 = m2d.query_idx.long().clamp(0, n - 1)
    p2 = m2d.train_idx.long().clamp(0, n - 1)
    track_lm = torch.where(m2d.mask, take_rows(state.prev_lm, p2), -1)
    tracked = track_lm >= 0
    m3d = match_descriptors(frame, Descriptors(data=state.lm_desc, mask=state.lm_mask),
                            config.map_matcher)
    corr_q = torch.cat([q2, m3d.query_idx.long().clamp(0, n - 1)], -1)
    corr_l = torch.cat([track_lm.long().clamp(0, L - 1),
                        m3d.train_idx.long().clamp(0, L - 1)], -1)
    corr_m = torch.cat([tracked, m3d.mask], -1)
    # tracked rows are frame-to-frame precise: bias the 6-point draws to them
    logits = torch.cat([torch.full(q2.shape, 2.0, device=desc.device),
                        torch.zeros(m3d.query_idx.shape, device=desc.device)], -1)
    return Association(m2d.mask, q2, p2, tracked, corr_q, corr_l, corr_m, logits)


def register_frame(
    state: SfMState,
    kps_xy: Tensor, desc: Tensor, fmask: Tensor,
    K: CameraIntrinsics,
    generator: Optional[Generators],
    config: SfMConfig,
    pnp_samples: Optional[Tensor] = None,
) -> Tuple[SfMState, StepStats]:
    """Register one frame against the map: associate (``associate``) →
    RANSAC PnP on the union of track and bank rows, with the last pose as
    an extra hypothesis → observations for the PnP inliers (one per
    landmark) and a descriptor refresh → new landmarks from the frame ↔
    previous-frame matches that have none, triangulated and gated by
    cheirality, depth and reprojection in both views.  With a segment axis,
    frame s of [S, N, ...] registers against map s (S generators).
    ``pnp_samples`` [*B, H, 6] injects the minimal sets as rows of the
    correspondence list."""
    with record_function("sfm.associate"):
        a = associate(state, desc, fmask, config)
    X3d = take_rows(state.X, a.corr_l)
    uvn = K.normalize_points(take_rows(kps_xy, a.corr_q))
    prev_cam = (state.num_cams - 1).clamp_min(0)
    prev_pose = Pose(R=take(state.poses.R, prev_cam), t=take(state.poses.t, prev_cam))
    samples = None
    if pnp_samples is not None:
        idx = pnp_samples.long().flatten(-2)
        samples = (take_rows(X3d, idx).reshape(*pnp_samples.shape, 3),
                   take_rows(uvn, idx).reshape(*pnp_samples.shape, 2))
    with record_function("sfm.pnp"):
        pnp = ransac_pnp(generator, X3d, uvn, a.corr_m,
                         num_hypotheses=config.pnp_hypotheses,
                         inlier_threshold=config.two_view.ransac.inlier_threshold
                         / K.fx.clamp_min(1.0),
                         sample_logits=a.logits, prior_pose=prev_pose, samples=samples)
    with record_function("sfm.map_update"):
        return _update_map(state, kps_xy, desc, fmask, K, config, a, prev_pose, pnp)


def _update_map(state: SfMState, kps_xy: Tensor, desc: Tensor, fmask: Tensor,
                K: CameraIntrinsics, config: SfMConfig, a: Association, prev_pose: Pose,
                pnp) -> Tuple[SfMState, StepStats]:
    """``register_frame`` after PnP: observations for the inliers and the
    descriptor refresh, new landmarks, the pose, the track associations."""
    cam_idx = state.num_cams
    prev_cam = (cam_idx - 1).clamp_min(0)
    C, L = state.cam_mask.shape[-1], state.X.shape[-2]
    lead, n = kps_xy.shape[:-2], kps_xy.shape[-2]
    dev = kps_xy.device
    corr_q, corr_l, q2, p2_ = a.corr_q, a.corr_l, a.q2, a.p2
    uv = take_rows(kps_xy, corr_q)
    thr_px = config.two_view.ransac.inlier_threshold
    registered = pnp.num_inliers >= config.pnp_min_inliers
    reg = registered[..., None]

    # -- observations + descriptor refresh: the first inlier row per slot --
    n_corr = corr_q.shape[-1]
    inl = pnp.inlier_mask & a.corr_m
    ar = torch.arange(n_corr, device=dev).expand(corr_q.shape)
    first_of_lm = torch.full((*lead, L + 1), n_corr, dtype=torch.long, device=dev)
    first_of_lm = first_of_lm.scatter_reduce(-1, torch.where(inl, corr_l, L), ar, "amin")
    good_obs = inl & (first_of_lm.gather(-1, corr_l) == ar) & reg

    obs = (state.obs_cam, state.obs_lm, state.obs_uv, state.obs_mask, state.num_obs)
    obs = _append_obs(obs, cam_idx, corr_l, uv, good_obs)
    lm_desc = put_rows(state.lm_desc, torch.where(good_obs, corr_l, L), take_rows(desc, corr_q))

    # -- new landmarks: frame ↔ prev matches whose prev keypoint has no
    # landmark and whose query landed no map observation this frame --------
    has_obs_q = put_rows(torch.zeros((*lead, n), dtype=torch.bool, device=dev),
                         torch.where(good_obs, corr_q, n), True)
    cand = a.m2d_mask & ~a.tracked & ~take_rows(has_obs_q, q2)
    uv_c = take_rows(kps_xy, q2)
    uv_p = take_rows(state.prev_kps_xy, p2_)
    Xn, cheir = triangulate_dlt(prev_pose.matrix34(), pnp.pose.matrix34(),
                               K.normalize_points(uv_p), K.normalize_points(uv_c))
    zc = pnp.pose.transform(Xn)[..., 2]

    def reproj_err_px(pose, uv_obs):
        Xc = pose.transform(Xn)
        d = Xc[..., :2] / Xc[..., 2:3].clamp_min(1e-6) - K.normalize_points(uv_obs)
        return torch.linalg.vector_norm(d, dim=-1) * K.fx

    # a false frame ↔ prev match triangulates to a point whose rays do not
    # meet: gate the reprojection in both views; only a trusted pose (≥
    # keyframe_min_inliers) may grow the map
    trusted = pnp.num_inliers >= config.keyframe_min_inliers
    new_ok = (cand & cheir & (zc > 0.05) & (zc < 100.0)
              & (reproj_err_px(prev_pose, uv_p) < thr_px)
              & (reproj_err_px(pnp.pose, uv_c) < thr_px) & reg & trusted[..., None])

    lsp = _append_positions(L, state.num_lms, new_ok)
    lok = lsp < L
    X_new = put_rows(state.X, lsp, Xn)
    lm_mask = put_rows(state.lm_mask, lsp, True)
    lm_desc = put_rows(lm_desc, lsp, take_rows(desc, q2))
    num_lms = torch.clamp_max(state.num_lms + _count(new_ok), L).to(torch.int32)
    obs = _append_obs(obs, prev_cam, lsp, uv_p, lok)
    obs = _append_obs(obs, cam_idx, lsp, uv_c, lok)

    # -- pose ----------------------------------------------------------------
    slot = torch.where(cam_idx < C, cam_idx, C)[..., None]       # C: dropped
    cur = cam_idx.clamp_max(C - 1)
    R_new = torch.where(_lead(registered, pnp.pose.R), pnp.pose.R, take(state.poses.R, cur))
    t_new = torch.where(reg, pnp.pose.t, take(state.poses.t, cur))
    poses = Pose(R=put_rows(state.poses.R, slot, R_new[..., None, :, :]),
                 t=put_rows(state.poses.t, slot, t_new[..., None, :]))
    cam_mask = put_rows(state.cam_mask, slot, reg)
    num_cams = torch.where(registered, cam_idx + 1, cam_idx).to(torch.int32)

    # track associations of this frame's keypoints: map observations keep
    # their landmark, new landmarks get their new slot
    prev_lm_new = torch.full((*lead, n), -1, dtype=torch.int32, device=dev)
    prev_lm_new = put_rows_last(prev_lm_new, torch.where(good_obs, corr_q, n),
                                corr_l.to(torch.int32))
    prev_lm_new = put_rows_last(prev_lm_new, torch.where(lok, q2, n), lsp.to(torch.int32))

    new_state = state.replace(
        poses=poses, cam_mask=cam_mask, X=X_new, lm_mask=lm_mask, lm_desc=lm_desc,
        obs_cam=obs[0], obs_lm=obs[1], obs_uv=obs[2], obs_mask=obs[3], num_obs=obs[4],
        num_lms=num_lms, num_cams=num_cams,
        prev_kps_xy=torch.where(_lead(registered, kps_xy), kps_xy, state.prev_kps_xy),
        prev_desc=torch.where(_lead(registered, desc), desc, state.prev_desc),
        prev_mask=torch.where(reg, fmask, state.prev_mask),
        prev_lm=torch.where(reg, prev_lm_new, state.prev_lm))
    stats = StepStats(registered=registered, num_pnp_inliers=pnp.num_inliers,
                      num_new_landmarks=_count(new_ok), pose=pnp.pose)
    return new_state, stats


def local_bundle_adjust(state: SfMState, K: CameraIntrinsics, config: SfMConfig,
                        window: int = 8, active: Optional[Tensor] = None
                        ) -> Tuple[SfMState, Tensor]:
    """Windowed sparse BA over the last ``window`` registered cameras, on the
    last ``config.local_ba_obs`` rows of the observation list (observations
    append in time order, so those are the window's).

    Cameras outside the window, the window's first camera and cameras 0–1
    stay fixed; landmarks created before the slice (slot ≤ the largest slot
    observed before it — slots are append-only) are held fixed, so their
    in-slice observations pin the free cameras and the monocular scale.
    With a segment axis each map gets its own window, slice and LM loop;
    ``active`` [*B] (all by default) leaves the maps it marks False
    untouched.  Returns (state with the adjusted poses and landmarks, final
    cost [*B]).
    """
    C, L = state.cam_mask.shape[-1], state.X.shape[-2]
    O = state.obs_cam.shape[-1]
    Ow = min(config.local_ba_obs, O)
    dev = state.X.device
    first = (state.num_cams - window).clamp_min(0)[..., None]
    cams = torch.arange(C, device=dev)
    in_win = (cams >= first) & (cams < state.num_cams[..., None])

    start = (state.num_obs - Ow).clamp(0, O - Ow)[..., None]
    rows = start + torch.arange(Ow, device=dev)
    pre = state.obs_mask & (torch.arange(O, device=dev) < start)
    max_slot_pre = torch.where(pre, state.obs_lm, -1).amax(-1, keepdim=True)
    fixed = ~in_win | (cams <= first) | (cams <= 1)
    ba_state = make_sparse_ba_state(
        state.poses, state.X, take_rows(state.obs_cam, rows), take_rows(state.obs_lm, rows),
        take_rows(state.obs_uv, rows), take_rows(state.obs_mask, rows), cam_fixed=fixed,
        lm_fixed=torch.arange(L, device=dev) <= max_slot_pre)
    with record_function("sfm.local_ba"):
        out, stats = bundle_adjust_sparse(ba_state, K, config.ba, active=active)
    # cam_fixed / lm_fixed zero their updates exactly inside the solver
    return state.replace(poses=out.poses, X=out.X), stats.final_cost


def register_frames_chunk(
    state: SfMState,
    frames: Sequence[Tuple[Tensor, Tensor, Tensor]],
    frame_idx: Sequence[int],
    K: CameraIntrinsics,
    generator: Optional[Generators],
    config: SfMConfig,
    ba_every: int,
    window: int,
    pnp_samples=None,
) -> Tuple[SfMState, StepStats]:
    """Register a chunk of frames, with a local BA after each frame whose
    global index is a multiple of ``ba_every``, for the maps that registered
    it (the only per-frame read of the device: whether any did).  With a
    segment axis every frame is [S, N, ...] and each map gets its own BA
    decision, the reference's ``lax.cond`` under ``vmap``.
    ``pnp_samples(i, state)`` injects frame i's PnP sets.  Returns the
    stats stacked over the chunk (last axis), still on the device."""
    stats = []
    for (xy, d, m), i in zip(frames, frame_idx):
        ps = None if pnp_samples is None else pnp_samples(i, state)
        state, st = register_frame(state, xy, d, m, K, generator, config, pnp_samples=ps)
        if i % ba_every == 0 and bool(st.registered.any()):
            state, _ = local_bundle_adjust(state, K, config, window, active=st.registered)
        stats.append(st)
    stacked = StepStats(
        registered=torch.stack([s.registered for s in stats], -1),
        num_pnp_inliers=torch.stack([s.num_pnp_inliers for s in stats], -1),
        num_new_landmarks=torch.stack([s.num_new_landmarks for s in stats], -1),
        pose=Pose(R=torch.stack([s.pose.R for s in stats], -3),
                  t=torch.stack([s.pose.t for s in stats], -2)))
    return state, stacked


@dataclasses.dataclass
class SfMResult:
    state: SfMState
    trajectory: Tensor            # [C, 3] camera centres (world frame)
    registered: List[bool]
    stats: List[StepStats]        # per frame, on the CPU


def camera_centers(poses: Pose, mask: Tensor) -> Tensor:
    """World-frame camera centres −Rᵀt (masked rows zeroed)."""
    c = -(poses.R * poses.t[..., :, None]).sum(-2)
    return torch.where(mask[..., None], c, torch.zeros_like(c))


def _to_cpu_stats(st: StepStats) -> StepStats:
    """Stats of one frame ([]) or a chunk ([F]) on the host, in one copy."""
    lead = st.registered.shape
    flat = torch.cat([torch.stack([st.registered.float(), st.num_pnp_inliers.float(),
                                   st.num_new_landmarks.float()], -1),
                      st.pose.R.flatten(-2), st.pose.t], -1).cpu()
    return StepStats(flat[..., 0] > 0, flat[..., 1].int(), flat[..., 2].int(),
                     Pose(R=flat[..., 3:12].reshape(*lead, 3, 3), t=flat[..., 12:15]))


def run_incremental_sfm(
    frames,
    K: CameraIntrinsics,
    config: SfMConfig = SfMConfig(),
    seed: int = 0,
    ba_every: int = 4,
    chunk_size: int = 16,
) -> SfMResult:
    """Bootstrap on the first two frames, register the rest ``chunk_size``
    frames at a time (stats read once a chunk), then one last local BA.

    Args:
      frames: sequence of (kps_xy [N, 2], desc [N, D], mask [N]) tensors,
        all on one device (the run's device).
      K: intrinsics (moved to the frames' device).
      seed: seeds the run's ``torch.Generator`` on that device.
    """
    frames = list(frames)
    if len(frames) < 2:
        raise ValueError("need at least two frames")
    pin_fp32()
    dev = frames[0][0].device
    K = K.to(dev)
    n_feat, d_dim = frames[0][1].shape
    state = init_sfm_state(config, n_feat, d_dim, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)

    state, st = bootstrap_two_view(state, *frames[0], *frames[1], K, generator, config)
    stats_all = [_to_cpu_stats(st)]
    registered = [True, True]

    rest = frames[2:]
    for c0 in range(0, len(rest), chunk_size):
        chunk = rest[c0:c0 + chunk_size]
        idx = range(c0 + 2, c0 + 2 + len(chunk))
        state, sts = register_frames_chunk(state, chunk, idx, K, generator, config,
                                           ba_every, config.local_ba_window)
        sts = _to_cpu_stats(sts)                  # one read a chunk
        for j in range(len(chunk)):
            stj = StepStats(sts.registered[j], sts.num_pnp_inliers[j],
                            sts.num_new_landmarks[j], sts.pose[j])
            stats_all.append(stj)
            registered.append(bool(stj.registered))

    state, _ = local_bundle_adjust(state, K, config, window=config.local_ba_window)
    return SfMResult(state=state, trajectory=camera_centers(state.poses, state.cam_mask),
                     registered=registered, stats=stats_all)
