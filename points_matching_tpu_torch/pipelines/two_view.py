"""Two-view pipeline — the reference demo end to end (port of
``points_matching_tpu/pipelines/two_view.py``).

detect → describe → match (kernel K1 for float descriptors, K4 for the
ORB configuration's binary ones) → filter → 8-point F (reference
semantics) or batched RANSAC (kernels K3 + K2) → residual audit → epilines,
on one device, with the same fixed-capacity outputs as the JAX pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from points_matching_tpu_torch.core.config import TwoViewConfig, surf_parity_config
from points_matching_tpu_torch.core.device import pin_fp32, resolve_device
from points_matching_tpu_torch.core.types import (
    Keypoints,
    Matches,
    TwoViewEstimate,
)
from points_matching_tpu_torch.geometry.fundamental import (
    compute_epilines,
    epipolar_residual_audit,
    find_fundamental,
    sampson_distance,
)
from points_matching_tpu_torch.geometry.ransac import ransac_fundamental
from points_matching_tpu_torch.ops.descriptors import extract_descriptors
from points_matching_tpu_torch.ops.detect import detect_keypoints
from points_matching_tpu_torch.ops.matching import match_descriptors, match_stats
from points_matching_tpu_torch.utils.profiling import stage

Tensor = torch.Tensor


@dataclasses.dataclass
class TwoViewResult:
    """Everything the reference demo prints/draws."""

    kps1: Keypoints
    kps2: Keypoints
    matches: Matches
    dist_min: Tensor         # reference's "Min Match" print
    dist_max: Tensor         # reference's "Max Match" print
    estimate: TwoViewEstimate
    p1: Tensor               # [M, 2] matched points image 1
    p2: Tensor               # [M, 2] matched points image 2
    residuals: Tensor        # [M] per-match p1ᵀFp2 (reference audit form)
    epilines2: Tensor        # [M, 3] lines in image 2 for p1


def two_view_pipeline(
    image1: Tensor,
    image2: Tensor,
    generator: Optional[torch.Generator] = None,
    config: TwoViewConfig = surf_parity_config(),
    samples: Optional[Tuple[Tensor, Tensor]] = None,
) -> TwoViewResult:
    """The full two-view geometry pipeline on the images' device.

    Args:
      image1, image2: [H, W] float32 grayscale (0-255), same device.
      generator: RANSAC sampling source (a ``torch.Generator`` on the
        images' device; seeded with 0 when None; unused without RANSAC).
      config: pipeline configuration (default: the reference demo's).
      samples: optional injected RANSAC minimal sets (sp1, sp2).
    """
    pin_fp32()
    with stage("two_view.detect"):
        kps1 = detect_keypoints(image1, config.detector)
        kps2 = detect_keypoints(image2, config.detector)

    with stage("two_view.describe"):
        d1 = extract_descriptors(image1, kps1, config.descriptor)
        d2 = extract_descriptors(image2, kps2, config.descriptor)

    with stage("two_view.match"):
        matches = match_descriptors(d1, d2, config.matcher)
        dmin, dmax = match_stats(matches)

    p1, p2 = matches.gather_points(kps1, kps2)
    w = matches.mask

    if config.use_ransac:
        if generator is None and samples is None:
            generator = torch.Generator(device=image1.device).manual_seed(0)
        with stage("two_view.ransac"):
            est = ransac_fundamental(generator, p1, p2, w, config.ransac, samples=samples)
    else:
        # OpenCV CV_FM_7POINT dispatch parity: 7-point for exactly 7 good
        # matches, normalized 8-point otherwise; among ≤3 root candidates
        # keep the best-supported one
        tau2 = config.ransac.inlier_threshold ** 2
        F_cand, cand_valid = find_fundamental(p1, p2, w)
        d_cand = sampson_distance(F_cand, p1[None], p2[None])        # [3, M]
        counts = ((d_cand < tau2) & w[None]).sum(-1, dtype=torch.int32)
        counts = torch.where(cand_valid, counts, -1)
        F = F_cand[counts.argmax()]
        inl = (sampson_distance(F, p1, p2) < tau2) & w
        _, res_mean = epipolar_residual_audit(F, p1, p2, w, form="reference")
        est = TwoViewEstimate(F=F, inlier_mask=inl,
                              num_inliers=inl.sum(dtype=torch.int32),
                              residual_mean=res_mean)

    residuals, _ = epipolar_residual_audit(est.F, p1, p2, w, form="reference")
    epilines2 = compute_epilines(p1, 1, est.F)
    return TwoViewResult(kps1=kps1, kps2=kps2, matches=matches, dist_min=dmin,
                         dist_max=dmax, estimate=est, p1=p1, p2=p2,
                         residuals=residuals, epilines2=epilines2)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(
            x, **{f.name: _to_cpu(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def run_two_view_demo(
    path1: str,
    path2: str,
    config: Optional[TwoViewConfig] = None,
    out_dir: Optional[str] = None,
    seed: int = 0,
    verbose: bool = True,
    device: str = "cuda",
) -> TwoViewResult:
    """Host entry point reproducing the reference demo's observable behavior:
    prints max/min match distance, the good-match and inlier counts and the
    mean epipolar residual, and writes the three windows it showed —
    keypoints, matches, epilines — as PNGs (needs PIL).  Runs on the CUDA
    device unless ``device="cpu"`` is asked, and raises where CUDA is
    missing.  Returns the result on the CPU."""
    import os

    import numpy as np

    from points_matching_tpu_torch.data.images import load_image
    from points_matching_tpu_torch.viz.draw import (
        draw_epilines,
        draw_keypoints,
        draw_matches,
        save_png,
    )

    dev = resolve_device(device)
    config = config or surf_parity_config()
    img1 = load_image(path1)
    img2 = load_image(path2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = two_view_pipeline(torch.from_numpy(img1).to(dev),
                            torch.from_numpy(img2).to(dev), gen, config)
    res = _to_cpu(res)

    if verbose:
        # the reference's console output, in order
        print(f"max match distance: {float(res.dist_max):.6f}")
        print(f"min match distance: {float(res.dist_min):.6f}")
        print(f"good matches: {int(res.matches.mask.sum())}")
        print(f"num inliers: {int(res.estimate.num_inliers)}")
        print(f"mean |p1' F p2| residual: {float(res.estimate.residual_mean):.6e}")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        save_png(draw_keypoints(img1, res.kps1), os.path.join(out_dir, "keypoints1.png"))
        save_png(draw_keypoints(img2, res.kps2, rich=True),
                 os.path.join(out_dir, "keypoints2.png"))
        save_png(draw_matches(img1, res.kps1, img2, res.kps2, res.matches),
                 os.path.join(out_dir, "matches.png"))
        ep_mask = np.asarray(res.matches.mask) & np.asarray(res.estimate.inlier_mask)
        save_png(draw_epilines(draw_keypoints(img2, res.kps2), np.asarray(res.epilines2),
                               ep_mask),
                 os.path.join(out_dir, "epilines.png"))
    return res
