"""The two-view pipeline as GPipe stages — port of
``points_matching_tpu/pipelines/staged_two_view.py``.

``two_view_pipeline``'s detect → describe → match → geometry flow split
into four stage functions over one padded wire (a dict of tensors), so
microbatches of image pairs stream through ``parallel.pipeline_stages``:
with a ``stage`` mesh of four ranks each rank runs one stage, without one
the stages compose on one device.

Wire: every stage maps the wire to the same leaves, so it is the padded
union of all the stages' outputs; leaves a stage has not produced yet ride
as zeros.  Masks are int32.  Binary (ORB) descriptors ride as ``torch.int32``
words holding the reference's uint32 bits, as everywhere in the port.  The
reference's PRNG key leaf becomes a per-pair ``seed`` (int64): the geometry
stage seeds a ``torch.Generator`` on the pair's device with it.  Injected
RANSAC minimal sets (``samples=``) ride as two more leaves, ``sp1``/``sp2``,
and replace the draw.  Matching launches kernel K1 (SURF) or K4 (ORB), the
geometry stage K3 and K2, as ``two_view_pipeline`` does.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from points_matching_tpu_torch.core.config import TwoViewConfig
from points_matching_tpu_torch.core.device import pin_fp32
from points_matching_tpu_torch.core.types import Descriptors, Keypoints
from points_matching_tpu_torch.geometry.fundamental import epipolar_residual_audit
from points_matching_tpu_torch.geometry.ransac import ransac_fundamental
from points_matching_tpu_torch.ops.descriptors import extract_descriptors
from points_matching_tpu_torch.ops.detect import detect_keypoints
from points_matching_tpu_torch.ops.matching import match_descriptors

Tensor = torch.Tensor
Wire = Dict[str, Tensor]

_SURF_DIM = 64
_ORB_WORDS = 8  # 256 bits packed into 32-bit words


def _desc_leaf_spec(config: TwoViewConfig) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape tail, dtype) of the wire's descriptor leaves for a config."""
    if config.descriptor.kind == "surf":
        return (_SURF_DIM,), torch.float32
    if config.descriptor.kind == "orb":
        return (_ORB_WORDS,), torch.int32
    raise ValueError(f"staged two-view wire: unknown descriptor kind "
                     f"{config.descriptor.kind!r}")


def two_view_wire(images1: Tensor, images2: Tensor, seeds: Tensor, config: TwoViewConfig,
                  samples: Optional[Tuple[Tensor, Tensor]] = None) -> Wire:
    """The initial wire of a microbatch stream.

    Args:
      images1, images2: [M, H, W] float32 grayscale (0-255), one device.
      seeds: [M] int64, one RANSAC seed a pair.
      samples: optional injected minimal sets (sp1, sp2), each [M, H, S, 2].
    """
    d_tail, d_dtype = _desc_leaf_spec(config)
    M = images1.shape[0]
    K = config.detector.max_keypoints
    dev = images1.device

    def zf(*s):
        return torch.zeros((M,) + s, dtype=torch.float32, device=dev)

    def zi(*s):
        return torch.zeros((M,) + s, dtype=torch.int32, device=dev)

    wire: Wire = {"img1": images1.float(), "img2": images2.float(),
                  "seed": seeds.to(device=dev, dtype=torch.int64)}
    if samples is not None:
        wire["sp1"], wire["sp2"] = (s.to(device=dev, dtype=torch.float32) for s in samples)
    for i in ("1", "2"):
        wire[f"xy{i}"] = zf(K, 2)
        wire[f"scale{i}"] = zf(K)
        wire[f"angle{i}"] = zf(K)
        wire[f"kmask{i}"] = zi(K)
        wire[f"desc{i}"] = torch.zeros((M, K) + d_tail, dtype=d_dtype, device=dev)
    wire["p1"] = zf(K, 2)
    wire["p2"] = zf(K, 2)
    wire["mmask"] = zi(K)
    wire["F"] = zf(3, 3)
    wire["num_inliers"] = zi()
    wire["residual_mean"] = zf()
    return wire


def _wire_kps(w: Wire, i: str) -> Keypoints:
    return Keypoints(xy=w[f"xy{i}"], scale=w[f"scale{i}"], angle=w[f"angle{i}"],
                     score=torch.zeros_like(w[f"scale{i}"]), mask=w[f"kmask{i}"] != 0)


def two_view_stage_fns(config: TwoViewConfig) -> List[Callable[[Wire], Wire]]:
    """The four stage functions: detect → describe → match → geometry."""

    def s_detect(w: Wire) -> Wire:
        out = dict(w)
        for i in ("1", "2"):
            kps = detect_keypoints(w[f"img{i}"], config.detector)
            out[f"xy{i}"] = kps.xy
            out[f"scale{i}"] = kps.scale
            out[f"angle{i}"] = kps.angle
            out[f"kmask{i}"] = kps.mask.to(torch.int32)
        return out

    def s_describe(w: Wire) -> Wire:
        out = dict(w)
        for i in ("1", "2"):
            out[f"desc{i}"] = extract_descriptors(w[f"img{i}"], _wire_kps(w, i),
                                                  config.descriptor).data
        return out

    binary = config.descriptor.kind == "orb"

    def s_match(w: Wire) -> Wire:
        out = dict(w)
        d1 = Descriptors(data=w["desc1"], mask=w["kmask1"] != 0, binary=binary)
        d2 = Descriptors(data=w["desc2"], mask=w["kmask2"] != 0, binary=binary)
        matches = match_descriptors(d1, d2, config.matcher)
        out["p1"], out["p2"] = matches.gather_points(_wire_kps(w, "1"), _wire_kps(w, "2"))
        out["mmask"] = matches.mask.to(torch.int32)
        return out

    def s_geometry(w: Wire) -> Wire:
        out = dict(w)
        mask = w["mmask"] != 0
        if "sp1" in w:
            gen, samples = None, (w["sp1"], w["sp2"])
        else:
            # one host read a pair: the seed of its generator
            gen = torch.Generator(device=w["p1"].device).manual_seed(int(w["seed"]))
            samples = None
        est = ransac_fundamental(gen, w["p1"], w["p2"], mask, config.ransac,
                                 samples=samples)
        _, res_mean = epipolar_residual_audit(est.F, w["p1"], w["p2"], mask,
                                              form="reference")
        out["F"] = est.F
        out["num_inliers"] = est.num_inliers.to(torch.int32)
        out["residual_mean"] = res_mean
        return out

    return [s_detect, s_describe, s_match, s_geometry]


def staged_two_view(images1: Tensor, images2: Tensor, seeds: Tensor,
                    config: TwoViewConfig, mesh=None,
                    samples: Optional[Tuple[Tensor, Tensor]] = None) -> Wire:
    """Run a microbatch of pairs through the 4-stage pipeline (over
    ``mesh``'s ``stage`` group when given; composed on one device without).
    Returns the final wire, leading dim M, on every rank."""
    from points_matching_tpu_torch.parallel.pipeline import pipeline_stages

    pin_fp32()
    wire = two_view_wire(images1, images2, seeds, config, samples)
    return pipeline_stages(two_view_stage_fns(config), wire, mesh=mesh)
