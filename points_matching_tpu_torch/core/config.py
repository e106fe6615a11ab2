"""Configuration dataclasses.

The reference hard-codes every constant (filenames ``main.cpp:14-15``,
Hessian threshold 8000 ``main.cpp:23``, the midpoint match filter
``main.cpp:65``, the F-estimation method flag ``main.cpp:98``).  Here every
knob is a frozen dataclass so configs are hashable.

Field for field the same as ``points_matching_tpu/core/config.py`` (same
names, same defaults), so a config converts between the two packages with
``dataclasses.asdict`` + ``core.convert.config_from_dict``.  Two knobs keep
their values but change meaning in this package:

* ``backend``: ``'auto'``/``'pallas'`` run the hand-written CUDA kernel on
  CUDA tensors and its plain PyTorch version on CPU tensors; ``'xla'`` runs
  the plain (distance-matrix / general solver) form on any device.
* ``score_mode``: both values score in exact fp32 (the fast/exact split
  exists only for bf16 MXU passes on the TPU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Keypoint detector configuration.

    ``kind='hessian'`` is the SURF-class blob detector (parity with the
    reference's ``SurfFeatureDetector(8000)``, ``main.cpp:23``);
    ``kind='fast'`` / ``'harris'`` are the corner families (BASELINE
    config 0 asks for an ORB-style path).
    """

    kind: str = "hessian"          # 'hessian' | 'fast' | 'harris'
    max_keypoints: int = 512       # static keypoint capacity (padded+masked)
    threshold: float = 8000.0      # response threshold (Hessian: parity w/ ref)
    num_octaves: int = 4           # scale-space octaves (SURF default, ref E2)
    layers_per_octave: int = 2     # intervals per octave (SURF default)
    nms_radius: int = 1            # non-max suppression radius (pixels)
    compute_orientation: bool = True
    border: int = 16               # ignore responses within this image border


@dataclasses.dataclass(frozen=True)
class DescriptorConfig:
    """Descriptor extractor configuration.

    ``kind='surf'`` → 64-dim float, unit-norm (parity with reference E4);
    ``kind='orb'``  → 256-bit binary, bit-packed into 8 uint32 words.
    """

    kind: str = "surf"             # 'surf' | 'orb'
    patch_size: int = 20           # support window in units of keypoint scale
    upright: bool = False          # skip orientation (SURF 'U-SURF' mode)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matcher configuration.

    ``filter='midpoint'`` reproduces the reference's keep-if
    ``d < min + (max-min)/2`` rule (``main.cpp:65``); ``'ratio'`` is Lowe's
    ratio test (the modern default); ``'threshold'`` is an absolute cut.
    """

    metric: str = "l2"             # 'l2' | 'hamming' | 'dot'
    filter: str = "ratio"          # 'ratio' | 'midpoint' | 'threshold' | 'none'
    ratio: float = 0.8             # Lowe ratio (distance best/second-best)
    threshold: float = 0.5         # absolute distance cut (filter='threshold')
    cross_check: bool = False      # mutual nearest-neighbor consistency
    max_matches: Optional[int] = None  # match-list capacity (None → N_query)
    compact: bool = True           # compact survivors to a dense prefix.
                                   # False returns matches in query order
                                   # with a boolean mask — the form for
                                   # mask-aware consumers (RANSAC); keep
                                   # True for fixed-capacity prefix
                                   # consumers (SfM observation tables)
    backend: str = "auto"          # 'auto' | 'xla' | 'pallas' — see the
                                   # module docstring
    compute_dtype: str = "f32"     # 'f32' | 'bf16' — 'bf16' rounds both
                                   # GEMM operands to bf16 and accumulates
                                   # in fp32.  Distances keep ~1e-2
                                   # accuracy — fine for ratio/threshold
                                   # gating; use f32 for exact parity


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Batched RANSAC configuration (extension beyond the reference, which
    calls ``findFundamentalMat`` without RANSAC — ``main.cpp:95-98``)."""

    num_hypotheses: int = 512      # all hypotheses evaluated in one batch
    sample_size: int = 8           # minimal sample size (ignored for '7pt')
    solver: str = "8pt"            # '8pt' | '7pt' — '7pt' draws 7-point
                                   # minimal samples (the flag the reference
                                   # passes, main.cpp:98) and scores all ≤3
                                   # cubic roots as extra hypotheses; more
                                   # sample-efficient at fixed H
    inlier_threshold: float = 1.5  # Sampson distance threshold (pixels)
    refit: bool = True             # least-squares refit on consensus set
    refit_iterations: int = 2      # refit/re-gate rounds after best model
    backend: str = "auto"          # 'auto' | 'xla' | 'pallas' — see the
                                   # module docstring
    score_mode: str = "fast"       # 'fast' | 'exact' — both exact fp32 here


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment (Levenberg-Marquardt + Schur complement)."""

    max_iterations: int = 20
    damping_init: float = 1e-3
    damping_up: float = 10.0
    damping_down: float = 0.1
    rtol: float = 1e-8             # relative cost decrease tolerance
    huber_delta: float = 0.0       # 0 → plain L2; >0 → Huber robust loss
    solver: str = "cholesky"       # 'cholesky' | 'pcg' (reduced camera system)
    pcg_iterations: int = 50
    obs_layout: str = "auto"       # sparse BA reduction layout: 'auto' |
                                   # 'sorted' | 'scatter', all one path
                                   # (the reference's two give the same
                                   # bits): sort once a BA call, then the
                                   # segmented-sum kernel, the same bits
                                   # on every run


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh for distributed execution (BASELINE configs 1, 4)."""

    axes: Tuple[str, ...] = ("data",)
    shape: Tuple[int, ...] = (1,)


@dataclasses.dataclass(frozen=True)
class TwoViewConfig:
    """End-to-end two-view pipeline (reference parity path + extensions)."""

    detector: DetectorConfig = DetectorConfig()
    descriptor: DescriptorConfig = DescriptorConfig()
    matcher: MatcherConfig = MatcherConfig()
    ransac: RansacConfig = RansacConfig()
    use_ransac: bool = True        # False → plain 8-point on all matches (ref parity)


@dataclasses.dataclass(frozen=True)
class SfMConfig:
    """Incremental SfM / SLAM configuration (BASELINE configs 3, 4)."""

    two_view: TwoViewConfig = TwoViewConfig()
    # Huber by default: SLAM observation lists always carry mis-associations
    # (duplicate landmarks, bad tracks) and one unbounded L2 residual can
    # steer every BA step.  Iteration budget sized for the windowed refresh
    # this config drives (re-entered every few frames near convergence).
    ba: BAConfig = BAConfig(huber_delta=3.0, max_iterations=6,
                            pcg_iterations=16, rtol=1e-4)
    # 2D↔3D matching (frame descriptors vs the landmark bank) must NOT use
    # the ratio test: duplicate landmarks make best ≈ second-best and the
    # ratio filter rejects perfectly good correspondences.  Absolute
    # threshold (unit-norm descriptors → same-point L2 typically < 0.5)
    # + MUTUAL cross-check: without it every unmapped keypoint still grabs
    # its nearest landmark and the junk swamps RANSAC PnP.
    map_matcher: MatcherConfig = MatcherConfig(
        metric="l2", filter="threshold", threshold=0.5, cross_check=True
    )
    # independent bootstrap RANSAC tries, selected by cheirality-consistent
    # landmark count (see pipelines/sfm.py bootstrap_two_view)
    bootstrap_candidates: int = 4
    # PnP RANSAC hypotheses for registration — deliberately larger than the
    # two-view F count: 6-point DLT samples need many more draws to survive
    # low inlier fractions
    pnp_hypotheses: int = 1024
    max_cameras: int = 128
    max_landmarks: int = 8192
    max_observations: int = 32768
    keyframe_min_inliers: int = 30
    local_ba_window: int = 8
    # Static observation capacity of the windowed local BA: the window
    # only needs the recent-observation suffix of the table.
    local_ba_obs: int = 4096
    loop_closure_min_score: float = 0.75
    pnp_min_inliers: int = 12


def surf_parity_config() -> TwoViewConfig:
    """The configuration that reproduces the reference demo's semantics:
    SURF-class Hessian detector (threshold 8000) → 64-d float descriptors →
    1-NN L2 match → midpoint filter → plain 8-point F (no RANSAC).
    Reference: ``Points Matching/main.cpp:23-98``."""
    return TwoViewConfig(
        detector=DetectorConfig(kind="hessian", threshold=8000.0),
        descriptor=DescriptorConfig(kind="surf"),
        matcher=MatcherConfig(metric="l2", filter="midpoint"),
        use_ransac=False,
    )


def orb_default_config() -> TwoViewConfig:
    """BASELINE config 0: ORB-style detect + brute-force match + ratio test +
    8-point RANSAC fundamental."""
    return TwoViewConfig(
        detector=DetectorConfig(kind="fast", threshold=20.0, max_keypoints=1024),
        descriptor=DescriptorConfig(kind="orb"),
        matcher=MatcherConfig(metric="hamming", filter="ratio", ratio=0.8),
        use_ransac=True,
    )


def named_config(name: str) -> TwoViewConfig:
    """The configurations the demo, the profiler and ``chip_smoke.py`` run
    by name: ``surf_parity`` (the reference demo), ``ransac`` (the demo's
    default: SURF-class + ratio 0.85 + batched RANSAC) and ``orb``
    (BASELINE config 0)."""
    if name == "surf_parity":
        return surf_parity_config()
    if name == "ransac":
        return dataclasses.replace(
            surf_parity_config(),
            matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.85),
            use_ransac=True)
    if name == "orb":
        return orb_default_config()
    raise ValueError(f"unknown configuration: {name!r}")
