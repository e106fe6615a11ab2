"""points_matching_tpu_torch — the PyTorch + CUDA port of points_matching_tpu.

The same two-view pipeline as the JAX package (Hessian detect → SURF
describe → L2 match → 8-point / batched RANSAC F → residual audit →
epilines; or the ORB configuration) and its incremental SfM (bootstrap from
E, RANSAC PnP registration, triangulation, windowed sparse bundle
adjustment: image → trajectory) with loop closure, written in PyTorch for
NVIDIA Hopper GPUs; the parallel layer (``parallel/``) runs the all-pairs
ring, pipeline stages, sharded bundle adjustment and distributed SLAM over
``torch.distributed`` process groups.  Every TPU kernel on those paths is a hand-written CUDA kernel under
``csrc/`` (built with ``nvcc`` for ``sm_90a`` at first use, see
``ops/kernels/_build.py``), with a plain PyTorch version beside it that CPU
tensors take.

This package imports torch, numpy and the standard library only — never
JAX or ``points_matching_tpu`` (the JAX package is the reference the parity
tests hold it against).
"""

__version__ = "0.1.0"

from points_matching_tpu_torch.ba.lm import bundle_adjust  # noqa: F401
from points_matching_tpu_torch.ba.sparse import bundle_adjust_sparse  # noqa: F401
from points_matching_tpu_torch.core import config, types  # noqa: F401
from points_matching_tpu_torch.core.device import pin_fp32, resolve_device  # noqa: F401
from points_matching_tpu_torch.geometry.fundamental import (  # noqa: F401
    compute_epilines,
    eight_point,
    epipolar_residual_audit,
    epipolar_residuals,
    find_fundamental,
    sampson_distance,
    seven_point,
)
from points_matching_tpu_torch.geometry.ransac import ransac_fundamental  # noqa: F401
from points_matching_tpu_torch.ops.descriptors import extract_descriptors  # noqa: F401
from points_matching_tpu_torch.ops.detect import detect_keypoints  # noqa: F401
from points_matching_tpu_torch.ops.matching import (  # noqa: F401
    knn_match,
    match_descriptors,
    match_descriptors_points,
)
from points_matching_tpu_torch.pipelines.two_view import (  # noqa: F401
    TwoViewResult,
    run_two_view_demo,
    two_view_pipeline,
)
from points_matching_tpu_torch.pipelines.sfm import run_incremental_sfm  # noqa: F401
