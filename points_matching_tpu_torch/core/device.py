"""Device choice and fp32 precision for the port.

Two jobs, both explicit:

* ``pin_fp32()`` turns TF32 off for matmuls and for cuDNN convolutions.
  Geometry needs true fp32: with truncated matmul operands the reference
  images gave 69 RANSAC inliers instead of 326.  PyTorch already computes
  fp32 matmuls in fp32 by default, but cuDNN runs fp32 convolutions in TF32
  by default, and the detector's Hessian response is a convolution.
* ``resolve_device(name)`` maps a device name to a ``torch.device``.  Only
  ``"cpu"`` gives the CPU; every other name is a CUDA device or an error,
  so a request on a machine without CUDA raises instead of carrying on on
  the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


def pin_fp32() -> None:
    """Disable TF32 for fp32 matmuls (cuBLAS) and convolutions (cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: Union[str, torch.device] = "cuda") -> torch.device:
    """``"cpu"``/``"cuda"``/``"cuda:N"`` → that device.  Raises RuntimeError
    for a CUDA request on a machine without a usable CUDA device, and
    ValueError for any other name."""
    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise ValueError(f"unsupported device {name!r}") from e
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
