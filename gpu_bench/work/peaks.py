"""Peak rates of the cards the benchmark knows, and the card's power limit.

NVIDIA H100 SXM5 data sheet: 67 TFLOP/s fp32 outside the tensor cores (an
FMA is two flops), 3.35 TB/s HBM3, rated at 700 W.  CUDA C++ Programming
Guide, arithmetic-instruction throughput for compute capability 9.0: 128
fp32 results a clock an SM, so one instruction per unfused operation is
half the flop rate.  A card set below 700 W runs slower under load, so the
benchmark prints ``power.limit`` beside these peaks.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional

PEAKS = {
    "h100": dict(flops=67e12, instr_per_s=33.5e12, hbm_bytes_per_s=3.35e12, rated_w=700.0),
}


def peaks_for(device_name: str) -> Dict[str, float]:
    """The peaks of a card by its name (``torch.cuda.get_device_name``);
    raises ``ValueError`` for a card the table does not name."""
    for key, peaks in PEAKS.items():
        if key in device_name.lower():
            return peaks
    raise ValueError(f"no peak rates known for {device_name!r}")


def nvidia_smi(fields: str) -> Optional[str]:
    """One ``nvidia-smi --query-gpu`` line of the first card, or None where
    the tool is missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None
