"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full power limit of 700 W), the table every roofline
and utilization of the benchmark is held to. A card may be set below
700 W; :func:`power_limit_w` reads what this card is set to, and each
traced run reports it beside its shares.
"""

from __future__ import annotations

import subprocess
from typing import Optional

FP32_FLOPS = 67e12        # float32 outside the tensor cores
HBM_BYTES = 3.35e12       # bytes/s


def power_limit_w() -> Optional[float]:
    """The first card's power limit as ``nvidia-smi`` reads it, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
