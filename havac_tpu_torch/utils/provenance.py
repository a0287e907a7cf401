"""Measurement provenance stamp for the PyTorch engine.

Every number the port records carries the software and the card it came
from: torch and CUDA versions, the device's name, its power limit as
``nvidia-smi`` reports it (a card set below its maximum runs slower under
load), and whether the native host core was loaded.
"""

from __future__ import annotations

import subprocess
from typing import Dict

import torch


def power_limit() -> str:
    """``nvidia-smi``'s "name, power.limit" line for device 0, or
    "unavailable" where the tool is missing or fails."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unavailable"
    if res.returncode != 0:
        return "unavailable"
    lines = res.stdout.strip().splitlines()
    return lines[0].strip() if lines else "unavailable"


def provenance(device, native_active: bool) -> Dict:
    """The stamp dict for a run on ``device``."""
    device = torch.device(device)
    stamp = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": str(device),
        "native_active": bool(native_active),
    }
    if device.type == "cuda":
        stamp["device_name"] = torch.cuda.get_device_name(device)
        stamp["nvidia_smi"] = power_limit()
    return stamp
