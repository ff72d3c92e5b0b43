"""Device policy of the port.

A tensor on a CUDA device goes through the hand-written kernel; a tensor on
the CPU goes through the kernel's plain torch twin. There is no third path:
any other device raises, and nothing falls back from the kernel to the twin.
"""

from __future__ import annotations

import subprocess

import torch


def uses_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (hand kernel), False for a CPU one (twin)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or twin for device {t.device}")


def nvidia_smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`, one line per card."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip()


def describe(device) -> dict:
    """Versions and the card: torch, CUDA, device name, nvidia-smi line."""
    dev = torch.device(device)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": str(dev)}
    if dev.type == "cuda":
        out["name"] = torch.cuda.get_device_name(dev)
        out["count"] = torch.cuda.device_count()
        out["nvidia_smi"] = nvidia_smi()
    return out
