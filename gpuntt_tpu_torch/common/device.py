"""Device probing utilities.

The port's equivalent of the reference's `CudaDevice` probe
(src/lib/common/common.cu:13-22), built on `torch.cuda`.
"""

from __future__ import annotations

import subprocess

import torch

from .errors import NTTDeviceError


def available_devices(platform: str | None = None) -> list[torch.device]:
    """Enumerate the devices the port can run on.

    `platform` "cuda" lists the visible cards (NTTDeviceError when there
    are none), "cpu" the host, None the cards if any, else the host."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform == "cuda":
        if not cards:
            raise NTTDeviceError("no CUDA device visible to torch")
        return cards
    if platform is not None:
        raise NTTDeviceError(f"unknown platform {platform!r}")
    return cards or [torch.device("cpu")]


def default_device() -> torch.device:
    """The first visible card, cuda:0 (the reference always used device
    0).  Raises NTTDeviceError when no card is visible: the port's entry
    points run on the card, and on the CPU only when the caller passes
    device="cpu"."""
    return available_devices("cuda")[0]


def _power_limits() -> list[str]:
    """Per-card power limits as nvidia-smi reports them ([] without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def device_summary() -> str:
    """Human-readable device table: name, count and power limit."""
    n = torch.cuda.device_count()
    if n == 0:
        return "id=0 platform=cpu kind=cpu count=1"
    limits = _power_limits()
    lines = []
    for i in range(n):
        limit = limits[i] if i < len(limits) else "not read"
        lines.append(f"id={i} platform=gpu kind={torch.cuda.get_device_name(i)}"
                     f" count={n} power_limit={limit}")
    return "\n".join(lines)
