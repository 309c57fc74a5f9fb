"""Device choice shared by the examples: the counterpart of the JAX
package's examples/_platform.py.

`--device=cpu` (or `--device cpu`), or the GPUNTT_DEVICE environment
variable, names the torch device.  The default is the first CUDA card,
and without one NTTDeviceError is raised: unlike the JAX scripts ("TPU
if available, CPU otherwise") there is no fallback to the host, which
runs only when asked for.
"""

from __future__ import annotations

import os

import torch

from ..common.device import default_device


def split(argv: list[str]) -> tuple[list[str], str | None]:
    """(the other arguments, the device named by --device or
    GPUNTT_DEVICE, or None)."""
    rest, name, i = [], None, 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--device="):
            name = a.split("=", 1)[1]
        elif a == "--device" and i + 1 < len(argv):
            name = argv[i + 1]
            i += 1
        else:
            rest.append(a)
        i += 1
    return rest, name or os.environ.get("GPUNTT_DEVICE") or None


def resolve(name: str | None) -> torch.device:
    """The named device, or the first card (NTTDeviceError without one)."""
    return torch.device(name) if name else default_device()


def parse(argv: list[str], logn: int, batch: int) -> tuple[int, int, torch.device]:
    """(LOGN, BATCH, device) from argv, with the script's defaults."""
    rest, name = split(argv)
    return (int(rest[0]) if rest else logn, int(rest[1]) if len(rest) > 1 else batch,
            resolve(name))
