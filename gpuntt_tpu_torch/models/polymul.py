"""Polynomial multiplication model — the framework's flagship pipeline.

The reference ships this pipeline only as example code
(test_cpu_merge_ntt.cu:69-101: NTT -> pointwise mult -> INTT ==
schoolbook).  `PolynomialMultiplier` is the port of the JAX package's
single-device model as an `nn.Module`: the plan's twiddle tables are
registered buffers (so `.to(device)` moves them), `forward(a, b)` takes
lane tensors, and calling it on numpy arrays keeps the JAX signature.
`device` defaults to the first CUDA card (NTTDeviceError without one);
pass device="cpu" to run on the host.  u64 params reach the kernels of
hopper_merge.py (logn 12-17) and hopper_merge_large.py (18-28), u32
params those of hopper_merge32.py, all through polymul_lanes.  A
big-ring plan holds no N-entry table (MergePlan.bigring): its module
registers an empty `anchor` buffer instead, whose device the plan
follows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.dispatch import polymul_lanes
from ..ops.merge_ntt import MergePlan, from_lanes, to_lanes
from ..params.merge import NTTParameters

_TABLES = ("fwd_table", "fwd_shoup", "inv_table", "inv_shoup")


class PolynomialMultiplier(torch.nn.Module):
    """c = a * b mod (q, X^N +/- 1) via merge NTT (single device)."""

    def __init__(self, params: NTTParameters, device=None):
        super().__init__()
        self.params = params
        self._plan = MergePlan.from_params(params, device=device)
        if self._plan.fwd_table is None:
            self.register_buffer("anchor", torch.empty(0, dtype=torch.int64,
                                                       device=self._plan.device))
            return
        for name in _TABLES:
            self.register_buffer(name, getattr(self._plan, name))

    @property
    def plan(self) -> MergePlan:
        """The plan over this module's buffers, wherever they now live."""
        if self._plan.fwd_table is None:
            if self.anchor.device != self._plan.device:
                self._plan = self._plan.to(self.anchor.device)
        elif self.fwd_table is not self._plan.fwd_table:
            self._plan = dataclasses.replace(
                self._plan, _moved={}, _lazy={}, device=self.fwd_table.device,
                **{n: getattr(self, n) for n in _TABLES})
        return self._plan

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return polymul_lanes(a, b, self.plan)

    def __call__(self, a, b):
        if isinstance(a, torch.Tensor):
            return super().__call__(a, b)
        plan = self.plan
        out = super().__call__(to_lanes(np.asarray(a), plan.is64, plan.device),
                               to_lanes(np.asarray(b), plan.is64, plan.device))
        return from_lanes(out, plan.is64)
