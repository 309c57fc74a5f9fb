"""Device mesh helpers on torch.distributed.

The port of the JAX package's parallel/mesh.py.  By convention mesh
axis "dp" shards the batch (independent polynomials) and axis "sp" the
coefficient axis of one transform.  A mesh here is a
`torch.distributed.device_mesh.DeviceMesh` with dims ("dp", "sp") over
the initialised default process group: NCCL for the card, gloo for the
host.  The transforms (fourstep_dist, merge_dist, fourstep_rns_dist)
take and return the rank-local shard, the per-shard view that JAX's
shard_map body sees; `shard` and `unshard` convert between that and the
global layout, for tests, examples and the dry run.  The layouts are
JAX's: `BLOCKS` = ("dp", None, "sp") for the 4-step's (B, n1, n2) and
(B, n2, n1) blocks (matrix_sharding), `ROWS` = ("dp", "sp") for the
merge's (B, N) rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..common.errors import NTTDeviceError

BLOCKS = ("dp", None, "sp")
ROWS = ("dp", "sp")

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(dp: int = 1, sp: int | None = None, device=None) -> DeviceMesh:
    """A (dp, sp) mesh over the first dp * sp ranks of the default group;
    sp defaults to the ranks left.  `device` defaults to the card, which
    needs an NCCL group; device="cpu" needs a gloo group.  Raises
    NTTDeviceError without a group, or when its backend does not serve
    the device, and ValueError when dp * sp exceeds the world size."""
    if not dist.is_available() or not dist.is_initialized():
        raise NTTDeviceError("make_mesh needs torch.distributed's default process group "
                             "(init_process_group) first")
    if device is None:
        from ..common.device import default_device

        device = default_device()
    device = torch.device(device)
    backend = str(dist.get_backend())
    if _BACKEND.get(device.type) not in backend:
        raise NTTDeviceError(f"a {device.type} mesh needs a {_BACKEND.get(device.type)} "
                             f"group, got {backend}")
    world = dist.get_world_size()
    if sp is None:
        sp = world // dp
    if dp < 1 or sp < 1 or dp * sp > world:
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} ranks, have {world}")
    return DeviceMesh(device.type, torch.arange(dp * sp).reshape(dp, sp),
                      mesh_dim_names=("dp", "sp"))


def axis(mesh: DeviceMesh, name: str) -> tuple[int, int]:
    """(size, this rank's coordinate) of mesh axis `name`."""
    return mesh.shape[mesh.mesh_dim_names.index(name)], mesh.get_local_rank(name)


def shard(x: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor `x` under `spec` (one mesh
    axis name or None per tensor axis), contiguous."""
    for dim, name in enumerate(spec):
        if name is not None:
            size, idx = axis(mesh, name)
            step = x.shape[dim] // size
            x = x.narrow(dim, idx * step, step)
    return x.contiguous()


def unshard(x: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """The global tensor from every rank's block `x` under `spec`: an
    all_gather along each sharded axis (every rank of the mesh calls it)."""
    for dim in reversed(range(len(spec))):
        name = spec[dim]
        if name is not None:
            parts = [torch.empty_like(x) for _ in range(axis(mesh, name)[0])]
            dist.all_gather(parts, x.contiguous(), group=mesh.get_group(name))
            x = torch.cat(parts, dim=dim)
    return x


def sp_group(mesh: DeviceMesh):
    """(sp, this rank's sp coordinate, the sp group)."""
    size, rank = axis(mesh, "sp")
    if size & (size - 1):
        raise ValueError(f"the sp axis must hold a power of two ranks, got {size}")
    return size, rank, mesh.get_group("sp")


def check_device(x: torch.Tensor, mesh: DeviceMesh) -> None:
    """A transform's operand must lie on the mesh's device type."""
    if x.device.type != mesh.device_type:
        raise NTTDeviceError(f"operand on {x.device} for a {mesh.device_type} mesh")
