"""Rank meshes and RaySet shardings (counterpart of
``pyrayt_tpu.parallel.mesh``).

The JAX package lays a single program's devices out as a 2-D
``('hosts', 'rays')`` mesh; the port runs one process per rank and lays
the ranks of the ``torch.distributed`` world out the same way, host-major.
Both axes shard the ray batch: rank ``r`` holds the ``r``-th contiguous
block of rays, the layout of ``P(None, ('hosts', 'rays'))``.  The scene is
replicated, so the only traffic is the combine of results, scalars and
parameter gradients.

Every combine is built from ``all_reduce``, the collective that the gloo
backend also runs on CUDA tensors (several ranks sharing one card): a
gather is an integer SUM of each rank's block bit pattern into a
zero-filled buffer (exact, -0.0 and NaN included), and a sum of
per-rank values adds the gathered blocks in rank order, so the result is
bit-identical on every rank and from run to run.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from pyrayt_tpu_torch.config import default_device
from pyrayt_tpu_torch.tracer.rayset import RaySet

__all__ = [
    "RAY_AXES",
    "Mesh",
    "default_mesh",
    "rayset_sharding",
    "shard_rayset",
    "pad_rayset",
]

# mesh axis names: both shard the ray batch (hierarchical DP)
RAY_AXES: Tuple[str, str] = ("hosts", "rays")

# the integer type of each element width: an exact gather sums bit patterns
_BITS = {8: torch.int64, 4: torch.int32, 1: torch.uint8}


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> Tuple[int, int]:
    if _joined():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """The world's ranks as a named grid, host-major.

    ``shape`` maps axis names to sizes whose product is the world size;
    ``rank`` is this process's rank, ``device`` the device its tensors
    live on.  In a process with no group the mesh has one rank and its
    collectives return their input; in a group (of any size, one rank
    included) they run on the group's backend.
    """

    def __init__(self, shape: dict, device):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        world, self.rank = _world()
        self.joined = _joined()
        if self.size != world:
            raise ValueError(
                f"mesh {self.shape} has {self.size} ranks, the world {world}: the port runs "
                "one process per device"
            )
        self.device = torch.device(device)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"

    def index(self, axis_name: str) -> int:
        """This rank's coordinate along ``axis_name``."""
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis_name:
                return (self.rank // stride) % self.shape[name]
            stride *= self.shape[name]
        raise KeyError(axis_name)

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``op`` (a ``torch.distributed.ReduceOp``) of ``t`` over the
        mesh, on a copy."""
        if not self.joined:
            return t
        t = t.clone()
        dist.all_reduce(t, op)
        return t

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's block concatenated in rank order along the last
        axis, bit for bit."""
        if not self.joined:
            return local
        k = local.shape[-1]
        full = torch.zeros(local.shape[:-1] + (self.size * k,), dtype=local.dtype,
                           device=local.device)
        full[..., self.rank * k:(self.rank + 1) * k] = local
        bits = full.view(_BITS[full.element_size()])
        dist.all_reduce(bits, dist.ReduceOp.SUM)
        return full

    def ordered_sum(self, tensors):
        """Each tensor summed over the ranks in rank order: one exact
        gather of the flattened tensors, then left-to-right adds, so every
        rank (and every run) gets the same bits."""
        if not self.joined:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        parts = self.gather(flat[None]).reshape(self.size, flat.numel())
        total = parts[0]
        for r in range(1, self.size):
            total = total + parts[r]
        out, start = [], 0
        for t in tensors:
            out.append(total[start:start + t.numel()].reshape(t.shape))
            start += t.numel()
        return out


def _node_count(world: int) -> int:
    local_world = os.environ.get("LOCAL_WORLD_SIZE")
    return world // int(local_world) if local_world else 1


def _rank_device(device):
    device = default_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def default_mesh(
    n_devices: Optional[int] = None,
    n_hosts: Optional[int] = None,
    device=None,
) -> Mesh:
    """A ``('hosts', 'rays')`` mesh over the world's ranks.

    ``n_devices`` must be the world size (one process per device; None
    reads it); ``n_hosts`` defaults to the node count (``WORLD_SIZE /
    LOCAL_WORLD_SIZE`` under torchrun, else 1), so a multi-node run maps
    the leading axis onto the nodes.  ``device`` is this rank's device
    (None: the current CUDA device, ``config.default_device``).  A process
    with no group gets a mesh of one rank.
    """
    world, _ = _world()
    if n_devices is None:
        n_devices = world
    if n_hosts is None:
        n_hosts = _node_count(world) if n_devices == world else 1
    if n_devices % n_hosts:
        raise ValueError(f"{n_devices} devices not divisible by {n_hosts} hosts")
    return Mesh({RAY_AXES[0]: n_hosts, RAY_AXES[1]: n_devices // n_hosts}, _rank_device(device))


def rayset_sharding(mesh: Mesh) -> RaySet:
    """A RaySet of per-field placements: every field is split along its
    last (ray) axis over the whole mesh, its leading axes replicated."""
    from torch.distributed.tensor import Shard

    del mesh  # one layout for every mesh: blocks in rank order
    ray_axis = Shard(-1)
    return RaySet(
        positions=ray_axis,
        directions=ray_axis,
        generation=ray_axis,
        intensity=ray_axis,
        wavelength=ray_axis,
        index=ray_axis,
        id=ray_axis,
    )


def shard_rayset(rays: RaySet, mesh: Mesh) -> RaySet:
    """This rank's contiguous block of the ray axis, on the mesh's device.
    The ray count must divide the mesh size (:func:`pad_rayset`)."""
    n = rays.n_rays
    if n % mesh.size:
        raise ValueError(
            f"{n} rays not divisible by the mesh's {mesh.size} ranks; pad_rayset first")
    k = n // mesh.size
    lo = mesh.rank * k
    return RaySet(
        **{
            name: getattr(rays, name)[..., lo:lo + k].to(mesh.device).contiguous()
            for name in ("positions", "directions") + RaySet.fields
        }
    )


def pad_rayset(rays: RaySet, multiple: int) -> Tuple[RaySet, int]:
    """Pad the ray axis up to a multiple of ``multiple`` with dead rays.

    Padding rays have zero direction, homogeneous ``w = 1`` and zero
    metadata, so the engines and kernels mark them dead on generation 0
    and they never appear in the results frame.  Returns ``(padded,
    n_valid)``.
    """
    n = rays.n_rays
    n_pad = (-n) % multiple
    if n_pad == 0:
        return rays, n

    def pad(x):
        return torch.nn.functional.pad(x, (0, n_pad))

    positions = pad(rays.positions)
    positions[3, n:] = 1.0
    padded = RaySet(
        positions=positions,
        directions=pad(rays.directions),
        generation=pad(rays.generation),
        intensity=pad(rays.intensity),
        wavelength=pad(rays.wavelength),
        index=pad(rays.index),
        id=pad(rays.id),
    )
    return padded, n
