"""Multi-device runs of the port: the process group, this rank's block of
a batch, and the collectives the training step and the engines use
(counterpart of ``pesr_tpu/parallel/mesh.py``).

JAX runs one program over a mesh of devices and lets XLA place the
collectives.  The PyTorch idiom is one process per device, so here a
:class:`Mesh` is the process group: its size P, this process's rank, its
device and the backend (NCCL for CUDA, gloo for the CPU; a caller may
name another, as ``chip_smoke.py`` puts two gloo ranks on one card).
Rank r takes ``cuda:(local_rank % device_count)``, ``local_rank`` from
torchrun's ``LOCAL_RANK`` or else the rank.  A mesh of one process
(no process group, or a group of one) runs no collective at all, so its
results are bitwise those of a run without a mesh.

* :func:`initialize_distributed` brings the process group up from the
  ``PESR_COORDINATOR`` / ``PESR_NUM_PROCESSES`` / ``PESR_PROCESS_ID``
  contract of the JAX package, or from torchrun's ``RANK`` /
  ``WORLD_SIZE`` / ``MASTER_ADDR``, which stand in for JAX's
  auto-detection.
* :func:`make_mesh` is the whole world or its first ``num_devices``
  ranks; it raises when the request exceeds the world.
* :func:`batch_sharding` / :func:`shard_batch`: this rank's contiguous
  ``B / P`` block of a global batch (JAX shards the batch axis so).
* :func:`replicated` / :func:`shard_pytree_replicated`: tensors
  broadcast from rank 0 (JAX replicates parameters so).

JAX's ``force_cpu_devices`` (virtual XLA CPU devices for its tests) has
no counterpart: the port's tests run real gloo processes on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree

from pesr_torch.utils.device import resolve_device

LAUNCH_HINT = ("launch one process per device: torchrun --nproc_per_node N "
               "python -m pesr_torch.train ..., or set PESR_COORDINATOR="
               "host:port, PESR_NUM_PROCESSES=N and PESR_PROCESS_ID=r in "
               "each of the N processes and pass --distributed")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """P processes, one device each.  ``group`` is None for a mesh of
    one process."""
    size: int
    rank: int
    device: torch.device
    backend: str
    group: Any = None

    def __deepcopy__(self, memo):
        return self  # a process group is not copied (modules hold meshes)

    @property
    def collective(self) -> bool:
        """True when the mesh has more than one process (collectives run)."""
        return self.size > 1


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device="cuda") -> torch.device:
    """This process's device: for a CUDA request without an index,
    ``cuda:(local_rank % device_count)`` in a process group (``local_rank``
    from ``LOCAL_RANK``, else the global rank) and ``device`` as given
    outside one; the CPU for a CPU request."""
    dev = resolve_device(device)
    if (dev.type != "cuda" or dev.index is not None
            or not dist.is_initialized()):
        return dev
    return _rank_device(dist.get_rank())


def _rank_device(rank: int) -> torch.device:
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_distributed(required: bool = False, device="cuda",
                           backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> bool:
    """Bring the process group up; returns True when one is up.

    Cluster configuration, in priority order:

    1. ``PESR_COORDINATOR`` (``host:port``) / ``PESR_NUM_PROCESSES`` /
       ``PESR_PROCESS_ID``: ``init_process_group(init_method=
       "tcp://host:port")`` with that world size and rank;
    2. torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``
       (``init_method="env://"``).

    With neither it is a no-op returning False, unless ``required`` (the
    ``--distributed`` flag), which raises.  An already initialised group
    returns True.  A set ``PESR_COORDINATOR`` is explicit intent: a
    half-set contract raises even without ``required``, and so does a
    failed bring-up, as in the JAX package (one worker training alone
    against the cluster's check_point directory would diverge and
    clobber it).  ``backend`` defaults to :func:`default_backend` of
    ``device``; the process's CUDA device is set to :func:`local_device`."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("PESR_COORDINATOR", "")
    kwargs = None
    if coord:
        try:
            kwargs = dict(init_method=f"tcp://{coord}",
                          world_size=int(os.environ["PESR_NUM_PROCESSES"]),
                          rank=int(os.environ["PESR_PROCESS_ID"]))
        except (KeyError, ValueError) as e:
            raise ValueError(
                "PESR_COORDINATOR is set, so PESR_NUM_PROCESSES and "
                "PESR_PROCESS_ID must both be integers (unset "
                f"PESR_COORDINATOR for single-host runs): {e!r}") from e
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        kwargs = dict(init_method="env://")
    if kwargs is None:
        if required:
            raise RuntimeError(f"--distributed: no cluster configured; "
                               f"{LAUNCH_HINT}")
        return False
    be = backend or default_backend(device)
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(_rank_device(
            kwargs.get("rank", int(os.environ.get("RANK", 0)))))
    dist.init_process_group(be, timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    return True


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of the first ``num_devices`` ranks (None: the whole
    world; without a process group the world is this one process).
    Raises if the request exceeds the world: a truncated mesh would skew
    the global batch.  Every rank calls it (a smaller mesh is a new
    group, which the whole world creates); a rank outside the mesh
    raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if num_devices is None else int(num_devices)
    if n < 1:
        raise ValueError(f"requested {n} devices")
    if n > world:
        raise ValueError(
            f"requested {n} devices, have {world}"
            + ("" if dist.is_initialized() else
               f" (no process group: {LAUNCH_HINT})"))
    dev = local_device(device)
    if not dist.is_initialized():
        return Mesh(1, 0, dev, "none")
    rank = dist.get_rank()
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh of the first {n} "
                         f"ranks")
    return Mesh(n, rank, dev, dist.get_backend(), group)


def batch_sharding(mesh: Optional[Mesh], batch: int) -> slice:
    """This rank's contiguous block of a global batch of ``batch``."""
    p = mesh.size if mesh is not None else 1
    if batch % p:
        raise ValueError(f"batch dim {batch} not divisible by mesh size {p}")
    b = batch // p
    r = mesh.rank if mesh is not None else 0
    return slice(r * b, (r + 1) * b)


def shard_batch(mesh: Optional[Mesh], batch: Any) -> Any:
    """This rank's block of every leaf (tensor or array) of a pytree of
    global batches, along axis 0."""
    return _pytree.tree_map(
        lambda x: x[batch_sharding(mesh, x.shape[0])], batch)


def replicated(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """``t`` overwritten in place with rank 0's copy; returned."""
    if mesh is not None and mesh.collective:
        dist.broadcast(t, src=0, group=mesh.group)
    return t


def shard_pytree_replicated(mesh: Optional[Mesh], tree: Any) -> Any:
    """Every tensor of a pytree, or every parameter and buffer of a
    module, broadcast from rank 0 in place (replicated parameters)."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                replicated(mesh, t.data)
        return tree
    return _pytree.tree_map(
        lambda x: replicated(mesh, x) if torch.is_tensor(x) else x, tree)


def all_reduce_mean_(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]
                     ) -> None:
    """Replace each tensor by its mean over the mesh, in place: one
    all-reduce of a float32 buffer holding them all."""
    if mesh is None or not mesh.collective or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    at = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[at:at + n].view_as(t))
        at += n


def sum_all(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the mesh, differentiable: the backward sums the
    gradients of every rank (``torch.distributed.nn``), and is itself
    differentiable, so a double backward (the gradient penalty) runs it
    too.  Every rank must call it in the same order."""
    if mesh is None or not mesh.collective:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, group=mesh.group)


def max_all_(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """``t`` replaced in place by its elementwise max over the mesh (no
    gradient); returned."""
    if mesh is not None and mesh.collective:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


def batch_mean(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """Mean of ``t`` over the GLOBAL batch (every element of every
    rank's block, which are all of one size), differentiable as
    :func:`sum_all`; ``t.mean()`` without collectives."""
    if mesh is None or not mesh.collective:
        return t.mean()
    return sum_all(mesh, t.sum()) / (t.numel() * mesh.size)


def all_gather_batch(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) concatenated along
    axis 0 in rank order, on every rank."""
    if mesh is None or not mesh.collective:
        return t
    src = t.contiguous().to(_comm_device(mesh))
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def all_agree(mesh: Optional[Mesh], ok: bool) -> bool:
    """True iff ``ok`` on every rank: keeps later collectives (the
    checkpoint barrier) from deadlocking on control flow that differs
    between ranks."""
    if mesh is None or not mesh.collective:
        return ok
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32,
                        device=_comm_device(mesh))
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag.item())


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh."""
    if mesh is not None and mesh.collective:
        all_agree(mesh, True)


def is_primary(mesh: Optional[Mesh] = None) -> bool:
    """True on rank 0 (of the mesh, or of the world without one): the
    rank that writes logs and checkpoints."""
    if mesh is not None:
        return mesh.rank == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def _comm_device(mesh: Mesh) -> torch.device:
    """Where flags and gathered outputs travel: the rank's device under
    NCCL, host memory under gloo."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")

