"""Data parallelism over processes (volprim_tpu.parallel.mesh).

The JAX package shards the ray and tile axes of one program over a 1-D
device mesh and lets XLA insert the collectives. The port runs one process
per rank instead, joined by ``torch.distributed`` (``torchrun``, or
:func:`init_multihost` with explicit arguments), and a :class:`Mesh` says
where this process stands among them:

- each rank renders its own contiguous block of tiles
  (``rf_tiled.render_state(mesh=)``) or of rays (``models.render`` and
  ``render_batch`` with ``mesh=``); the primitives are replicated;
- a collective assembles the frame: an all-gather of the tile blocks
  (:func:`gather_blocks`) or an all-reduce of the partial films
  (:func:`sum_parts`), so every rank holds the whole image;
- the parameter gradients are summed over the ranks
  (:func:`sharded_grad_step`, ``train.train_step(mesh=)``).

That gives the single process's images and gradients, up to the order of
the sums.

**The backward of the collectives.** Every rank computes the loss on the
whole, replicated image, so every rank receives the whole image's
cotangent. The backward of :func:`gather_blocks` hands a rank the slice of
its own block, and that of :func:`sum_parts` passes the cotangent through
unchanged: a rank's parameter gradient is then the gradient of its own
block's part of the image, and the sum over the ranks is the single
process's gradient. (``torch.distributed.nn.functional.all_gather`` and
``all_reduce`` sum the cotangent over the ranks in their backward, which
with a replicated loss gives W times the gradient.) So a loss summed by
:func:`sharded_grad_step` must reach the parameters only through renders on
the same mesh: a term that every rank computes from the parameters directly
(a regulariser) would be counted W times.

Without a process group a mesh has one rank and no collective runs: the
path is the single process's, bit for bit. A one-rank process group (a
one-card NCCL run) runs its collectives, which copy.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh seen from one rank: this process's ``rank`` among
    ``size`` ranks of the process group ``group`` (None: a single process,
    no collective), and the device it renders on. JAX's ``mesh.devices.size``
    is ``size`` here."""

    rank: int
    size: int
    device: torch.device
    axis: str = "data"
    group: Any = None

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows: the first ``n % size``
        ranks take one row more."""
        return slice(n * self.rank // self.size, n * (self.rank + 1) // self.size)


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: Optional[float] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join the process group: ``torch.distributed.init_process_group`` at
    ``tcp://<coordinator_address>`` with ``num_processes`` ranks as rank
    ``process_id``. What is not given comes from torchrun's environment
    (``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    Returns True when a process group exists (this call made it, or an
    earlier one), False when there is nothing to join (no coordinator, world
    size or rank) or the rendezvous fails within ``timeout_s`` seconds
    (torch's default timeout when None); callers proceed either way, as
    with JAX's ``jax.distributed.initialize``, whose arguments these are.
    The backend follows the device: NCCL for ranks on the card (``device``
    None or CUDA; each rank takes card ``LOCAL_RANK % device_count``), gloo
    when ``device`` is the CPU or ``backend="gloo"`` is asked for (gloo also
    takes CUDA tensors, through the host, so several gloo ranks may share
    one card, which NCCL refuses)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        return False
    from .. import as_device

    if backend is None:
        backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        as_device(device)  # raises without a card
        torch.cuda.set_device(_local_rank(process_id) % torch.cuda.device_count())
    timeout = None if timeout_s is None else datetime.timedelta(seconds=timeout_s)
    try:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id),
                                timeout=timeout)
    except (RuntimeError, OSError):  # the store's DistError is a RuntimeError
        return False
    return True


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def data_mesh(device=None, axis: str = "data", group=None) -> Mesh:
    """The 1-D mesh over the ranks of ``group`` (default: every rank of the
    process group), with this rank's device: ``device`` as given, or the
    card ``cuda:{LOCAL_RANK % device_count}`` when it is None or names CUDA
    without an index. Without a process group it is a one-rank mesh over
    this process, as JAX's ``data_mesh`` spans the one local device. JAX's
    ``devices`` argument, a subset of the devices, is a process group from
    ``torch.distributed.new_group`` / ``new_subgroups`` here."""
    from .. import as_device

    if dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        global_rank = dist.get_rank()
    else:
        if group is not None:
            raise ValueError("a group was given, but no process group is initialised")
        rank, size, global_rank = 0, 1, 0
    dev = as_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank(global_rank) % torch.cuda.device_count())
    return Mesh(rank=rank, size=size, device=dev, axis=axis, group=group)


def shard_rays(mesh: Optional[Mesh], *arrays):
    """This rank's contiguous block of each array along axis 0 (the rays);
    the arrays themselves when ``mesh`` is None or has one rank. Unlike
    JAX's, whose arrays stay global under a sharding constraint, the
    result is the local block: the caller assembles the outputs with
    :func:`sum_parts` or :func:`gather_blocks`."""
    if mesh is not None and mesh.size > 1:
        arrays = tuple(a[mesh.block(a.shape[0])] for a in arrays)
    return arrays if len(arrays) > 1 else arrays[0]


def replicate(mesh: Optional[Mesh], tree):
    """Make every tensor of ``tree`` (a tensor, or dicts, lists and tuples
    of them) equal to rank 0's, in place (a broadcast from rank 0, outside
    autograd), so that the replicas start equal. Returns ``tree``. JAX's
    constrains the sharding instead; its replicas are one array."""
    if mesh is None or mesh.group is None:
        return tree
    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t, dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return tree


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def sum_grads(mesh: Optional[Mesh], grads) -> None:
    """Sum each gradient tensor of ``grads`` over the ranks, in place."""
    if mesh is None or mesh.group is None:
        return
    for g in _tensors(grads):
        dist.all_reduce(g, group=mesh.group)


def sharded_grad_step(loss_fn, mesh: Optional[Mesh] = None):
    """``step(params, *args) -> (loss, grads)``: the loss ``loss_fn(params,
    *args)`` (a scalar tensor) and its gradients with respect to
    ``params`` (a tensor or a dict of tensors, replicated on every rank),
    summed over the mesh's ranks, so that every rank holds the single
    process's gradient. ``loss_fn`` must render through the same mesh (see
    the module docstring). The parameters themselves are left as they are;
    a parameter the loss does not reach gets a zero gradient."""

    def step(params, *args):
        single = isinstance(params, torch.Tensor)
        named = {"": params} if single else dict(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in named.items()}
        loss = loss_fn(leaves[""] if single else leaves, *args)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g for g, v in zip(grads, leaves.values())]
        sum_grads(mesh, grads)
        return loss.detach(), grads[0] if single else dict(zip(leaves, grads))

    return step


class _GatherBlocks(torch.autograd.Function):
    """All-gather of equal blocks along axis 0; the backward hands each rank
    the cotangent of its own block."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.rank = x.shape[0], mesh.rank
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class _SumParts(torch.autograd.Function):
    """All-reduce (sum); the backward passes the cotangent through."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_blocks(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks ``x`` [n, ...] (equal n, in rank order) as one
    [size n, ...] tensor on every rank; differentiable with the backward of
    the module docstring. ``x`` itself without a process group."""
    if mesh is None or mesh.group is None:
        return x
    return _GatherBlocks.apply(x, mesh)


def sum_parts(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' ``x`` on every rank; differentiable with the
    backward of the module docstring. ``x`` itself without a process
    group."""
    if mesh is None or mesh.group is None:
        return x
    return _SumParts.apply(x, mesh)


def rank_generator(mesh: Optional[Mesh], generator: torch.Generator) -> torch.Generator:
    """The generator a rank's radiance function draws from: ``generator``
    itself on one rank (so a one-rank mesh draws what ``mesh=None`` draws);
    on W > 1 ranks a new generator on its device, seeded from a hash of
    ``generator``'s state (the same on every rank) and the rank, so the
    ranks' rays draw independent variates. ``generator`` itself is not
    advanced: the film jitter that every rank draws from it stays the
    single process's."""
    if mesh is None or mesh.size == 1:
        return generator
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()
                            + mesh.rank.to_bytes(8, "little")).digest()
    gen = torch.Generator(device=generator.device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") % 2**63)
    return gen
