"""Meshes whose positions belong to several processes (torch.distributed).

The counterpart of the JAX package's ``jax.distributed`` wiring
(``__graft_entry__.py:dryrun_multihost``): every process runs the same
program (one process per host, or several on one host), initialises one
process group, and builds the same global mesh from the global device
list in process-major order, as ``jax.devices()`` orders it.  Each mesh
position knows the rank of the process that holds it
(``parallel/mesh.py:Mesh``); a process computes only on its own positions
and holds array pieces only for them.  Where a data row's model shards
lie in several processes, the collectives of ``parallel/mesh.py`` and
``parallel/shard_intersect.py`` run over the row's process group.

Collectives and their backends.  CPU tensors go through gloo.  CUDA
tensors go through NCCL when every rank has cards of its own, and are
staged through the host around a gloo collective when ranks share a card
(NCCL refuses two ranks on one device); ``init_distributed`` chooses and
prints which.  The compute stays on the card either way.

Semantics of the differentiable collectives (``gather_stack``,
``assemble_rows``): the program is replicated, so every process of a row
computes the row's shading on the same gathered values.  The row's
*owner* (its lowest rank) carries the row's gradient; the others pass
zeros (and still run the row's backward, so the gathers' backward
all-reduces meet), so a replicated parameter's gradient is counted once
per row and each shard's once, by its process.  The train step then
sums the parameters' gradients over the mesh's processes.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ProcessGroup:
    """A set of ranks and the torch groups its collectives run on: ``gloo``
    for CPU tensors (and staged CUDA tensors), ``nccl`` for CUDA tensors
    where every rank has a card of its own (None: staged)."""

    ranks: tuple
    gloo: object
    nccl: object = None

    @property
    def index(self) -> int:
        """This process's position in ``ranks`` (its rank in the group)."""
        return self.ranks.index(dist.get_rank())


@dataclasses.dataclass(frozen=True)
class Context:
    """The initialised process group: this process's rank, the world size
    and its local devices."""

    rank: int
    world_size: int
    local_devices: tuple
    #: the card NCCL collectives run on (None: no NCCL)
    nccl_device: torch.device | None


#: torch.distributed's process group is the process's own; so are these:
#: the context ``init_distributed`` made, and the groups made so far by
#: their ranks
_CONTEXT = None
_GROUPS = {}


def context() -> Context:
    if _CONTEXT is None:
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.distributed.init_distributed() first")
    return _CONTEXT


def _card_ids(devices) -> list:
    """Host and UUID of each CUDA card of ``devices`` (CPU positions: none)."""
    host = socket.gethostname()
    return [f"{host}/{torch.cuda.get_device_properties(d).uuid}"
            for d in devices if d.type == "cuda"]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_devices=None) -> Context:
    """Initialise the process group and return its ``Context``.

    Arguments left None come from the environment that
    ``dryrun_multihost`` reads: ``COORDINATOR_ADDRESS`` ("host:port" of
    rank 0), ``NUM_PROCESSES`` and ``PROCESS_ID``.  ``local_devices``: this
    process's mesh positions (default: every CUDA card, raising without
    one; ``["cpu"] * 2`` gives two CPU positions).  The backend is gloo;
    where every rank has cards of its own a second, NCCL group carries the
    CUDA collectives, else CUDA tensors are staged through the host.  The
    choice is printed."""
    global _CONTEXT
    if _CONTEXT is not None:
        return _CONTEXT
    env = os.environ
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if not address:
        raise ValueError("no coordinator address: pass one or set "
                         "COORDINATOR_ADDRESS (host:port of process 0)")
    world = int(num_processes if num_processes is not None
                else env["NUM_PROCESSES"])
    rank = int(process_id if process_id is not None else env["PROCESS_ID"])
    if local_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass local_devices=[...] "
                               "(for example [\"cpu\"] * 2) to run elsewhere")
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    local = tuple(torch.device(d) for d in local_devices)
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    ids = [None] * world
    dist.all_gather_object(ids, _card_ids(local))
    flat = [c for per in ids for c in per]
    cards = bool(flat)
    nccl = cards and len(set(flat)) == len(flat)
    nccl_device = None
    if nccl:
        # NCCL binds each rank to its current card
        nccl_device = next(d for d in local if d.type == "cuda")
        torch.cuda.set_device(nccl_device)
    _CONTEXT = Context(rank=rank, world_size=world, local_devices=local,
                       nccl_device=nccl_device)
    _GROUPS[tuple(range(world))] = ProcessGroup(
        tuple(range(world)), dist.group.WORLD,
        dist.new_group(backend="nccl") if nccl else None)
    if not cards:
        how = "gloo (CPU positions)"
    elif nccl:
        how = "gloo for CPU tensors, NCCL for CUDA tensors (a card a rank)"
    else:
        how = ("gloo, CUDA tensors staged through the host (ranks share a "
               "card)")
    print(f"[distributed] rank {rank} of {world}: {how}; local positions "
          f"{[str(d) for d in local]}", flush=True)
    return _CONTEXT


def global_devices() -> tuple:
    """(devices, ranks): every process's local devices in process-major
    order (``jax.devices()``'s order) and the rank holding each."""
    ctx = context()
    per = [None] * ctx.world_size
    dist.all_gather_object(per, [str(d) for d in ctx.local_devices])
    devices, ranks = [], []
    for r, devs in enumerate(per):
        devices += [torch.device(d) for d in devs]
        ranks += [r] * len(devs)
    return devices, ranks


def group_of(ranks) -> ProcessGroup:
    """The process group of ``ranks`` (made once, by every process in the
    same order, as ``torch.distributed.new_group`` requires)."""
    ctx = context()
    key = tuple(sorted(set(ranks)))
    if key not in _GROUPS:
        _GROUPS[key] = ProcessGroup(
            key, dist.new_group(list(key)),
            dist.new_group(list(key), backend="nccl")
            if ctx.nccl_device is not None else None)
    return _GROUPS[key]


def _host(shape, dtype, like) -> torch.Tensor:
    """A host buffer for staging ``like``'s data: page-locked when ``like``
    lies on a card (the copies then run at the link's rate)."""
    return torch.empty(shape, dtype=dtype, pin_memory=like.device.type ==
                       "cuda")


def _wire(x, group: ProcessGroup):
    """``x`` as the collective takes it, and the torch group to use."""
    if x.device.type == "cuda" and group.nccl is not None:
        return x.to(context().nccl_device).contiguous(), group.nccl
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if x.device.type == "cpu":
        return x.contiguous(), group.gloo
    y = _host(x.shape, x.dtype, x)
    y.copy_(x)
    return y, group.gloo


def all_gather(x, group: ProcessGroup) -> torch.Tensor:
    """[k, *x.shape]: every rank's ``x`` in the group's rank order, on
    ``x``'s device (no gradient)."""
    y, g = _wire(x, group)
    out = (torch.empty((len(group.ranks),) + tuple(y.shape), dtype=y.dtype,
                       device=y.device) if y.device.type == "cuda" else
           _host((len(group.ranks),) + tuple(y.shape), y.dtype, x))
    dist.all_gather(list(out.unbind(0)), y, group=g)
    return out.to(device=x.device, dtype=x.dtype)


def all_reduce(x, group: ProcessGroup) -> torch.Tensor:
    """The sum of every rank's ``x`` (no gradient; ``x`` is not changed)."""
    y, g = _wire(x, group)
    if y.data_ptr() == x.data_ptr():
        y = y.clone()                   # the collective works in place
    dist.all_reduce(y, group=g)
    return y.to(device=x.device, dtype=x.dtype)


class _GatherStack(torch.autograd.Function):
    """``all_gather``; the backward sums the gradients of this process's
    piece over the group (what ``torch.distributed.nn.functional``'s
    all_gather does) and returns it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group)[ctx.group.index], None


def gather_stack(x, group: ProcessGroup) -> torch.Tensor:
    """Differentiable ``all_gather`` of ``x`` over ``group``:
    [k, *x.shape] in the group's rank order."""
    return _GatherStack.apply(x, group)


class _OwnedRows(torch.autograd.Function):
    """Rows assembled from their owners' copies; the gradient goes back to
    the rows this process owns only (no communication)."""

    @staticmethod
    def forward(ctx, buf, group, src, owned):
        ctx.save_for_backward(owned)
        if group is None:                   # every process holds every row
            return buf.clone()
        stacked = all_gather(buf, group)
        return stacked[src, torch.arange(buf.shape[0], device=buf.device)]

    @staticmethod
    def backward(ctx, grad):
        (owned,) = ctx.saved_tensors
        mask = owned.reshape((-1,) + (1,) * (grad.dim() - 1))
        return torch.where(mask, grad, 0), None, None, None


def owned_rows(buf, group, src, owned) -> torch.Tensor:
    """``buf`` [N, ...] with element row n taken from rank index
    ``src[n]`` of ``group`` (None: from this process's own ``buf``, every
    process holding every row); the gradient reaches ``buf`` only where
    ``owned`` (bool[N]) is set."""
    return _OwnedRows.apply(buf, group, src, owned)


def free_port() -> int:
    """A free TCP port on localhost, for a coordinator address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shutdown() -> None:
    """Destroy the process group (the end of a process's distributed run)."""
    global _CONTEXT
    if dist.is_initialized():
        dist.destroy_process_group()
    _CONTEXT = None
    _GROUPS.clear()


def process_mesh(mesh, ranks):
    """``mesh`` (``parallel/mesh.py:Mesh``) with the rank holding each
    position (``ranks`` in the flat order of its devices) and the process
    groups of its rows and of the whole (None for a row in one process).
    Every process calls this alike, in the same order: the groups are made
    here."""
    ctx = context()
    mp = mesh.shape["model"]
    grid = tuple(tuple(ranks[i * mp:(i + 1) * mp])
                 for i in range(mesh.shape["data"]))
    groups = tuple(group_of(row) if len(set(row)) > 1 else None
                   for row in grid)
    return dataclasses.replace(
        mesh, ranks=grid, rank=ctx.rank, groups=groups,
        group=group_of([r for row in grid for r in row]))


def global_mesh(n_devices: int | None = None, model_parallel: int = 1,
                order=None):
    """The ("data", "model") mesh over every process's positions, in
    process-major order (as the JAX package's ``make_mesh`` reshapes
    ``jax.devices()``), ``model_parallel`` positions to a row; ``order``
    (a permutation of the global positions) lays them out otherwise, for
    example so that the "model" axis crosses processes."""
    from prismarine_core_tpu_torch.parallel.mesh import make_mesh
    devices, ranks = global_devices()
    if order is not None:
        devices = [devices[k] for k in order]
        ranks = [ranks[k] for k in order]
    return process_mesh(make_mesh(n_devices, model_parallel, devices), ranks)
