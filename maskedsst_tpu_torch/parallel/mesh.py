"""Data parallelism across processes, and the ``data × model`` grid of
tensor parallelism: the JAX package's ``parallel/mesh.py`` on
``torch.distributed``.

The JAX package trains data-parallel over a 1-D ``data`` mesh: the batch
sharded on axis 0, parameters and optimizer state replicated, and the
gradient ``psum`` inserted by XLA. Here each process holds a full replica
of the model on its card and computes the step on its rows of the global
batch; its gradients, summed over the processes, are the global batch's
gradient, so every process applies the same update and the replicas stay
equal bit for bit.

* ``DataWorld`` (rank, size, local rank, device, group) takes the place of
  ``get_mesh``. Without a process group it is rank 0 of 1, and every
  collective here is the identity.
* ``Grid``, the counterpart of ``get_mesh(..., model_axis=T)``: ``data ×
  model`` processes laid out row-major as JAX reshapes its devices (process
  r has data index r // T and model index r % T). A ``Grid`` is the
  ``DataWorld`` of its data axis (rank, size and group are the data
  axis's), so every data-parallel call below works on it unchanged, plus
  its model index, size and group; with model size 1 it is a
  ``DataWorld``. ``make_grid`` builds one from a joined world and
  ``initialize_multihost(model_axis=T)`` returns one.
  ``parallel/sharding_rules.py`` splits a model's heads over its model
  axis.
* ``initialize_multihost`` joins the process group (``nccl`` on the card,
  ``gloo`` on the CPU, or ``gloo`` on the card when several processes share
  one: NCCL refuses two ranks on one card).
* ``global_streamed_batch``: this process's rows of a batch that every
  process built alike (the same-seed loader contract).
* ``shard_host_batch`` and ``put_replicated``: the identity, since a process
  holds only its own rows and its own copy of a replicated value.
* ``all_reduce_``, ``all_reduce_grads_`` and ``sum_across``: sums over the
  processes, of one tensor, of every gradient as one flat buffer, and of a
  few metric tensors as one buffer.

Not ported: ``data_axis_or_warn``, which exists only because GSPMD may
gather a batch whose rows do not divide the data axis onto every chip;
here each process always takes its own rows, and the trainers pad
(finetuning) or raise (pretraining, streamed batches) instead. The batch
shardings (``batch_sharding``, ``replicate``, ``shard_batch``) have no
counterpart: a process holds its own rows. The parameters' tensor-parallel
shardings are ``parallel/sharding_rules.py``'s.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

# a rank that stops answering fails the others' collectives after this long
TIMEOUT_S = 300


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a bare ``"cuda"`` becomes the
    current card, ``cuda:{index}`` (``initialize_multihost`` has set it to
    the local rank's)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class DataWorld:
    """This process's place in a data-parallel run: rank ``rank`` of
    ``size``, ``local_rank`` on its host, its ``device``, and the process
    ``group`` (None: one process, no collectives)."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: Optional[Any] = None

    @property
    def shard(self) -> Tuple[int, int]:
        """``(rank, size)``: the models' argument that names a process's rows
        of the global batch."""
        return (self.rank, self.size)

    def rows(self, n: int) -> slice:
        """This rank's rows ``[r·n/W, (r+1)·n/W)`` of ``n``; raises when W does
        not divide n (dropping or duplicating rows would change the global
        batch)."""
        if n % self.size:
            raise ValueError(
                f"batch of {n} rows is not divisible by the world size ({self.size} "
                "processes); use a drop_last/padded loader with a world-divisible batch_size")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


@dataclass(frozen=True)
class Grid(DataWorld):
    """This process's place in a ``data × model`` grid: the ``DataWorld``
    of its data axis (``rank`` its data index of ``size``, ``group`` the
    processes that share its model index), plus its ``model_rank`` of
    ``model_size`` and the ``model_group`` of the processes that share its
    data index (None when the model size is 1)."""

    model_rank: int = 0
    model_size: int = 1
    model_group: Optional[Any] = None

    @property
    def global_rank(self) -> int:
        """The process's rank in the whole group: data index · model size +
        model index."""
        return self.rank * self.model_size + self.model_rank


def make_grid(world: DataWorld, model_axis: int = 1, data_axis: Optional[int] = None) -> Grid:
    """The grid of ``data_axis × model_axis`` processes over a joined
    ``world`` (its rank and size global), row-major as ``get_mesh``
    reshapes its devices; ``data_axis`` defaults to the world size over
    ``model_axis``, and their product must be the world size. Every
    process of the world must call it (it creates the subgroups, on the
    world's backend)."""
    if model_axis < 1:
        raise ValueError(f"model_axis must be >= 1, got {model_axis}")
    if data_axis is None:
        data_axis = world.size // model_axis
    if data_axis * model_axis != world.size:
        raise ValueError(f"data_axis={data_axis} * model_axis={model_axis} != the world size "
                         f"{world.size}")
    d, m = divmod(world.rank, model_axis)
    data_group = model_group = None
    if world.group is not None:
        # every rank creates every group, in one order (torch.distributed's rule)
        if data_axis > 1:
            for mi in range(model_axis):
                g = dist.new_group([di * model_axis + mi for di in range(data_axis)])
                if mi == m:
                    data_group = g
        if model_axis > 1:
            for di in range(data_axis):
                g = dist.new_group([di * model_axis + mi for mi in range(model_axis)])
                if di == d:
                    model_group = g
    return Grid(d, data_axis, world.local_rank, world.device, data_group, m, model_axis,
                model_group)


def initialize_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *, device: str = "cuda",
                         backend: Optional[str] = None, model_axis: int = 1) -> DataWorld:
    """Join the process group and return this process's ``DataWorld``, or
    with ``model_axis`` above 1 its ``Grid`` (``make_grid``: the data and
    model subgroups on the group's backend).

    The rank, the world size and the rendezvous come from the arguments
    (``coordinator`` "host:port") or else from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``). ``backend`` defaults to ``nccl`` on the card and
    ``gloo`` on the CPU; ``gloo`` on the card is for ranks that share one
    card, which NCCL refuses. On the card it selects ``cuda:{local_rank}``
    (modulo the card count under ``gloo``) before anything touches it, and
    local rank 0 builds the kernels while the other ranks wait at a barrier.
    A failed rendezvous or backend raises; a second call returns the world
    of the group already joined."""
    dev_type = torch.device(device).type
    if dist.is_initialized():
        world = _joined_world(dev_type)
        return make_grid(world, model_axis) if model_axis > 1 else world
    env = os.environ
    try:
        rank = process_id if process_id is not None else int(env["RANK"])
        size = num_processes if num_processes is not None else int(env["WORLD_SIZE"])
    except KeyError as exc:
        raise ValueError(f"initialize_multihost: no process id / count given and {exc} is not "
                         "set (run under torchrun or pass them)") from None
    local_rank = int(env.get("LOCAL_RANK", rank))
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev_type != "cuda"):
        raise ValueError(f"backend {backend!r} on {dev_type}: nccl needs the card, gloo runs "
                         "on both")
    kwargs: Dict[str, Any] = {}
    if dev_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("initialize_multihost: no CUDA device")
        if backend == "nccl" and local_rank >= cards:
            raise ValueError(f"local rank {local_rank} has no card of its own ({cards} cards): "
                             "NCCL takes one card a process; ranks that share one use gloo")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    else:
        dev = torch.device("cpu")
    init_method = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **kwargs)
    world = DataWorld(rank, size, local_rank, dev, dist.group.WORLD)
    if dev_type == "cuda":
        # the build is atomic per library, but two ranks would both run nvcc
        from maskedsst_tpu_torch.ops import _build

        if local_rank == 0:
            _build.build()
        dist.barrier()
    return make_grid(world, model_axis) if model_axis > 1 else world


def add_multihost_args(parser) -> None:
    """The drivers' data-parallel options (the JAX drivers' flags, plus the
    backend)."""
    parser.add_argument("--multihost", action="store_true",
                        help="join a torch.distributed process group and train data-parallel "
                             "(implied under torchrun, which sets WORLD_SIZE)")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="rendezvous address (default: torchrun's MASTER_ADDR:MASTER_PORT)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="default: nccl on the card, gloo on the CPU; gloo on the card "
                             "for processes that share one card")


def world_from_args(args, device: str) -> DataWorld:
    """The world of a driver run: joined (and its rank line printed) under
    ``--multihost`` or torchrun, else one process on ``device``."""
    if not (args.multihost or "WORLD_SIZE" in os.environ):
        return DataWorld(device=resolve_device(device))
    world = initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                 device=device, backend=args.dist_backend)
    print(f"multihost: process {world.rank}/{world.size}, backend {dist.get_backend()}, "
          f"device {world.device}", flush=True)
    return world


def _joined_world(dev_type: str) -> DataWorld:
    rank = dist.get_rank()
    dev = (torch.device("cuda", torch.cuda.current_device()) if dev_type == "cuda"
           else torch.device("cpu"))
    return DataWorld(rank, dist.get_world_size(), int(os.environ.get("LOCAL_RANK", rank)), dev,
                     dist.group.WORLD)


def shutdown_multihost() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_streamed_batch(world: DataWorld, batch):
    """A batch built alike on every process (an array, a tensor, or a dict
    of them) → this process's rows of it. Raises when the world size does
    not divide the rows, as the JAX function does."""
    if isinstance(batch, dict):
        return {k: global_streamed_batch(world, v) for k, v in batch.items()}
    return batch[world.rows(batch.shape[0])]


def shard_host_batch(world: DataWorld, batch):
    """Per-process rows → the global batch: the identity, since each process
    computes on its own rows (the collectives join the results)."""
    return batch


def put_replicated(world: DataWorld, a):
    """A value every process holds alike: the identity."""
    return a


def all_reduce_(t: torch.Tensor, world: DataWorld) -> torch.Tensor:
    """``t`` summed over the processes, in place; the identity without a
    group."""
    if world.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=world.group)
    return t


def all_reduce_grads_(params: Iterable[torch.nn.Parameter], world: DataWorld,
                      scale: float = 1.0) -> None:
    """Every gradient summed over the processes and times ``scale``, as one
    all-reduce of one flat buffer written back into ``.grad``. Parameters
    without a gradient are skipped (alike on every process)."""
    if world.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, world)
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def sum_across(values: Dict[str, torch.Tensor], world: DataWorld) -> Dict[str, torch.Tensor]:
    """Each tensor of ``values`` summed over the processes, by one
    all-reduce of an fp64 buffer on ``world.device`` (counts stay exact);
    each comes back in its own dtype, shape and device. The identity
    without a group."""
    if world.group is None:
        return values
    flat = torch.cat([v.detach().reshape(-1).to(world.device, torch.float64)
                      for v in values.values()])
    all_reduce_(flat, world)
    out, offset = {}, 0
    for k, v in values.items():
        out[k] = flat[offset : offset + v.numel()].view(v.shape).to(v.device, v.dtype)
        offset += v.numel()
    return out
