"""The trainers' superstep: ``steps_per_call`` training steps per host
dispatch, the counterpart of the JAX trainers' ``_superstep`` (a
``lax.scan`` of K steps inside one jitted call).

A chunk of K steps on the device store's index batches is prepared on the
host first. The trainer draws every step's random values from its
generator in the order K single steps draw them (crop origin, then the
model's ``draw_step``: SimMIM's mask, the layers' seeds, the embedding
dropout's keep mask), so that after the chunk the generator is where K
single steps leave it. :meth:`Superstep.stage` puts the chunk's inputs on
the device: the index batches, crop origins and layer seeds as one int64
[K, B + 2 + layers] table through pinned memory (one non-blocking copy,
two pinned buffers in turn), the masks into [K, ...] buffers. Step i then
reads row i: the crop gathered at device origins
(``data/device_store.py::gather_crop``), the layer kernels' seeds read
from device memory.

:meth:`Superstep.run` runs the chunk by one of two routes, chosen once from
how the trainer was built (:func:`choose_route`):

* the graph route (k above 1, CUDA, no process group or an NCCL one, no
  model axis, a ViT, Adam or AdamW, built capturable for the trainer's
  eager steps and replays alike): one ``torch.cuda.CUDAGraph`` holds the chain of K
  steps (forward, backward, the all-reduce, clamp, optimizer step) and is
  replayed once per chunk. It is captured after the first chunk of its
  shapes has run eagerly (the optimizer state exists, every kernel is built
  and has its attributes set), and again when K, the shapes or a group's
  learning rate change (a captured step keeps its rate). A replay runs no
  wrapper, so the launches the capture counted are added to the counts per
  replay. A capture or replay that fails raises: there is no fallback;
* the eager route (everything else: the CPU, Gloo ranks, the zoo nets, SGD,
  Adagrad, Adadelta): the same K steps on the same staged inputs, one after
  the other.

Either route returns the chunk's metrics as [K] device vectors, and gives
the bits of K single steps.

Under a torch profiler the host's part is recorded as spans
(``utils/profiling.py::span``) inside the trainers' ``train.chunk``
(``steps``) and its ``train.draw``: ``train.stage``, in it
``train.stage_wait`` (the host waiting on the card for a pinned buffer);
``train.capture`` and ``train.replay``, each with ``launches``, the counts
by kernel that a replay adds; ``train.eager`` (an eager or warm-up chunk)
with ``launches``, the counts its wrappers added.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from maskedsst_tpu_torch.models.layers import StepDraws
from maskedsst_tpu_torch.ops import add_launch_counts, launch_counts
from maskedsst_tpu_torch.utils.profiling import span

Metrics = Dict[str, torch.Tensor]


class Route(NamedTuple):
    graph: bool
    reason: str

    def describe(self, k: int) -> str:
        name = "CUDA graph" if self.graph else "eager"
        return f"superstep of {k} steps, {name} route: {self.reason}"


def choose_route(device: torch.device, world, model: torch.nn.Module, optimizer: str,
                 steps_per_call: int) -> Route:
    """The graph route where a chunk can be one CUDA graph, else the eager
    route, with the reason. ``optimizer``: the name the trainer builds
    (``train/optim.py``), capturable on the graph route only: a trainer
    that never replays a graph keeps torch's default (faster when never
    captured, and the arithmetic of single-step runs)."""
    from maskedsst_tpu_torch.models.simmim import SimMIMSpatialSpectral
    from maskedsst_tpu_torch.models.vit_spatial_spectral import ViTBase

    if steps_per_call <= 1:
        return Route(False, "single steps (steps_per_call 1)")
    if device.type != "cuda":
        return Route(False, f"the device is {device.type}, a CUDA graph needs the card")
    if getattr(world, "model_size", 1) > 1:
        return Route(False, "a model axis")
    if world.group is not None:
        import torch.distributed as dist

        backend = dist.get_backend(world.group)
        if backend != "nccl":
            return Route(False, f"a {backend} group, whose collectives run on the host")
    if not isinstance(model, (ViTBase, SimMIMSpatialSpectral)):
        return Route(False, f"{type(model).__name__} is not a ViT: its draws are made "
                            "inside its forward")
    if optimizer not in ("Adam", "AdamW"):
        return Route(False, f"{optimizer} is not captured (Adam and AdamW are)")
    return Route(True, f"{type(model).__name__} with {optimizer} on "
                       f"{device}" + ("" if world.group is None else " over NCCL"))


def chain(step: Callable[[int], Metrics], k: int) -> Metrics:
    """Steps 0..k-1 one after the other; their metrics stacked into [k]."""
    outs = [step(i) for i in range(k)]
    return {name: torch.stack([o[name] for o in outs]) for name in outs[0]}


def _eager(step: Callable[[int], Metrics], k: int) -> Metrics:
    """:func:`chain` in a ``train.eager`` span that counts its launches."""
    with span("train.eager") as sp:
        before = launch_counts() if sp else None
        out = chain(step, k)
        if sp:
            after = launch_counts()
            sp.count(launches={name: after[name] - before[name] for name in after})
    return out


class Staged(NamedTuple):
    """A chunk's inputs on the device, row i for step i: ``idx`` int64 [K, B]
    (this process's rows), ``xy`` int64 [K, 2], ``seeds`` int32 [K,
    layers], ``mask`` / ``keep`` [K, ...] or None."""

    idx: torch.Tensor
    xy: torch.Tensor
    seeds: torch.Tensor
    mask: Optional[torch.Tensor]
    keep: Optional[torch.Tensor]

    def draws(self, i: int) -> StepDraws:
        return StepDraws(self.seeds[i], None if self.keep is None else self.keep[i],
                         None if self.mask is None else self.mask[i])


def _stack_into(buf: Optional[torch.Tensor], parts: Sequence[Optional[torch.Tensor]]):
    if parts[0] is None:
        return None
    for i, t in enumerate(parts):
        buf[i].copy_(t)
    return buf


class Superstep:
    """One ``fit``'s chunk runner on ``device`` by ``route`` (a graph lives
    no longer than the fit that captured it: a resume replaces the
    optimizer's state tensors, whose addresses a graph holds)."""

    def __init__(self, route: Route, device: torch.device):
        self.route, self.device = route, device
        self._key = None
        self._staged: Optional[Staged] = None
        self._table: Optional[torch.Tensor] = None
        self._pinned: List[list] = []  # [host table, event after its copy]
        self._turn = 0
        self._graph = None
        self._graph_key = None
        self._outputs: Optional[Metrics] = None
        self._counts: Dict[str, int] = {}
        self._warm: set = set()
        # each capture: {"k", "seconds", "pool_bytes", "launches"}
        self.captures: List[dict] = []
        self.replays = 0

    # --- inputs -------------------------------------------------------------
    def stage(self, idx: np.ndarray, xy: np.ndarray, draws: Sequence[StepDraws]) -> Staged:
        """Puts a chunk's inputs on the device: ``idx`` int [K, B] (this
        process's rows), ``xy`` int [K, 2], ``draws`` the K steps' draws
        (seeds on the CPU, masks on the device)."""
        with span("train.stage"):
            seeds = torch.stack([d.seeds for d in draws]).to(torch.int64).numpy()
            table = np.concatenate([np.asarray(idx, np.int64), np.asarray(xy, np.int64), seeds],
                                   axis=1)
            k, b, n_seeds = table.shape[0], idx.shape[1], seeds.shape[1]
            masks = [d.mask for d in draws]
            keeps = [d.keep for d in draws]
            key = (table.shape, *(None if t[0] is None else (tuple(t[0].shape), t[0].dtype)
                                  for t in (masks, keeps)))
            if key != self._key:
                self._allocate(key, k, b, n_seeds, masks[0], keeps[0])
            if self.device.type == "cuda":
                host, event = self._pinned[self._turn]
                if event is not None:
                    with span("train.stage_wait"):
                        event.synchronize()  # the copy two chunks ago has read this buffer
                host.numpy()[...] = table
                self._table.copy_(host, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                self._pinned[self._turn][1] = event
                self._turn ^= 1
            else:
                self._table.copy_(torch.from_numpy(table))
            st = self._staged
            st.seeds.copy_(self._table[:, b + 2 :])
            _stack_into(st.mask, masks)
            _stack_into(st.keep, keeps)
            return st

    def _allocate(self, key, k, b, n_seeds, mask, keep) -> None:
        self._graph = self._outputs = self._graph_key = None
        dev = self.device
        self._table = torch.empty((k, b + 2 + n_seeds), dtype=torch.int64, device=dev)
        if dev.type == "cuda":
            self._pinned = [[torch.empty(self._table.shape, dtype=torch.int64).pin_memory(), None]
                            for _ in range(2)]
        self._staged = Staged(
            idx=self._table[:, :b], xy=self._table[:, b : b + 2],
            seeds=torch.empty((k, n_seeds), dtype=torch.int32, device=dev),
            mask=None if mask is None else torch.empty((k, *mask.shape), dtype=mask.dtype,
                                                       device=dev),
            keep=None if keep is None else torch.empty((k, *keep.shape), dtype=keep.dtype,
                                                       device=dev))
        self._key = key

    # --- running --------------------------------------------------------------
    def run(self, state, k: int, step: Callable[[int], Metrics]) -> Metrics:
        """The chunk's K steps (``step(i)`` reads row i of the staged inputs
        and makes one update of ``state``): [K] metric vectors."""
        if not self.route.graph:
            return _eager(step, k)
        shapes = (k, self._key)
        if shapes not in self._warm:
            self._warm.add(shapes)
            return _eager(step, k)
        key = (shapes, tuple(float(g["lr"]) for g in state.optimizer.param_groups))
        if key != self._graph_key:
            with span("train.capture") as sp:
                self._capture(state, k, step, key)
                sp.count(launches=self._counts)
        with span("train.replay", launches=self._counts):
            self._graph.replay()
        self.replays += 1
        add_launch_counts(self._counts)
        state.step += k
        return {name: v.clone() for name, v in self._outputs.items()}

    def _capture(self, state, k: int, step: Callable[[int], Metrics], key) -> None:
        self._graph = self._outputs = self._graph_key = None  # frees the old graph's pool
        before, step0 = launch_counts(), state.step
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture does first: the pool's growth alone
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = chain(step, k)
        torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        after = launch_counts()
        # the capture launched nothing: its counts are the launches of a replay
        self._counts = {name: after[name] - before[name] for name in after}
        add_launch_counts({name: -n for name, n in self._counts.items()})
        state.step = step0
        self._graph, self._outputs, self._graph_key = graph, outputs, key
        self.captures.append({"k": k, "seconds": seconds,
                              "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved,
                              "launches": dict(self._counts)})
