"""Pretraining through the program's store path: ``Pretrainer.train_chunk_idx``
chunk after chunk, as ``fit`` drives it (supersteps of ``steps_per_call``
index batches, a CUDA graph replay each on the card's route).

Parameters (``traffic`` of the cell): ``section`` (the configuration's
recipe), ``tiles`` and ``tile_size`` (the store, made on the device from
the seed), ``checked_steps`` (how many of the first steps the reference
follows from the seed's weights). Index batches: each epoch a
permutation of the store drawn from the seed, in batches of the recipe's
batch size; every seed trains the same number of cubes of the same shapes.

Set-up builds one trainer, loads the seed's weights and runs three chunks
through the window's call, then hands the same trainer to the window:

1. the first chunk, which the program runs step by step (a new shape's
   first chunk): the start, checked from the seed's weights (the losses
   of the checked steps, step 1's clamped gradient as AdamW's first
   moment holds it, the parameters' change over the checked steps);
2. the second chunk: the graph's capture and its first replay;
3. the third chunk, a replay of that graph as every chunk of the window
   is: checked from the program's state before it (the reference follows
   its steps from there: the losses the replay returns, the parameters'
   change and AdamW's first moment after it). A long bfloat16 run drifts
   from a float32 one, so its state is not one the reference reaches from
   the seed; the start and this chunk are each checked by themselves.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch

from hsi_bench import port, weights
from hsi_bench.reference import train as ref_train

BETA1 = 0.9


def _leaf_gap(prog: dict, ref: dict, names, own: bool = False) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger (``own``: of
    that leaf alone)."""
    med = 0.0 if own else statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def _worst_leaf(prog: dict, ref: dict, names) -> list:
    """[leaf, program's norm, reference's norm, the median leaf's] of the
    leaf that sets ``_leaf_gap``."""
    med = statistics.median(ref[k] for k in ref)
    k = max(names, key=lambda n: abs(prog[n] - ref[n]) / max(ref[n], med))
    return [k, prog[k], ref[k], med]


def _whole_gap(prog: dict, ref: dict, names) -> float:
    """The gap between the norms of all ``names`` leaves taken as one vector."""
    whole = [sum(d[k] ** 2 for k in names) ** 0.5 for d in (prog, ref)]
    return _rel(*whole)


def moved_leaves(ref: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: AdamW moves the others by round-off alone."""
    gmed = statistics.median(ref["grad_norms"].values())
    return [k for k, g in ref["grad_norms"].items() if g >= 1e-3 * gmed]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers read. Of the start: ``loss<t>_gap`` (step t's relative
    loss gap), ``grad_gap`` (step 1's clamped gradient, worst leaf),
    ``change_gap`` (the change over the checked steps, worst leaf of
    ``moved_leaves``), and ``grad_gap_own`` / ``change_gap_own`` (the same
    against each leaf's own norm). Of the replayed chunk:
    ``replay_loss1_gap`` (its first step), ``replay_loss_gap`` (the mean
    over its steps), ``replay_change_gap`` and ``replay_moment_gap`` (the
    change over it and AdamW's first moment after it, worst leaf)."""
    ps, rs, pr, rr = prog["start"], ref["start"], prog["replay"], ref["replay"]
    out = {f"loss{t}_gap": _rel(a, b) for t, (a, b) in enumerate(zip(ps["losses"], rs["losses"]), 1)}
    moved = moved_leaves(rs)
    out["grad_gap"] = _leaf_gap(ps["grad_norms"], rs["grad_norms"], rs["grad_norms"])
    out["change_gap"] = _leaf_gap(ps["change_norms"], rs["change_norms"], moved)
    out["grad_gap_own"] = _leaf_gap(ps["grad_norms"], rs["grad_norms"], moved, own=True)
    out["change_gap_own"] = _leaf_gap(ps["change_norms"], rs["change_norms"], moved, own=True)
    out["replay_loss1_gap"] = _rel(pr["losses"][0], rr["losses"][0])
    out["replay_loss_gap"] = statistics.fmean(_rel(a, b) for a, b in zip(pr["losses"], rr["losses"]))
    out["replay_change_gap"] = _leaf_gap(pr["change_norms"], rr["change_norms"], moved_leaves(rr))
    out["replay_moment_gap"] = _leaf_gap(pr["moment_norms"], rr["moment_norms"], moved_leaves(rr))
    out["replay_change_whole_gap"] = _whole_gap(pr["change_norms"], rr["change_norms"],
                                                moved_leaves(rr))
    return out


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf that sets each worst-leaf number."""
    ps, rs, pr, rr = prog["start"], ref["start"], prog["replay"], ref["replay"]
    return {"grad_gap": _worst_leaf(ps["grad_norms"], rs["grad_norms"], rs["grad_norms"]),
            "change_gap": _worst_leaf(ps["change_norms"], rs["change_norms"], moved_leaves(rs)),
            "replay_change_gap": _worst_leaf(pr["change_norms"], rr["change_norms"],
                                             moved_leaves(rr)),
            "replay_moment_gap": _worst_leaf(pr["moment_norms"], rr["moment_norms"],
                                             moved_leaves(rr))}


def small_leaves(prog: dict, ref: dict) -> dict:
    """Of the start's leaves whose reference gradient lies under the median
    leaf's: each one's gradient and change gap against its own norm."""
    rs, ps = ref["start"], prog["start"]
    med = statistics.median(rs["grad_norms"].values())
    return {k: {"grad": _rel(ps["grad_norms"][k], g),
                "change": _rel(ps["change_norms"][k], rs["change_norms"][k])}
            for k, g in rs["grad_norms"].items() if g < med}


class Cell:
    def __init__(self, config: dict, params: dict, seed: int, device: str):
        self.cfg = config[params["section"]]
        self.params, self.device = params, device
        (self.w_seed, self.data_seed, self.trainer_seed,
         self.order_seed) = weights.sub_seeds(seed, 4)
        self.batch = int(self.cfg["batch_size"])
        self.k = int(self.cfg["steps_per_call"])
        self.checked = int(params["checked_steps"])
        self.order = np.random.default_rng(self.order_seed)
        self.pending: list = []

    def _next_chunk(self) -> list:
        """The next ``steps_per_call`` index batches, epoch after epoch."""
        n = int(self.params["tiles"])
        while len(self.pending) < self.k:
            perm = self.order.permutation(n)
            self.pending += [perm[i : i + self.batch]
                             for i in range(0, n - self.batch + 1, self.batch)]
        chunk, self.pending = self.pending[: self.k], self.pending[self.k :]
        return chunk

    def _store(self) -> torch.Tensor:
        tile = int(self.params["tile_size"])
        return weights.cubes((int(self.params["tiles"]), int(self.cfg["n_bands"]), tile, tile),
                             self.data_seed, self.device)

    def setup(self) -> None:
        dev = self.device
        clock = weights.phases()
        self.trainer = port.pretrainer(self.cfg, self.trainer_seed, int(self.params["tile_size"]),
                                       dev)
        clock("trainer")
        self.w0 = weights.make(self.cfg, "simmim", self.w_seed, dev)
        weights.load_into(self.trainer.model, self.w0)
        self.store = self._store()
        clock("weights and store")
        first = self._next_chunk()
        if self.checked > len(first):
            raise ValueError("the checked steps have to lie in the first chunk")
        self.prog = {"start": self._first_chunk(first)}
        clock("first chunk")
        self.trainer.train_chunk_idx(self.store, self._next_chunk())
        self._sync()
        clock("capture and replay")
        third = self._next_chunk()
        self.prog["replay"] = self._replayed_chunk(third)
        self.checked_batches = {t: first[t - 1] for t in range(1, self.checked + 1)}
        self.checked_batches.update({self.replay_start.step + i + 1: b for i, b in enumerate(third)})
        self._sync()
        clock("the checked replay")

    def _sync(self) -> None:
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def _first_chunk(self, chunk: list) -> dict:
        """Runs ``chunk`` through the window's call, reading the state after
        step 1 (AdamW's first moment) and after the checked steps."""
        state, model = self.trainer.state, self.trainer.model
        reads: dict = {}
        apply = state.apply_gradients

        def watched() -> None:
            apply()
            done = state.step - start
            if done == 1:
                opt = state.optimizer
                # a leaf the optimizer never stepped holds no moment: it reads 0
                reads["grad_norms"] = {
                    k: opt.state[p]["exp_avg"].norm() / (1 - BETA1) if "exp_avg" in opt.state[p]
                    else torch.zeros(()) for k, p in model.named_parameters()}
            if done == self.checked:
                reads["change_norms"] = {k: (p.detach() - self.w0[k]).norm()
                                         for k, p in model.named_parameters()}

        start = state.step
        state.apply_gradients = watched
        try:
            out = self.trainer.train_chunk_idx(self.store, chunk)
        finally:
            del state.apply_gradients
        if "change_norms" not in reads:
            raise RuntimeError("the first chunk did not step the optimizer as the checked "
                               "steps need")
        return {"losses": [float(x) for x in out["loss"][: self.checked]],
                "grad_norms": {k: float(v) for k, v in reads["grad_norms"].items()},
                "change_norms": {k: float(v) for k, v in reads["change_norms"].items()}}

    def _state(self) -> ref_train.Start:
        """A copy of the parameters, AdamW's moments and the updates made."""
        state = self.trainer.state
        opt = state.optimizer.state
        named = list(self.trainer.model.named_parameters())
        moment = {k: {n: opt[p][k].detach().clone() if k in opt[p] else torch.zeros_like(p)
                      for n, p in named} for k in ("exp_avg", "exp_avg_sq")}
        return ref_train.Start({n: p.detach().clone() for n, p in named},
                               moment["exp_avg"], moment["exp_avg_sq"], int(state.step))

    def _replayed_chunk(self, chunk: list) -> dict:
        """Runs ``chunk`` through the window's call, which replays the
        captured graph, reading the state before and after it."""
        sup = self.trainer.superstep
        replays, captures = sup.replays, len(sup.captures)
        self.replay_start = self._state()
        out = self.trainer.train_chunk_idx(self.store, chunk)
        if sup.route.graph and (sup.replays != replays + 1 or len(sup.captures) != captures):
            raise RuntimeError("the checked chunk was not a replay of the window's graph")
        end = self._state()
        before = self.replay_start.params
        return {"losses": [float(x) for x in out["loss"]],
                "change_norms": {k: float((p - before[k]).norm()) for k, p in end.params.items()},
                "moment_norms": {k: float(m.norm()) for k, m in end.exp_avg.items()}}

    def window(self, seconds: float) -> dict:
        losses, steps = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            losses.append(self.trainer.train_chunk_idx(self.store, self._next_chunk())["loss"])
            steps += self.k
        self._sync()
        window_s = time.perf_counter() - t0
        finite = int(torch.isfinite(torch.cat(losses)).sum())
        return {"window_s": window_s, "steps": steps, "cubes": steps * self.batch,
                "attempted": steps, "failed": steps - finite}

    def release(self) -> None:
        del self.trainer, self.store
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def _checked_tiles(self) -> dict:
        """The checked steps' tiles, gathered from the store made again
        from the seed (the program's is freed by then)."""
        if not hasattr(self, "tiles"):
            store = self._store()
            dev = store.device
            self.tiles = {t: store[torch.as_tensor(np.asarray(b), device=dev)]
                          for t, b in self.checked_batches.items()}
            del store
            if self.device.startswith("cuda"):
                torch.cuda.empty_cache()
        return self.tiles

    def reference(self, rounding: str = "float32", rows=None) -> dict:
        """The reference over the start (from the seed's weights) and over
        the replayed chunk (from the program's state before it)."""
        tiles = self._checked_tiles().__getitem__
        args = (self.cfg, self.trainer_seed, rounding, rows)
        return {"start": ref_train.follow(ref_train.Start(self.w0), tiles, self.checked, *args),
                "replay": ref_train.follow(self.replay_start, tiles, self.k, *args)}

    def compare(self) -> dict:
        ref = self.reference()
        left = sorted(set(ref["start"]["grad_norms"]) - set(moved_leaves(ref["start"])))
        print(f"change_gap leaves left out: {left or 'none'}", file=sys.stderr)
        return numbers(self.prog, ref)

    def readings(self, control: bool, seconds: float) -> dict:
        """The numbers of the program and, with ``control``, of the control
        (the reference in float8) and of half of the batch left out of the
        loss (the reference so planted), each in the program's place; a
        state left unchanged reads 1 by the change measures. Runs no
        window: a training cell's readings need none."""
        self.release()
        ref = self.reference()
        sides = {"program": self.prog}
        if control:
            sides["control"] = self.reference("fp8")
            sides["half_batch"] = self.reference(rows=self.batch // 2)
        return {"numbers": {k: numbers(v, ref) for k, v in sides.items()},
                "small_leaves": {k: small_leaves(v, ref) for k, v in sides.items()},
                "worst_leaves": {k: worst_leaves(v, ref) for k, v in sides.items()},
                "losses": {"program": self.prog["replay"]["losses"],
                           "reference": ref["replay"]["losses"]}}
