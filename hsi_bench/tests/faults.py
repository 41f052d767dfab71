"""Faults planted underneath a training cell's timed path, each acting
only while ``on()`` holds: a step that leaves the state unchanged, half of
the batch left out of the loss (the mean taken over the rest), and the
inputs staged for a chunk left as they were for the one before (a staged
table, masks and seeds frozen as a capture saw them)."""

from __future__ import annotations

from typing import Callable

FAULTS = ("unchanged_state", "half_batch", "stale_inputs")
# the number of the checked replay that each fault has to fail
CAUGHT_BY = {"unchanged_state": "replay_change_whole_gap", "half_batch": "replay_loss1_gap",
             "stale_inputs": "replay_loss1_gap"}


def replay_cases(cells) -> list:
    """(cell, fault) of every fault that a cell's compared numbers catch in
    the checked replay alone: where its catching number has a limit."""
    from hsi_bench import registry

    return [(c, f) for c in cells for f in FAULTS
            if CAUGHT_BY[f] in registry.workload(c)["limits"]]


def from_third_chunk(monkeypatch) -> Callable[[], bool]:
    """True from the trainer's third chunk on: the chunk that set-up checks
    as a replay of the window's graph, and every chunk of the window."""
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    calls = [0]
    chunk = Pretrainer.train_chunk_idx

    def counted(self, *args, **kw):
        calls[0] += 1
        return chunk(self, *args, **kw)

    monkeypatch.setattr(Pretrainer, "train_chunk_idx", counted)
    return lambda: calls[0] >= 3


def plant(monkeypatch, fault: str, on: Callable[[], bool]) -> None:
    if fault == "unchanged_state":
        from maskedsst_tpu_torch.train import train_state

        apply = train_state.TrainState.apply_gradients

        def maybe_no_update(self):
            if on():
                self.step += 1
            else:
                apply(self)

        monkeypatch.setattr(train_state.TrainState, "apply_gradients", maybe_no_update)
    elif fault == "half_batch":
        from maskedsst_tpu_torch.models import simmim

        forward = simmim.SimMIMSpatialSpectral.forward

        def maybe_half(self, img, *args, draws=None, **kw):
            if on():
                h = img.shape[0] // 2
                img = img[:h]
                if draws is not None:
                    draws = draws._replace(mask=draws.mask[:h])
            return forward(self, img, *args, draws=draws, **kw)

        monkeypatch.setattr(simmim.SimMIMSpatialSpectral, "forward", maybe_half)
    elif fault == "stale_inputs":
        from maskedsst_tpu_torch.train.superstep import Superstep

        stage = Superstep.stage

        def maybe_stale(self, *args, **kw):
            if on() and getattr(self, "_staged", None) is not None:
                return self._staged
            return stage(self, *args, **kw)

        monkeypatch.setattr(Superstep, "stage", maybe_stale)
    else:
        raise ValueError(fault)
