"""Supervised finetuning loop, the JAX package's ``Finetuner``.

One training step: an optional random crop (or shifting-window tiling) of
the 64x64 tiles with one origin per batch, center-pixel labels for
pixelwise models, the model's forward in train mode with its dropout drawn
from the trainer's generator, cross-entropy with ignored labels, backward
through the fused ops (the CUDA kernels on the card), and an Adam update
with split head/backbone learning rates (the li 3-D CNN: the factory's
``optimizer_override``, SGD with momentum, and ``class_weights`` in the
cross-entropy, its cubes given their channel axis by ``add_channel_dim``);
it returns loss, micro and macro accuracy. Validation slides
``image_size`` windows over the tiles and averages over all windows, from
per-chunk sums.

``fit`` keeps the tiles on the card (``DeviceTileStore``, unless
``device_data`` is off or the dataset draws anew on every read): each step
moves only its index vector and gathers just its crop windows there
(``train_step_idx``), and validation windows the tiles there
(``_eval_sums_idx``). A set larger than the store's budget streams host
batches (``DataLoader``) instead, as does a stochastic one; the two paths
take the same samples and draws, so they give the same bits (the host
batches read ahead on the loader's thread, a stochastic set's on this
one). The loop has the JAX loop's budgets: strict epoch/step overrides,
validation on ``get_val_epochs``, the plateau scheduler stepped
at the end of every completed epoch with the last mean validation loss,
and a raise when the logged loss is NaN. It logs the JAX loop's rows
through a ``Tracker`` (``utils/tracking.py``): every ``logging_freq``
steps the window means of loss, acc and macro_acc with the rate and the
window's steps/s and items/s, after each validation ``val_loss``,
``val_acc`` and ``val_macro_acc``. Metrics stay on the card until a
logging boundary or an epoch's end; whole epochs are timed, each ending in
one synchronize (``history["throughput"]``). It writes full-state
checkpoints (``train/checkpoint.py``) to ``models_dir/run_id/`` at
``checkpoint_save_epochs`` and the epoch budget once a validation has run,
``best_{method}`` on a new best, and one at every budget end that saved
nothing else; ``resume`` restores one with the loop state of its sidecar
(scheduler, ``best_val_acc``, the last validation loss), and ``fit``
continues it bit for bit.

Data parallelism (``world``, a ``parallel.mesh.DataWorld``): every process
builds the same batches and draws the same crop origins and dropout seeds;
it pads each prepared batch (the index vector on the store path) to a
multiple of the world size with ignored labels, as the JAX ``_pad_batch``,
and takes its rows. The cross-entropy of its rows is divided by the
global batch's weight mass, summed over the processes before the
backward, so the gradients summed by one all-reduce are the global
batch's; the training loss and accuracies and every validation sum are
summed over the processes as well, so the scheduler, ``best_val_acc`` and
the saves see the same numbers on every process. Not ported yet
(ROADMAP.md): the superstep (CUDA graphs later).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from maskedsst_tpu_torch.config import Config
from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
from maskedsst_tpu_torch.data.pipeline import DataLoader
from maskedsst_tpu_torch.models.zoo import ZooNet
from maskedsst_tpu_torch.parallel.mesh import (
    DataWorld,
    all_reduce_,
    all_reduce_grads_,
    global_streamed_batch,
    sum_across,
)
from maskedsst_tpu_torch.train.checkpoint import (
    load_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from maskedsst_tpu_torch.train.losses import cross_entropy_sums
from maskedsst_tpu_torch.train.metrics import confusion_matrix, macro_from_cm, micro_from_counts
from maskedsst_tpu_torch.train.optim import (
    build_optimizer,
    get_learning_rates,
    make_head_label_fn,
    plateau_scheduler,
)
from maskedsst_tpu_torch.train.pretrainer import largest_divisor
from maskedsst_tpu_torch.train.train_state import TrainState
from maskedsst_tpu_torch.train.windows import window_tiles
from maskedsst_tpu_torch.utils.tracking import Throughput, Tracker


def get_val_epochs(config: Config, steps_per_epoch: int) -> list:
    """Validation epochs: every epoch when the epoch budget dominates;
    ``epoch`` validations spread evenly over the run when max_steps does."""
    total_steps = steps_per_epoch * config.epoch
    if total_steps > config.max_steps:
        return list(range(config.epoch))
    total_epochs = config.max_steps // max(steps_per_epoch, 1)
    return sorted(set(int(e) for e in np.linspace(0, total_epochs, config.epoch)))


class Finetuner:
    """Trains ``model`` (already on its device) by the config's recipe.

    ``tile_size``: the side of the dataset's tiles (64 for EnMAP; crops of
    ``image_size`` are drawn from them). Every random choice of a step (the
    crop origin, then the model's dropout seeds) comes from
    ``self.state.rng``, a CPU generator seeded by ``config.seed``.
    ``world``: this process's place in a data-parallel run (default: one
    process); ``config.batch_size`` is the global batch.
    ``add_channel_dim``: feed the model [B, 1, C, H, W] (the li 3-D CNN);
    ``optimizer_override``: a recipe's optimizer spec (``name``,
    ``learning_rate``, ``weight_decay``, ``momentum``) over the config's;
    ``class_weights``: per-class weights of the cross-entropy."""

    def __init__(
        self,
        config: Config,
        model: torch.nn.Module,
        center_pixel: bool = False,
        tile_size: int = 64,
        world: Optional[DataWorld] = None,
        add_channel_dim: bool = False,
        optimizer_override: Optional[dict] = None,
        class_weights=None,
    ):
        self.config = config
        self.model = model
        self.world = world or DataWorld()
        self.device = next(model.parameters()).device
        self.center_pixel = center_pixel
        self.add_channel_dim = add_channel_dim
        if isinstance(model, ZooNet):
            # cuDNN's fastest 3-D convolution weight gradients sum with
            # atomics, so two li steps from one state differ in their last
            # bits on the card and a resume misses its control (the JAX zoo's
            # XLA convolutions repeat them); the deterministic algorithms cost
            # li's store step ~2x of device time (PERF.md, PR 15). cuDNN
            # only: the ViT paths run no cuDNN operation.
            torch.backends.cudnn.deterministic = True
        self.tile_size = tile_size
        self.class_weights = (None if class_weights is None else
                              torch.as_tensor(np.asarray(class_weights), dtype=torch.float32,
                                              device=self.device))
        opt = dict(name="Adam", learning_rate=config.lr, weight_decay=config.weight_decay,
                   head_lr=config.get("mlp_head_lr"),
                   head_label_fn=make_head_label_fn(config.get("method_name")),
                   linear_eval=bool(config.get("linear_eval", False)))
        opt.update(optimizer_override or {})
        if opt["linear_eval"]:
            opt["head_lr"] = None  # linear eval trains the head at the base lr
        optimizer = build_optimizer(model, opt.pop("learning_rate"), opt.pop("weight_decay"),
                                    **opt)
        rng = torch.Generator().manual_seed(int(config.get("seed", 5)))
        self.state = TrainState(model, optimizer, rng)
        self.scheduler = plateau_scheduler(optimizer)
        self.num_params = sum(p.numel() for p in model.parameters())
        self.crop = config.image_size != tile_size and config.dataset in ("dfc", "worldcover")
        self.shifting_window = bool(config.get("shifting_window", False))
        self.eval_chunk = int(config.get("eval_chunk", 256))
        self._resume_extra: dict = {}

    @property
    def window(self) -> int:
        return self.config.image_size - self.config.get("patch_sub", 0)

    # --- one step ------------------------------------------------------------
    def _crop_draw(self) -> Tuple[int, Tuple[int, int]]:
        """One crop origin per batch, in the reference's deliberately narrow
        range ``randint(0, tile - image_size - patch_sub)`` (under patch_sub
        the last 2*patch_sub origins are never drawn)."""
        hi = max(self.tile_size - self.config.image_size - self.config.get("patch_sub", 0), 1)
        xy = torch.randint(0, hi, (2,), generator=self.state.rng).tolist()
        return self.window, (xy[0], xy[1])

    def _prep(self, img: torch.Tensor, label: torch.Tensor,
              xy: Optional[Tuple[int, int]] = None):
        """Crop (origin drawn, or ``xy`` when given) or window the batch, and
        take center-pixel labels for pixelwise models."""
        s = self.window
        if self.crop and self.shifting_window:
            img, label = window_tiles(img, s, label)
        elif self.crop:
            if xy is None:
                s, xy = self._crop_draw()
            x0, y0 = xy
            img = img[:, :, x0 : x0 + s, y0 : y0 + s]
            label = label[:, x0 : x0 + s, y0 : y0 + s]
        if self.center_pixel and label.dim() == 3:
            label = label[:, s // 2, s // 2]
        return img, label

    def _shard(self, img, label):
        """This process's rows of a global batch (tensors), padded first to a
        multiple of the world size with zero images under the ignored label
        (JAX ``_pad_batch``): pad rows add nothing to the loss, its
        gradients or the metrics."""
        pad = (-img.shape[0]) % self.world.size
        if pad:
            img = torch.cat([img, img.new_zeros((pad, *img.shape[1:]))])
            label = torch.cat([label, label.new_full((pad, *label.shape[1:]),
                                                     self.config.ignored_label)])
        return global_streamed_batch(self.world, img), global_streamed_batch(self.world, label)

    def _shard_idx(self, idx) -> torch.Tensor:
        """This process's rows of a global index batch, padded first to a
        multiple of the world size with -1 (ignored labels)."""
        idx = torch.as_tensor(idx, dtype=torch.int64)
        pad = (-idx.shape[0]) % self.world.size
        if pad:
            idx = torch.cat([idx, idx.new_full((pad,), -1)])
        return global_streamed_batch(self.world, idx)

    def _to_device(self, img, label):
        img = torch.as_tensor(img).to(self.device, torch.float32)
        label = torch.as_tensor(label).to(self.device, torch.int64)
        return img, label

    def train_step(self, img, label, xy: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
        """One update on a batch of tiles (numpy or tensors, the global
        batch); returns the global batch's loss, acc and macro_acc as device
        scalars. The crop is taken where the batch lies, before the copy to
        the card, so a host batch moves only this process's crop windows."""
        return self._update(*self._to_device(*self._shard(
            *self._prep(torch.as_tensor(img), torch.as_tensor(label), xy))))

    def _gather_batch(self, store_img: torch.Tensor, store_label: torch.Tensor,
                      idx: torch.Tensor):
        """The tiles at ``idx`` and their labels; a -1 index (the padded
        tail of an epoch) reads tile 0 under the ignored label."""
        safe = idx.clamp(min=0)
        return store_img[safe], self._mask_pad(store_label[safe], idx)

    def _gather_crop_batch(self, store_img: torch.Tensor, store_label: torch.Tensor,
                           idx: torch.Tensor, xy: Tuple[int, int], s: int):
        """Gather + crop on the card: reads only the [B, C, s, s] windows of
        the indexed tiles and the [B, s, s] windows of their labels."""
        x0, y0 = xy
        safe = idx.clamp(min=0)
        img = store_img[:, :, x0 : x0 + s, y0 : y0 + s][safe]
        label = store_label[:, x0 : x0 + s, y0 : y0 + s][safe]
        return img, self._mask_pad(label, idx)

    def _mask_pad(self, label: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        keep = (idx >= 0).reshape((-1,) + (1,) * (label.dim() - 1))
        return torch.where(keep, label, torch.full_like(label, self.config.ignored_label))

    def train_step_idx(self, store_img: torch.Tensor, store_label: torch.Tensor, idx,
                       xy: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
        """One update on the store's tiles at ``idx`` ([B] indices of the
        global batch, -1 for padding: this process gathers its rows), as
        ``train_step`` on the same tiles: the crop origin is drawn first (or
        given as ``xy``), then the dropout seeds."""
        idx = self._shard_idx(idx).to(store_img.device)
        if self.crop and not self.shifting_window and store_label.dim() == 3:
            s, xy = (self.window, xy) if xy is not None else self._crop_draw()
            img, label = self._gather_crop_batch(store_img, store_label, idx, xy, s)
            if self.center_pixel:
                label = label[:, s // 2, s // 2]
            return self._update(img, label)
        return self._update(*self._prep(*self._gather_batch(store_img, store_label, idx), xy))

    def _update(self, img: torch.Tensor, label: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Forward in train mode, cross-entropy, backward and the Adam step
        on this process's rows of a batch, on the card; the global batch's
        loss and accuracies as device scalars. The loss is normalized by the
        global weight mass, so that the gradients summed over the processes
        are the global batch's (the ranks' means averaged would weigh the
        rows of a rank with few valid labels more)."""
        cfg, world = self.config, self.world
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        logits = self.model(img[:, None] if self.add_channel_dim else img, rng=self.state.rng,
                            shard=world.shard)
        num, wsum = cross_entropy_sums(logits, label, ignore_index=cfg.ignored_label,
                                       weight=self.class_weights)
        loss = num / all_reduce_(wsum.detach(), world).clamp_min(1e-12)
        loss.backward()
        all_reduce_grads_(self.model.parameters(), world)
        self.state.apply_gradients()
        with torch.no_grad():
            pred = logits.argmax(dim=1)
            valid = label != cfg.ignored_label
            sums = sum_across({
                "loss": loss.detach(), "correct": ((pred == label) & valid).sum(),
                "n_valid": valid.sum(),
                "cm": confusion_matrix(pred, label, cfg.n_classes, cfg.ignored_label),
            }, world)
            return {
                "loss": sums["loss"],
                "acc": micro_from_counts(sums["correct"], sums["n_valid"]),
                "macro_acc": macro_from_cm(sums["cm"]),
            }

    @torch.no_grad()
    def _eval_sums(self, img, label) -> Dict[str, torch.Tensor]:
        """Per-chunk metric sums (weighted-loss numerator and weight mass,
        correct, valid, confusion matrix), so that host aggregation gives
        exact global metrics."""
        cfg = self.config
        img, label = self._to_device(img, label)
        if self.center_pixel and label.dim() == 3:
            label = label[:, self.window // 2, self.window // 2]
        self.model.eval()
        logits = self.model(img[:, None] if self.add_channel_dim else img)
        loss_num, loss_wsum = cross_entropy_sums(logits, label, ignore_index=cfg.ignored_label,
                                                 weight=self.class_weights)
        pred = logits.argmax(dim=1)
        valid = label != cfg.ignored_label
        return {
            "loss_num": loss_num, "loss_wsum": loss_wsum,
            "correct": ((pred == label) & valid).sum(), "n_valid": valid.sum(),
            "cm": confusion_matrix(pred, label, cfg.n_classes, cfg.ignored_label),
        }

    @torch.no_grad()
    def _eval_sums_idx(self, store_img: torch.Tensor, store_label: torch.Tensor,
                       idx) -> Dict[str, torch.Tensor]:
        """``_eval_sums`` over every window of the store's tiles at ``idx``:
        gathered and windowed on the card, in chunks of
        ``largest_divisor(windows, 256)``, the sums added there."""
        idx = self._shard_idx(idx).to(store_img.device)
        img, label = self._gather_batch(store_img, store_label, idx)
        if self.crop:
            img, label = window_tiles(img, self.window, label)
        n = img.shape[0]
        chunk = largest_divisor(n, 256)
        sums = None
        for lo in range(0, n, chunk):
            out = self._eval_sums(img[lo : lo + chunk], label[lo : lo + chunk])
            sums = out if sums is None else {k: sums[k] + out[k] for k in sums}
        return sums

    def _window_batch(self, img: np.ndarray, label: np.ndarray):
        """Host-side sliding windows at stride s over the tiles, then
        fixed-size chunks padded with ignored labels."""
        if self.crop:
            img, label = window_tiles(img, self.window, label)
        chunk, n = self.eval_chunk, img.shape[0]
        for lo in range(0, n, chunk):
            ci, cl = img[lo : lo + chunk], label[lo : lo + chunk]
            if ci.shape[0] < chunk:
                pad = chunk - ci.shape[0]
                ci = np.concatenate([ci, np.zeros((pad, *ci.shape[1:]), ci.dtype)])
                cl = np.concatenate([cl, np.full((pad, *cl.shape[1:]), self.config.ignored_label,
                                                 cl.dtype)])
            yield ci, cl

    def validate(self, val_loader, val_store: Optional[DeviceTileStore] = None) -> Optional[dict]:
        """Mean loss, acc and macro_acc over every window of the loader's
        batches: host batches, or index batches into ``val_store``. Each
        process computes the sums of its rows, summed over the processes at
        the end."""
        sums = None
        for batch in val_loader:
            if val_store is not None:
                parts = [self._eval_sums_idx(val_store.arrays["img"], val_store.arrays["label"],
                                             batch)]
            else:
                parts = (self._eval_sums(*self._shard(torch.as_tensor(ci), torch.as_tensor(cl)))
                         for ci, cl in self._window_batch(batch["img"], batch["label"]))
            for part in parts:
                out = {k: v.cpu().numpy() for k, v in part.items()}
                sums = out if sums is None else {k: sums[k] + out[k] for k in sums}
        if sums is not None:
            sums = {k: v.numpy() for k, v in sum_across(
                {k: torch.from_numpy(np.asarray(v)) for k, v in sums.items()}, self.world).items()}
        if sums is None or sums["n_valid"] <= 0:
            return None
        support = sums["cm"].sum(axis=1)
        recall = np.where(support > 0, np.diag(sums["cm"]) / np.maximum(support, 1), 0.0)
        present = support > 0
        return {
            "loss": float(sums["loss_num"]) / max(float(sums["loss_wsum"]), 1e-12),
            "acc": float(sums["correct"]) / float(sums["n_valid"]),
            "macro_acc": float((recall * present).sum() / max(present.sum(), 1)),
        }

    # --- checkpoints ----------------------------------------------------------
    def resume(self, path: str) -> int:
        """Restore the full finetune state from a checkpoint this trainer
        wrote: parameters, the optimizer's state (Adam moments, SGD momentum
        buffers), step and generator, then from the
        sidecar the plateau scheduler, ``best_val_acc`` and the last mean
        validation loss, which the next ``fit`` takes up once. Returns the
        step. A JAX finetuner's ``.msgpack`` restores the same (Adam only;
        the generator seeded from the file's JAX key,
        ``io/flax_checkpoint.py``)."""
        restore_checkpoint(path, self.state)
        try:
            extra = load_metadata(path).get("extra", {})
        except FileNotFoundError:
            extra = {}
        if extra.get("scheduler"):
            self.scheduler.load_state_dict(extra["scheduler"])
        self._resume_extra = dict(extra)
        return self.state.step

    # --- loop ----------------------------------------------------------------
    def fit(self, train_dataset, val_dataset, tracker: Optional[Tracker] = None,
            models_dir: str = "models", save_checkpoints: bool = True,
            epochs: Optional[int] = None, max_steps: Optional[int] = None) -> dict:
        """Train from the state's step to the budgets, logging to ``tracker``
        (default: a ``Tracker`` of the JAX project name); checkpoints go to
        ``models_dir/<tracker.run_id>/``."""
        cfg = self.config
        tracker = tracker or Tracker("downstream", cfg)
        cfg.run_id = tracker.run_id
        cfg.num_params = self.num_params
        tracker.update_config(cfg)
        run_dir = os.path.join(models_dir, str(cfg.run_id))
        val_bs = cfg.get("val_batch_size", cfg.batch_size)
        seed = int(cfg.get("seed", 5))
        if cfg.batch_size % self.world.size and cfg.batch_size >= self.world.size:
            raise ValueError(f"batch_size {cfg.batch_size} is not divisible by the world size "
                             f"({self.world.size})")
        # the tiles on the card unless they exceed the store's budget; a
        # dataset that draws anew on every read streams (a store made once
        # would freeze one draw for the whole run)
        train_store = val_store = None
        if cfg.get("device_data", True) and not getattr(train_dataset, "stochastic", False):
            try:
                train_store = DeviceTileStore(train_dataset, self.device)
                val_store = DeviceTileStore(val_dataset, self.device)
            except MemoryError as exc:
                print(f"[finetune] streaming from host: {exc}")
                train_store = val_store = None
        if train_store is not None:
            # the ragged tails pad with -1: ignored labels, as the streamed
            # batches' padding
            loader = IndexBatcher(len(train_store), cfg.batch_size, shuffle=True,
                                  drop_last=False, seed=seed)
            val_loader = IndexBatcher(len(val_store), val_bs, shuffle=False, drop_last=False)
        else:
            loader = DataLoader(train_dataset, cfg.batch_size, shuffle=True, seed=seed,
                                pad_to_multiple=cfg.batch_size,
                                pad_label_value=cfg.ignored_label)
            val_loader = DataLoader(val_dataset, val_bs, shuffle=False, pad_to_multiple=val_bs,
                                    pad_label_value=cfg.ignored_label)
        # config budgets run until BOTH are exhausted; explicit overrides stop
        # at whichever is hit first
        strict = epochs is not None or max_steps is not None
        epoch_budget = epochs if epochs is not None else cfg.epoch
        step_budget = max_steps if max_steps is not None else cfg.max_steps
        validation_epochs = set(get_val_epochs(cfg, max(len(loader), 1)))
        best_val_acc = float(self._resume_extra.get("best_val_acc") or 0.0)
        # the last mean validation loss keeps stepping the scheduler at every
        # epoch end, across a resume too
        last_val_loss = self._resume_extra.get("last_val_loss")
        self._resume_extra = {}  # taken up once
        history = {"train": [], "val": [], "best_val_acc": best_val_acc,
                   "device_store": train_store is not None}
        # a resumed run continues the loader's shuffle at its epoch and skips
        # the batches of that epoch trained before the save; the truncated
        # epoch's end hooks fire once, in the run that completes it
        step = self.state.step
        steps_per_epoch = max(1, len(loader))
        start_epoch = epoch = step // steps_per_epoch
        resume_skip = step - start_epoch * steps_per_epoch
        loader.epoch = start_epoch
        if train_store is None:
            loader.skip_next = resume_skip
        win = {k: deque(maxlen=cfg.logging_freq) for k in ("loss", "acc", "macro_acc")}
        train_seconds, train_steps = 0.0, 0
        meter = Throughput(cfg.batch_size, num_chips=self.world.size)
        meter.start()

        def done() -> bool:
            if strict:
                return epoch >= epoch_budget or step >= step_budget
            return epoch >= epoch_budget + 1 and step >= step_budget + 1

        def log_step():
            means = {k: float(torch.stack(list(v)).float().mean()) for k, v in win.items() if v}
            if "loss" in means and not np.isfinite(means["loss"]):
                raise ValueError("Loss is NaN")
            # the rates are read after the means' fetch, which waits for the card
            tracker.log({"epoch": epoch, **means,
                         "lr": get_learning_rates(self.state.optimizer)[0],
                         **meter.window_stats()}, step=step)

        def loop_extra() -> dict:
            """The loop state a resume cannot rederive from the train state."""
            return {"epoch": epoch, "step": step, "best_val_acc": best_val_acc,
                    "last_val_loss": last_val_loss, "scheduler": self.scheduler.state_dict()}

        def save(name: str, **extra) -> None:
            save_checkpoint(os.path.join(run_dir, name), self.state, cfg,
                            extra={**loop_extra(), **extra})

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        while not done():
            metrics, consumed = None, 0
            # the batches a complete pass over this epoch yields
            skip = resume_skip if epoch == start_epoch else 0
            expected = len(loader) - skip
            batches = loader if train_store is None else list(loader)[skip:]
            t0 = time.perf_counter()
            for batch in batches:
                if train_store is None:
                    metrics = self.train_step(batch["img"], batch["label"])
                else:
                    metrics = self.train_step_idx(train_store.arrays["img"],
                                                  train_store.arrays["label"], batch)
                train_steps += 1
                for k in win:
                    win[k].append(metrics[k])
                step += 1
                consumed += 1
                meter.tick()
                if step % cfg.logging_freq == 0:
                    log_step()
                if strict and step >= step_budget:
                    break
            sync()
            train_seconds += time.perf_counter() - t0
            epoch_complete = consumed >= expected
            if metrics is not None:
                history["train"].append({k: float(v) for k, v in metrics.items()})
            val_mean, new_best = None, False
            if epoch_complete and (epoch in validation_epochs or epoch == epoch_budget):
                val_mean = self.validate(val_loader, val_store)
                if val_mean is not None:
                    tracker.log({"epoch": epoch, "val_loss": val_mean["loss"],
                                 "val_acc": val_mean["acc"],
                                 "val_macro_acc": val_mean["macro_acc"]}, step=step)
                    history["val"].append(val_mean)
                    last_val_loss = val_mean["loss"]
                    if val_mean["acc"] > best_val_acc:
                        best_val_acc = history["best_val_acc"] = val_mean["acc"]
                        new_best = True
            # the plateau scheduler steps at the end of EVERY completed epoch
            # with the (possibly stale) last mean validation loss
            if epoch_complete and last_val_loss is not None:
                self.scheduler.step(last_val_loss)
            # saves come after the scheduler step, and only where a validation
            # ran (the reference saves from inside its validation)
            saved_this_epoch = False
            if val_mean is not None and save_checkpoints:
                if epoch == epoch_budget or epoch in cfg.get("checkpoint_save_epochs", []):
                    save(f"{cfg.method_name}_at_ep{epoch}.pt")
                    saved_this_epoch = True
                if new_best:
                    save(f"best_{cfg.method_name}.pt", val_acc=best_val_acc)
                    saved_this_epoch = True
            if epoch_complete:
                epoch += 1
            # every budget end leaves a resumable checkpoint where it stopped:
            # mid-epoch, or at the end of an epoch that saved nothing
            if save_checkpoints and done() and (not epoch_complete or not saved_this_epoch):
                save(f"{cfg.method_name}_at_step{step}.pt")
            if len(loader) == 0:
                break
        history["throughput"] = (
            {"steps_per_s": train_steps / train_seconds,
             "cubes_per_s": train_steps * cfg.batch_size / train_seconds}
            if train_steps else {}
        )
        return history
