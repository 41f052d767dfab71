"""SimMIM masked pretraining loop, the JAX package's ``Pretrainer``.

One training step: one crop origin per batch in [0, tile − image_size),
then the mask (drawn on the card), then the dropout seeds, all from the
trainer's generator; the SimMIM loss in train mode through the fused ops
(the CUDA kernels on the card); backward; every gradient clamped to
[-1, 1]; AdamW. The step returns the loss as a device tensor, and with
``log_grad_norm`` the global L2 norm of the raw gradients (before the
clamp) as another; ``fit`` reads them on the host only at logging
boundaries and epoch ends.

``fit`` keeps the tiles on the card (``DeviceTileStore``: each step moves
only its index vector and gathers just the crop windows there), or streams
host batches (read ahead on the loader's thread) when the set exceeds the
store's budget; it has the JAX loop's epoch and step budgets, logs through
a ``Tracker`` (``utils/tracking.py``) the JAX loop's rows: every
``logging_freq`` steps the window's mean loss (a raise when it is NaN),
the rate, the window's steps/s and items/s and, with ``log_grad_norm``,
the window's mean gradient norm; at a completed epoch's end the last
step's loss and the validation loss. It validates (sliding windows, one
mask per chunk from a seed folded with the chunk index) and steps the
scheduler on completed epochs only, and writes full-state checkpoints
(``train/checkpoint.py``) to ``models_dir/run_id/`` after them, by
``model_save_freq``, and at a ``max_steps`` break. ``resume`` restores
one; ``fit`` then continues at its step, on the loader's epoch and past
the batches already trained, so a resumed run gives the bits of an
uninterrupted one.

Data parallelism (``world``, a ``parallel.mesh.DataWorld``): every process
builds the same batches (the same loader seed) and takes its rows of each,
of the index vector on the store path and of the host batch when
streaming; it draws the same crop origin, mask seed and dropout seeds from
its generator, keeps its rows of the global mask, and folds the layers'
dropout seeds by its rank. After the backward the gradients are averaged
over the processes by one all-reduce (each process's loss is the mean over
its equal share of the rows), so the clamp, the norm and AdamW see the
global batch's gradient on every process, and so do the logged and
validation losses. Not ported yet (ROADMAP.md): the superstep (CUDA graphs
later).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from maskedsst_tpu_torch.config import Config
from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
from maskedsst_tpu_torch.data.pipeline import DataLoader, split_dataset
from maskedsst_tpu_torch.models import SimMIMSpatialSpectral, ViTSpatialSpectral
from maskedsst_tpu_torch.parallel.mesh import (
    DataWorld,
    all_reduce_grads_,
    global_streamed_batch,
    resolve_device,
    sum_across,
)
from maskedsst_tpu_torch.train.checkpoint import (
    load_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from maskedsst_tpu_torch.train.optim import (
    CosineAnnealingLR,
    build_pretrain_optimizer,
    build_scheduler,
    clamp_gradients_,
    get_learning_rates,
    global_norm,
)
from maskedsst_tpu_torch.train.train_state import TrainState
from maskedsst_tpu_torch.train.windows import window_tiles
from maskedsst_tpu_torch.utils.tracking import Throughput, Tracker

VAL_SEED = 7  # the JAX loop's validation key, PRNGKey(7)


def largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (1 when n <= 0)."""
    if n <= 0:
        return 1
    d = min(cap, n)
    while n % d:
        d -= 1
    return d


def fold_seed(seed: int, i: int) -> int:
    """A seed for item ``i`` of a stream keyed by ``seed`` (``fold_in``)."""
    return int(np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)[0] >> 1)


def build_pretrain_model(config: Config, dtype: Optional[torch.dtype] = None,
                         device: str = "cuda") -> SimMIMSpatialSpectral:
    """Encoder + SimMIM wrapper from a merged pretrain config, with weights
    made from ``config.seed``, on ``device``. ``dtype`` is the compute dtype
    of the fused ops (None = fp32; parameters stay fp32). The options
    ``blockwise_patch_embed``, ``to_pixels_per_spectral_block`` and
    ``mim_intermediate_losses`` choose the routes of
    ``models/simmim.py``; as in JAX, the encoder is a ViTSpatialSpectral,
    so ``mim_intermediate_losses`` raises JAX's assertion."""
    assert config.encoder_name == "ViTSpatialSpectral", (
        f"encoder {config.encoder_name} not available"
    )
    encoder = ViTSpatialSpectral(
        image_size=config.image_size,
        spatial_patch_size=config.patch_size,
        spectral_patch_size=config.band_patch_size,
        num_classes=config.n_classes,
        dim=config.transformer_dim,
        depth=config.transformer_depth,
        heads=config.transformer_n_heads,
        mlp_dim=config.transformer_mlp_dim,
        dropout=config.transformer_dropout,
        emb_dropout=config.transformer_emb_dropout,
        channels=config.n_bands,
        spectral_pos_embed=config.spectral_pos_embed,
        spectral_pos=list(range(config.n_bands // config.band_patch_size)),
        blockwise_patch_embed=config.blockwise_patch_embed,
        spectral_only=config.spectral_only,
        dtype=dtype,
    )
    model = SimMIMSpatialSpectral(
        encoder,
        masking_ratio=config.mim_masking_ratio,
        mask_patch_size=config.mim_mask_patch_size,
        tube_masking=config.tube_masking,
        to_pixels_per_spectral_block=config.to_pixels_per_spectral_block,
        intermediate_losses=config.mim_intermediate_losses,
        dtype=dtype,
    )
    return model.init_weights(config.get("seed", 5)).to(device)


class Pretrainer:
    """Pretrains a SimMIM model built from ``config`` on ``device``.

    ``tile_size``: the side of the dataset's tiles (64 for EnMAP; crops of
    ``image_size`` are drawn from them). Every random choice of a step comes
    from ``self.state.rng``, a CPU generator seeded by ``config.seed``.
    ``world``: this process's place in a data-parallel run (default: one
    process); ``config.batch_size`` is the global batch, which its size
    must divide."""

    def __init__(self, config: Config, dtype: Optional[torch.dtype] = None,
                 tile_size: int = 64, device: str = "cuda",
                 world: Optional[DataWorld] = None):
        self.config = config
        self.world = world or DataWorld()
        if config.batch_size % self.world.size:
            raise ValueError(f"batch_size {config.batch_size} is not divisible by the world size "
                             f"({self.world.size}): each process takes an equal share of the rows")
        self.device = resolve_device(device)
        self.tile_size = tile_size
        self.model = build_pretrain_model(config, dtype, self.device)
        optimizer = build_pretrain_optimizer(self.model, config.optimizer, config.lr,
                                             config.weight_decay)
        self.grad_clamp = 1.0 if config.get("clip_grad_norm") else None
        self.log_grad_norm = bool(config.get("log_grad_norm", False))
        rng = torch.Generator().manual_seed(int(config.get("seed", 5)))
        self.state = TrainState(self.model, optimizer, rng)
        self.scheduler = build_scheduler(config.scheduler, optimizer)
        self.num_params = sum(p.numel() for p in self.model.parameters())
        self.crop = config.image_size != tile_size and config.dataset in ("dfc", "enmap")

    # --- one step ------------------------------------------------------------
    def _crop_draw(self) -> Tuple[int, int]:
        """One crop origin per batch, uniform in [0, tile - image_size)."""
        hi = self.tile_size - self.config.image_size
        x0, y0 = torch.randint(0, hi, (2,), generator=self.state.rng).tolist()
        return x0, y0

    def _update(self, img: torch.Tensor,
                bool_mask: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Loss, backward, the gradients averaged over the processes, clamp,
        AdamW on this process's rows ``img``; the mask drawn when not given
        (a given one is the global batch's). Returns the global batch's loss
        and, with ``log_grad_norm``, the raw gradients' global norm, as
        device scalars."""
        model, world = self.model, self.world
        model.train()
        model.zero_grad(set_to_none=True)
        if bool_mask is None:
            bool_mask = model.sample_mask(img.shape[0], img.device, self.state.rng, world.shard)
        else:
            bool_mask = bool_mask[world.rows(bool_mask.shape[0])]
        loss = model(img, rng=self.state.rng, bool_mask=bool_mask, shard=world.shard)
        loss.backward()
        all_reduce_grads_(model.parameters(), world, 1.0 / world.size)
        metrics = {"loss": sum_across({"loss": loss.detach()}, world)["loss"] / world.size}
        if self.log_grad_norm:
            metrics["grad_norm"] = global_norm(
                p.grad for p in model.parameters() if p.grad is not None)
        if self.grad_clamp is not None:
            clamp_gradients_(model.parameters(), self.grad_clamp)
        self.state.apply_gradients()
        return metrics

    def train_step(self, tiles, xy: Optional[Tuple[int, int]] = None,
                   bool_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One update on a batch of tiles [B, C, T, T] (numpy or a tensor, the
        global batch: this process takes its rows); the crop is taken where
        the batch lies, before the copy to the card. ``xy`` and ``bool_mask``
        inject the crop origin and the global batch's mask."""
        s = self.config.image_size
        tiles = global_streamed_batch(self.world, torch.as_tensor(tiles))
        if self.crop:
            x0, y0 = xy if xy is not None else self._crop_draw()
            tiles = tiles[:, :, x0 : x0 + s, y0 : y0 + s]
        else:
            tiles = tiles[:, :, :s, :s]
        img = tiles.to(self.device, torch.float32)
        return self._update(img, bool_mask)

    def _gather_crop(self, store_img: torch.Tensor, idx: torch.Tensor, xy: Tuple[int, int],
                     s: int) -> torch.Tensor:
        """Gather + crop on the card: reads only the [B, C, s, s] windows of
        the indexed tiles."""
        x0, y0 = xy
        return store_img[:, :, x0 : x0 + s, y0 : y0 + s][idx]

    def train_step_idx(self, store_img: torch.Tensor, idx,
                       xy: Optional[Tuple[int, int]] = None,
                       bool_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One update on the store's tiles at ``idx`` ([B] indices of the
        global batch: this process gathers its rows)."""
        s = self.config.image_size
        idx = torch.as_tensor(idx, dtype=torch.int64)
        idx = idx[self.world.rows(idx.shape[0])].to(store_img.device)
        if self.crop:
            img = self._gather_crop(store_img, idx, xy if xy is not None else self._crop_draw(), s)
        else:
            img = store_img[idx][:, :, :s, :s]
        return self._update(img, bool_mask)

    @torch.no_grad()
    def _step_val(self, tiles: torch.Tensor, seed: int,
                  bool_masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Mean loss over every ``image_size`` window of the tiles (stride =
        window), in chunks of ``largest_divisor(windows, 512)``, each masked
        by a generator seeded with ``fold_seed(seed, chunk)`` or by
        ``bool_masks[chunk]``; deterministic forward. Each process computes
        its rows of every chunk (under its rows of the chunk's mask), and
        the losses are averaged over the processes."""
        s = self.config.image_size
        world = self.world
        (windows,) = window_tiles(tiles, s)
        n = windows.shape[0]
        chunk = largest_divisor(n, 512)
        rows = world.rows(chunk)
        self.model.eval()
        losses = []
        for i in range(n // chunk):
            w = windows[i * chunk : (i + 1) * chunk][rows]
            mask = bool_masks[i][rows] if bool_masks is not None else None
            rng = torch.Generator().manual_seed(fold_seed(seed, i))
            losses.append(self.model(w, rng=rng, bool_mask=mask, shard=world.shard))
        loss = torch.stack(losses).mean()
        return sum_across({"loss": loss}, world)["loss"] / world.size

    # --- checkpoints ----------------------------------------------------------
    def resume(self, path: str) -> int:
        """Restore the full train state (parameters, AdamW moments, step,
        generator) from a checkpoint this trainer wrote, or from the JAX
        pretrainer's ``.msgpack`` (its generator seeded from the file's JAX
        key, ``io/flax_checkpoint.py``), and the scheduler from its
        sidecar; returns the step."""
        restore_checkpoint(path, self.state)
        try:
            sched = load_metadata(path).get("extra", {}).get("scheduler")
        except FileNotFoundError:
            sched = None
        if sched and self.scheduler is not None:
            self.scheduler.load_state_dict(sched)
        return self.state.step

    def _scheduler_extra(self) -> dict:
        return {"scheduler": self.scheduler.state_dict()} if self.scheduler is not None else {}

    # --- loop ----------------------------------------------------------------
    def fit(self, dataset, epochs: Optional[int] = None, max_steps: Optional[int] = None,
            tracker: Optional[Tracker] = None, models_dir: str = "models",
            save_checkpoints: bool = True) -> dict:
        """Train from the state's step to the budgets (``max_steps`` counts
        from step 0, a resumed run's steps included), logging to ``tracker``
        (default: a ``Tracker`` of the JAX project name); checkpoints go to
        ``models_dir/<tracker.run_id>/``."""
        cfg = self.config
        tracker = tracker or Tracker("enmap-mim-spatial-spectral", cfg)
        seed = int(cfg.get("seed", 5))
        bs = cfg.batch_size
        cfg.run_id = tracker.run_id
        cfg.model_params = self.num_params
        tracker.update_config(cfg)
        run_dir = os.path.join(models_dir, str(cfg.run_id))
        val_ds, train_ds = split_dataset(dataset, cfg.train_fraction, cfg.data_fraction, seed)

        # tiles on the card when they fit the budget (and the dataset does
        # not draw fresh samples per item), else host streaming
        train_store = val_store = None
        if cfg.get("device_data", True) and not getattr(train_ds, "stochastic", False):
            try:
                train_store = DeviceTileStore(train_ds, self.device)
                if len(val_ds) >= bs:
                    val_store = DeviceTileStore(val_ds, self.device)
            except MemoryError as exc:
                print(f"[pretrain] streaming from host: {exc}")
                train_store = val_store = None
        if train_store is not None:
            loader = IndexBatcher(len(train_store), bs, shuffle=True, drop_last=True, seed=seed)
            val_loader = (IndexBatcher(len(val_store), bs, shuffle=False, drop_last=True)
                          if val_store is not None else [])
            if not cfg.get("skip_val", False) and val_store is None:
                print(f"[pretrain] WARNING: val split ({len(val_ds)} tiles) is smaller than "
                      f"batch_size ({bs}); no validation will run and ReduceLROnPlateau will "
                      "never step (the reference's drop_last=True val loader is empty in this "
                      "regime too)")
        else:
            loader = DataLoader(train_ds, bs, shuffle=True, seed=seed, drop_last=True)
            val_loader = DataLoader(val_ds, bs, shuffle=False, drop_last=True)

        epochs = epochs if epochs is not None else cfg.epoch
        steps_per_epoch = max(1, len(loader))
        start = step = self.state.step
        # a resumed run continues the loader's shuffle at its epoch and skips
        # the batches of that epoch trained before the save; the truncated
        # epoch's end hooks fire once, in the run that completes it
        start_epoch = step // steps_per_epoch
        resume_skip = step - start_epoch * steps_per_epoch
        loader.epoch = start_epoch
        if resume_skip and train_store is None:
            loader.skip_next = resume_skip
        model_save_freq = cfg.get("model_save_freq", 1)
        if start_epoch > 10 and model_save_freq == 1:
            model_save_freq = 10  # the switch at epoch 10 fired before the save
        freq = cfg.logging_freq
        window: deque = deque(maxlen=freq)  # device scalars until a logging boundary
        gn_window: deque = deque(maxlen=freq)
        history: dict = {"train_loss": [], "val_loss": []}
        train_seconds = 0.0
        meter = Throughput(bs, num_chips=self.world.size)
        meter.start()

        def log_row(epoch: int) -> None:
            loss = float(torch.stack(list(window)).float().mean())
            if np.isnan(loss):
                raise ValueError("Loss is NaN")
            # the rates are read after the loss fetch, which waits for the card
            row = {"epoch": epoch, "loss": loss,
                   "lr": get_learning_rates(self.state.optimizer)[0], **meter.window_stats()}
            if gn_window:
                row["grad_norm"] = float(torch.stack(list(gn_window)).float().mean())
            tracker.log(row, step=step)

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def save(name: str, epoch: int) -> None:
            save_checkpoint(os.path.join(run_dir, name), self.state, cfg,
                            extra={"epoch": epoch, **self._scheduler_extra()})

        for epoch in range(start_epoch, epochs):
            # the budget before any step: a run resumed at or past it trains nothing
            if max_steps is not None and step >= max_steps:
                break
            last = None
            t0 = time.perf_counter()
            if train_store is not None:
                batches = list(loader)[resume_skip if epoch == start_epoch else 0 :]
            else:
                batches = loader
            for batch in batches:
                if train_store is not None:
                    metrics = self.train_step_idx(train_store.arrays["img"], batch)
                else:
                    metrics = self.train_step(batch["img"])
                last = metrics["loss"]
                window.append(last)
                if "grad_norm" in metrics:
                    gn_window.append(metrics["grad_norm"])
                step += 1
                meter.tick()
                if step % freq == 0:
                    log_row(epoch)
                if max_steps is not None and step >= max_steps:
                    break
            sync()
            train_seconds += time.perf_counter() - t0
            # epoch-end hooks fire only for completed epochs
            epoch_complete = step >= (epoch + 1) * steps_per_epoch
            if last is not None and epoch_complete:
                history["train_loss"].append(float(last))
                tracker.log({"epoch": epoch, "loss": history["train_loss"][-1]}, step=step)
            if not cfg.get("skip_val", False) and epoch_complete:
                val_losses = []
                for vi, batch in enumerate(val_loader):
                    if val_store is not None:
                        idx = torch.as_tensor(batch, dtype=torch.int64).to(self.device)
                        tiles = val_store.arrays["img"][idx]
                    else:
                        tiles = torch.as_tensor(batch["img"]).to(self.device, torch.float32)
                    vseed = fold_seed(VAL_SEED, epoch * 10000 + vi)
                    val_losses.append(float(self._step_val(tiles, vseed)))
                if val_losses:
                    val_loss = float(np.mean(val_losses))
                    history["val_loss"].append(val_loss)
                    tracker.log({"epoch": epoch, "val_loss": val_loss}, step=step)
                    if isinstance(self.scheduler, torch.optim.lr_scheduler.ReduceLROnPlateau):
                        self.scheduler.step(val_loss)
            if isinstance(self.scheduler, CosineAnnealingLR) and epoch_complete:
                self.scheduler.step()
            # saves come after validation and the scheduler step, so that a
            # checkpoint carries the post-epoch rate and scheduler counters
            saved_this_epoch = False
            if save_checkpoints and epoch_complete and epoch % model_save_freq == 0:
                save(f"model_{cfg.encoder_name}_ep{epoch}.pt", epoch)
                saved_this_epoch = True
            if epoch == 10 and model_save_freq == 1 and epoch_complete:
                model_save_freq = 10
            if max_steps is not None and step >= max_steps:
                # a step budget always leaves a resumable checkpoint where it stopped
                if save_checkpoints and not saved_this_epoch:
                    save(f"model_{cfg.encoder_name}_at_step{step}.pt", epoch)
                break
        steps = step - start
        history["throughput"] = (
            {"steps_per_s": steps / train_seconds, "cubes_per_s": steps * bs / train_seconds}
            if steps and train_seconds > 0 else {}
        )
        return history
