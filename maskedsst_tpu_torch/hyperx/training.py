"""Train / validate / full-scene inference for the HyperX benchmark, the JAX
package's ``hyperx/training.py`` (reference DeepHyperX/models.py:998-1230).

One training step covers both supervision modes:

* full: the weighted cross-entropy on (center-pixel) labels, padded rows
  (label -100) ignored;
* semi: that cross-entropy + ``aux_loss_weight`` × the MSE of the
  reconstruction against the center spectrum (liu) or the input spectrum
  (boulch), averaged over the real rows only (criterion lambdas,
  models.py:153-169).

The DataLoader pads a trailing batch to the batch size with zero cubes
under label -100, and BatchNorm's batch statistics see those rows that
step, as in the JAX trainer. The optimizer is the recipe's
(``train/optim.py::build_optimizer``), the scheduler MultiStepLR where the
recipe names it (sharma), else the plateau scheduler (factor 0.1, patience
epoch // 4) stepped by the epoch's metric. ``test()`` is the reference's
sliding-window full-scene inference (models.py:1157-1207): logits summed
per pixel (center-pixel or dense), argmax by the caller.

It runs where the model's parameters are: the card by default
(``device``), the CPU when asked. The net comes from
``models/zoo.py::get_model`` with its weights made from the recipe's seed
(0 by default, the JAX trainer's fixed init key); dropout masks come from
``self.rng``, a CPU generator seeded by ``hyperparams["seed"]``.
Checkpoints are ``.pt`` files of the model's ``state_dict`` (parameters
and BatchNorm statistics) through ``train/checkpoint.py``, or the JAX
trainer's ``.msgpack`` of ``params`` and ``batch_stats``; they restore
the weights, not the run (no optimizer state), so the trainer keeps cuDNN's
default algorithms, whose sums may differ in their last bits from run to
run (the Finetuner, whose resume is exact, selects the deterministic ones).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from maskedsst_tpu_torch.data.pipeline import DataLoader
from maskedsst_tpu_torch.hyperx.utils import grouper, sliding_window
from maskedsst_tpu_torch.train.checkpoint import is_flax, restore_params, save_checkpoint
from maskedsst_tpu_torch.train.losses import cross_entropy
from maskedsst_tpu_torch.train.optim import MultiStepLR, build_optimizer, plateau_scheduler
from maskedsst_tpu_torch.utils.tracking import Tracker

PAD_LABEL = -100


class HyperXTrainer:
    def __init__(self, model: torch.nn.Module, opt_spec: Dict, criterion_spec: Dict,
                 hyperparams: Dict, device: str = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.hp = hyperparams
        self.center_pixel = hyperparams["center_pixel"]
        self.patch_size = hyperparams["patch_size"]
        self.supervision = hyperparams.get("supervision", "full")
        self.weights = torch.as_tensor(np.asarray(criterion_spec["weight"]),
                                       dtype=torch.float32, device=self.device)
        self.aux_loss_weight = getattr(model, "aux_loss_weight", 1.0)
        spec = dict(opt_spec)
        self.optimizer = build_optimizer(
            model, spec.pop("learning_rate"), spec.pop("weight_decay", 0.0),
            name=spec.pop("name"), momentum=spec.pop("momentum", 0.0))
        self.rng = torch.Generator().manual_seed(int(hyperparams.get("seed", 0)))
        sched = hyperparams.get("scheduler")
        if isinstance(sched, dict) and sched.get("type") == "MultiStepLR":
            self.scheduler = MultiStepLR(self.optimizer, sched["milestones"],
                                         sched.get("gamma", 0.1))
        else:
            self.scheduler = plateau_scheduler(
                self.optimizer, factor=0.1, patience=max(hyperparams.get("epoch", 100) // 4, 1))

    # --- one step -------------------------------------------------------------
    def _to_device(self, img, label=None):
        """A batch (numpy or tensors, anywhere) on the trainer's device, the
        cubes in the model's dtype."""
        dtype = next(self.model.parameters()).dtype
        img = torch.as_tensor(img).to(self.device, dtype)
        if label is None:
            return img
        return img, torch.as_tensor(label).to(self.device, torch.int64)

    def loss(self, out, img: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """The recipe's loss of the model's output ``out`` on a batch."""
        if self.supervision == "semi":
            logits, rec = out
            if self.patch_size > 1:
                c = self.patch_size // 2
                target = img[:, 0, :, c, c]  # center-pixel spectrum (models.py:153-157)
            else:
                target = img.reshape(img.shape[0], -1)
            valid = (label != PAD_LABEL).to(rec.dtype)
            per_row = ((rec - target) ** 2).mean(dim=-1)
            aux = (per_row * valid).sum() / valid.sum().clamp_min(1.0)
        else:
            logits = out[0] if isinstance(out, tuple) else out
            aux = 0.0
        ce = cross_entropy(logits, label, ignore_index=PAD_LABEL, weight=self.weights)
        return ce + self.aux_loss_weight * aux

    def train_step(self, img, label) -> torch.Tensor:
        """One update on a batch (numpy or tensors); the loss as a device
        scalar."""
        img, label = self._to_device(img, label)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(self.model(img, rng=self.rng), img, label)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.inference_mode()
    def predict(self, img) -> torch.Tensor:
        """Eval-mode logits of a batch, on the trainer's device."""
        self.model.eval()
        out = self.model(self._to_device(img))
        return out[0] if isinstance(out, tuple) else out

    # --- checkpoints ----------------------------------------------------------
    def save(self, path: str) -> None:
        """The model's ``state_dict`` (parameters and BatchNorm running
        statistics) as a ``.pt`` with its sidecar, or, for a ``.msgpack``
        path, as the JAX trainer saves it (``{"params", "batch_stats"}``);
        :meth:`restore` loads either."""
        save_checkpoint(path, self.model if is_flax(path) else
                        {k: v.detach().cpu() for k, v in self.model.state_dict().items()})

    def restore(self, path: str) -> None:
        """Load a ``.pt`` written by :meth:`save` (or a full-state checkpoint's
        model) into the model; or the JAX trainer's ``.msgpack`` of params
        and ``batch_stats``, or of bare params, which keep the model's own
        BatchNorm statistics (``maskedsst_tpu/hyperx/training.py:153-170``)."""
        state = restore_params(path, self.device, self.model)
        if is_flax(path):
            state = {**self.model.state_dict(), **state}
        self.model.load_state_dict(state)

    # --- loops ----------------------------------------------------------------
    def train(self, dataset, epochs: Optional[int] = None, val_dataset=None,
              tracker: Optional[Tracker] = None, display_iter: int = 100,
              max_steps: Optional[int] = None, save_dir: Optional[str] = None) -> Dict:
        """Epochs over ``dataset``; after each, validation accuracy (or the
        mean loss without a validation set) is the metric the scheduler steps
        on and a new best saves ``save_dir/best.pt``."""
        hp = self.hp
        epochs = epochs if epochs is not None else hp.get("epoch", 100)
        tracker = tracker or Tracker("hyperx", quiet=False)
        bs = hp.get("batch_size", 100)
        loader = DataLoader(dataset, bs, shuffle=True, seed=hp.get("seed", 0),
                            pad_to_multiple=bs, pad_label_value=PAD_LABEL)
        step = 0
        history: Dict[str, list] = {"loss": [], "val_acc": []}
        best_metric = float("inf")
        for epoch in range(1, epochs + 1):
            total, n_batches = None, 0
            for batch in loader:
                loss = self.train_step(batch["img"], batch["label"])
                total = loss if total is None else total + loss
                step += 1
                n_batches += 1
                if display_iter and step % display_iter == 0:
                    tracker.log({"epoch": epoch, "loss": float(loss)}, step=step)
                if max_steps is not None and step >= max_steps:
                    break
            avg_loss = float(total) / n_batches if n_batches else 0.0
            history["loss"].append(avg_loss)
            if val_dataset is not None:
                acc = self.val(val_dataset)
                history["val_acc"].append(acc)
                tracker.log({"epoch": epoch, "val_acc": acc}, step=step)
                metric = -acc
            else:
                metric = avg_loss
            # the reference saves every save_epoch epochs (models.py:1126-1135);
            # the best-metric state is what --restore and inference consume
            if save_dir is not None and metric < best_metric:
                best_metric = metric
                self.save(os.path.join(save_dir, "best.pt"))
            self.scheduler.step(metric)
            if max_steps is not None and step >= max_steps:
                break
        return history

    def val(self, dataset) -> float:
        """Accuracy over a patch dataset, ignoring ignored-label targets (the
        reference's val() skips *predictions* equal to an ignored label,
        models.py:1224-1227: a metric quirk not replicated)."""
        bs = self.hp.get("batch_size", 100)
        loader = DataLoader(dataset, bs, shuffle=False, pad_to_multiple=bs,
                            pad_label_value=PAD_LABEL)
        correct, total = 0, 0
        ignored = set(self.hp.get("ignored_labels", []))
        for batch in loader:
            pred = self.predict(batch["img"]).argmax(dim=1).cpu().numpy()
            label = np.asarray(batch["label"])
            keep = label != PAD_LABEL
            for lab in ignored:
                keep &= label != lab
            correct += int((pred[keep] == label[keep]).sum())
            total += int(keep.sum())
        return correct / total if total else 0.0

    def test(self, img: np.ndarray, batch_size: Optional[int] = None) -> np.ndarray:
        """Class scores [H, W, n_classes]: the logits of a patch window slid
        over the scene ``img`` [H, W, B] at ``test_stride``, summed at each
        window's center pixel (or over its patch, for a dense net)."""
        hp = self.hp
        p = self.patch_size
        batch_size = batch_size or hp.get("batch_size", 100)
        probs = np.zeros(img.shape[:2] + (hp["n_classes"],))
        windows = sliding_window(img, step=hp.get("test_stride", 1), window_size=(p, p))
        for batch in grouper(batch_size, windows):
            if p == 1:
                data = np.array([b[0][0, 0] for b in batch], dtype=np.float32)
            else:
                data = np.array([b[0] for b in batch], dtype=np.float32)
                data = data.transpose(0, 3, 1, 2)[:, None]  # [B, 1, C, p, p]
            out = self.predict(data).float().cpu().numpy()
            if p != 1 and not self.center_pixel:
                out = out.transpose(0, 2, 3, 1)  # [B, p, p, n_classes]
            for (_, x, y, w, h), o in zip(batch, out):
                if self.center_pixel:
                    probs[x + w // 2, y + h // 2] += o
                else:
                    probs[x : x + w, y : y + h] += o
        return probs
