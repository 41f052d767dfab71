"""A quiet ``Tracker`` for the port's tests and ``chip_smoke.py``: it prints
and writes nothing, keeps its ``(step, row)`` pairs and takes the run id
that names the directory ``fit`` writes checkpoints to. Imports torch and
the port only, so that ``chip_smoke.py`` can use it on the card."""

from maskedsst_tpu_torch.utils.tracking import Tracker


class QuietTracker(Tracker):
    def __init__(self, run_id=None):
        super().__init__("test", use_wandb=False, quiet=True)
        self.run_id = run_id or self.run_id
        self.rows = []

    def log(self, metrics, step):
        self.rows.append((step, dict(metrics)))
