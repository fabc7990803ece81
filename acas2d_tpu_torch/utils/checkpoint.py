"""Checkpoints with exact train-resume (counterpart of
`acas2d_tpu/utils/checkpoint.py`, without orbax).

The manager stores checkpoint dicts (`learner.state_to_dict`: plain dicts
of CPU tensors, ints and strings, so `torch.load(weights_only=True)`
reads them) and hands them back; `learner.state_from_dict` turns one into
a training state again.

Layout under `directory` (a run's `checkpoints/`):

    <step>/state.pt          the periodic saves, the newest `max_to_keep`
    best/state.pt            the state of the best eval so far
    best/best_value.json     {"value", "step"} of that eval, read back by
                             a new manager, so a resumed run keeps its best

Every file is written under a temporary name and then renamed
(`os.replace`), so a process killed mid-save leaves the previous
checkpoint whole.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"
BEST_KEY = "eval_return_mean"         # the eval metric best/ follows


def _atomic_save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Periodic checkpoints, the best eval's state, and restore.

    `update_best` follows the eval cadence and `save` the checkpoint
    cadence, as in the JAX manager.  Deliberate divergence: a non-finite
    eval value never becomes the best (the JAX manager would store a NaN
    first eval as the best and write it into `best_value.json`)."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_dir = os.path.join(self.directory, "best")
        self._best_meta = os.path.join(self._best_dir, "best_value.json")
        self._best_value = None
        if os.path.exists(self._best_meta):
            with open(self._best_meta) as f:
                self._best_value = json.load(f).get("value")

    @property
    def best_value(self) -> Optional[float]:
        return self._best_value

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), STATE_FILE)

    def steps(self):
        """The saved steps, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, STATE_FILE)):
                out.append(int(name))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Write checkpoint dict `state` as `<step>/state.pt` (replacing a
        save of the same step) and keep the newest `max_to_keep` steps."""
        os.makedirs(os.path.dirname(self._step_path(step)), exist_ok=True)
        _atomic_save(state, self._step_path(step))
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def is_better(self, metrics: dict) -> bool:
        """Whether metrics[BEST_KEY] is finite and strictly beats the
        persisted best value."""
        if BEST_KEY not in metrics:
            return False
        v = float(metrics[BEST_KEY])
        return math.isfinite(v) and (self._best_value is None
                                     or v > self._best_value)

    def update_best(self, step: int, state: Dict[str, Any],
                    metrics: dict) -> bool:
        """Overwrite best/ with checkpoint dict `state` iff `is_better`.
        Returns True on a new best."""
        if not self.is_better(metrics):
            return False
        v = float(metrics[BEST_KEY])
        os.makedirs(self._best_dir, exist_ok=True)
        _atomic_save(state, os.path.join(self._best_dir, STATE_FILE))
        tmp = self._best_meta + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"value": v, "step": int(step)}, f)
        os.replace(tmp, self._best_meta)
        self._best_value = v
        return True

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The checkpoint dict saved at `step` (default the latest), CPU
        tensors; `learner.state_from_dict` restores a run from it."""
        return torch.load(self._path(step, best=False), weights_only=True)

    def restore_raw(self, step: Optional[int] = None, best: bool = False
                    ) -> Dict[str, Any]:
        """The params and iteration of the checkpoint at `step` (default
        the latest) or of best/: what eval needs, whatever the run's
        config."""
        raw = torch.load(self._path(step, best), weights_only=True)
        return {"params": raw["params"], "iteration": raw["iteration"]}

    def _path(self, step: Optional[int], best: bool) -> str:
        if best:
            path = os.path.join(self._best_dir, STATE_FILE)
        else:
            step = step if step is not None else self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under "
                                        f"{self.directory}")
            path = self._step_path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return path
