"""Local experiment log (port of `sound_bubble_tpu/train/logging.py`, local
only): metrics go to <run_dir>/metrics.jsonl, one JSON object per commit,
with wandb's `log(data, commit, step)` call surface."""
from __future__ import annotations

import json
import os
import time


class LocalRun:
    def __init__(self, run_dir: str, project: str = "", name: str = ""):
        self.dir = run_dir or "."
        os.makedirs(self.dir, exist_ok=True)
        self._path = os.path.join(self.dir, "metrics.jsonl")
        self._pending: dict = {}
        self.project, self.name = project, name

    def log(self, data: dict, commit: bool = True, step=None):
        clean = {k: v for k, v in data.items()
                 if isinstance(v, (int, float, bool, str))}
        self._pending.update(clean)
        if step is not None:
            self._pending["_step"] = step
        if commit:
            self._pending["_time"] = time.time()
            with open(self._path, "a") as f:
                f.write(json.dumps(self._pending) + "\n")
            self._pending = {}

    def finish(self):
        if self._pending:
            self.log({}, commit=True)


def init_run(project: str, name: str, run_dir: str) -> LocalRun:
    return LocalRun(run_dir, project, name)
