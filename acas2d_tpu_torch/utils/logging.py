"""Structured metrics logging: CSV + JSONL.  The file-writing part of
`acas2d_tpu/utils/logging.py` (importing the JAX package imports jax), so
the two drivers write the same files for the same rows.

Each row goes to `<out_dir>/<run_name>.csv` (append-only; the header widens
when a row brings new keys, rewriting the file under a temporary name and
renaming it, so a resumed run's earlier rows survive a crash mid-rewrite)
and `<run_name>.jsonl`, with `wall_time_s` since the logger was made.  The
drivers print their rows themselves; the JAX logger's console echo and
TensorBoard writer have no caller in the port.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional


def _to_py(v):
    try:
        return v.item()
    except AttributeError:
        return v


class MetricsLogger:
    def __init__(self, out_dir: str, run_name: str = "run"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.csv_path = os.path.join(out_dir, f"{run_name}.csv")
        self.jsonl_path = os.path.join(out_dir, f"{run_name}.jsonl")
        self._csv_file = None
        self._csv_writer = None
        self._fields = None
        self._t0 = time.time()

    def _open_csv(self, fields):
        """Open the CSV for append with a header that is the union of the
        file's existing header (a resumed run may have logged columns this
        process never will) and `fields`; rewrite the file if the header
        must widen (old rows get empty cells in the new columns)."""
        fields = list(fields)
        existing = []
        if os.path.exists(self.csv_path) and os.path.getsize(self.csv_path):
            with open(self.csv_path, newline="") as f:
                reader = csv.DictReader(f)
                existing = list(reader.fieldnames or [])
                old_rows = (list(reader)
                            if any(k not in existing for k in fields) else None)
            if old_rows is not None:
                merged = existing + [k for k in fields if k not in existing]
                # write-then-rename: a crash mid-rewrite must not lose the
                # already-logged rows of a resumed run
                tmp_path = self.csv_path + ".tmp"
                with open(tmp_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=merged,
                                       extrasaction="ignore")
                    w.writeheader()
                    w.writerows(old_rows)
                os.replace(tmp_path, self.csv_path)
                existing = merged
        self._fields = existing or fields
        self._csv_file = open(self.csv_path, "a", newline="")
        self._csv_writer = csv.DictWriter(self._csv_file,
                                          fieldnames=self._fields,
                                          extrasaction="ignore")
        if self._csv_file.tell() == 0:
            self._csv_writer.writeheader()

    def _widen_csv(self, new_fields):
        """A later log() introduced keys unseen in the header: reopen with
        the widened field set instead of silently dropping the columns."""
        self._csv_file.close()
        self._open_csv(self._fields
                       + [k for k in new_fields if k not in self._fields])

    def log(self, metrics: Dict, step: Optional[int] = None):
        """Persist one row."""
        row = {k: _to_py(v) for k, v in metrics.items()}
        row.setdefault("wall_time_s", round(time.time() - self._t0, 3))
        if step is not None:
            row.setdefault("global_step", step)
        if self._csv_writer is None:
            self._open_csv(row.keys())
        elif any(k not in self._fields for k in row):
            self._widen_csv(row.keys())
        self._csv_writer.writerow(row)
        self._csv_file.flush()
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def close(self):
        if self._csv_file:
            self._csv_file.close()


class NullLogger:
    """A logger that writes nothing: a rank of a mesh other than rank 0,
    which alone writes the run's files."""

    def log(self, metrics: Dict, step: Optional[int] = None):
        pass

    def close(self):
        pass
