"""Episode-telemetry CSV with the reference drivers' exact schema
(counterpart of `acas2d_tpu/utils/episode_csv.py`), without pandas.

Reproduces the DataFrame layouts of testing_main.py:113-138 (full
telemetry) and baseline_main.py:66-74 (compact), so notebooks and tools
written against the reference's CSVs read this port's output unchanged.
The JAX package builds a pandas DataFrame and writes it with
`to_csv(index=False)`; `write_csv` gives the same bytes through the `csv`
module: the header, an `Episode` column from 1, float columns as numpy
formats float64 (`astype(str)`, NaN empty), integers and everything else
(lists of tuples included) through `str()`, minimal quoting, `\\n` line
ends.
"""

from __future__ import annotations

import csv
import io
import numbers
from typing import Dict, List, Sequence

import numpy as np

from acas2d_tpu_torch.config import OUTCOME_NAMES


def episode_records(init: Dict, tel, n_steps: int, num_traffic: int) -> Dict:
    """Convert one env's (init seed values, stacked Telemetry, #steps taken)
    into the reference's per-episode record lists.

    `init` is initial_telemetry()'s dict of t=0 values; `tel` a Telemetry
    of one env's numpy arrays with leading time axis; `n_steps` the number
    of actions taken (done step inclusive).
    """
    k = n_steps
    f = float
    path = [(f(init["px"]), f(init["py"]))]
    path += [(f(x), f(y)) for x, y in zip(tel.px[:k], tel.py[:k])]
    traffic_paths = []
    for n in range(num_traffic):
        tp = [(f(init["tx"][n]), f(init["ty"][n]))]
        tp += [(f(x), f(y)) for x, y in zip(tel.tx[:k, n], tel.ty[:k, n])]
        traffic_paths.append(tp)

    def rec(name):
        return [f(init[name])] + [f(v) for v in getattr(tel, name)[:k]]

    return {
        "Outcome": OUTCOME_NAMES[int(tel.outcome[k - 1])],
        "Total Reward": f(np.sum(tel.reward[:k])),
        "Time Steps": k + 1,          # steps counter includes the reset observe
        "Path Length": f(np.sum(tel.d_path_inc[:k])),
        "Path": path,
        "Traffic Paths": traffic_paths,
        "psi": rec("psi"),
        "d_sep": rec("d_sep"),
        "a_lat": rec("a_lat"),
        "d_goal": rec("d_goal"),
        "delta_heading": rec("delta_h_goal"),
        "v_closing": rec("v_closing"),
        "d_cpa": rec("d_cpa"),
        "d_dev": rec("d_dev"),
        "r_d_goal": rec("r_d_goal"),
        "r_h_goal": rec("r_h_goal"),
        "r_d_cpa": rec("r_d_cpa"),
        "r_d_dev": rec("r_d_dev"),
        "r_step": rec("r_step"),
    }


FULL_COLUMNS = ["Episode", "Outcome", "Total Reward", "Time Steps",
                "Path Length", "Path", "Traffic Paths", "psi", "d_sep",
                "a_lat", "d_goal", "delta_heading", "v_closing", "d_cpa",
                "d_dev", "r_d_goal", "r_h_goal", "r_d_cpa", "r_d_dev",
                "r_step"]

BASELINE_COLUMNS = ["Episode", "Outcome", "Total Reward", "Time Steps",
                    "Path", "Traffic Paths"]


def _is_int(v) -> bool:
    return isinstance(v, numbers.Integral) and not isinstance(v, bool)


def _column_text(values: List) -> List[str]:
    """One column's cells as a DataFrame column of these values writes
    them: a column of numbers with a float among them is float64, written
    as numpy formats it (NaN as an empty cell); a column of integers is
    int64; any other column holds objects, written through str()."""
    if values and all(_is_int(v) or isinstance(v, numbers.Real)
                      and not isinstance(v, bool) for v in values):
        if all(_is_int(v) for v in values):
            return [str(int(v)) for v in values]
        arr = np.asarray(values, dtype=np.float64)
        text = arr.astype(str)
        text[np.isnan(arr)] = ""
        return text.tolist()
    return [str(v) for v in values]


def to_csv_text(episodes: List[Dict], columns: Sequence[str] = None) -> str:
    """The CSV of `episodes` (one record dict each) in `columns` (default
    FULL_COLUMNS), as pandas' `to_csv(index=False)` writes the JAX
    package's DataFrame."""
    columns = list(columns or FULL_COLUMNS)
    cells = []
    for col in columns:
        if col == "Episode":
            cells.append([str(i) for i in range(1, len(episodes) + 1)])
        else:
            cells.append(_column_text([e[col] for e in episodes]))
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n",
                        quoting=csv.QUOTE_MINIMAL)
    writer.writerow(columns)
    writer.writerows(zip(*cells))
    return buf.getvalue()


def write_csv(path: str, episodes: List[Dict],
              columns: Sequence[str] = None) -> None:
    """Write `to_csv_text(episodes, columns)` to `path`."""
    with open(path, "w", newline="") as f:
        f.write(to_csv_text(episodes, columns))
