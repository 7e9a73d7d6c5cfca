"""Byte-compatible evaluation log writer.

Reproduces the reference's append-mode text log format exactly — the same
'{:.4f}' scalar lines and the same pandas ``to_string`` tables with '1H'..
row names and '> 15'/'> 35'/'> 75' columns (``evaluation_vit.py:203-206,
577-692``) — so diff-based workflows over ``logs/test_{model}.log`` keep
working against this rebuild.  The tables are laid out here without pandas
(``_table_str``), byte-identical to ``DataFrame.to_string``.
"""

from __future__ import annotations

import os
from typing import TextIO

import numpy as np

from vit_grid_model_tpu.evaluation.metrics import EvaluationMetrics

# (log prefix, metrics-engine predictor key) in the reference's print order
_SCALAR_ORDER = (
    ("persist", "persist"),
    ("model", "model"),
    ("sim 21h", "sim_21h"),
    ("sim avg", "sim_avg"),
)

# (log table title, predictor key); 'MultiAir' is the reference's legacy
# label for the model under evaluation (``evaluation_vit.py:679``)
_TABLE_ORDER = (
    ("persistance model", "persist"),
    ("MultiAir", "model"),
    ("simulation 21h", "sim_21h"),
    ("simulation avg", "sim_avg"),
)


_COLUMNS = ("> 15", "> 35", "> 75")


def _table_str(values: np.ndarray, output_dim: int,
               hour_index: bool = True) -> str:
    """The three per-threshold columns of ``values`` (3 * output_dim) laid
    out as pandas' ``DataFrame.to_string`` does under a '{:.4f}' float
    format: index left-justified, columns right-justified to the widest
    cell, one space between columns, NaN as 'NaN', and a column without a
    finite value at least 5 wide."""
    L = output_dim
    index = ([f"{i}H" for i in range(1, L + 1)] if hour_index
             else [str(i) for i in range(L)])
    index_width = max(len(s) for s in index)
    columns = []
    for c, header in enumerate(_COLUMNS):
        col = np.asarray(values[c * L:(c + 1) * L], dtype=np.float64)
        cells = ["NaN" if np.isnan(v) else f"{v:.4f}" for v in col]
        width = max(len(header), *(len(s) for s in cells))
        if not np.isfinite(col).any():
            width = max(width, 5)
        columns.append([header.rjust(width)]
                       + [s.rjust(width) for s in cells])
    rows = [" " * index_width] + [s.ljust(index_width) for s in index]
    return "\n".join(" ".join([label] + [col[r] for col in columns])
                     for r, label in enumerate(rows))


def write_log(f: TextIO, metrics: EvaluationMetrics, args_repr: str = "") -> None:
    if args_repr:
        f.write(args_repr)
        f.write("\n")
        f.flush()
    summary = metrics.summary()
    for prefix, key in _SCALAR_ORDER:
        s = summary[key]
        f.write(f"{prefix} total ACC: {s['ACC']:.4f}\n")
        f.write(f"{prefix} total POD: {s['POD']:.4f}\n")
        f.write(f"{prefix} total FAR: {s['FAR']:.4f}\n")
        f.write(f"{prefix} total F1 score: {s['F1']:.4f}\n")
        f.write(f"{prefix} MAE: {s['MAE']:.4f}\n")
        f.write(f"{prefix} RMSE: {s['RMSE']:.4f}\n")
        f.write(f"{prefix} NMB: {s['NMB']:.4f}\n")
        f.write(f"{prefix} NME: {s['NME']:.4f}\n")
        f.write(f"{prefix} R: {s['R']:.4f}\n")
    for title, key in _TABLE_ORDER:
        tables = metrics.lead_tables(key)
        # reference quirk: the sim-avg RMSE/MAE frames never get the
        # 'NH' row index assigned (``evaluation_vit.py:607-613`` covers
        # every other table) and print with a 0..L-1 integer index.
        hour_idx_rmse = key != "sim_avg"
        f.write(f"{title} CSI:\n" + _table_str(tables["CSI"],
                                               metrics.output_dim) + "\n")
        f.write(f"{title} F1:\n" + _table_str(tables["F1"],
                                              metrics.output_dim) + "\n")
        f.write(f"{title} RMSE:\n" + _table_str(
            tables["RMSE"], metrics.output_dim, hour_idx_rmse) + "\n")
        f.write(f"{title} MAE:\n" + _table_str(
            tables["MAE"], metrics.output_dim, hour_idx_rmse) + "\n")
    f.flush()


def open_log(model_name: str, log_dir: str = "logs") -> TextIO:
    """Append-mode log file, reference naming (``evaluation_vit.py:203``)."""
    os.makedirs(log_dir, exist_ok=True)
    return open(os.path.join(log_dir, f"test_{model_name}.log"), "a")
