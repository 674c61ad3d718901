"""The least time a kernel's launches could take: the larger of the bytes
they need over the card's memory rate and their integer operations over
its int32 rate (peaks.json). Frozen copies of the formulas PERF.md's
kernel table uses:

- the radix sort: each key read once, each key and its int32 index
  written once: 20 B a key for int64 words (PERF.md "20 B a key");
- the banded DPs: chip_smoke.dp_terms, the bytes the batch's data needs
  (each problem's q_len query bytes and the target columns its band
  reaches, read once; q_len, t_len and offset in, cost and t_end out) and
  the rows its q_len asks for times the operations a row: 12 for the
  bit-parallel kernel (chip_smoke.BP_OPS_PER_ROW), 5 a band slot for the
  general one (GENERAL_OPS_PER_SLOT), whose bound leaves out the chain
  term chip_smoke.general_bound measures on the card.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

BP_OPS_PER_ROW = 12
GENERAL_OPS_PER_SLOT = 5


def peaks(kind: str):
    """{hbm_bytes_per_s, int32_ops_per_s} of a card by its torch name, or
    None for a card the table does not hold."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    return table.get(kind)


def sort_bytes(n: int, key_bytes: int = 8) -> int:
    return n * (2 * key_bytes + 4)


def dp_terms(q_len: np.ndarray, offset: np.ndarray, Lq: int, Lt: int,
             band: int, ops_per_row: int) -> tuple:
    """(bytes, int32 operations) of one banded-DP call of B problems."""
    ql = np.asarray(q_len, np.int64)
    off = np.asarray(offset, np.int64)
    rows = np.where((ql >= 1) & (ql <= Lq), ql, 0)
    lo = np.clip(off - band, 0, Lt)
    hi = np.clip(rows + off + band, 0, Lt)
    cols = np.where(rows > 0, np.maximum(hi - lo, 0), 0)
    n_bytes = int(rows.sum()) + int(cols.sum()) + 5 * 4 * len(ql)
    return n_bytes, int(rows.sum()) * ops_per_row


def bound_s(n_bytes: int, n_ops: int, peak: dict) -> float:
    return max(n_bytes / peak["hbm_bytes_per_s"],
               n_ops / peak["int32_ops_per_s"])
