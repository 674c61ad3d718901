"""Assembly statistics: N50 and friends (ref: src/math/Functions.h N50,
src/paths/reporting/ BasicAssemblyStats)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def nx(lengths: Sequence[int], x: float = 50.0) -> int:
    ls = np.sort(np.asarray([l for l in lengths if l > 0]))[::-1]
    if ls.size == 0:
        return 0
    target = ls.sum() * (x / 100.0)
    csum = np.cumsum(ls)
    return int(ls[np.searchsorted(csum, target)])


def n50(lengths: Sequence[int]) -> int:
    return nx(lengths, 50.0)


def assembly_stats(contig_lengths: Sequence[int], min_len: int = 0) -> Dict[str, float]:
    ls = np.asarray([l for l in contig_lengths if l >= min_len])
    if ls.size == 0:
        return {"n_contigs": 0, "total_bases": 0, "n50": 0, "n90": 0,
                "max_len": 0, "mean_len": 0.0}
    return {
        "n_contigs": int(ls.size),
        "total_bases": int(ls.sum()),
        "n50": n50(ls),
        "n90": nx(ls, 90.0),
        "max_len": int(ls.max()),
        "mean_len": float(ls.mean()),
    }
