"""Unipath copy-number calls from kmer coverage.

Behavior contract (ref: src/paths/UnipathCoverageCore.cc, exe
UnipathCoverage → reads.unipaths.predicted_count.k96 — SURVEY.md §2.4):
probabilistic copy number per unipath from its read/kmer arrival rate.
Here: a length-weighted robust estimate of the single-copy coverage peak,
then a Poisson-style rounded ratio per unipath; CN=1 long unipaths are the
seeds/anchors for localization.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from allpathslg_tpu_torch.graph.unipath import Unipaths


def single_copy_peak(ups: Unipaths, min_len: int = 0) -> float:
    """Length-weighted median of per-unipath mean coverage ≈ CN=1 rate."""
    assert ups.mean_cov is not None, "build_unipaths needs counts for CN"
    lens = ups.lengths()
    keep = lens >= min_len
    if not keep.any():
        keep = np.ones_like(keep)
    cov = ups.mean_cov[keep]
    w = lens[keep].astype(np.float64)
    order = np.argsort(cov)
    cw = np.cumsum(w[order])
    med = cov[order[np.searchsorted(cw, cw[-1] / 2)]]
    return float(max(med, 1e-6))


def copy_numbers(ups: Unipaths, min_len_for_peak: int = 200
                 ) -> Tuple[np.ndarray, float]:
    """(cn int32 [n], peak): cn = round(mean_cov / peak), floored at 1 for
    anything with real coverage."""
    peak = single_copy_peak(ups, min_len_for_peak)
    ratio = ups.mean_cov / peak
    cn = np.maximum(np.rint(ratio), (ups.mean_cov > 0).astype(int))
    return cn.astype(np.int32), peak


def select_seeds(ups: Unipaths, cn: np.ndarray, min_len: int = 400,
                 spacing: int = 5000) -> np.ndarray:
    """Seed unipaths: long, CN=1, roughly evenly spread (ref:
    LocalizeReadsLG seed selection — long CN=1 unipaths, min spacing)."""
    lens = ups.lengths()
    cand = np.nonzero((cn == 1) & (lens >= min_len))[0]
    # greedy spacing by cumulative length budget
    cand = cand[np.argsort(-lens[cand])]
    seeds = []
    budget = 0
    total = int(lens[cand].sum()) if len(cand) else 0
    want = max(1, total // max(spacing, 1))
    for c in cand:
        seeds.append(int(c))
        if len(seeds) >= want:
            break
    return np.asarray(sorted(seeds), dtype=np.int64)
