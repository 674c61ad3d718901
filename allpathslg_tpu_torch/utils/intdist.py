"""Empirical integer distributions (insert sizes).

Behavior contract (ref: src/math/IntDistribution.{h,cc} — SURVEY.md §2.1):
the reference models per-library insert sizes as empirical distributions and
uses them for fill validation, link gap estimation, and RemodelGaps' MLE.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class IntDistribution:
    """Empirical distribution over a contiguous integer support."""
    lo: int
    pmf: np.ndarray  # float64, sums to 1

    @staticmethod
    def from_samples(samples: np.ndarray, smooth: float = 0.5
                     ) -> "IntDistribution":
        s = np.asarray(samples).astype(np.int64)
        s = s[(s >= 0)]
        if len(s) == 0:
            return IntDistribution(0, np.ones(1))
        lo, hi = int(s.min()), int(s.max())
        counts = np.bincount(s - lo, minlength=hi - lo + 1).astype(np.float64)
        if smooth > 0:  # light box smoothing + a tiny uniform floor
            k = np.ones(3) / 3
            for _ in range(2):
                counts = np.convolve(counts, k, mode="same")
            counts += smooth * counts.sum() / (100.0 * len(counts))
        return IntDistribution(lo, counts / counts.sum())

    @property
    def hi(self) -> int:
        return self.lo + len(self.pmf) - 1

    def mean(self) -> float:
        xs = np.arange(self.lo, self.hi + 1)
        return float((xs * self.pmf).sum())

    def sd(self) -> float:
        xs = np.arange(self.lo, self.hi + 1)
        m = self.mean()
        return float(np.sqrt(((xs - m) ** 2 * self.pmf).sum()))

    def quantile(self, q: float) -> int:
        c = np.cumsum(self.pmf)
        return self.lo + int(np.searchsorted(c, q))

    def logpmf(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x).astype(np.int64) - self.lo
        p = np.full(x.shape, 1e-12)
        ok = (x >= 0) & (x < len(self.pmf))
        p[ok] = np.maximum(self.pmf[x[ok]], 1e-12)
        return np.log(p)

    def mle_gap(self, spans: np.ndarray, gap_lo: int, gap_hi: int,
                max_samples: int = 512) -> Tuple[int, float]:
        """RemodelGaps MLE: observed spanning-pair within-contig spans d_i
        imply insert = d_i + gap; choose the gap maximizing
        sum_i log pmf(d_i + g) (ref: src/paths/RemodelGaps.cc).
        Vectorized over the candidate-gap grid."""
        spans = np.asarray(spans).astype(np.int64)
        if len(spans) > max_samples:
            spans = spans[np.linspace(0, len(spans) - 1,
                                      max_samples).astype(np.int64)]
        if len(spans) == 0 or gap_hi < gap_lo:
            return int(gap_lo), float("-inf")
        gs = np.arange(gap_lo, gap_hi + 1, dtype=np.int64)
        ll = self.logpmf(spans[None, :] + gs[:, None]).sum(axis=1)
        i = int(np.argmax(ll))
        return int(gs[i]), float(ll[i])

    def mle_grid(self, spans: np.ndarray, gap_lo: int, gap_hi: int,
                 max_samples: int = 512):
        """Like mle_gap but returns (best_gap, full log-likelihood grid
        over [gap_lo, gap_hi]) so multi-library junctions can sum grids
        across libraries before taking the argmax. Returns (gap_lo, None)
        when there is nothing to score."""
        spans = np.asarray(spans).astype(np.int64)
        if len(spans) > max_samples:
            spans = spans[np.linspace(0, len(spans) - 1,
                                      max_samples).astype(np.int64)]
        if len(spans) == 0 or gap_hi < gap_lo:
            return int(gap_lo), None
        gs = np.arange(gap_lo, gap_hi + 1, dtype=np.int64)
        ll = self.logpmf(spans[None, :] + gs[:, None]).sum(axis=1)
        return int(gs[int(np.argmax(ll))]), ll

    @staticmethod
    def from_histogram(hist: np.ndarray, smooth: float = 0.5
                       ) -> "IntDistribution":
        """Build from a bincount histogram (index = value)."""
        counts = np.asarray(hist, np.float64)
        if counts.sum() <= 0:
            return IntDistribution(0, np.ones(1))
        nz = np.nonzero(counts)[0]
        lo, hi = int(nz[0]), int(nz[-1])
        counts = counts[lo : hi + 1]
        if smooth > 0:
            k = np.ones(3) / 3
            for _ in range(2):
                counts = np.convolve(counts, k, mode="same")
            counts += smooth * counts.sum() / (100.0 * len(counts))
        return IntDistribution(lo, counts / counts.sum())

    def to_arrays(self) -> dict:
        """Serializable form (the .distribs artifact, ref:
        SamplePairedReadDistributions output)."""
        return {"lo": np.asarray(self.lo, np.int64), "pmf": self.pmf}

    @staticmethod
    def from_arrays(d) -> "IntDistribution":
        return IntDistribution(int(d["lo"]), np.asarray(d["pmf"], np.float64))
