"""K-mer spectrum analysis: peaks, thresholds, genome-size estimation.

Port of allpathslg_tpu/kmer/spectrum.py (host numpy, unchanged). The
device part is a histogram (kmer/count.py:spectrum); this host module does
the small 1-D analysis the reference's KmerSpectra does (ref:
src/kmers/naif_kmer/KmerSpectra.h; consumed by ValidateAllPathsInputs and
FindErrors threshold selection): find the error-peak/main-peak valley,
estimate coverage, genome size, and the strong/weak cutoff.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SpectrumAnalysis:
    valley: int            # frequency separating error kmers from real kmers
    peak: int              # main coverage peak frequency
    genome_size_est: int   # distinct-kmer-based genome size estimate
    coverage_est: float    # kmer coverage at the main peak
    n_distinct: int
    n_error_kmers: int     # distinct kmers below valley
    frac_repetitive: float # fraction of genomic kmer mass at >1.5x peak


def analyze(spec: np.ndarray, min_valley: int = 2) -> SpectrumAnalysis:
    """spec[f] = number of distinct kmers with multiplicity f (f>=1)."""
    spec = np.asarray(spec, dtype=np.float64)
    F = len(spec)
    n_distinct = int(spec[1:].sum())
    if n_distinct == 0:
        return SpectrumAnalysis(0, 0, 0, 0.0, 0, 0, 0.0)

    # valley: first local minimum after f=1 (error peak is at f=1 and decays)
    valley = min_valley
    for f in range(min_valley, F - 1):
        if spec[f] <= spec[f + 1]:
            valley = f
            break
    else:
        valley = min_valley

    # main peak: argmax beyond the valley
    if valley + 1 < F:
        peak = int(valley + 1 + np.argmax(spec[valley + 1 :]))
    else:
        peak = valley

    mass = spec * np.arange(F)            # total kmer observations per f
    genomic_mass = mass[valley:].sum()
    genome_size = int(round(genomic_mass / max(peak, 1)))
    rep_cut = int(1.5 * peak)
    frac_rep = float(mass[rep_cut:].sum() / genomic_mass) if genomic_mass > 0 and rep_cut < F else 0.0
    return SpectrumAnalysis(
        valley=int(valley),
        peak=peak,
        genome_size_est=genome_size,
        coverage_est=float(peak),
        n_distinct=n_distinct,
        n_error_kmers=int(spec[1:valley].sum()),
        frac_repetitive=frac_rep,
    )


def strong_threshold(spec: np.ndarray, min_thresh: int = 2) -> int:
    """Strong/weak kmer cutoff for error correction = spectrum valley
    (ref: FindErrors threshold from KmerSpectra valley)."""
    return max(analyze(spec).valley, min_thresh)
