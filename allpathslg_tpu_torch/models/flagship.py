"""Flagship steps: the assembler's compute core as plain functions (port of
allpathslg_tpu/models/flagship.py).

The flagship forward step is the fused kmerize -> canonicalize -> sort ->
count -> spectrum program (ref: src/kmers/naif_kmer/NaifKmerizer.cc). On a
CUDA tensor its sort is the Hopper radix sort (ops/cuda/sort_cuda.py).
"""

from __future__ import annotations

import torch

from allpathslg_tpu_torch.kmer import count as kcount


def spectrum_step(codes: torch.Tensor, K: int = 24, max_freq: int = 255):
    """Read batch -> (kmer spectrum int32 [max_freq + 1], n distinct kmers).

    codes: uint8 [N, L] with pad code 4 beyond read ends.
    """
    return kcount.spectrum_reads(codes, K, max_freq)


def spectrum_step_weighted(codes, quals, K: int = 24, max_freq: int = 255):
    """Quality-aware forward used by error correction (strong/weak support)."""
    ck = kcount.count_reads(codes, K, quals)
    return kcount.spectrum(ck, max_freq), ck.n_unique, ck.qsum
