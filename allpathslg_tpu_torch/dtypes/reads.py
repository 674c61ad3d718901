"""Read batches and pair tables (port of allpathslg_tpu/dtypes/reads.py).

  * `ReadBatch`: codes uint8 [N, Lmax] (0..3 = ACGT, 4 = N/pad) + lengths
    int32 [N] + optional quals uint8 [N, Lmax]. Positions >= length always
    hold the pad code so windowed kernels need no separate length check.
  * `PairTable`: int32 [P, 2] read indices + int8 library ids + per-library
    insert statistics (ref: src/PairsManager.h `.pairs` format).

As in the reference, batch_from_codes returns a numpy-backed batch; a
consumer moves the arrays to its device when it first needs them. The
string helpers are the two that io/fasta and io/efasta use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

PAD_CODE = 4
_CODE_OF = np.full(256, PAD_CODE, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _CODE_OF[ord(c)] = i
    _CODE_OF[ord(c.lower())] = i
_BASE_OF = np.array(list("ACGTN"), dtype="U1")


@dataclasses.dataclass(frozen=True)
class ReadBatch:
    """A fixed-shape batch of reads (numpy arrays or tensors)."""

    codes: Any            # uint8 [N, Lmax]; >= length positions hold PAD_CODE
    lengths: Any          # int32 [N]
    quals: Optional[Any] = None  # uint8 [N, Lmax], 0 where padded

    @property
    def n_reads(self) -> int:
        return self.codes.shape[0]

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]


@dataclasses.dataclass(frozen=True)
class PairTable:
    """Read pairing + library metadata (ref: src/PairsManager.h)."""

    pairs: Any     # int32 [P, 2] — indices into the read batch
    lib_ids: Any   # int8  [P]
    # per-library stats, indexed by lib id:
    lib_sep: Any   # int32 [L] — nominal insert size (outer distance)
    lib_sd: Any    # int32 [L] — its standard deviation

    @property
    def n_pairs(self) -> int:
        return self.pairs.shape[0]


# ---------------------------------------------------------------------------
# host-side constructors
# ---------------------------------------------------------------------------

def batch_from_codes(codes: np.ndarray, lengths: np.ndarray,
                     quals: Optional[np.ndarray] = None) -> ReadBatch:
    """Host-side constructor: pads in numpy."""
    codes = np.asarray(codes, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    pos = np.arange(codes.shape[1], dtype=np.int32)[None, :]
    mask = pos < lengths[:, None]
    codes = np.where(mask, codes, np.uint8(PAD_CODE))
    q = None
    if quals is not None:
        q = np.where(mask, np.asarray(quals, dtype=np.uint8), np.uint8(0))
    return ReadBatch(codes, lengths, q)


def codes_from_string(s: str) -> np.ndarray:
    return _CODE_OF[np.frombuffer(s.encode(), dtype=np.uint8)]


def string_from_codes(codes: np.ndarray) -> str:
    return "".join(_BASE_OF[np.clip(np.asarray(codes), 0, 4)])
