"""Reference state -> port state.

Turns the reference's (allpathslg_tpu) state, given as numpy arrays, into
the port's tensors on a device, so the output of one package's stage can
feed the other's next stage and the first stage that diverges can be
found. Word arrays are uint32 in the reference and int64 holding the same
values here (kmer/bits.py); every other array keeps its dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from allpathslg_tpu_torch.dtypes.devcache import DeviceBatches
from allpathslg_tpu_torch.kmer.count import CountedKmers
from allpathslg_tpu_torch.ops.join import HashedTable


def words(arrays: Sequence[np.ndarray], device) -> list:
    """uint32 word arrays (a list, or the rows of a [W, M] array) -> int64
    tensors."""
    return [torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)
            for a in arrays]


def array(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    """A non-word array, dtype kept (None stays None)."""
    if a is None:
        return None
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def counted_kmers(word_arrays, counts, qsum, n_unique, device) -> CountedKmers:
    """A reference CountedKmers' fields -> the port's CountedKmers."""
    return CountedKmers(words=words(word_arrays, device),
                        counts=array(np.asarray(counts, np.int32), device),
                        qsum=None if qsum is None else
                        array(np.asarray(qsum, np.int32), device),
                        n_unique=torch.tensor(int(n_unique),
                                              dtype=torch.int32,
                                              device=device))


def hashed_table(hash_fp, word_arrays, payloads, bucket_starts, shift: int,
                 H: int, device) -> HashedTable:
    """A reference join.HashedTable's fields -> the port's HashedTable.
    Payloads keep their dtype; hash_fp holds uint32 words."""
    return HashedTable(
        hash_fp=torch.stack(words(np.asarray(hash_fp), device)),
        words=tuple(words(word_arrays, device)),
        payloads=tuple(array(np.asarray(p), device) for p in payloads),
        bucket_starts=array(np.asarray(bucket_starts, np.int32), device),
        shift=int(shift), H=int(H))


def strong_table(table: np.ndarray, device) -> list:
    """strong_table.npy ([W, M] uint32) -> the port's word list."""
    return words(np.asarray(table), device)


def device_batches(batch: int, L: int, n_real: int, word_arrays, nmask,
                   qnib, qpal, lengths=(), *, device) -> DeviceBatches:
    """A reference DeviceBatches' per-batch arrays -> the port's cache.
    qnib[i] may be None (raw quals in qpal[i]); qpal[i] None means no
    quals."""
    db = DeviceBatches(batch, L, n_real, device)
    db.words = words(word_arrays, device)
    db.nmask = words(nmask, device)
    db.qnib = [None if q is None else words([q], device)[0] for q in qnib]
    db.qpal = [array(None if p is None else np.asarray(p), device)
               for p in qpal]
    db.lengths = [array(np.asarray(x, np.int32), device) for x in lengths]
    return db
