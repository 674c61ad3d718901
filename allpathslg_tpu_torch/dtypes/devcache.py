"""Device-resident packed read-batch cache (port of
allpathslg_tpu/dtypes/devcache.py).

Each read batch is packed once on the host (2-bit codes + N mask + 4-bit
palette quals, dtypes/packed layout) and kept on an explicit torch device;
correction stages replace the resident code words and only the final
artifact save downloads them (ref: MasterVec keeping the read set
resident across FindErrors phases, src/feudal/MasterVec.h).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.dtypes import packed as pk


class DeviceBatches:
    """Fixed-size packed read batches resident on `device`.

    words[i]/nmask[i]: int64 tensors holding the uint32 code words and
    N mask. qnib[i]/qpal[i]: packed quals (or None when quals are absent).
    The last batch is padded with all-N reads to the fixed batch size.
    """

    def __init__(self, batch_size: int, L: int, n_real: int, device):
        self.batch = batch_size
        self.L = L
        self.n_real = n_real
        self.device = torch.device(device)
        self.words: List[torch.Tensor] = []
        self.nmask: List[torch.Tensor] = []
        self.qnib: List[Optional[torch.Tensor]] = []
        self.qpal: List[Optional[torch.Tensor]] = []
        self.lengths: List[torch.Tensor] = []   # int32 [batch] (or empty)
        self.n_host_downloads = 0

    @property
    def n_batches(self) -> int:
        return len(self.words)

    @classmethod
    def from_host(cls, codes: np.ndarray, quals: Optional[np.ndarray],
                  batch_size: int, lengths: Optional[np.ndarray] = None, *,
                  device) -> "DeviceBatches":
        # the span covers the host packing and the copies to the device
        with trace.span("upload") as sp:
            n, L = codes.shape
            db = cls(batch_size, L, n, device)
            dev = db.device
            # one palette test for the whole read set, as the reference does;
            # each batch still packs against its own palette
            if quals is not None:
                palette = np.unique(np.asarray(quals))
                if len(palette) > 16:
                    palette = None
            for s in range(0, n, batch_size):
                e = min(s + batch_size, n)
                cb = np.asarray(codes[s:e])
                if e - s < batch_size:
                    cb = np.concatenate(
                        [cb, np.full((batch_size - (e - s), L), 4, cb.dtype)])
                w, m, _ = pk.pack_codes(cb)
                db.words.append(pk.to_device_words(w, dev))
                db.nmask.append(pk.to_device_words(m, dev))
                if quals is None:
                    db.qnib.append(None)
                    db.qpal.append(None)
                else:
                    qb = np.asarray(quals[s:e])
                    if e - s < batch_size:
                        qb = np.concatenate(
                            [qb, np.zeros((batch_size - (e - s), L), qb.dtype)])
                    if palette is None:
                        db.qnib.append(None)
                        db.qpal.append(torch.from_numpy(np.array(qb)).to(dev))
                    else:
                        qn, qp, _ = pk.pack_quals(qb)
                        db.qnib.append(pk.to_device_words(qn, dev))
                        db.qpal.append(torch.from_numpy(qp).to(dev))
                if lengths is not None:
                    lb = np.asarray(lengths[s:e]).astype(np.int32)
                    if e - s < batch_size:
                        lb = np.concatenate(
                            [lb, np.zeros(batch_size - (e - s), np.int32)])
                    db.lengths.append(torch.from_numpy(lb).to(dev))
            sp.add("batches", db.n_batches)
            sp.add("bytes", sum(t.nbytes for part in (
                db.words, db.nmask, db.qnib, db.qpal, db.lengths)
                for t in part if t is not None))
        return db

    def update_codes(self, i: int, words, nmask) -> None:
        """Replace batch i's resident code words. This mutates the cache in
        place: every holder of this DeviceBatches sees the new codes (the
        pipeline hands one cache from stage to stage this way)."""
        self.words[i] = words
        self.nmask[i] = nmask

    def codes_to_host(self) -> np.ndarray:
        """Download + unpack all batches -> [n_real, L] uint8 codes."""
        self.n_host_downloads += 1
        with trace.span("download") as sp:
            outs = [pk.unpack_codes(w, m, self.L).cpu().numpy()
                    for w, m in zip(self.words, self.nmask)]
            sp.add("bytes", sum(o.nbytes for o in outs))
            return np.concatenate(outs)[: self.n_real]
