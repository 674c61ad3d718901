"""Diploid ambiguity records threaded through coordinate-changing stages.

Behavior contract (ref: src/paths/FlattenHKP.cc + the EFASTA emitters —
SURVEY.md §2.5 row 22): popped-bubble alternatives become {kept,alt} blocks
in the final EFASTA. The reference carries them through patching and
scaffolding; round 1 left the offsets stale after any contig-modifying
stage. An AmbTable is (contig, offset, kept_len, alt bases) rows plus
transforms for every coordinate change the pipeline performs:

  * remap       — contig ids renumbered / dropped (CleanAssembly)
  * from_pieces — contigs rebuilt by concatenating oriented source slices
                  (gap patching, long-read patching): each record maps
                  through the piece that contains it, with rc mirroring
  * shift       — small indel edits at known positions (FixSomeIndels pass)

Records that land outside every kept piece, or overlap an edit window, are
dropped (the honest fallback: the bases remain in the contig, only the
ambiguity annotation is lost for that record).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _rc(seq: np.ndarray) -> np.ndarray:
    out = (3 - seq[::-1].astype(np.int32)) % 4
    return np.where(seq[::-1] > 3, 4, out).astype(np.uint8)


@dataclasses.dataclass
class AmbTable:
    contig: np.ndarray       # int32 [R]
    offset: np.ndarray       # int64 [R] start of the kept segment
    kept_len: np.ndarray     # int32 [R]
    alt: List[np.ndarray]    # R variable-length uint8 alt segments

    @property
    def n(self) -> int:
        return len(self.contig)

    @staticmethod
    def empty() -> "AmbTable":
        return AmbTable(np.zeros(0, np.int32), np.zeros(0, np.int64),
                        np.zeros(0, np.int32), [])

    @staticmethod
    def from_contig_lists(ambiguities: Sequence[Sequence[Tuple]]) -> "AmbTable":
        """From graph/cleanup.Contigs.ambiguities."""
        c, o, k, a = [], [], [], []
        for ci, alist in enumerate(ambiguities):
            for (off, klen, alt) in alist:
                c.append(ci)
                o.append(int(off))
                k.append(int(klen))
                a.append(np.asarray(alt, np.uint8))
        return AmbTable(np.asarray(c, np.int32), np.asarray(o, np.int64),
                        np.asarray(k, np.int32), a)

    def to_arrays(self) -> Dict[str, np.ndarray]:
        aoff = np.zeros(self.n + 1, np.int64)
        np.cumsum([len(x) for x in self.alt], out=aoff[1:])
        flat = np.concatenate(self.alt) if self.alt else np.zeros(0, np.uint8)
        return {"amb_contig": self.contig, "amb_offset": self.offset,
                "amb_kept_len": self.kept_len, "amb_alt": flat,
                "amb_alt_offsets": aoff}

    @staticmethod
    def from_arrays(d) -> "AmbTable":
        if "amb_contig" not in d:
            return AmbTable.empty()
        aoff = d["amb_alt_offsets"]
        alt = [d["amb_alt"][aoff[i]:aoff[i + 1]]
               for i in range(len(aoff) - 1)]
        return AmbTable(np.asarray(d["amb_contig"], np.int32),
                        np.asarray(d["amb_offset"], np.int64),
                        np.asarray(d["amb_kept_len"], np.int32), alt)

    def per_contig(self, ci: int) -> List[Tuple[int, int, np.ndarray]]:
        out = []
        for i in np.nonzero(self.contig == ci)[0]:
            out.append((int(self.offset[i]), int(self.kept_len[i]),
                        self.alt[i]))
        return sorted(out, key=lambda t: t[0])

    # ---- transforms ----

    def remap(self, mapping: Dict[int, int]) -> "AmbTable":
        """Renumber contigs; records of unmapped contigs are dropped."""
        keep, c2 = [], []
        for i in range(self.n):
            m = mapping.get(int(self.contig[i]))
            if m is not None:
                keep.append(i)
                c2.append(m)
        keep = np.asarray(keep, np.int64)
        return AmbTable(np.asarray(c2, np.int32),
                        self.offset[keep] if len(keep) else np.zeros(0, np.int64),
                        self.kept_len[keep] if len(keep) else np.zeros(0, np.int32),
                        [self.alt[i] for i in keep])

    def from_pieces(self, pieces: Sequence[Tuple[int, int, bool, int, int, int, int]]
                    ) -> "AmbTable":
        """Rebuild for a piecewise-recomposed contig set.

        pieces rows: (src_contig, dst_contig, flip, src_lo, src_hi,
        src_len, dst_off) — the new contig dst contains
        oriented(src[src_lo:src_hi], flip) starting at dst_off, where
        src_lo/src_hi are in the ORIENTED source's coordinates and src_len
        is the source contig's length. A record survives if its whole
        [offset, offset+kept_len) lies inside one piece."""
        c2, o2, k2, a2 = [], [], [], []
        by_src: Dict[int, list] = {}
        for row in pieces:
            by_src.setdefault(int(row[0]), []).append(row)
        for i in range(self.n):
            ci = int(self.contig[i])
            off = int(self.offset[i])
            klen = int(self.kept_len[i])
            for (src, dst, flip, lo, hi, slen, doff) in by_src.get(ci, ()):
                if flip:
                    # oriented coords: record [off, off+klen) in fwd coords
                    # maps to [slen-off-klen, slen-off) in flipped coords
                    f_lo = slen - off - klen
                else:
                    f_lo = off
                f_hi = f_lo + klen
                if f_lo >= lo and f_hi <= hi:
                    c2.append(int(dst))
                    o2.append(doff + (f_lo - lo))
                    k2.append(klen)
                    a2.append(_rc(self.alt[i]) if flip else self.alt[i])
                    break
        return AmbTable(np.asarray(c2, np.int32), np.asarray(o2, np.int64),
                        np.asarray(k2, np.int32), a2)

    def shift(self, edits: Sequence[Tuple[int, int, int, int]]) -> "AmbTable":
        """Apply small in-place edits: rows (contig, pos, old_len, new_len).
        Records after pos shift by (new_len - old_len); records overlapping
        [pos, pos+old_len) are dropped."""
        by_c: Dict[int, list] = {}
        for (ci, pos, ol, nl) in edits:
            by_c.setdefault(int(ci), []).append((int(pos), int(ol), int(nl)))
        keep, off2 = [], []
        for i in range(self.n):
            ci = int(self.contig[i])
            off = int(self.offset[i])
            klen = int(self.kept_len[i])
            ok = True
            for (pos, ol, nl) in sorted(by_c.get(ci, ())):
                if off + klen <= pos:
                    continue
                if off >= pos + ol:
                    off += nl - ol
                    continue
                ok = False
                break
            if ok:
                keep.append(i)
                off2.append(off)
        keep = np.asarray(keep, np.int64)
        return AmbTable(self.contig[keep] if len(keep) else np.zeros(0, np.int32),
                        np.asarray(off2, np.int64),
                        self.kept_len[keep] if len(keep) else np.zeros(0, np.int32),
                        [self.alt[i] for i in keep])
