"""Assembly cleaning: drop degenerate contigs/scaffolds, dedupe.

Behavior contract (ref: src/paths/CleanAssembly.cc behavior — SURVEY.md
§2.5 row 20): remove tiny free-standing contigs, scaffolds below a size
floor, and contigs wholly contained in others (duplicates from unmerged
haplotype/repeat copies).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from allpathslg_tpu_torch.scaffold.superb import Superb


@dataclasses.dataclass(frozen=True)
class CleanConfig:
    min_contig_len: int = 192       # drop singleton contigs below (2*K default)
    min_scaffold_len: int = 400
    dedupe_contained: bool = True


def clean_assembly(contigs: List[np.ndarray], scaffolds: List[Superb],
                   cfg: CleanConfig = CleanConfig()
                   ) -> Tuple[List[np.ndarray], List[Superb], dict]:
    lens = np.array([len(c) for c in contigs], np.int64)

    # contained-duplicate detection among singleton scaffolds
    drop = set()
    if cfg.dedupe_contained:
        strings = {}
        singleton = {sb.contig_ids[0] for sb in scaffolds if sb.n_contigs == 1}
        big_ids = [i for i in range(len(contigs)) if i not in singleton
                   or lens[i] >= cfg.min_contig_len * 4]
        hay = ["".join(map(str, contigs[i])) for i in range(len(contigs))]
        for i in sorted(singleton, key=lambda x: lens[x]):
            s = hay[i]
            rc = "".join(map(str, (3 - contigs[i])[::-1]))
            for jj in range(len(contigs)):
                if jj == i or lens[jj] < lens[i]:
                    continue
                if s in hay[jj] or rc in hay[jj]:
                    drop.add(i)
                    break

    out_scaffolds = []
    used = []
    for sb in scaffolds:
        if sb.n_contigs == 1:
            c = sb.contig_ids[0]
            if c in drop or lens[c] < cfg.min_contig_len:
                continue
        total = sb.length(lens)
        if total < cfg.min_scaffold_len and sb.n_contigs == 1:
            continue
        out_scaffolds.append(sb)
        used.extend(sb.contig_ids)

    used = sorted(set(used))
    remap = {c: i for i, c in enumerate(used)}
    new_contigs = [contigs[c] for c in used]
    for sb in out_scaffolds:
        sb.contig_ids = [remap[c] for c in sb.contig_ids]
    metrics = {
        "n_contigs_in": len(contigs),
        "n_contigs_out": len(new_contigs),
        "n_contained_dropped": len(drop),
        "n_scaffolds_out": len(out_scaffolds),
    }
    return new_contigs, out_scaffolds, metrics, remap
