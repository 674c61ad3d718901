"""Input preparation from library sheets, the user-facing import (port of
allpathslg_tpu/pipeline/prepare.py; host code).

Behavior contract (ref: PrepareAllPathsInputs.pl + CacheLibs.pl /
CacheGroups.pl / CacheToAllPathsInputs.pl — SURVEY.md §2.6 row 1): the user
describes libraries in `in_libs.csv` (name, type, insert stats, orientation)
and read groups in `in_groups.csv` (group, library, file); the importer
converts FASTQ/SAM into the run-dir artifacts the pipeline consumes —
`frag_reads_orig` / `jump_reads_orig` / `long_jump_reads_orig` with pair
tables and per-library stats, plus the `ploidy` file.

CSV columns follow the reference's sheets:
  in_libs.csv:   library_name, project_name, organism_name, type, paired,
                 frag_size, frag_stddev, insert_size, insert_stddev,
                 read_orientation, genomic_start, genomic_end
  in_groups.csv: group_name, library_name, file_name
Only library_name / frag or insert stats / paired / read_orientation are
semantically used; unknown columns pass through.

File conventions: `x_1.fastq` + `x_2.fastq` mate files (give either, with
`?` wildcard as in the reference, or comma-separated), a single interleaved
FASTQ, or a `.sam` with paired flags. Gzip allowed everywhere.

The artifacts are the reference's byte for byte, its quirks included: the
per-pair library ids are saved as int8 `lib_ids` (the stages read
`lib_id`, so pairs of two jump libraries from sheets pool into library 0),
and the `ploidy` file is written though no stage reads it (assembly
ploidy comes from the `ploidy=` KEY=VALUE). ROADMAP.md records both.
"""

from __future__ import annotations

import csv
import dataclasses
import glob as globlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.pipeline.rundir import RunDir


@dataclasses.dataclass
class Library:
    """Per-library metadata (ref: src/PairsManager.h library records)."""
    name: str
    type: str = "fragment"        # fragment | jumping | long_jump | long
    paired: bool = True
    frag_size: Optional[int] = None
    frag_stddev: Optional[int] = None
    insert_size: Optional[int] = None
    insert_stddev: Optional[int] = None
    read_orientation: str = "inward"   # inward | outward

    @property
    def is_fragment(self) -> bool:
        return self.frag_size is not None or self.type == "fragment"

    @property
    def sep(self) -> int:
        return int(self.insert_size or self.frag_size or 0)

    @property
    def sd(self) -> int:
        return int(self.insert_stddev or self.frag_stddev or max(1, self.sep // 10))


def read_in_libs(path: str) -> Dict[str, Library]:
    libs: Dict[str, Library] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            row = {k.strip(): (v.strip() if v else "") for k, v in row.items()
                   if k}
            name = row.get("library_name", "")
            if not name:
                continue

            def _int(key):
                v = row.get(key, "")
                return int(float(v)) if v not in ("", "nan") else None

            lib = Library(
                name=name,
                type=(row.get("type") or "fragment").lower(),
                paired=(row.get("paired", "1") not in ("0", "false", "False", "")),
                frag_size=_int("frag_size"),
                frag_stddev=_int("frag_stddev"),
                insert_size=_int("insert_size"),
                insert_stddev=_int("insert_stddev"),
                read_orientation=(row.get("read_orientation") or "inward").lower(),
            )
            libs[name] = lib
    return libs


def read_in_groups(path: str) -> List[Tuple[str, str, str]]:
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            row = {k.strip(): (v.strip() if v else "") for k, v in row.items()
                   if k}
            if row.get("file_name"):
                out.append((row.get("group_name", ""),
                            row.get("library_name", ""),
                            row["file_name"]))
    return out


def _load_group_files(pattern: str):
    """Resolve a group's file(s): '?' wildcard (mate pair), comma list,
    or single path. Returns (kind, paths): kind in {'mates','single'}."""
    if "," in pattern:
        paths = [p.strip() for p in pattern.split(",")]
        return "mates", paths
    if "?" in pattern:
        paths = sorted(globlib.glob(pattern))
        if len(paths) == 2:
            return "mates", paths
        if len(paths) == 1:
            return "single", paths
        raise FileNotFoundError(
            f"group pattern {pattern} matched {len(paths)} files (need 1-2)")
    return "single", [pattern]


def _read_seq_file(path: str):
    """One sequence file → (codes, quals, lengths, pairs|None)."""
    if path.endswith((".sam", ".sam.gz")):
        from allpathslg_tpu_torch.io import sam as samio
        codes, quals, lengths, pairs, _ = samio.read_sam(path)
        return codes, quals, lengths, pairs
    if path.endswith((".bam",)):
        from allpathslg_tpu_torch.io import sam as samio
        codes, quals, lengths, pairs, _ = samio.read_bam(path)
        return codes, quals, lengths, pairs
    from allpathslg_tpu_torch.io import native_fastq
    codes, quals, lengths = native_fastq.read_fastq_arrays(path)
    return codes, quals, lengths, None


def _concat_reads(parts):
    lmax = max(p[0].shape[1] for p in parts)
    n = sum(p[0].shape[0] for p in parts)
    codes = np.full((n, lmax), 4, np.uint8)
    quals = np.zeros((n, lmax), np.uint8)
    lengths = np.zeros(n, np.int32)
    at = 0
    for c, q, l in parts:
        m, L = c.shape
        codes[at:at + m, :L] = c
        quals[at:at + m, :L] = q
        lengths[at:at + m] = l
        at += m
    return codes, quals, lengths


def prepare_inputs(rd: RunDir, in_libs: str, in_groups: str,
                   ploidy: int = 1, log=print) -> Dict[str, int]:
    """Convert library sheets into run-dir artifacts (the span
    `ingest`). Returns counts."""
    with trace.span("ingest", run=rd.path):
        return _prepare(rd, in_libs, in_groups, ploidy, log)


def _prepare(rd: RunDir, in_libs: str, in_groups: str, ploidy: int,
             log) -> Dict[str, int]:
    libs = read_in_libs(in_libs)
    groups = read_in_groups(in_groups)
    base = os.path.dirname(os.path.abspath(in_groups))

    # gather reads per class
    cls_parts: Dict[str, List] = {"frag": [], "jump": [], "long_jump": [],
                                  "long": []}
    cls_pairs: Dict[str, List[np.ndarray]] = {k: [] for k in cls_parts}
    cls_libids: Dict[str, List[np.ndarray]] = {k: [] for k in cls_parts}
    cls_libs: Dict[str, List[Library]] = {k: [] for k in cls_parts}

    def classify(lib: Library) -> str:
        if lib.type in ("long", "pacbio"):
            return "long"
        if lib.type in ("long_jump", "longjump"):
            return "long_jump"
        if lib.type == "jumping" or (lib.insert_size or 0) >= 1000:
            return "jump"
        return "frag"

    for gname, lname, pattern in groups:
        lib = libs.get(lname)
        if lib is None:
            raise KeyError(f"group {gname}: unknown library {lname}")
        if not os.path.isabs(pattern):
            pattern = os.path.join(base, pattern)
        kind, paths = _load_group_files(pattern)
        cls = classify(lib)
        if cls not in ("long",) and lib.paired:
            if kind == "mates":
                p1 = _read_seq_file(paths[0])
                p2 = _read_seq_file(paths[1])
                n1 = p1[0].shape[0]
                if n1 != p2[0].shape[0]:
                    raise ValueError(f"group {gname}: mate files differ in "
                                     f"read count ({n1} vs {p2[0].shape[0]})")
                offset = sum(p[0].shape[0] for p in cls_parts[cls])
                cls_parts[cls].append(p1[:3])
                cls_parts[cls].append(p2[:3])
                pr = np.stack([np.arange(n1), np.arange(n1) + n1], 1)
                cls_pairs[cls].append((pr + offset).astype(np.int32))
                cls_libids[cls].append(np.full(n1, _lib_index(cls_libs[cls],
                                                              lib), np.int8))
            else:
                c, q, l, pr = _read_seq_file(paths[0])
                offset = sum(p[0].shape[0] for p in cls_parts[cls])
                cls_parts[cls].append((c, q, l))
                if pr is None:  # interleaved convention
                    n = c.shape[0]
                    pr = np.stack([np.arange(0, n - 1, 2),
                                   np.arange(1, n, 2)], 1)
                cls_pairs[cls].append((pr + offset).astype(np.int32))
                cls_libids[cls].append(np.full(len(pr),
                                               _lib_index(cls_libs[cls], lib),
                                               np.int8))
        else:
            c, q, l, _ = _read_seq_file(paths[0])
            cls_parts[cls].append((c, q, l))
            _lib_index(cls_libs[cls], lib)

    counts = {}
    art_of = {"frag": "frag_reads_orig", "jump": "jump_reads_orig",
              "long_jump": "long_jump_reads_orig"}
    for cls, art in art_of.items():
        if not cls_parts[cls]:
            continue
        codes, quals, lengths = _concat_reads(cls_parts[cls])
        cls_parts[cls].clear()   # the per-file arrays are copied: free them
        pairs = (np.concatenate(cls_pairs[cls]) if cls_pairs[cls]
                 else np.zeros((0, 2), np.int32))
        lib_ids = (np.concatenate(cls_libids[cls]) if cls_libids[cls]
                   else np.zeros(0, np.int8))
        L = cls_libs[cls]
        rd.save_arrays(art, codes=codes, lengths=lengths, quals=quals,
                       pairs=pairs, lib_ids=lib_ids,
                       lib_sep=np.asarray([lb.sep for lb in L], np.int32),
                       lib_sd=np.asarray([lb.sd for lb in L], np.int32))
        counts[art] = codes.shape[0]
        log(f"[prepare] {art}: {codes.shape[0]} reads, "
            f"{pairs.shape[0]} pairs, {len(L)} libs")
    if cls_parts["long"]:
        codes, quals, lengths = _concat_reads(cls_parts["long"])
        flat = np.concatenate([codes[i, :lengths[i]]
                               for i in range(len(lengths))]) \
            if len(lengths) else np.zeros(0, np.uint8)
        offs = np.zeros(len(lengths) + 1, np.int64)
        np.cumsum(lengths, out=offs[1:])
        rd.save_arrays("long_reads_orig", bases=flat, offsets=offs)
        counts["long_reads_orig"] = len(lengths)
        log(f"[prepare] long_reads_orig: {len(lengths)} reads")

    with open(rd.file_path("ploidy"), "w") as f:
        f.write(f"{ploidy}\n")
    return counts


def _lib_index(lib_list: List[Library], lib: Library) -> int:
    for i, lb in enumerate(lib_list):
        if lb.name == lib.name:
            return i
    lib_list.append(lib)
    return len(lib_list) - 1
