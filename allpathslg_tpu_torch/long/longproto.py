"""LongProto: long-read-first local assembly, the DISCOVAR precursor (port
of allpathslg_tpu/long/longproto.py).

Behavior contract (ref: src/paths/long/LongProto.cc and the src/paths/long/
subtree): assemble a region from longer reads (250 bp pairs or similar) by
(1) correcting reads with friend stacks, (2) building an assembly graph at
large K, (3) threading the corrected reads through it as ReadPaths and (4)
simplifying the graph with that path support (low-support deletion,
pull-aparts), emitting the supported graph and contigs.

Friend finding, k-mer counting (3-word keys at K=48, by composed stable
passes of the sort), unipath condensation and read pathing run on the
device (the Hopper radix sort on the card); the support-driven cleanup
runs on the condensed graph on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from allpathslg_tpu_torch.graph import cleanup
from allpathslg_tpu_torch.graph import pathsdb as pdb
from allpathslg_tpu_torch.graph import unipath as gup
from allpathslg_tpu_torch.kmer import count as kcount
from allpathslg_tpu_torch.long import friends as fr
from allpathslg_tpu_torch.long import supported as sup


@dataclasses.dataclass(frozen=True)
class LongProtoConfig:
    K: int = 48                 # large-K graph (the reference uses K=200-ish
                                # on 250bp reads; scaled to read length)
    friend_k: int = 16
    min_shared: int = 3
    correction_rounds: int = 1
    min_kmer_count: int = 2
    min_support: int = 2
    min_thread_support: int = 2
    ploidy: int = 1


@dataclasses.dataclass
class LongProtoResult:
    contigs: cleanup.Contigs
    sg: sup.SupportedGraph
    metrics: Dict[str, int]


def long_proto(codes: np.ndarray, cfg: LongProtoConfig = LongProtoConfig(),
               device="cuda") -> LongProtoResult:
    """Assemble a read batch the LongProto way on `device`. codes: uint8
    [N, L]."""
    metrics: Dict[str, int] = {}

    # 1) friend-stack correction
    corrected = codes
    total_fixed = 0
    n_friend_records = 0
    for _ in range(cfg.correction_rounds):
        f = fr.find_friends(corrected, K=cfg.friend_k,
                            min_shared=cfg.min_shared, device=device)
        n_friend_records = int(len(f.a))
        corrected, n_fixed = fr.correct_with_friends(corrected, f)
        total_fixed += n_fixed
        if n_fixed == 0:
            break
    metrics["n_bases_corrected"] = total_fixed
    metrics["n_friend_records"] = n_friend_records

    # 2) large-K graph from corrected reads
    ck = kcount.trim_to_host(kcount.count_reads_streaming(
        corrected, cfg.K, device=device))
    ups, g, placement = gup.build_unipaths(
        ck.words, cfg.K, min_count=cfg.min_kmer_count, counts=ck.counts,
        with_graph=True, with_placement=True, device=device)
    metrics["n_unipaths"] = ups.n

    # 3) thread corrected reads through the graph (ReadPaths)
    rp = pdb.path_reads(placement, corrected)

    # 4) support-driven simplification (iterated, with path revision after
    # every edit: the reference's LongProto loop)
    sg = sup.build_supported(ups, g, rp)
    sg, m, rp = sup.simplify_supported(sg, rp, cfg.min_support,
                                       cfg.min_thread_support,
                                       ploidy=cfg.ploidy, K=cfg.K)
    metrics.update(m)

    # the pulled-apart graph changed node ids: re-derive support for merge
    contigs, cm = cleanup.simplify(sg.ups, sg.g, cfg.K, ploidy=cfg.ploidy)
    metrics.update({f"cleanup_{k}": v for k, v in cm.items()})
    return LongProtoResult(contigs=contigs, sg=sg, metrics=metrics)
