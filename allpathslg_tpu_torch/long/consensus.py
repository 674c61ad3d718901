"""Consensus scoring + iterative refinement over a read stack (port of
allpathslg_tpu/long/consensus.py).

Behavior contract (ref: src/paths/long/ConsensusScoreModel.{h,cc} and the
MultipleAligner consensus machinery under src/paths/long/ — SURVEY.md §2.5
long-read extensions): a candidate consensus is scored by the total
alignment cost of the stacked reads against it; consensus construction
proposes local variants (substitutions, 1–2 bp indels) at disagreeing
columns and keeps whichever candidate minimizes the stack score.

Scoring is ONE batched banded-DP call per refinement round: all (read,
variant-window) problems padded into a single [B, L] batch through
ops/banded.banded_align_auto on `device` (band 6: the Hopper bit-parallel
kernel on a CUDA tensor, the plain DP on a CPU one). The batch is padded to
a multiple of 256 rows with q_len = t_len = 0, as the reference pads it.
Column votes are a vectorized pileup at the reads' modal offsets; only
variant windows pay DP.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from allpathslg_tpu_torch.ops import banded


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    window: int = 12            # half-window around a suspect column
    band: int = 6
    max_suspects: int = 64      # per round
    max_reads_per_suspect: int = 12
    margin: int = 1             # best variant must beat current by this
    rounds: int = 3
    min_disagree: int = 2       # reads contradicting the consensus column


def stack_votes(consensus: np.ndarray, reads: Sequence[np.ndarray],
                offsets: Sequence[int]) -> np.ndarray:
    """Per-column base votes [L, 4] of reads laid at fixed offsets."""
    L = len(consensus)
    votes = np.zeros((L, 4), np.int32)
    for seq, off in zip(reads, offsets):
        lo = max(0, off)
        hi = min(L, off + len(seq))
        if hi <= lo:
            continue
        frag = np.asarray(seq[lo - off : hi - off])
        m = frag < 4
        np.add.at(votes, (np.arange(lo, hi)[m], frag[m]), 1)
    return votes


def score_stack(consensus: np.ndarray, reads: Sequence[np.ndarray],
                offsets: Sequence[int], band: int = 8,
                device="cuda") -> int:
    """ConsensusScoreModel analog: total banded-DP cost of every read vs
    the candidate (one batched call)."""
    B = len(reads)
    if B == 0:
        return 0
    Lq = max(len(r) for r in reads)
    q = np.full((B, Lq), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        q[i, : len(r)] = r
        ql[i] = len(r)
    t = np.asarray(consensus, np.uint8)[None, :].repeat(B, axis=0)
    tl = np.full(B, len(consensus), np.int32)
    off = np.asarray(offsets, np.int32)
    cost, _ = banded.banded_align_host(q, ql, t, tl, off, band, device)
    return int(cost.sum())


def _variants(t0: np.ndarray, xs: np.ndarray
              ) -> List[Tuple[str, int, np.ndarray]]:
    """Candidate window variants: per position x — substitutions, del1,
    del2, ins1 of every base (ref: FixSomeIndels' candidate enumeration)."""
    out = []
    for x in xs:
        x = int(x)
        cur = int(t0[x])
        for b in range(4):
            if b != cur:
                v = t0.copy()
                v[x] = b
                out.append((f"sub{b}", x, v))
        out.append(("del1", x, np.delete(t0, x)))
        if x + 1 < len(t0):
            out.append(("del2", x, np.delete(t0, [x, x + 1])))
        for b in range(4):
            out.append((f"ins{b}", x,
                        np.insert(t0, x, np.uint8(b))))
    return out


def refine_consensus(seed: np.ndarray, reads: Sequence[np.ndarray],
                     offsets: Sequence[int],
                     cfg: ConsensusConfig = ConsensusConfig(),
                     device="cuda") -> Tuple[np.ndarray, int]:
    """Iteratively improve a consensus against its read stack.

    Each round: vote pileup at the stack offsets → disagreeing columns →
    enumerate window variants → score all (variant, covering read) problems
    in one batched banded-DP call → apply non-overlapping improvements.
    Returns (consensus, n_edits). Offsets are re-derived only through the
    applied edits (shift by the indel delta), so rounds stay cheap.
    """
    cons = np.asarray(seed, np.uint8).copy()
    reads = [np.asarray(r, np.uint8) for r in reads]
    offsets = [int(o) for o in offsets]
    total_edits = 0

    for _ in range(cfg.rounds):
        votes = stack_votes(cons, reads, offsets)
        depth = votes.sum(axis=1)
        agree = votes[np.arange(len(cons)), cons]
        disagree = depth - agree
        # fractional majority: indel-drifted stack members vote ~randomly,
        # so a fixed count threshold drowns in spurious columns — require
        # a real plurality against the consensus base
        suspect = (disagree >= cfg.min_disagree) & (depth >= 2) \
            & (2 * disagree >= depth)
        if not suspect.any():
            break
        pos = np.nonzero(suspect)[0]
        # cluster within window; strongest first
        brk = np.nonzero(np.diff(pos) > cfg.window)[0]
        clusters = np.split(pos, brk + 1)
        clusters.sort(key=lambda cl: -int(disagree[cl].sum()))
        clusters = clusters[: cfg.max_suspects]

        probs_q, probs_t, meta = [], [], []
        infos = []
        for si, cl in enumerate(clusters):
            # anchor on the LEFTMOST disagreement: an indel desynchronizes
            # every column downstream, so the cluster's left edge is the
            # actionable position (drift clusters can span the whole tail)
            c = int(cl[0])
            ws = max(0, c - 4)
            we = min(len(cons), c + 2 * cfg.window)
            if we - ws < 5:
                infos.append(None)
                continue
            t0 = cons[ws:we].copy()
            incl = cl[(cl >= ws + 1) & (cl <= we - 3)][:8]
            xs = np.unique(np.clip(incl - ws, 1, we - ws - 3))
            vs = [("orig", -1, t0)] + _variants(t0, xs)
            # covering reads, clipped to the window
            rws = []
            for seq, off in zip(reads, offsets):
                if off <= ws - 2 and off + len(seq) >= we + 2:
                    frag = seq[ws - off : we - off]
                    if len(frag) == we - ws:
                        rws.append(frag)
                if len(rws) >= cfg.max_reads_per_suspect:
                    break
            if len(rws) < 2:
                infos.append(None)
                continue
            infos.append((ws, we, vs, len(rws)))
            for vi, (_, _, v) in enumerate(vs):
                for q in rws:
                    probs_q.append(q)
                    probs_t.append(v)
                    meta.append((si, vi))
        if not probs_q:
            break

        B0 = len(probs_q)
        # the reference's quantized padding (stable shapes across rounds)
        B = ((B0 + 255) // 256) * 256
        Lq = ((max(len(x) for x in probs_q) + 15) // 16) * 16
        Lt = ((max(len(x) for x in probs_t) + 15) // 16) * 16
        qa = np.full((B, Lq), 4, np.uint8)
        ta = np.full((B, Lt), 4, np.uint8)
        ql = np.zeros(B, np.int32)
        tl = np.zeros(B, np.int32)
        for i in range(B0):
            qa[i, : len(probs_q[i])] = probs_q[i]
            ta[i, : len(probs_t[i])] = probs_t[i]
            ql[i] = len(probs_q[i])
            tl[i] = len(probs_t[i])
        cost, _ = banded.banded_align_host(
            qa, ql, ta, tl, np.zeros(B, np.int32), cfg.band, device)
        tot: dict = {}
        for (si, vi), c in zip(meta, cost):
            tot[(si, vi)] = tot.get((si, vi), 0) + int(c)

        # apply the best variant per cluster, right-to-left (offsets stay
        # valid for earlier windows); shift read offsets after indels
        edits = []
        for si, info in enumerate(infos):
            if info is None:
                continue
            ws, we, vs, _ = info
            base_cost = tot.get((si, 0))
            if base_cost is None:
                continue
            cands = [(tot[(si, vi)], vi) for vi in range(len(vs))
                     if (si, vi) in tot]
            bc, bvi = min(cands)
            if bvi == 0 or bc > base_cost - cfg.margin:
                continue
            edits.append((ws, we, vs[bvi][2]))
        if not edits:
            break
        applied_lo = len(cons) + 1
        for ws, we, v in sorted(edits, key=lambda e: -e[0]):
            if we > applied_lo:      # overlapping window already edited
                continue
            applied_lo = ws
            delta = len(v) - (we - ws)
            cons = np.concatenate([cons[:ws], v, cons[we:]])
            if delta != 0:
                offsets = [o + delta if o >= we else o for o in offsets]
            total_edits += 1
    return cons, total_edits
