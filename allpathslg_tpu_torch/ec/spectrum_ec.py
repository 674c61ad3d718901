"""Phase-2 quality-aware K=24 spectrum error correction + read cleaning
(port of allpathslg_tpu/ec/spectrum_ec.py).

Behavior contract (ref: src/paths/FindErrors.cc, FindErrorsCore.cc): a
kmer is strong if its quality-weighted support clears a threshold; for each
read base covered only by weak kmers, search the one substitution that
makes all covering kmers strong; cap edits by base quality; iterate
(bounded rounds). CleanCorrectedReads (ref: src/paths/CleanCorrectedReads.cc):
trim reads to their strong span and drop reads with residual weak cores,
keeping row indices stable so pairing survives.

Membership tests join against the strong table (ops/join); candidate
re-tests substitute bases into packed forward windows and re-canonicalize:
[N, MAXFIX, 4, K] lookups, all batched.
"""

from __future__ import annotations

import dataclasses

import torch

from allpathslg_tpu_torch.dtypes import packed as pk
from allpathslg_tpu_torch.kmer import bits, kmerize
from allpathslg_tpu_torch.kmer import count as kcount
from allpathslg_tpu_torch.ops import join
from allpathslg_tpu_torch.ops import sort as ops_sort


@dataclasses.dataclass(frozen=True)
class SpectrumECConfig:
    K: int = 24
    min_strong_count: int = 2      # raw multiplicity floor for strong
    min_strong_qsum: int = 60      # quality-weighted support floor
    max_fixes_per_round: int = 4   # candidate positions per read per round
    rounds: int = 3
    # adaptive cutoff: stop iterating once a round fixes fewer than this
    # fraction of reads (the reference iterates to a bounded fixpoint)
    min_round_fixes_frac: float = 0.002
    qual_protect: int = 45         # never edit bases at/above this quality
    min_tail_len: int = 24         # CleanCorrectedReads: min kept read length


def strong_table(ck: kcount.CountedKmers, cfg: SpectrumECConfig):
    """Strong kmer keys from a quality-weighted counted table, sorted with
    weak and padding rows as sentinels behind: (word list, n_strong)."""
    strong = ck.counts >= cfg.min_strong_count
    if ck.qsum is not None:
        strong = strong & (ck.qsum >= cfg.min_strong_qsum)
    keyed = [torch.where(strong, w, bits.SENTINEL) for w in ck.words]
    out, _ = ops_sort.sort_by_words(keyed)
    return out, strong.sum(dtype=torch.int32)


def compact_strong_table(table, n_strong: int, bucket: int = 1 << 18):
    """Slice the sorted strong-first table to a capacity rounded up to
    `bucket` rows (sentinels fill the tail). The capacity sets the shape of
    the strong_table.npy artifact, so it follows the reference."""
    ns = max(int(n_strong), 1)
    cap = ((ns + bucket - 1) // bucket) * bucket
    out = []
    for w in table:
        if w.shape[0] >= cap:
            out.append(w[:cap])
        else:
            out.append(torch.cat([w, torch.full((cap - w.shape[0],),
                                                bits.SENTINEL,
                                                dtype=w.dtype,
                                                device=w.device)]))
    return out


def _member(table, flat):
    """Membership: a join.HashedTable, or a sorted word list."""
    if isinstance(table, join.HashedTable):
        return join.member_hashed(table, flat)
    _, found = join.searchsorted_words(table, flat)
    return found


def _window_strong(codes, table, K: int):
    """bool [N, P]: window's canonical kmer is in the strong table."""
    canon, valid = kmerize.kmer_windows(codes, K)
    N, P = valid.shape
    found = _member(table, [w.reshape(-1) for w in canon])
    return found.reshape(N, P) & valid, valid


def _coverage_counts(strongw, validw, K: int, L: int):
    """Per-base counts over covering windows: (n_strong_cov, n_cov)."""
    N, P = strongw.shape
    dev = strongw.device
    cs = torch.cumsum(torch.nn.functional.pad(strongw.to(torch.int32), (1, 0)),
                      1, dtype=torch.int32)
    cv = torch.cumsum(torch.nn.functional.pad(validw.to(torch.int32), (1, 0)),
                      1, dtype=torch.int32)
    # windows covering base c: p in [max(0, c-K+1), min(c, P-1)]
    c = torch.arange(L, device=dev)
    lo = (c - K + 1).clamp(min=0)
    hi = c.clamp(max=P - 1)
    return cs[:, hi + 1] - cs[:, lo], cv[:, hi + 1] - cv[:, lo]


def _top_k_first(score: torch.Tensor, k: int):
    """lax.top_k along the last axis: the k largest, ties to the lowest
    index first. Each entry gets a distinct key (score, -column), so
    torch.topk has no ties left to order."""
    L = score.shape[-1]
    col = torch.arange(L, device=score.device)
    key = score.long() * L + (L - 1 - col)
    top, _ = torch.topk(key, k, dim=-1)
    top_score = torch.div(top, L, rounding_mode="floor")
    return top_score, L - 1 - (top - top_score * L)


def correct_round_packed(words, nmask, qnib, qpal, L: int, table,
                         cfg: SpectrumECConfig):
    """Packed-in/packed-out correct_round (dtypes/packed)."""
    out, n = correct_round(pk.unpack_codes(words, nmask, L),
                           pk.unpack_quals(qnib, qpal, L), table, cfg)
    ow, om = pk.pack_codes_device(out)
    return ow, om, n


def correct_round(codes, quals, table, cfg: SpectrumECConfig):
    """One round of spectrum EC. Returns (new_codes, n_fixed)."""
    K = cfg.K
    N, L = codes.shape
    P = L - K + 1
    MAXFIX = cfg.max_fixes_per_round
    dev = codes.device

    strongw, validw = _window_strong(codes, table, K)
    n_strong, n_cov = _coverage_counts(strongw, validw, K, L)

    # suspect base: has covering valid windows, none strong, editable quality
    suspect = ((n_cov > 0) & (n_strong == 0)
               & (quals.to(torch.int32) < cfg.qual_protect) & (codes < 4))

    # up to MAXFIX suspects per read, highest covering-window count first:
    # an error position is covered by every weak window around it
    top_scores, cand = _top_k_first(torch.where(suspect, n_cov, -1), MAXFIX)
    has_c = top_scores > 0
    csafe = torch.where(has_c, cand, 0)                         # [N, MF]

    fwd, fvalid = kmerize.kmer_windows_fwd(codes, K)

    own = torch.gather(codes, 1, csafe).long()                   # [N, MF]
    alts = torch.arange(4, device=dev)[None, None, :]            # [1,1,4]
    alt_ok = alts != own[:, :, None]                             # [N, MF, 4]

    # original fwd windows at every covering offset j: window p = c - j
    j = torch.arange(K, device=dev)[None, None, :]               # [1,1,K]
    p = csafe[:, :, None] - j                                    # [N, MF, K]
    p_ok = (p >= 0) & (p < P) & has_c[:, :, None]
    psafe = p.clamp(0, P - 1).reshape(N, -1)
    gwords = [torch.gather(w, 1, psafe).reshape(N, MAXFIX, K) for w in fwd]
    p_ok = p_ok & torch.gather(fvalid, 1, psafe).reshape(N, MAXFIX, K)

    # substitute each alt base at offset j of its window: [N, MF, 4, K]
    shape = (N, MAXFIX, 4, K)
    sub = bits.put_base_dyn([w[:, :, None, :].expand(shape) for w in gwords],
                            j[:, :, None, :].expand(shape),
                            alts[:, :, :, None].expand(shape))
    canon, _ = bits.canonical(sub, K)
    found = _member(table, [w.reshape(-1) for w in canon])
    strong_alt = found.reshape(shape) | ~p_ok[:, :, None, :]
    all_strong = strong_alt.all(-1) & alt_ok & has_c[:, :, None]  # [N, MF, 4]

    do = (all_strong.sum(-1) == 1) & has_c
    fix_base = torch.argmax(all_strong.to(torch.uint8), dim=-1).to(torch.uint8)
    # apply slot by slot, in slot order: the reference's scatter writes
    # every (read, slot), the empty slots rewrite column 0 with its
    # original base, and the last write to a cell wins
    upd = torch.where(do, fix_base, torch.gather(codes, 1, csafe))
    new_codes = codes.clone()
    rows = torch.arange(N, device=dev)
    for s in range(MAXFIX):
        new_codes[rows, csafe[:, s]] = upd[:, s]
    return new_codes, do.sum()


def clean_reads_packed(words, nmask, lengths, L: int, table,
                       cfg: SpectrumECConfig):
    """Packed-in/packed-out clean_reads (see correct_round_packed)."""
    out, lens, k = clean_reads(pk.unpack_codes(words, nmask, L), lengths,
                               table, cfg)
    ow, om = pk.pack_codes_device(out)
    return ow, om, lens, k


def clean_reads(codes, lengths, table, cfg: SpectrumECConfig):
    """CleanCorrectedReads: keep [first strong window, first weak window
    after it + K - 1); drop reads whose kept span is shorter than
    min_tail_len (length 0, rows kept so pair indices stay valid).
    Returns (codes, lengths, n_kept)."""
    K = cfg.K
    N, L = codes.shape
    dev = codes.device
    strongw, validw = _window_strong(codes, table, K)
    P = L - K + 1
    anys = strongw.any(1)
    first = torch.argmax(strongw.to(torch.uint8), dim=1)  # first True
    idxp = torch.arange(P, device=dev)[None, :]
    weak_after = ~strongw & validw & (idxp >= first[:, None])
    first_weak = torch.where(weak_after.any(1),
                             torch.argmax(weak_after.to(torch.uint8), dim=1),
                             P)
    start = torch.where(anys, first, 0)
    end = torch.where(anys, torch.minimum(first_weak + K - 1,
                                          lengths.long()), 0)
    keep_len = (end - start).clamp(min=0)
    ok = keep_len >= cfg.min_tail_len
    keep_len = torch.where(ok, keep_len, 0)

    # shift the kept span to column 0
    cols = (torch.arange(L, device=dev)[None, :] + start[:, None]).clamp(
        0, L - 1)
    shifted = torch.gather(codes, 1, cols)
    mask = torch.arange(L, device=dev)[None, :] < keep_len[:, None]
    out = torch.where(mask, shifted, 4).to(torch.uint8)
    return out, keep_len.to(torch.int32), ok.sum()
