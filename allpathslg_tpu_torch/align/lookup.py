"""Seed-and-verify read-to-contig alignment producing alignlets (port of
allpathslg_tpu/align/lookup.py).

Behavior contract (ref: src/lookup/ lookup_table + QueryLookupTable +
ImperfectLookup, and src/paths/AlignPairsToHyper*): build a kmer seed
index of the contig set, find candidate placements for each read by seed
vote, verify gap-free with a mismatch count, rescue verify failures with a
banded DP, and keep unique placements as compact alignlets (contig, pos,
rc, mismatches, aligned).

As in the reference: the index is a hash-bucketed (canonical kmer ->
packed gpos << 1 | rc) table over the flat concatenated contig bases,
sorted through the port's stable sort (ops/sort); seeds probe buckets with
direct gathers; votes resolve densely per read over [N, C, C] candidate
blocks (C = seeds x hits); verification is a gather + compare. The dense
vote is taken in slabs of reads, which gives the same integers at bounded
memory (XLA fused the [N, C, C] block on the TPU; eager torch would hold
several of them at once). The gapped rescue runs the whole batch through
ops/banded.banded_align_auto: the Hopper bit-parallel kernel on a CUDA
device, the plain `banded_align` on the CPU. The reference cut the rescue
into 16,384-problem chunks for the TPU kernel's VMEM; the results are per
problem, so the port runs each batch in one call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from allpathslg_tpu_torch.dtypes import packed as pk
from allpathslg_tpu_torch.dtypes.reads import PAD_CODE
from allpathslg_tpu_torch.kmer import bits, kmerize
from allpathslg_tpu_torch.ops import banded, sort as ops_sort

# elements of one [reads, C, C] vote slab (~256 M, a few hundred MB)
_VOTE_SLAB_ELEMS = 1 << 28


@dataclasses.dataclass
class SeedIndex:
    """Hash-bucketed canonical-kmer seed index of a contig set.

    Rows are sorted by a 32-bit mixed hash of the canonical seed kmer and
    addressed by direct bucket lookup on the hash's top bits. Row payloads
    are packed into one word `(gpos << 1) | is_rc` when the flat contig set
    is < 2^30 bases; contig/pos derive from gpos through the offsets array.
    Larger indexes use the 3-array layout (packed=None). Words are int64
    tensors holding uint32, on the device that built the index."""
    K: int
    hash: torch.Tensor           # uint32 values [T] sorted
    bucket_starts: torch.Tensor  # int32 [NB + 1]; NB = 1 << (32 - shift)
    shift: int                   # bucket = hash >> shift
    contig: Optional[torch.Tensor]  # int32 [T] (legacy layout; None if packed)
    pos: Optional[torch.Tensor]     # int32 [T] position within contig
    is_rc: Optional[torch.Tensor]   # bool [T] canonical is rc of contig fwd
    offsets: torch.Tensor        # int32 [n_contigs + 1]
    contig_lens: np.ndarray      # int32 [n_contigs] (host)
    packed: Optional[torch.Tensor] = None  # uint32 values [T] (gpos<<1)|rc


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    K: int = 24
    seed_stride: int = 8        # query seed every `stride` windows
    max_hits_per_seed: int = 8  # repeat guard
    max_mismatch_frac: float = 0.06
    require_unique: bool = True
    rescue_band: int = 8        # banded-DP rescue half-width for reads whose
                                # winning placement fails gap-free verify
                                # (ref: QueryLookupTable seed-extend through
                                # SmithWatBandedA); 0 = off


def build_index(bases: np.ndarray, offsets: np.ndarray, K: int,
                force_legacy: bool = False, device="cuda") -> SeedIndex:
    """bases: uint8 flat contig bases; offsets: int [n+1].

    force_legacy keeps the 3-array row layout even under 2^30 bases
    (tests the >=1 Gb layout on small data)."""
    total = int(offsets[-1])
    flat = torch.from_numpy(np.asarray(bases, np.uint8).reshape(1, -1)) \
        .to(device)
    off32 = torch.from_numpy(np.asarray(offsets, np.int64).astype(np.int32)) \
        .to(device)
    off64 = off32.long()
    canon, valid = kmerize.kmer_windows(flat, K)
    fwd, _ = kmerize.kmer_windows_fwd(flat, K)
    P = total - K + 1
    gpos = torch.arange(P, dtype=torch.int64, device=flat.device)
    contig = torch.searchsorted(off64, gpos, right=True) - 1
    # window must not cross its contig's end
    inside = (gpos + K) <= off64[contig + 1]
    valid = valid.reshape(-1) & inside
    is_rc = ~bits.lex_eq(canon, fwd).reshape(-1)
    pos = gpos - off64[contig]

    flat_words = [w.reshape(-1) for w in canon]
    h = bits.hash_words(flat_words).clamp(max=0xFFFFFFFE)
    keys = [torch.where(valid, h, bits.SENTINEL)]
    packed_mode = total < (1 << 30) and not force_legacy
    if packed_mode:
        skeys, spay = ops_sort.sort_by_words(keys,
                                             [(gpos << 1) | is_rc.long()])
    else:
        skeys, spay = ops_sort.sort_by_words(
            keys, [contig.int(), pos.int(), is_rc.int()])
    n_valid = int(valid.sum())
    hash_sorted = skeys[0][:n_valid]
    # bucket directory: ~4 buckets per row keeps mean occupancy ~0.25 so
    # an H-row scan from the bucket start covers the query's hash run
    nb_bits = max(16, min(26, int(np.ceil(np.log2(max(4 * n_valid, 2))))))
    shift = 32 - nb_bits
    NB = 1 << nb_bits
    bounds = torch.arange(NB, dtype=torch.int64, device=flat.device) << shift
    bucket_starts = torch.cat([
        torch.searchsorted(hash_sorted, bounds).to(torch.int32),
        torch.full((1,), n_valid, dtype=torch.int32, device=flat.device)])
    clens = np.diff(np.asarray(offsets)).astype(np.int32)
    if packed_mode:
        return SeedIndex(K=K, hash=hash_sorted, bucket_starts=bucket_starts,
                         shift=shift, contig=None, pos=None, is_rc=None,
                         offsets=off32, contig_lens=clens,
                         packed=spay[0][:n_valid])
    return SeedIndex(K=K, hash=hash_sorted, bucket_starts=bucket_starts,
                     shift=shift, contig=spay[0][:n_valid],
                     pos=spay[1][:n_valid],
                     is_rc=spay[2][:n_valid].bool(), offsets=off32,
                     contig_lens=clens)


def _candidates(index: SeedIndex, codes: torch.Tensor, cfg: AlignConfig):
    """Seed lookups -> candidate (contig, diag, orient, ok), each [N, S*H]
    read-major. Seeds address the index by direct hash-bucket lookup; over
    a packed index (`_candidates_packed` in the reference) the hit
    expansion gathers hash + packed and derives contig/pos from gpos, over
    the legacy layout it gathers the three row arrays."""
    K = cfg.K
    N, L = codes.shape
    P = L - K + 1
    dev = codes.device
    canon, valid = kmerize.kmer_windows(codes, K)
    fwd, _ = kmerize.kmer_windows_fwd(codes, K)
    q_rc = ~bits.lex_eq(canon, fwd)   # read window stored as rc of read-fwd

    # seeds: every stride-th window
    seed_pos = torch.arange(0, P, cfg.seed_stride, dtype=torch.int64,
                            device=dev)
    S = seed_pos.shape[0]
    flat = [w[:, seed_pos].reshape(-1) for w in canon]
    sval = valid[:, seed_pos].reshape(-1)
    sqrc = q_rc[:, seed_pos].reshape(-1)

    qh = bits.hash_words(flat).clamp(max=0xFFFFFFFE)
    b = qh >> index.shift
    lo = index.bucket_starts[b].long()
    hi = index.bucket_starts[b + 1].long()
    H = cfg.max_hits_per_seed
    T = index.hash.shape[0]
    # expand each seed to up to H rows scanned from its bucket start
    hit_idx = lo[:, None] + torch.arange(H, dtype=torch.int64, device=dev)
    ok = hit_idx < hi[:, None]
    hit_clip = hit_idx.clamp(max=T - 1)
    ok &= index.hash[hit_clip] == qh[:, None]
    if index.packed is not None:
        pk32 = index.packed[hit_clip]
        gp = pk32 >> 1
        t_rc = (pk32 & 1).bool()
        off64 = index.offsets.long()
        c = torch.searchsorted(off64, gp, right=True) - 1
        p = gp - off64[c]
    else:
        c = index.contig[hit_clip].long()
        p = index.pos[hit_clip].long()
        t_rc = index.is_rc[hit_clip]

    # orientation: read-fwd maps to contig-fwd iff (q_rc == t_rc)
    orient_rc = sqrc[:, None] ^ t_rc       # True: read maps rc
    qpos = seed_pos[None, :, None].expand(N, S, H).reshape(-1, H)
    # seed-invariant anchors: fwd placements use A with read j <-> A + j
    # (A = p - qpos); rc placements use A with read j <-> A - j
    # (A = p + qpos + K - 1)
    diag = torch.where(orient_rc, p + qpos + (K - 1), p - qpos)
    ok &= sval[:, None]
    return (c.reshape(N, -1), diag.reshape(N, -1), orient_rc.reshape(N, -1),
            ok.reshape(N, -1))


def _vote_counts(c, d, o, ok):
    """votes int64 [N, C]: for each ok candidate row, the ok rows of its
    read with the same (contig, diag, orient); 0 for rows not ok. The
    triple packs into one injective int64 key (contig + 1 < 2^28,
    diag + 2^31 < 2^32, orient < 4), compared in slabs of reads."""
    N, C = c.shape
    key = ((c + 1) << 35) | ((d + (1 << 31)) << 2) | o
    votes = torch.empty((N, C), dtype=torch.int64, device=c.device)
    slab = max(1, _VOTE_SLAB_ELEMS // max(C * C, 1))
    for s in range(0, N, slab):
        k = key[s:s + slab]
        okc = ok[s:s + slab]
        same = k[:, :, None] == k[:, None, :]
        same &= okc[:, None, :]
        votes[s:s + slab] = same.sum(dim=2) * okc
    return votes


def _vote_and_verify_dense(contig, diag, orient, ok, flat_bases, offsets,
                           codes, lengths, cfg: AlignConfig):
    """Dense per-read voting: every read has exactly S*H candidate rows, so
    the modal placement is an all-pairs vote count over its rows.

    Tie-break: earliest candidate row (rows are seed-major, so this
    prefers the leftmost seed's placement)."""
    N, L = codes.shape
    C = contig.shape[1]
    dev = codes.device
    c = torch.where(ok, contig, -1)
    d = torch.where(ok, diag, 1 << 30)
    o = torch.where(ok, orient.long(), 2)
    votes = _vote_counts(c, d, o, ok)
    # winner: most votes, ties to the earliest row (argmax: first index)
    score = votes * (C + 1) + (C - torch.arange(C, device=dev))[None, :]
    score = score * ok
    win_row = torch.argmax(score, dim=1)[:, None]

    def take(a):
        return torch.gather(a, 1, win_row)[:, 0]

    win_votes = take(votes)
    has = win_votes > 0
    win_contig = torch.where(has, take(c), -1)
    win_diag = torch.where(has, take(d), 0)
    win_orient = torch.where(has, take(o), 0)

    # runner-up among OTHER placements; same-locus near-diagonal rows
    # (the other side of an indel, within the rescue band) don't count
    # as ambiguity (ref: QueryLookupTable groups hits by approx diagonal)
    tol = max(cfg.rescue_band, 1)
    same_locus = (c == win_contig[:, None]) & (o == win_orient[:, None])
    same_as_win = same_locus & (d == win_diag[:, None])
    near = same_locus & ((d - win_diag[:, None]).abs() <= tol)
    run2 = torch.where(same_as_win | near, 0, votes).max(dim=1).values

    # verification: compare read to contig segment
    total = flat_bases.shape[0]
    off64 = offsets.long()
    wc0 = win_contig.clamp(min=0)
    gstart = off64[wc0]
    cend = off64[wc0 + 1]
    j = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    lenv = lengths.long()[:, None]
    rc_win = win_orient[:, None] == 1
    tpos = torch.where(rc_win, win_diag[:, None] - j, win_diag[:, None] + j) \
        + gstart[:, None]
    inb = (tpos >= gstart[:, None]) & (tpos < cend[:, None]) & (j < lenv)
    tb = flat_bases[tpos.clamp(0, total - 1)].long()
    tb = torch.where(rc_win, 3 - tb, tb)
    is_base = codes < 4
    mm = ((codes.long() != tb) & inb & is_base).sum(1)
    n_in = (inb & is_base).sum(1)

    max_mm = _max_mismatches(lengths, cfg)
    aligned = ((win_contig >= 0) & (n_in >= (lengths.long() * 9) // 10)
               & (mm <= max_mm))
    unique_ok = (run2 * 2 < win_votes) if cfg.require_unique \
        else torch.ones_like(aligned)
    aligned = aligned & unique_ok
    return win_contig, win_diag, win_orient.bool(), mm, aligned, unique_ok


def _max_mismatches(lengths, cfg: AlignConfig):
    """float32(frac) * float32(length), truncated: the reference's
    float32 arithmetic, so the threshold is the same integer."""
    frac = torch.full_like(lengths, cfg.max_mismatch_frac,
                           dtype=torch.float32)
    return (frac * lengths.float()).long()


def _gapped_rescue(win_c, win_d, win_o, aligned, flat_bases, offsets,
                   codes, lengths, cfg: AlignConfig):
    """Banded-DP rescue of reads whose winning placement failed gap-free
    verification (an indel vs the contig shifts the tail and swamps the
    mismatch count; ref: QueryLookupTable's SmithWatBandedA extension).

    Every read of the batch aligns against its expected contig window
    (+- band) through ops/banded.banded_align_auto; a placement is accepted
    when the EDIT distance clears the same fraction threshold the gap-free
    path applies to mismatches."""
    N, L = codes.shape
    dev = codes.device
    band = cfg.rescue_band
    total = flat_bases.shape[0]
    j = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    lenv = lengths.long()[:, None]
    # rc reads align forward after reversing within their length
    j2 = (lenv - 1 - j).clamp(0, L - 1)
    in_read = j < lenv
    rc_codes = torch.where(in_read, torch.gather(codes, 1, j2), PAD_CODE)
    rc_codes = torch.where((rc_codes < 4) & in_read, 3 - rc_codes.long(),
                           PAD_CODE).to(torch.uint8)
    q = torch.where(win_o[:, None], rc_codes, codes)

    off64 = offsets.long()
    wc0 = win_c.clamp(min=0)
    gstart = off64[wc0]
    cend = off64[wc0 + 1]
    # expected contig start of the (possibly rc'd) query
    exp = torch.where(win_o, win_d - (lengths.long() - 1), win_d)
    tstart = gstart + exp - band
    Wt = L + 2 * band
    tpos = tstart[:, None] + torch.arange(Wt, dtype=torch.int64, device=dev)
    inb = (tpos >= gstart[:, None]) & (tpos < cend[:, None])
    t = torch.where(inb, flat_bases[tpos.clamp(0, total - 1)],
                    PAD_CODE).to(torch.uint8)
    t_len = torch.full((N,), Wt, dtype=torch.int32, device=dev)
    offv = torch.full((N,), band, dtype=torch.int32, device=dev)
    cost, _ = banded.banded_align_auto(q, lengths.int(), t, t_len, offv,
                                       band=band)
    ok = (win_c >= 0) & ~aligned & (cost <= _max_mismatches(lengths, cfg))
    return ok, cost


def align_reads(index: SeedIndex, codes, lengths, cfg: AlignConfig,
                flat_bases):
    """Full alignment on the index's device: returns host alignlet arrays
    (contig int32, pos int32, rc bool, mismatches int32, aligned bool).

    codes: uint8 [N, L] numpy (moved 2-bit packed, dtypes/packed) or a
    tensor; flat_bases: the contig bases (tensor on the index's device, or
    numpy)."""
    dev = index.hash.device
    if isinstance(codes, np.ndarray):
        codes = pk.device_codes(codes, dev)
    else:
        codes = codes.to(dev)
    if not torch.is_tensor(lengths):
        lengths = torch.from_numpy(np.array(lengths))
    lengths = lengths.to(dev)
    fb = torch.as_tensor(flat_bases).to(dev)
    c, d, o, ok = _candidates(index, codes, cfg)
    win_c, win_d, win_o, mm, aligned, unique_ok = _vote_and_verify_dense(
        c, d, o, ok, fb, index.offsets, codes, lengths, cfg)
    if cfg.rescue_band > 0:
        rescued, cost = _gapped_rescue(win_c, win_d, win_o, aligned, fb,
                                       index.offsets, codes, lengths, cfg)
        rescued = rescued & unique_ok   # rescue fixes verify failures,
        aligned = aligned | rescued     # never ambiguity failures
        mm = torch.where(rescued, cost.long(), mm)
    return (win_c.to(torch.int32).cpu().numpy(),
            win_d.to(torch.int32).cpu().numpy(),
            win_o.cpu().numpy(), mm.to(torch.int32).cpu().numpy(),
            aligned.cpu().numpy())
