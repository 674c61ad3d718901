"""Phase-1 pre-correction: 25-mer stack majority voting (port of
allpathslg_tpu/ec/precorrect.py).

Behavior contract (ref: src/paths/FindErrors.cc phase 1 / PreCorrect): pile
up all 25-mers sharing the same 24-base context (12 bases each side of the
center), majority-vote the center base when a dominant alternative exists,
and never touch high-quality disagreeing bases. Stacks are strand-neutral:
windows orient by the smaller of (context, rc(context)) with the center
bits masked, and the center base complements along.

`precorrect` piles stacks within one batch. The scale path,
`precorrect_global_resident`, builds a global (context, base) -> count
table in hash-block passes over a device-resident read cache (3-word keys
through the generic count machinery, whose sorts are the Hopper radix sort
on a CUDA device) and then votes every window against it with the hashed
join.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.dtypes import packed as pk
from allpathslg_tpu_torch.kmer import bits, kmerize
from allpathslg_tpu_torch.kmer import count as kcount
from allpathslg_tpu_torch.ops import join, segmented
from allpathslg_tpu_torch.ops import sort as ops_sort

K_PRE = 25
CENTER = 12  # self-mirroring position: 24 - 12 == 12


@dataclasses.dataclass(frozen=True)
class PrecorrectConfig:
    min_winner: int = 6        # dominant base needs this many observations
    qual_protect: int = 30     # protect recurrent (>=2x) bases at/above this qual
    min_ratio: int = 8         # winner/loser count ratio


def _orient_windows(codes, quals):
    """Strand-neutral per-window records: oriented masked-context key
    (2 words), oriented center base, center qual, valid mask, rc flag —
    all in [N, P] layout."""
    N, L = codes.shape
    P = L - K_PRE + 1
    fwd, valid = kmerize.kmer_windows_fwd(codes, K_PRE)
    ctx_f = bits.mask_base(fwd, CENTER)
    ctx_r = bits.mask_base(bits.rc_words(fwd, K_PRE), CENTER)
    use_rc = bits.lex_less(ctx_r, ctx_f)
    key = bits.select_words(use_rc, ctx_r, ctx_f)
    center_in_read = codes[:, CENTER: CENTER + P].to(torch.int32)
    center = torch.where(use_rc, 3 - center_in_read, center_in_read)
    cqual = quals[:, CENTER: CENTER + P].to(torch.int32)
    return key, center, cqual, valid, use_rc


def _vote(n_b, own, squal, cfg: PrecorrectConfig):
    """(fix, winner): per window, whether the stack outvotes its center.
    An invalid window's center may be N (4, or -1 oriented); its own count
    is read from a clamped index, and the caller masks its fix out."""
    own_n = torch.gather(n_b, 1, own.long().clamp(0, 3)[:, None])[:, 0]
    winner = torch.argmax(n_b, dim=-1).to(torch.int32)  # ties: lowest base
    win_n = torch.gather(n_b, 1, winner.long()[:, None])[:, 0]
    # a singleton minority is correctable at any quality; a recurrent
    # minority (>=2 observations, e.g. a het allele) is protected once its
    # quality is high (ref: PreCorrect's high-quality-disagreement guard)
    protected = (squal >= cfg.qual_protect) & (own_n >= 2)
    fix = ((own != winner) & (win_n >= cfg.min_winner)
           & (win_n >= cfg.min_ratio * own_n.clamp(min=1)) & ~protected)
    return fix, winner


def _apply_centers(codes, new_center, use_rc):
    """Write voted centers (-1 = keep) into the interior band of the reads."""
    P = new_center.shape[1]
    do_fix = new_center >= 0
    fixed_val = torch.where(use_rc, 3 - new_center, new_center)
    interior = codes[:, CENTER: CENTER + P].to(torch.int32)
    out = codes.clone()
    out[:, CENTER: CENTER + P] = torch.where(do_fix, fixed_val,
                                             interior).to(torch.uint8)
    return out, do_fix.sum()


def precorrect(codes: torch.Tensor, quals: torch.Tensor,
               cfg: PrecorrectConfig = PrecorrectConfig()
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacks within one batch. Returns (corrected_codes, n_corrections)."""
    N, L = codes.shape
    P = L - K_PRE + 1
    key, center, cqual, valid, use_rc = _orient_windows(codes, quals)
    T = N * P
    vm = valid.reshape(-1)
    fkey = [torch.where(vm, w.reshape(-1), bits.SENTINEL) for w in key]
    fcen = torch.where(vm, center.reshape(-1), 0)
    fq = torch.where(vm, cqual.reshape(-1), 0)
    slot = torch.arange(T, dtype=torch.int32, device=codes.device)

    skeys, (scen, squal, sslot) = ops_sort.sort_by_words(fkey,
                                                         [fcen, fq, slot])
    starts = ops_sort.run_starts(skeys)
    rl = segmented.run_lengths(starts)
    start_pos = (torch.arange(T, dtype=torch.int32, device=codes.device)
                 - segmented.position_in_run(starts)).long()

    # per-stack per-base counts, broadcast to members (cumsum-diff)
    n_b = torch.stack([
        kcount._sum_per_run((scen == b).to(torch.int32), starts, rl)[start_pos]
        for b in range(4)], dim=-1)                       # [T, 4]
    fix, winner = _vote(n_b, scen, squal, cfg)
    fix = fix & ~bits.is_sentinel(skeys)

    # route decisions back to window slots (sslot is a permutation)
    new_center = torch.full((T,), -1, dtype=torch.int32, device=codes.device)
    new_center[sslot.long()] = torch.where(fix, winner, -1)
    return _apply_centers(codes, new_center.reshape(N, P), use_rc)


def precorrect_stats_batch(codes: torch.Tensor, quals: torch.Tensor):
    """Compact (context, base) -> count table for one batch (3-word keys:
    ctx_w0, ctx_w1, base)."""
    key, center, _, valid, _ = _orient_windows(codes, quals)
    return _stats_table(key, center, valid.reshape(-1))


def _stats_table(key, center, vm):
    """Count the (context, base) keys of the windows selected by vm."""
    words = [torch.where(vm, w.reshape(-1), bits.SENTINEL) for w in key]
    words.append(torch.where(vm, center.reshape(-1).long(), bits.SENTINEL))
    skeys, counts, starts = kcount.count_sorted(words)
    return kcount.compact_table(skeys, counts, starts)


def precorrect_stats_batch_packed(words, nmask, qnib, qpal, L: int):
    """precorrect_stats_batch over a 2-bit packed batch (dtypes/packed)."""
    return precorrect_stats_batch(pk.unpack_codes(words, nmask, L),
                                  pk.unpack_quals(qnib, qpal, L))


def precorrect_stats_batch_packed_blocked(words, nmask, qnib, qpal, L: int,
                                          blk: int, n_blocks: int):
    """Hash-block slice of the batch stack stats (ref: NaifKmerizer
    hash-block passes): rows whose context-hash block != blk become
    sentinels, so each block's unique volume is ~1/n_blocks."""
    key, center, _, valid, _ = _orient_windows(
        pk.unpack_codes(words, nmask, L), pk.unpack_quals(qnib, qpal, L))
    h = bits.hash_words([w.reshape(-1) for w in key])
    return _stats_table(key, center,
                        valid.reshape(-1) & ((h % n_blocks) == blk))


def precorrect_apply_batch_packed(words, nmask, qnib, qpal, L: int,
                                  table_words, table_counts,
                                  cfg: PrecorrectConfig):
    """Packed-in, packed-out apply: corrected codes return as 2-bit words
    (+ N mask)."""
    out, k = precorrect_apply_batch(pk.unpack_codes(words, nmask, L),
                                    pk.unpack_quals(qnib, qpal, L),
                                    table_words, table_counts, cfg)
    ow, om = pk.pack_codes_device(out)
    return ow, om, k


def precorrect_apply_batch(codes, quals, table_words, table_counts,
                           cfg: PrecorrectConfig = PrecorrectConfig()):
    """Vote every window of one batch against the global stack table.

    table_words: a join.HashedTable (counts as payload 0), or 3 sorted word
    tensors [M] (ctx_w0, ctx_w1, base) with table_counts int32 [M].
    Returns (corrected_codes, n_corrections)."""
    key, center, cqual, valid, use_rc = _orient_windows(codes, quals)
    N, P = valid.shape
    flat_ctx = [w.reshape(-1) for w in key]
    n_b = []
    for b in range(4):
        q = flat_ctx + [torch.full_like(flat_ctx[0], b)]
        if isinstance(table_words, join.HashedTable):
            cnt, _ = join.payload_hashed(table_words, 0, q, 0)
        else:
            cnt, _ = join.lookup_payload(table_words, table_counts, q, 0)
        n_b.append(cnt)
    n_b = torch.stack(n_b, dim=-1)                     # [N*P, 4]
    fix, winner = _vote(n_b, center.reshape(-1), cqual.reshape(-1), cfg)
    fix = fix & valid.reshape(-1)
    new_center = torch.where(fix, winner, -1).reshape(N, P)
    return _apply_centers(codes, new_center, use_rc)


def precorrect_global_resident(db, cfg: PrecorrectConfig = PrecorrectConfig(),
                               log=None, n_blocks: int = None):
    """Two-pass global pre-correction over a device-resident batch cache
    (dtypes/devcache.DeviceBatches): pass 1 builds the global stack table
    from the resident batches in hash-block passes, pass 2 corrects them in
    place (DeviceBatches.update_codes). Returns n_corrections.

    Blocks partition the key space, so the per-block min_count>=2 filter
    drops error singletons with globally correct semantics and each
    block's accumulator stays small; the filtered block tables merge by
    concat + recount on the device."""
    say = log or (lambda *a: None)
    rows_per_batch = db.batch * max(db.L - K_PRE + 1, 1)
    total_rows = db.n_batches * rows_per_batch
    # worst-case uniques ~ 0.5x raw rows (error singletons); keep each
    # block's accumulator near 0.75 GB (20 B/row: 4 arrays x 4 B + slack)
    if n_blocks is None:
        n_blocks = max(1, -(-int(total_rows * 0.5) * 20 // (768 << 20)))
    say(f"  [precorrect] pass 1: {db.n_batches} batches x "
        f"{n_blocks} hash blocks")
    block_tables = []
    with trace.span("ec.round", phase="stack table"):
        for blk in range(n_blocks):
            sc = kcount.StreamingCounter()
            for i in range(db.n_batches):
                sc.add(precorrect_stats_batch_packed_blocked(
                    db.words[i], db.nmask[i], db.qnib[i], db.qpal[i], db.L,
                    blk, n_blocks))
            t = sc.finish(min_count=min(2, cfg.min_winner))
            block_tables.append(t)
            say(f"  [precorrect] block {blk}: {int(t.n_unique)} strong rows")
        if len(block_tables) > 1:
            merged = kcount.merge_tables(block_tables)
        else:
            merged = block_tables[0]
        merged = kcount.pad_table_quantized(merged)
        ht = join.hash_table(list(merged.words), payloads=[merged.counts])
        say(f"  [precorrect] stack table hashed (scan depth H={ht.H})")

    say(f"  [precorrect] pass 2: voting {db.n_batches} batches")
    total = 0
    with trace.span("ec.round", phase="vote"):
        for i in range(db.n_batches):
            ow, om, k = precorrect_apply_batch_packed(
                db.words[i], db.nmask[i], db.qnib[i], db.qpal[i], db.L,
                ht, None, cfg)
            db.update_codes(i, ow, om)
            total += int(k)
            if (i + 1) % 10 == 0 or i + 1 == db.n_batches:
                say(f"  [precorrect] voted {i + 1}/{db.n_batches} batches "
                    f"({total} corrections)")
    return total
