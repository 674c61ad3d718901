"""FillFragments: merge overlapping fragment pairs into filled super-reads
(port of allpathslg_tpu/asm/fill.py).

Behavior contract (ref: src/paths/FillFragments.cc): fragment inserts
(~180bp) are shorter than two read lengths, so each pair overlaps in the
middle; validate the overlap against the insert-size distribution, merge
into one double-quality "filled" read, and pass unfillable pairs through
unchanged.

As in the reference, all candidate insert sizes are scored at once as one
[N, D, L] compare; the best and runner-up offsets are picked with the
first index winning ties (torch.argmin, like jnp.argmin), and the merged
bases/quals are built by gather.
"""

from __future__ import annotations

import dataclasses

import torch

from allpathslg_tpu_torch.dtypes.reads import PAD_CODE

_NO_FILL = 10 ** 6


@dataclasses.dataclass(frozen=True)
class FillConfig:
    insert_lo: int = 120        # smallest insert size to try
    insert_hi: int = 260        # largest insert size to try
    max_mismatch: int = 2       # allowed mismatches in the overlap
    min_overlap: int = 12       # minimum overlap bases
    min_margin: int = 3         # runner-up must have this many more mismatches


def fill_pairs(codes1, quals1, len1, codes2, quals2, len2,
               cfg: FillConfig, out_len: int):
    """Merge r1 with rc(r2) across candidate insert sizes.

    codes1/codes2: uint8 [N, L] (r2 as sequenced; rc applied internally).
    Returns (filled_codes [N, out_len], filled_quals, filled_len, ok [N]).
    """
    N, L = codes1.shape
    dev = codes1.device
    len1 = len1.long()
    len2 = len2.long()
    # reverse-complement read 2 (padding-aware: flip the valid prefix)
    idx = torch.arange(L, device=dev)[None, :]
    src = len2[:, None] - 1 - idx
    srcc = src.clamp(0, L - 1)
    r2 = torch.gather(codes2, 1, srcc)
    r2 = torch.where((src >= 0) & (r2 < 4), 3 - r2.long(),
                     PAD_CODE).to(torch.uint8)
    q2 = torch.gather(quals2, 1, srcc)
    q2 = torch.where(src >= 0, q2, 0).to(torch.uint8)

    # candidate inserts d: r2rc starts at offset o = d - len2
    ds = torch.arange(cfg.insert_lo, cfg.insert_hi + 1, device=dev)
    D = ds.shape[0]
    o = ds[None, :] - len2[:, None]                       # [N, D]
    # overlap = [o, len1) in merged coords; r1[j] vs r2[j - o]
    j = torch.arange(L, device=dev)[None, None, :]         # positions in r1
    k = j - o[:, :, None]                                  # positions in r2
    in_ov = (j < len1[:, None, None]) & (k >= 0) & (k < len2[:, None, None])
    kc = k.clamp(0, L - 1)
    r2_at = torch.gather(r2[:, None, :].expand(N, D, L), 2, kc)
    mism = ((codes1[:, None, :] != r2_at) & in_ov).sum(-1)
    ov_len = in_ov.sum(-1)
    valid_d = ((o >= 0) & (ov_len >= cfg.min_overlap)
               & (ds[None, :] >= len1[:, None]))
    score = torch.where(valid_d, mism, _NO_FILL)

    best = torch.argmin(score, dim=1)                     # first index wins
    best_mm = torch.gather(score, 1, best[:, None])[:, 0]
    second = torch.where(torch.arange(D, device=dev)[None, :] == best[:, None],
                         _NO_FILL, score)
    second_mm = second.min(dim=1).values
    ok = ((best_mm <= cfg.max_mismatch)
          & (second_mm >= best_mm + cfg.min_margin))

    d_best = ds[best]                                      # [N]
    o_best = d_best - len2

    # build merged read of length d_best: position t takes r1[t] and/or
    # r2[t - o_best], higher-quality base wins in the overlap
    t = torch.arange(out_len, device=dev)[None, :]
    from1 = t < len1[:, None]
    k2 = t - o_best[:, None]
    from2 = (k2 >= 0) & (k2 < len2[:, None])
    k2c = k2.clamp(0, L - 1)
    tc = t.clamp(0, L - 1).expand(N, out_len)
    b1 = torch.gather(codes1, 1, tc)
    q1 = torch.gather(quals1, 1, tc)
    b2 = torch.gather(r2, 1, k2c)
    q2g = torch.gather(q2, 1, k2c)

    use2 = from2 & (~from1 | (q2g > q1))
    merged = torch.where(use2, b2, torch.where(from1, b1, PAD_CODE)
                         .to(torch.uint8))
    # double quality where the strands agree; min where they disagree
    agree = from1 & from2 & (b1 == b2)
    q = torch.where(agree, (q1.int() + q2g.int()).clamp(max=60),
                    torch.where(use2, q2g.int(),
                                torch.where(from1, q1.int(), 0)))
    mlen = torch.where(ok, d_best.clamp(max=out_len), 0)
    in_read = t < mlen[:, None]
    merged = torch.where(in_read, merged, PAD_CODE).to(torch.uint8)
    q = torch.where(in_read, q, 0).to(torch.uint8)
    return merged, q, mlen.to(torch.int32), ok
