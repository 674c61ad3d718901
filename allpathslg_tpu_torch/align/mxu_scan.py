"""Gap-free exhaustive alignment as a one-hot convolution (port of
allpathslg_tpu/align/mxu_scan.py).

Behavior contract (ref: src/lookup/PerfectLookup.cc, ImperfectLookup.cc --
SURVEY.md §2.2): place short reads on a target allowing substitutions only,
exhaustively over every offset and both strands; PerfectLookup keeps exact
matches, ImperfectLookup the best placement with bounded mismatches.

Match-counting at every offset is a correlation of one-hot encodings --
sum_j 1[target[p+j] == read[j]] -- i.e. a convolution with the read as
filter: reads are output channels, base identity the contracted channel,
offsets the spatial axis. The reference runs it as one `lax.conv` (an XLA
program, no Pallas kernel) on bf16 one-hots with f32 output; here it is
one `torch.nn.functional.conv1d` on the inputs' device. The one-hots are
float32 and, on the card, TF32 is off for the call, so every product and
partial sum is an integer below 2**24 in float32: the counts are exact for
any read length (a bf16 output would round counts above 256). Ties in the
best placement go to the lowest offset and the forward strand, as
`jnp.argmax` and the strict `nr > nf` give them in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from allpathslg_tpu_torch.dtypes.reads import PAD_CODE


def _one_hot(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes -> float32 one-hot on a new trailing axis; pad rows
    all-zero."""
    return (codes[..., None] == torch.arange(4, dtype=codes.dtype,
                                             device=codes.device)
            ).to(torch.float32)


def _conv(t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    if not t.is_cuda:
        return F.conv1d(t, r)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv1d(t, r)


def match_counts(target: torch.Tensor, reads: torch.Tensor) -> torch.Tensor:
    """Match counts of every read at every target offset.

    target: uint8 [G] (PAD_CODE allowed: never matches).
    reads:  uint8 [N, L] (PAD_CODE positions never match).
    Returns int32 [N, G - L + 1].
    """
    t = _one_hot(target).T[None]                 # [1, 4, G]  (NCW)
    r = _one_hot(reads).permute(0, 2, 1)         # [N, 4, L]  (OIW)
    out = _conv(t.contiguous(), r.contiguous())
    return torch.round(out[0]).to(torch.int32)   # [N, P]


def _rc_reads(reads: torch.Tensor) -> torch.Tensor:
    rev = torch.flip(reads, dims=(1,))
    return torch.where(rev >= PAD_CODE, PAD_CODE,
                       3 - rev.to(torch.int32)).to(reads.dtype)


def imperfect_lookup(target: torch.Tensor, reads: torch.Tensor,
                     lengths: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Best substitution-only placement of each read on either strand.

    Returns (pos, is_rc, mismatches): pos is the offset of the read's
    first base on the target fwd strand; mismatches counts real-base
    mismatches of the best placement. (ref: ImperfectLookup semantics --
    best unique gap-free placement; ties resolve to the lowest offset,
    fwd strand preferred.)
    """
    N, L = reads.shape
    mc_f = match_counts(target, reads)
    mc_r = match_counts(target, _rc_reads(reads))
    best_f = torch.argmax(mc_f, dim=1)
    best_r = torch.argmax(mc_r, dim=1)
    nf = torch.gather(mc_f, 1, best_f[:, None])[:, 0]
    nr = torch.gather(mc_r, 1, best_r[:, None])[:, 0]
    use_r = nr > nf
    n_match = torch.where(use_r, nr, nf)
    raw_pos = torch.where(use_r, best_r, best_f).to(torch.int32)
    # pad-aware: padded tail of an rc'd read sits BEFORE the window start
    pad = (L - lengths).to(torch.int32)
    pos = torch.where(use_r, raw_pos + pad, raw_pos)
    mism = lengths.to(torch.int32) - n_match
    return pos, use_r, mism


def perfect_lookup(target: torch.Tensor, reads: torch.Tensor,
                   lengths: torch.Tensor, max_hits: int = 4):
    """All exact placements (both strands) of each read, up to max_hits.

    Returns (pos [N, max_hits], is_rc [N, max_hits], n_hits [N]); unused
    slots hold -1. (ref: PerfectLookup -- exhaustive exact placements.)
    """
    N, L = reads.shape
    mc_f = match_counts(target, reads)
    mc_r = match_counts(target, _rc_reads(reads))
    P = mc_f.shape[1]
    exact_f = mc_f == lengths[:, None]
    exact_r = mc_r == lengths[:, None]
    pad = (L - lengths).to(torch.int32)
    both = torch.cat([exact_f, exact_r], dim=1)  # [N, 2P]
    n_hits = both.sum(dim=1).to(torch.int32)
    # the max_hits smallest hit positions: iota where hit, 2P elsewhere
    iota = torch.arange(2 * P, dtype=torch.int32, device=reads.device)
    keyed = torch.where(both, iota[None, :], 2 * P)
    hits = torch.topk(keyed, max_hits, dim=1, largest=False,
                      sorted=True).values
    found = hits < 2 * P
    is_rc = found & (hits >= P)
    raw = torch.where(is_rc, hits - P, hits)
    pos = torch.where(found, torch.where(is_rc, raw + pad[:, None], raw), -1)
    return pos.to(torch.int32), is_rc, n_hits
