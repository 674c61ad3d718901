"""Jump (mate-pair) library error correction (port of
allpathslg_tpu/ec/jump.py).

Behavior contract (ref: src/paths/ErrorCorrectJump.cc + FirstLookup):
jump reads chimerize mid-read at the circularization junction, so only the
aligned *prefix* is trusted: truncate each read at its first untrusted
window against the strong kmer set of the corrected fragment reads, flip
outies to innies, and drop duplicate and unalignable pairs (jump libraries
have high molecular-duplicate rates).

The prefix truncation is spectrum_ec.clean_reads (the strong-window
membership scan and trim); the flip is a gather. Both run on the device of
the strong table, in fixed-size batches; deduplication is on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.dtypes import packed as _pk
from allpathslg_tpu_torch.dtypes.reads import PAD_CODE
from allpathslg_tpu_torch.ec import spectrum_ec as sec


@dataclasses.dataclass(frozen=True)
class JumpECConfig:
    K: int = 24
    min_prefix_len: int = 40    # drop mates with shorter trusted prefix
    dedupe: bool = True


def flip_reads(codes: torch.Tensor, quals: torch.Tensor,
               lengths: torch.Tensor):
    """Reverse-complement every read in place (outie -> innie convention)."""
    N, L = codes.shape
    idx = torch.arange(L, dtype=torch.int64, device=codes.device)[None, :]
    src = lengths.long()[:, None] - 1 - idx
    srcc = src.clamp(0, L - 1)
    c = torch.gather(codes, 1, srcc)
    c = torch.where((src >= 0) & (c < 4), 3 - c,
                    torch.full_like(c, PAD_CODE)).to(torch.uint8)
    q = torch.gather(quals, 1, srcc)
    q = torch.where(src >= 0, q, torch.zeros_like(q)).to(torch.uint8)
    return c, q


def error_correct_jumps(codes, quals, lengths, pairs, table,
                        cfg: JumpECConfig = JumpECConfig(),
                        batch_size: int = 65536, device="cuda"):
    """Returns (codes, quals, lengths, pair_ok, metrics). Rows are kept
    aligned with the input (dropped reads get length 0). `table` is the
    strong-kmer HashedTable on `device`; reads stream in batches of
    `batch_size`, uploaded 2-bit packed."""
    codes_np = np.asarray(codes)
    quals_np = np.asarray(quals)
    lens_np = np.asarray(lengths)
    n, L = codes_np.shape
    ccfg = sec.SpectrumECConfig(K=cfg.K, min_tail_len=cfg.min_prefix_len)
    fcodes = np.empty_like(codes_np)
    fquals = np.empty_like(quals_np)
    ln = np.empty(n, lens_np.dtype)
    with trace.span("jump_ec.truncate") as sp:
        sp.add("reads", n)
        sp.add("bytes", codes_np.nbytes + quals_np.nbytes)
        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            cb, qb, lb = codes_np[s:e], quals_np[s:e], lens_np[s:e]
            if e - s < batch_size:
                pad = batch_size - (e - s)
                cb = np.concatenate([cb, np.full((pad, L), 4, cb.dtype)])
                qb = np.concatenate([qb, np.zeros((pad, L), qb.dtype)])
                lb = np.concatenate([lb, np.zeros(pad, lb.dtype)])
            dc = _pk.device_codes(cb, device)
            dq = _pk.device_quals(qb, device)
            dl = torch.from_numpy(np.ascontiguousarray(lb)).to(device)
            # 1. trusted-prefix truncation at the chimeric junction: trim
            #    from the START of the read (the sequencing end);
            #    clean_reads keeps the leading strong span, which is the
            #    trusted prefix here
            tcodes, tlens, _ = sec.clean_reads(dc, dl, table, ccfg)
            # the kept span keeps the original leading quals of its length
            # (jump quals only order dedup priority)
            keep = (torch.arange(L, device=dq.device)[None, :]
                    < tlens[:, None])
            tquals = torch.where(keep, dq,
                                 torch.zeros_like(dq)).to(torch.uint8)
            # 2. flip outies -> innies
            fc, fq = flip_reads(tcodes, tquals, tlens)
            fcodes[s:e] = fc.cpu().numpy()[: e - s]
            fquals[s:e] = fq.cpu().numpy()[: e - s]
            ln[s:e] = tlens.cpu().numpy()[: e - s]

    # 3. pair survival: both mates long enough
    p = np.asarray(pairs)
    pair_ok = ((ln[p[:, 0]] >= cfg.min_prefix_len)
               & (ln[p[:, 1]] >= cfg.min_prefix_len))

    # 4. molecular-duplicate removal on trusted prefixes: the reference's
    #    own keys (Python `hash` of the prefix bytes), so both packages
    #    pick the same first pair of each duplicate set in one process
    n_dup = 0
    if cfg.dedupe and len(p):
        with trace.span("jump_ec.dedup") as sp:
            sp.add("pairs", len(p))
            pre = min(cfg.min_prefix_len, fcodes.shape[1])
            h1 = np.array([hash(fcodes[i, :pre].tobytes())
                           for i in p[:, 0]])
            h2 = np.array([hash(fcodes[i, :pre].tobytes())
                           for i in p[:, 1]])
            _, first = np.unique(np.stack([h1, h2], 1), axis=0,
                                 return_index=True)
            dup = np.ones(len(p), bool)
            dup[first] = False
            n_dup = int((dup & pair_ok).sum())
            pair_ok &= ~dup

    out_lens = ln.copy()
    bad_reads = np.ones(n, bool)
    bad_reads[p[pair_ok, 0]] = False
    bad_reads[p[pair_ok, 1]] = False
    out_lens[bad_reads] = 0

    metrics = {
        "n_pairs_in": int(len(p)),
        "n_pairs_kept": int(pair_ok.sum()),
        "n_duplicates": n_dup,
    }
    return fcodes, fquals, out_lens, pair_ok, metrics
