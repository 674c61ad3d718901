"""Time the two k-mer count engines on this device and persist the faster
one through tuning.save (port of scripts/tune_count.py).

    python -m allpathslg_tpu_torch.tune_count [--dry] [--device cuda|cpu]

The shape is the reference's: 131,072 random reads x 150 bp at K=24
(16,646,144 k-mers), REP batches a round with the input varied each
batch, the best of 3 rounds after a warm-up. "flat" is
kmer/count.spectrum_reads (one radix sort); "bucketed" is
ops/bucket_count.spectrum_grouped (batched row sorts), which loses when a
slab overflows. Each engine is printed as ms a batch and M k-mers/s, and
the last line of the output is a JSON object of the result. The winner
goes to the per-user tuning file (tuning.py), never into the checkout;
`--dry` writes nothing. Runs on the card unless `--device cpu` is given,
and raises without CUDA otherwise. `--reads`, `--read-len` and `--reps`
shrink the run (for a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from allpathslg_tpu_torch import tuning
from allpathslg_tpu_torch.kmer import count as kcount
from allpathslg_tpu_torch.ops import bucket_count

REP = 8
K = 24
N_READS, READ_LEN = 131072, 150
ROUNDS = 3


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure(device: str = "cuda", n_reads: int = N_READS,
            read_len: int = READ_LEN, reps: int = REP) -> dict:
    """Times both engines on `device`: {"device", "kmers", "plan": [N, R,
    B, S], "flat_ms", "bucketed_ms" (ms a batch; None when a slab
    overflowed), "flat_mkmers_s", "bucketed_mkmers_s", "winner"}."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tune_count: no CUDA device (pass device='cpu' "
                           "to time the plain versions)")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    _log(f"device: {name}")
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(
        rng.integers(0, 4, (n_reads, read_len)).astype(np.uint8)).to(dev)
    kmers = n_reads * (read_len - K + 1)
    N, R, B, S = bucket_count.grouping_plan(kmers)
    _log(f"bucketed plan: N={N} R={R} B={B} S={S}")

    def flat():
        tot = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(reps):
            codes[0, 0] = i % 4
            _, nu = kcount.spectrum_reads(codes, K, 255)
            tot += nu
        return int(tot)

    def bucketed():
        tot = torch.zeros((), dtype=torch.int64, device=dev)
        all_ok = torch.ones((), dtype=torch.bool, device=dev)
        for i in range(reps):
            codes[0, 0] = i % 4
            words = bucket_count._pad_to(kcount._kmer_flat(codes, K), N)
            _, nu, ok = bucket_count.spectrum_grouped(words, R, B, S, 255)
            tot += nu
            all_ok &= ok
        return int(tot) if bool(all_ok) else -1

    def sustained(label, fn):
        fn()
        ts = []
        for _ in range(ROUNDS):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()                        # ends in a read to the host
            ts.append(time.perf_counter() - t0)
        dt = min(ts) / reps
        _log(f"{label:28s} {dt * 1e3:8.2f} ms/batch  "
             f"{kmers / dt / 1e6:8.1f} Mkmers/s")
        return dt

    t_flat = sustained("flat radix sort", flat)
    if bucketed() < 0:
        _log("bucketed: slab overflow at this shape -> keeping flat")
        t_b = None
        winner = "flat"
    else:
        t_b = sustained("bucketed row sorts", bucketed)
        winner = "bucketed" if t_b < t_flat else "flat"
    _log(f"winner: {winner}")
    return {"device": name, "kmers": kmers, "plan": [N, R, B, S],
            "flat_ms": t_flat * 1e3,
            "bucketed_ms": None if t_b is None else t_b * 1e3,
            "flat_mkmers_s": kmers / t_flat / 1e6,
            "bucketed_mkmers_s": None if t_b is None else kmers / t_b / 1e6,
            "winner": winner}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dry", action="store_true",
                    help="print the winner; write no tuning file")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--read-len", type=int, default=READ_LEN)
    ap.add_argument("--reps", type=int, default=REP)
    args = ap.parse_args(argv)
    res = measure(args.device, args.reads, args.read_len, args.reps)
    if not args.dry:
        res["wrote"] = tuning.save({"count_engine": res["winner"]})
        _log(f"wrote {res['wrote']}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
