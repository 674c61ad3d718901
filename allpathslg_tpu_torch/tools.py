"""Standalone utility CLI (port of allpathslg_tpu/tools.py).

Subcommands mirror the reference's ad-hoc executables:
  stats        read-set statistics                  (ref: FastbStats)
  search       find a query sequence in a FASTA     (ref: SearchFastb2)
  mutate       mutated copy of a reference genome   (ref: MutateReference)
  simulate     simulated paired reads from a FASTA  (ref: paths/simulation)
  kspec        k-mer spectrum + genome size report  (ref: KmerSpectra CLI use)
  convert      fastq/fasta/sam <-> npz read arrays  (ref: Fastb converters)
  align        place reads on a target FASTA        (ref: QueryLookupTable)
  longproto    region assembly from longer reads    (ref: LongProto)

Usage: python -m allpathslg_tpu_torch.tools <subcommand> [args]

kspec, align and longproto take `--device` (default cuda): kspec's count,
align's index, votes and rescue (the bit-parallel banded DP) and
longproto's friend finding, count and graph run there. The output is the
reference's, byte for byte.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def cmd_stats(args):
    from allpathslg_tpu_torch.io import native_fastq, fasta as fio

    if args.path.endswith((".fastq", ".fq", ".fastq.gz", ".fq.gz")):
        codes, quals, lengths = native_fastq.read_fastq_arrays(args.path)
        lens = lengths
        qmean = float(quals[quals > 0].mean()) if (quals > 0).any() else 0.0
    else:
        recs = fio.read_fasta(args.path)
        lens = np.array([len(s) for _, s in recs])
        qmean = None
    from allpathslg_tpu_torch.eval import stats

    out = {
        "n_reads": int(len(lens)),
        "total_bases": int(lens.sum()),
        "min_len": int(lens.min()) if len(lens) else 0,
        "max_len": int(lens.max()) if len(lens) else 0,
        "mean_len": round(float(lens.mean()), 1) if len(lens) else 0,
        "n50": stats.n50(lens),
    }
    if qmean is not None:
        out["mean_qual"] = round(qmean, 1)
    print(json.dumps(out))


def cmd_longproto(args):
    """LongProto-style region assembly from a FASTQ of longer reads
    (ref: src/paths/long/LongProto.cc entry point)."""
    from allpathslg_tpu_torch.io import native_fastq, fasta as fio
    from allpathslg_tpu_torch.long import longproto as lp

    codes, quals, lengths = native_fastq.read_fastq_arrays(args.reads)
    cfg = lp.LongProtoConfig(K=args.k, ploidy=args.ploidy)
    res = lp.long_proto(codes, cfg, device=args.device)
    recs = [(f"contig_{i}", s) for i, s in enumerate(res.contigs.seqs)]
    out = args.out or "longproto.contigs.fasta"
    fio.write_fasta(out, recs)
    print(json.dumps({"n_reads": int(codes.shape[0]),
                      "n_contigs": len(recs),
                      "total_bases": int(sum(len(s) for _, s in recs)),
                      "out": out, **res.metrics}))


def cmd_search(args):
    from allpathslg_tpu_torch.io import fasta as fio
    from allpathslg_tpu_torch.dtypes.reads import codes_from_string

    recs = fio.read_fasta(args.fasta)
    q = codes_from_string(args.query.upper())
    qs = "".join(map(str, q))
    rqs = "".join(map(str, (3 - q)[::-1]))
    for name, seq in recs:
        hay = "".join(map(str, seq))
        for pat, strand in ((qs, "+"), (rqs, "-")):
            at = hay.find(pat)
            while at >= 0:
                print(f"{name}\t{at}\t{strand}")
                at = hay.find(pat, at + 1)


def cmd_mutate(args):
    from allpathslg_tpu_torch.io import fasta as fio
    from allpathslg_tpu_torch.eval import sim

    recs = fio.read_fasta(args.fasta)
    out = []
    for name, seq in recs:
        out.append((name + "_mut",
                    sim.mutate_genome(seq, args.snp_rate, seed=args.seed)))
    fio.write_fasta(args.out, out)
    print(f"wrote {args.out}")


def cmd_simulate(args):
    from allpathslg_tpu_torch.io import fasta as fio
    from allpathslg_tpu_torch.eval import sim

    recs = fio.read_fasta(args.fasta)
    genome = np.concatenate([s for _, s in recs])
    batch, pairs, truth = sim.simulate_paired_reads(
        genome, coverage=args.coverage, read_len=args.read_len,
        insert_mean=args.insert, insert_sd=args.insert_sd,
        error_rate=args.error_rate, seed=args.seed)
    codes = np.asarray(batch.codes)
    quals = np.asarray(batch.quals)
    lengths = np.asarray(batch.lengths)
    fio.write_fastq(args.out, ((f"read_{i}", codes[i, : lengths[i]],
                                quals[i, : lengths[i]])
                               for i in range(batch.n_reads)))
    print(f"wrote {batch.n_reads} reads to {args.out}")


def cmd_kspec(args):
    from allpathslg_tpu_torch.io import native_fastq
    from allpathslg_tpu_torch.models.flagship import spectrum_step
    from allpathslg_tpu_torch.kmer import spectrum as kspec

    codes, quals, lengths = native_fastq.read_fastq_arrays(args.fastq)
    spec, nu = spectrum_step(torch.from_numpy(codes).to(args.device),
                             K=args.k, max_freq=255)
    a = kspec.analyze(spec.cpu().numpy())
    print(json.dumps({
        "k": args.k, "n_distinct": a.n_distinct,
        "genome_size_est": a.genome_size_est,
        "coverage_est": a.coverage_est, "valley": a.valley, "peak": a.peak,
        "frac_repetitive": round(a.frac_repetitive, 4),
    }))


def cmd_convert(args):
    """Format converters (ref: Fastb / Fasta2Fastb / FastbQualbToFastq —
    SURVEY.md §2.6): fastq/fasta/sam → npz read arrays, npz → fastq/fasta."""
    from allpathslg_tpu_torch.io import fasta as fio

    src, dst = args.src, args.out
    if src.endswith((".fastq", ".fq", ".fastq.gz", ".fq.gz")):
        from allpathslg_tpu_torch.io import native_fastq
        codes, quals, lengths = native_fastq.read_fastq_arrays(src)
        pairs = None
    elif src.endswith((".sam", ".sam.gz", ".bam")):
        from allpathslg_tpu_torch.io import sam as samio
        rd = samio.read_bam if src.endswith(".bam") else samio.read_sam
        codes, quals, lengths, pairs, _ = rd(src)
    elif src.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        recs = fio.read_fasta(src)
        lengths = np.asarray([len(s) for _, s in recs], np.int32)
        lmax = int(lengths.max()) if len(recs) else 0
        codes = np.full((len(recs), lmax), 4, np.uint8)
        for i, (_, s) in enumerate(recs):
            codes[i, : len(s)] = s
        quals = np.full_like(codes, 30)
        pairs = None
    elif src.endswith(".npz"):
        z = np.load(src)
        codes, lengths = z["codes"], z["lengths"]
        quals = z["quals"] if "quals" in z.files else None
        if dst.endswith((".fastq", ".fq")):
            q = quals if quals is not None else np.full_like(codes, 30)
            fio.write_fastq(dst, ((f"read_{i}", codes[i, : lengths[i]],
                                   q[i, : lengths[i]])
                                  for i in range(codes.shape[0])))
        else:
            fio.write_fasta(dst, [(f"read_{i}", codes[i, : lengths[i]])
                                  for i in range(codes.shape[0])])
        print(f"wrote {codes.shape[0]} reads to {dst}")
        return
    else:
        raise SystemExit(f"unsupported source format: {src}")
    out = {"codes": codes, "lengths": lengths, "quals": quals}
    if pairs is not None and len(pairs):
        out["pairs"] = pairs
    np.savez(dst if dst.endswith(".npz") else dst + ".npz",
             **{k: v for k, v in out.items() if v is not None})
    print(f"wrote {codes.shape[0]} reads to {dst}")


def cmd_align(args):
    """Standalone aligner CLI (ref: MakeLookupTable + QueryLookupTable —
    SURVEY.md §2.6): place reads on a target FASTA; TSV of look_align-style
    records (read, contig, pos, strand, mismatches, aligned)."""
    from allpathslg_tpu_torch.align import lookup as alook
    from allpathslg_tpu_torch.io import fasta as fio
    from allpathslg_tpu_torch.io import native_fastq

    recs = fio.read_fasta(args.target)
    bases = np.concatenate([s for _, s in recs])
    offsets = np.zeros(len(recs) + 1, np.int64)
    np.cumsum([len(s) for _, s in recs], out=offsets[1:])
    if args.reads.endswith((".fa", ".fasta")):
        rr = fio.read_fasta(args.reads)
        lengths = np.asarray([len(s) for _, s in rr], np.int32)
        lmax = int(lengths.max())
        codes = np.full((len(rr), lmax), 4, np.uint8)
        for i, (_, s) in enumerate(rr):
            codes[i, : len(s)] = s
    else:
        codes, _, lengths = native_fastq.read_fastq_arrays(args.reads)
    index = alook.build_index(bases, offsets, K=args.k, device=args.device)
    acfg = alook.AlignConfig(K=args.k)
    B = 4096
    n = codes.shape[0]
    pad = (-n) % B
    if pad:
        codes = np.concatenate([codes, np.full((pad, codes.shape[1]), 4,
                                               np.uint8)])
        lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
    for s in range(0, n + pad, B):
        c, d, o, mm, ok = alook.align_reads(index, codes[s:s + B],
                                            lengths[s:s + B], acfg, bases)
        for i in range(min(B, n - s)):
            r = s + i
            strand = "-" if o[i] else "+"
            print(f"read_{r}\t{recs[c[i]][0] if ok[i] else '*'}\t"
                  f"{int(d[i]) if ok[i] else -1}\t{strand}\t{int(mm[i])}\t"
                  f"{int(ok[i])}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="allpathslg_tpu_torch.tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("stats")
    p.add_argument("path")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("search")
    p.add_argument("fasta")
    p.add_argument("query")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("mutate")
    p.add_argument("fasta")
    p.add_argument("--out", required=True)
    p.add_argument("--snp-rate", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_mutate)

    p = sub.add_parser("simulate")
    p.add_argument("fasta")
    p.add_argument("--out", required=True)
    p.add_argument("--coverage", type=float, default=50)
    p.add_argument("--read-len", type=int, default=100)
    p.add_argument("--insert", type=int, default=180)
    p.add_argument("--insert-sd", type=int, default=18)
    p.add_argument("--error-rate", type=float, default=0.005)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("kspec")
    p.add_argument("fastq")
    p.add_argument("--k", type=int, default=25)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_kspec)

    p = sub.add_parser("convert")
    p.add_argument("src")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("longproto")
    p.add_argument("reads")
    p.add_argument("--k", type=int, default=48)
    p.add_argument("--ploidy", type=int, default=1)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_longproto)

    p = sub.add_parser("align")
    p.add_argument("reads")
    p.add_argument("target")
    p.add_argument("--k", type=int, default=24)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_align)

    args = ap.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
