"""Pipeline CLI, the RunAllPathsLG analog (port of
allpathslg_tpu/pipeline/run.py).

Usage (simulated input, the built-in test oracle):
  python -m allpathslg_tpu_torch.pipeline.run --run-dir /tmp/run1 \\
      --sim-genome 100000 --coverage 50 --error-rate 0.005 \\
      [--jump-coverage 50 --jump-insert 3000 --jump-sd 300] \\
      [--long-jump-libs 12000:1200:6] [--pacbio-coverage 8] \\
      [--device cuda] [--k 96] [KEY=VALUE ...]

Real input:
  python -m allpathslg_tpu_torch.pipeline.run --run-dir /tmp/run2 \\
      --in-libs in_libs.csv --in-groups in_groups.csv [--ploidy 1] ...
  python -m allpathslg_tpu_torch.pipeline.run --run-dir /tmp/run3 \\
      --frag-fastq interleaved.fastq [more.fastq ...] ...

KEY=VALUE pairs override any AssemblyConfig field (ref: RunAllPathsLG's
ArachneArgs KEY=VALUE forwarding; `assist_ref=related.fasta` adds the
assisted stage). The run goes through `run_full` on `--device` (default
cuda).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from allpathslg_tpu_torch.eval import sim
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig
from allpathslg_tpu_torch.pipeline.rundir import RunDir
from allpathslg_tpu_torch.pipeline.stages import Pipeline


def _log_factory(rd: RunDir):
    logf = open(rd.file_path("pipeline.log"), "a")

    def log(*a):
        msg = " ".join(str(x) for x in a)
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"{stamp} {msg}"
        print(line, flush=True)
        logf.write(line + "\n")
        logf.flush()

    return log


def prepare_sim_inputs(rd: RunDir, genome_size: int, coverage: float,
                       error_rate: float, read_len: int, seed: int, log,
                       jump_coverage: float = 0.0, jump_insert: int = 3000,
                       jump_sd: int = 300, pacbio_coverage: float = 0.0,
                       jump_libs=None, long_jump_libs=None):
    """PrepareAllPathsInputs analog for simulated data; also stores the
    truth genome. Same seeds and artifacts as the reference.

    `jump_libs` is an optional list of (insert, sd, coverage) tuples for
    multi-library jump simulation; it supersedes the single
    jump_coverage/insert/sd knobs. `long_jump_libs` is a list of the same
    tuples for long-jump libraries; `pacbio_coverage` > 0 adds PacBio long
    reads."""
    genome = sim.random_genome(genome_size, seed=seed)
    batch, pairs, _ = sim.simulate_paired_reads(
        genome, coverage=coverage, read_len=read_len,
        error_rate=error_rate, seed=seed + 1)
    rd.save_arrays("frag_reads_orig",
                   codes=np.asarray(batch.codes),
                   lengths=np.asarray(batch.lengths),
                   quals=np.asarray(batch.quals),
                   pairs=np.asarray(pairs.pairs))
    rd.save_arrays("genome_truth", genome=genome)
    log(f"[prepare] simulated genome={genome_size} reads={batch.n_reads}")
    if jump_libs is None and jump_coverage > 0:
        jump_libs = [(jump_insert, jump_sd, jump_coverage)]
    if jump_libs:
        _save_jump_libs(rd, "jump_reads_orig", "jump", 2, genome,
                        read_len, error_rate, seed, log, jump_libs)
    if long_jump_libs:
        # long-jump (Fosill-class) libraries: the same outward chemistry,
        # much larger inserts
        _save_jump_libs(rd, "long_jump_reads_orig", "long-jump", 101,
                        genome, read_len, error_rate, seed, log,
                        long_jump_libs)
    if pacbio_coverage > 0:
        lr, _, _ = sim.simulate_long_reads(genome, coverage=pacbio_coverage,
                                           seed=seed + 3)
        flat = np.concatenate(lr) if lr else np.zeros(0, np.uint8)
        offs = np.zeros(len(lr) + 1, np.int64)
        np.cumsum([len(r) for r in lr], out=offs[1:])
        rd.save_arrays("long_reads_orig", bases=flat, offsets=offs)
        log(f"[prepare] simulated {len(lr)} PacBio long reads")


def _save_jump_libs(rd, artifact, label, seed_base, genome, read_len,
                    error_rate, seed, log, libs):
    """Simulates outward jump libraries [(insert, sd, coverage)] from
    `genome` (library li with seed seed + seed_base + 31 * li, as the
    reference's) and saves them as `artifact`."""
    parts = []
    for li, (ins, sd, cov) in enumerate(libs):
        jb, jp, _ = sim.simulate_paired_reads(
            genome, coverage=cov, read_len=read_len,
            error_rate=error_rate, insert_mean=ins,
            insert_sd=sd, outward=True, seed=seed + seed_base + 31 * li)
        parts.append((ins, sd, jb, jp))
        log(f"[prepare] simulated {label} lib {li} reads={jb.n_reads} "
            f"insert={ins}±{sd}")
    rd.save_arrays(artifact, **jump_lib_arrays(parts))


def jump_lib_arrays(parts) -> dict:
    """One jump artifact's arrays from simulated libraries
    [(insert, sd, ReadBatch, PairTable)]: reads padded to one length
    (code 4, quality 0), pairs renumbered into the pooled reads, lib_id
    by position in `parts`."""
    lmax = max(jb.codes.shape[1] for _, _, jb, _ in parts)
    n_at = 0
    codes, lens, quals, prs, libids = [], [], [], [], []
    for li, (_, _, jb, jp) in enumerate(parts):
        c = np.asarray(jb.codes)
        q = np.asarray(jb.quals)
        codes.append(np.pad(c, ((0, 0), (0, lmax - c.shape[1])),
                            constant_values=4))
        quals.append(np.pad(q, ((0, 0), (0, lmax - q.shape[1]))))
        lens.append(np.asarray(jb.lengths))
        prs.append(np.asarray(jp.pairs) + n_at)
        libids.append(np.full(len(jp.pairs), li, np.int32))
        n_at += jb.n_reads
    return dict(codes=np.concatenate(codes),
                lengths=np.concatenate(lens),
                quals=np.concatenate(quals),
                pairs=np.concatenate(prs),
                lib_id=np.concatenate(libids),
                lib_sep=np.array([p[0] for p in parts], np.int32),
                lib_sd=np.array([p[1] for p in parts], np.int32))


def prepare_fastq_inputs(rd: RunDir, fastqs, log):
    """FASTQ import through the native C++ reader (ref:
    PrepareAllPathsInputs.pl conversion path): the files' reads in order
    as one fragment library, paired by the interleaved convention (0, 1),
    (2, 3), ..."""
    from allpathslg_tpu_torch.io import native_fastq
    from allpathslg_tpu_torch.pipeline.prepare import _concat_reads

    codes, quals, lengths = _concat_reads(
        [native_fastq.read_fastq_arrays(p) for p in fastqs])
    n = codes.shape[0]
    pairs = np.stack([np.arange(0, n - 1, 2), np.arange(1, n, 2)],
                     1).astype(np.int32)
    rd.save_arrays("frag_reads_orig", codes=codes, lengths=lengths,
                   quals=quals, pairs=pairs)
    log(f"[prepare] imported {n} reads from {len(fastqs)} fastq files")


def _libspec(spec: str):
    """'ins:sd:cov,ins:sd:cov,...' -> [(ins, sd, cov), ...] or None."""
    return ([tuple(float(x) if i == 2 else int(x)
                   for i, x in enumerate(one.split(":")))
             for one in spec.split(",")] if spec else None)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="ALLPATHS-class assembler, PyTorch + CUDA port")
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sim-genome", type=int, default=0)
    ap.add_argument("--coverage", type=float, default=50.0)
    ap.add_argument("--error-rate", type=float, default=0.005)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frag-fastq", nargs="*", default=[])
    ap.add_argument("--in-libs", default="",
                    help="in_libs.csv library sheet (ref: "
                         "PrepareAllPathsInputs.pl)")
    ap.add_argument("--in-groups", default="",
                    help="in_groups.csv read-group sheet")
    ap.add_argument("--ploidy", type=int, default=1,
                    help="written to the run dir's ploidy file with the "
                         "sheets (the assembly's ploidy is ploidy=)")
    ap.add_argument("--jump-coverage", type=float, default=0.0)
    ap.add_argument("--jump-insert", type=int, default=3000)
    ap.add_argument("--jump-sd", type=int, default=300)
    ap.add_argument("--jump-libs", default="",
                    help="multi-library jump spec 'ins:sd:cov,ins:sd:cov,...'"
                         " (e.g. 3000:300:50,10000:1000:10)")
    ap.add_argument("--long-jump-libs", default="",
                    help="long-jump (Fosill-class) spec 'ins:sd:cov,...'"
                         " consumed by the second scaffolding pass")
    ap.add_argument("--pacbio-coverage", type=float, default=0.0,
                    help="PacBio long-read coverage")
    ap.add_argument("--k", type=int, default=96)
    ap.add_argument("overrides", nargs="*", help="KEY=VALUE config overrides")
    args = ap.parse_args(argv)

    over = {}
    for kv in args.overrides:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except ValueError:
            pass
        over[k] = v
    cfg = AssemblyConfig.from_overrides(K=args.k, **over)

    rd = RunDir(args.run_dir)
    log = _log_factory(rd)
    log(f"config: {cfg.to_json()}")

    if not rd.has("frag_reads_orig"):
        if args.sim_genome:
            prepare_sim_inputs(rd, args.sim_genome, args.coverage,
                               args.error_rate, args.read_len, args.seed, log,
                               jump_coverage=args.jump_coverage,
                               jump_insert=args.jump_insert,
                               jump_sd=args.jump_sd,
                               pacbio_coverage=args.pacbio_coverage,
                               jump_libs=_libspec(args.jump_libs),
                               long_jump_libs=_libspec(args.long_jump_libs))
        elif args.in_libs and args.in_groups:
            from allpathslg_tpu_torch.pipeline.prepare import prepare_inputs
            prepare_inputs(rd, args.in_libs, args.in_groups,
                           ploidy=args.ploidy, log=log)
        elif args.frag_fastq:
            prepare_fastq_inputs(rd, args.frag_fastq, log)
        else:
            ap.error("need --sim-genome, --in-libs/--in-groups or "
                     "--frag-fastq (or an existing run dir)")

    pipe = Pipeline(rd, cfg, log, device=args.device)
    final = pipe.run_full()
    log(f"final: {final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
