"""Pipeline stages (port of allpathslg_tpu/pipeline/stages.py):

  validate_inputs     (ref: ValidateAllPathsInputs)
  remove_dodgy        (ref: RemoveDodgyReads)
  precorrect          (ref: FindErrors phase 1 / PreCorrect)
  find_errors         (ref: FindErrors phase 2)
  clean_reads         (ref: CleanCorrectedReads)
  fill_fragments      (ref: FillFragments)
  unipaths            (ref: CommonPather + Unipather at K=96, localization,
                       cleanup)
  jump_ec             (ref: ErrorCorrectJump)
  align_jumps         (ref: AlignPairsToHyper for the jump libraries,
                       SamplePairedReadDistributions)
  make_scaffolds      (ref: MakeScaffolds + RemodelGaps +
                       TagCircularScaffolds)
  align_frags         (ref: AlignPairsToHyper for the fragment library)
  long_jump_scaffolds (ref: MakeScaffolds' later passes with long-jump
                       libraries)
  patch_gaps          (ref: PostPatcher)
  long_read_patch     (ref: LongReadPostPatcher, PacBio consensus patches)
  assisted            (ref: AssistedPatcher, an assisting reference)
  polish              (ref: FixSomeIndels / FixLocal)
  clean_final         (ref: CleanAssembly)
  evaluate            (ref: AssemblyAccuracy, EVALUATION=STANDARD/FULL)
  finalize            (ref: FlattenHKP -> final.assembly.{fasta,efasta})
  submission_prep     (ref: SubmissionPrep)
  report              (ref: reporting/ BasicAssemblyStats -> assembly.report)

`run_contig_slice` runs the first seven and the report in order;
`run_full` runs the whole DAG with `stage_workers` threads. Each stage
writes the same named artifacts to the run directory as the reference,
byte for byte, and resumes from the same manifest. The stages run on the
torch device the Pipeline is given; the read set is uploaded once and
stays resident on it across the EC stages (dtypes/devcache).

Diagnostics: check_mode holds validate_inputs' spectrum of the first 512
reads against the Python oracle (eval/oracle.py); evaluation="CHEAT" adds
the truth metrics of find_errors and unipaths; profile_dir writes a
torch.profiler trace of each stage to `{profile_dir}/{stage}/`, with the
program's spans (allpathslg_tpu_torch/trace.py) in it. With
n_devices > 1 the counting and K-table stages run on a mesh of that many
shards on the Pipeline's device (parallel/*): validate_inputs' spectra
and find_errors' rounds through hash-routed counting, unipaths' K table
through the distributed sample sort and its chain sums through the ring
scan; every artifact equals the 1-device run's.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.dtypes import packed as _packed
from allpathslg_tpu_torch.dtypes.devcache import DeviceBatches
from allpathslg_tpu_torch.dtypes.reads import batch_from_codes
from allpathslg_tpu_torch.ec import precorrect as pc
from allpathslg_tpu_torch.ec import spectrum_ec as sec
from allpathslg_tpu_torch.eval import stats
from allpathslg_tpu_torch.graph import unipath
from allpathslg_tpu_torch.io import fasta as fio
from allpathslg_tpu_torch.kmer import count as kcount
from allpathslg_tpu_torch.kmer import spectrum as kspec
from allpathslg_tpu_torch.ops import join
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig
from allpathslg_tpu_torch.pipeline.rundir import RunDir

# the reference's input-validation kmer size: per-library 25-mer spectra
# (ref: ValidateAllPathsInputs 25-mer kspec) — distinct from the EC K_ec
K_VALIDATE = 25
# profile_dir opens one torch.profiler session at a time (torch allows one
# a process): a stage that starts while another stage's session is open
# runs inside that session, and its spans go into that stage's trace
_PROFILE_LOCK = threading.Lock()


def _dup_pair_mask(codes: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """True for every pair whose exact (r1,r2) base content already appeared
    at a lower pair index. Packs bases 21-per-uint64 (3 bits, codes 0..4)
    column-wise, then a stable lexsort over the integer key columns (ref:
    RemoveDodgyReads exact-duplicate-pair removal)."""
    P = len(pairs)
    L = codes.shape[1]
    per = 21
    nw = (2 * L + per - 1) // per
    words = np.zeros((P, nw), np.uint64)
    r1 = codes[pairs[:, 0]]
    r2 = codes[pairs[:, 1]]
    for col in range(2 * L):
        src = r1[:, col] if col < L else r2[:, col - L]
        w, k = divmod(col, per)
        words[:, w] |= src.astype(np.uint64) << np.uint64(3 * k)
    order = np.lexsort(words.T[::-1])  # stable; word 0 most significant
    sw = words[order]
    is_first = np.ones(P, bool)
    if P > 1:
        is_first[1:] = (sw[1:] != sw[:-1]).any(axis=1)
    dup = np.zeros(P, bool)
    dup[order] = ~is_first
    return dup


def _pad_batch(arr, batch_size, pad_value):
    n = arr.shape[0]
    if n % batch_size == 0:
        return arr, n
    pad = batch_size - n % batch_size
    padding = np.full((pad,) + arr.shape[1:], pad_value, dtype=arr.dtype)
    return np.concatenate([arr, padding]), n


def _contig_list(u) -> List[np.ndarray]:
    """Per-contig views of flat contig arrays (bases, offsets)."""
    offs = u["offsets"]
    return [u["bases"][offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]


def _flatten(contigs) -> Tuple[np.ndarray, np.ndarray]:
    """(flat uint8 bases, int64 offsets [n + 1]) of a contig list."""
    bases = (np.concatenate([np.asarray(c) for c in contigs]) if contigs
             else np.zeros(0, np.uint8))
    offsets = np.zeros(len(contigs) + 1, np.int64)
    np.cumsum([len(c) for c in contigs], out=offsets[1:])
    return bases, offsets


class StageTimeout(Exception):
    """A stage exceeded cfg.stage_timeout_s (raised IN the stage thread)."""


class _StageWatchdog:
    """Per-stage heartbeat + wall-clock guard.

    A daemon thread logs `[stage] heartbeat ...` every heartbeat_s, and —
    when timeout_s > 0 — async-raises StageTimeout in the thread running
    the stage once wall-clock exceeds it. The stage fails before mark_done,
    so the manifest resumes exactly there. The raise lands at the next
    Python bytecode, so a stage blocked inside one long native call dies
    only when it returns; the heartbeat still makes the stall visible."""

    def __init__(self, name, t0, heartbeat_s, timeout_s, log):
        import threading
        self._stop = threading.Event()
        self._thread = None
        polls = [x for x in (heartbeat_s, timeout_s) if x and x > 0]
        if not polls:
            return
        target_tid = threading.get_ident()

        def watch():
            poll = max(0.25, min(polls) / 4.0)
            next_beat = heartbeat_s if heartbeat_s else float("inf")
            while not self._stop.wait(poll):
                dt = time.time() - t0
                if timeout_s and dt > timeout_s:
                    log(f"[{name}] WATCHDOG: {dt:.0f}s > stage_timeout_s="
                        f"{timeout_s}; raising StageTimeout in stage thread")
                    import ctypes
                    ctypes.pythonapi.PyThreadState_SetAsyncExc(
                        ctypes.c_ulong(target_tid),
                        ctypes.py_object(StageTimeout))
                    return
                if dt >= next_beat:
                    log(f"[{name}] heartbeat: running for {dt:.0f}s")
                    next_beat += heartbeat_s

        self._thread = threading.Thread(target=watch, daemon=True,
                                        name=f"watchdog-{name}")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class Pipeline:
    """Stage DAG executor with manifest-based resume (ref: make dependency
    semantics of RunAllPathsLG), on one explicit torch device (a mesh of
    n_devices shards on it when n_devices > 1)."""

    def __init__(self, rd: RunDir, cfg: AssemblyConfig, log: Callable = print,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Pipeline(device={device!r}): no CUDA device")
        self.rd = rd
        self.cfg = cfg
        self.log = log
        # device-resident packed read batches shared ACROSS stages: reads
        # upload once and corrected codes stay on the device
        self._read_cache = {}
        self._mesh = None
        if cfg.n_devices > 1:
            # counting + K-table stages run mesh-distributed (hash-routed
            # all_to_all counting / distributed sample sort); all other
            # stages are unchanged and artifacts equal the 1-device run's
            from allpathslg_tpu_torch.parallel import mesh as pmesh
            self._mesh = pmesh.make_mesh(cfg.n_devices, self.device)
            self.log(f"[pipeline] mesh: {cfg.n_devices} devices "
                     f"({self._mesh.platform})")

    def _resident_batches(self, art: str, quals: bool = True):
        """Device-resident packed batches of artifact `art` (one upload;
        reused by later stages via _register_resident)."""
        db = self._read_cache.get(art)
        if db is None:
            a = self.rd.load_arrays(art, mmap=True)
            db = DeviceBatches.from_host(
                a["codes"], a["quals"] if quals and "quals" in a else None,
                self.cfg.batch_reads, device=self.device)
            self._read_cache[art] = db
        return db

    def _register_resident(self, art: str, db, drop: str = None):
        """A stage's corrected resident batches become the OUTPUT
        artifact's cache (the input name is dropped: its codes were
        replaced in place)."""
        if drop:
            self._read_cache.pop(drop, None)
        self._read_cache[art] = db

    def _count_streaming(self, codes, K, quals=None, **kw):
        """Counting router: 1 device -> kmer.count.count_reads_streaming;
        mesh -> parallel.dist_count.count_reads_streaming_dist (identical
        tables either way)."""
        if self._mesh is None:
            return kcount.count_reads_streaming(
                codes, K, quals, batch_size=self.cfg.batch_reads,
                device=self.device, **kw)
        from allpathslg_tpu_torch.parallel import dist_count as dcount
        return dcount.count_reads_streaming_dist(
            self._mesh, codes, K, quals=quals,
            batch_size=self.cfg.batch_reads, **kw)

    def run_stage(self, name: str, inputs_hash: str, outputs: List[str], fn):
        if self.rd.stage_done(name, inputs_hash, outputs):
            self.log(f"[{name}] up to date, skipping")
            return self.rd.metrics(name)
        if self.cfg.fault_stage == name:
            # fault-injection hook: the stage dies before any output is
            # marked; a rerun must resume exactly here
            raise RuntimeError(f"injected fault in stage {name}")
        t0 = time.time()
        self.log(f"[{name}] running...")
        watch = _StageWatchdog(name, t0, self.cfg.stage_heartbeat_s,
                               self.cfg.stage_timeout_s, self.log)

        def traced():
            with trace.stage(name, run=self.rd.path):
                return fn() or {}

        try:
            if self.cfg.profile_dir:
                metrics = self._profiled(name, traced)
            else:
                metrics = traced()
        finally:
            watch.stop()
        dt = time.time() - t0
        self.rd.mark_done(name, inputs_hash, outputs, metrics, dt)
        self.log(f"[{name}] done in {dt:.1f}s {metrics}")
        return metrics

    # ---- stages ----

    def validate_inputs(self):
        cfg, rd = self.cfg, self.rd
        have_jumps = rd.has("jump_reads_orig")
        ih = rd.hash_of("validate", K_VALIDATE,
                        self._art_hash("frag_reads_orig"),
                        self._art_hash("jump_reads_orig") if have_jumps
                        else "nojump")

        def lib_row(spec, n_reads):
            ana = kspec.analyze(spec)
            return ana, {
                "n_reads": int(n_reads),
                "n_kmers_distinct": int(spec.sum()),
                "genome_size_est": ana.genome_size_est,
                "coverage_est": ana.coverage_est,
                "spectrum_valley": ana.valley,
                "spectrum_peak": ana.peak,
                "frac_repetitive": round(ana.frac_repetitive, 4),
            }

        def spectrum(codes):
            # spectrum-only streaming: the raw table is discarded per merge
            # pass; K is the reference's 25, independent of K_ec. int64
            # regardless of path (the device-resident path returns int32,
            # the merge path int64; artifact bytes must match)
            _, spec = self._count_streaming(
                codes, K_VALIDATE, min_count=1 << 30,
                spectrum_max_freq=cfg.max_freq)
            return np.asarray(spec, np.int64)

        def fn():
            a = rd.load_arrays("frag_reads_orig", mmap=True)
            batch = batch_from_codes(a["codes"], a["lengths"], a.get("quals"))
            spec = spectrum(np.asarray(batch.codes))
            ana, frag_row = lib_row(spec, batch.n_reads)
            arts = {"spectrum": spec}
            libs = {"frag": frag_row}
            if int(a["lengths"].min()) < cfg.K_ec:
                raise ValueError("reads shorter than K_ec")
            if cfg.check_mode:
                self._check_spectrum_oracle(batch, spec, K=K_VALIDATE)

            if have_jumps:
                j = rd.load_arrays("jump_reads_orig", mmap=True)
                jlens = np.asarray(j["lengths"])
                pairs = np.asarray(j["pairs"]) if "pairs" in j else None
                lib_id = np.asarray(j["lib_id"]) if "lib_id" in j else None
                # malformed-pairs contract (ref: ValidateAllPathsInputs
                # hard-fails on malformed pairs/quals)
                if pairs is not None and len(pairs):
                    if pairs.min() < 0 or pairs.max() >= len(jlens):
                        raise ValueError("jump pairs index out of range")
                    flat = pairs.reshape(-1)
                    if len(np.unique(flat)) != len(flat):
                        raise ValueError("jump read appears in two pairs")
                if int(jlens.min()) < cfg.K_ec:
                    raise ValueError("jump reads shorter than K_ec")
                n_libs = (int(lib_id.max()) + 1
                          if lib_id is not None and len(lib_id) else 1)
                for li in range(n_libs):
                    if lib_id is not None and pairs is not None:
                        ridx = np.sort(pairs[lib_id == li].reshape(-1))
                    else:
                        ridx = np.arange(len(jlens))
                    jspec = spectrum(np.asarray(j["codes"][ridx]))
                    jana, row = lib_row(jspec, len(ridx))
                    arts[f"spectrum_jump{li}"] = jspec
                    libs[f"jump{li}"] = row
                    # a jump library whose distinct-kmer mass implies a
                    # genome a tiny fraction of the frag estimate is
                    # malformed (duplicate/adapter-dominated or mislabeled)
                    if (ana.genome_size_est > 0 and
                            jana.genome_size_est < 0.2 * ana.genome_size_est):
                        raise ValueError(
                            f"jump lib {li}: 25-mer spectrum implies genome "
                            f"{jana.genome_size_est} < 20% of frag estimate "
                            f"{ana.genome_size_est}: malformed jump library")

            rd.save_arrays("kspec_25mer", **arts)
            return {**frag_row, "libraries": libs}

        return self.run_stage("validate_inputs", ih, ["kspec_25mer.npz"], fn)

    def remove_dodgy(self):
        """Drop exact-duplicate pairs and reads with many ambiguous bases
        (ref: RemoveDodgyReads — dedup, poly-A, N-rich)."""
        rd = self.rd
        ih = rd.hash_of("remove_dodgy", self._art_hash("frag_reads_orig"))

        def fn():
            a = rd.load_arrays("frag_reads_orig", mmap=True)
            codes, lengths = a["codes"], a["lengths"]
            quals = a.get("quals")
            pairs = a.get("pairs")
            n = codes.shape[0]
            n_amb = (codes == 4).sum(axis=1) - (codes.shape[1] - lengths)
            ok = n_amb <= 0.1 * np.maximum(lengths, 1)
            # poly-A guard: >90% A or >90% T
            frac_a = (codes == 0).sum(axis=1) / np.maximum(lengths, 1)
            frac_t = (codes == 3).sum(axis=1) / np.maximum(lengths, 1)
            ok &= (frac_a < 0.9) & (frac_t < 0.9)
            if pairs is not None and len(pairs):
                # duplicate pairs: identical (r1,r2) base content, exact
                with trace.span("dodgy.dup_pairs"):
                    dup = _dup_pair_mask(codes, pairs)
                ok[pairs[dup, 0]] = False
                ok[pairs[dup, 1]] = False
                # a pair survives only whole
                pair_bad = ~(ok[pairs[:, 0]] & ok[pairs[:, 1]])
                ok[pairs[pair_bad, 0]] = False
                ok[pairs[pair_bad, 1]] = False
            lengths = np.where(ok, lengths, 0).astype(np.int32)
            out = {"codes": codes, "lengths": lengths}
            if quals is not None:
                out["quals"] = quals
            if pairs is not None:
                out["pairs"] = pairs
                out["pair_ok"] = (ok[pairs[:, 0]] if len(pairs)
                                  else np.zeros(0, bool))
            rd.save_arrays("frag_reads_filt", **out)
            return {"n_reads_in": int(n), "n_reads_kept": int(ok.sum())}

        return self.run_stage("remove_dodgy", ih, ["frag_reads_filt.npz"], fn)

    def precorrect(self):
        cfg, rd = self.cfg, self.rd
        # algorithm-version salt, the reference's
        ih = rd.hash_of("precorrect-global-v2", str(cfg.precorrect),
                        self._art_hash("frag_reads_filt"))

        def fn():
            a = rd.load_arrays("frag_reads_filt", mmap=True)
            # global stacks: votes pool over ALL reads, not one batch
            db = self._resident_batches("frag_reads_filt")
            total = pc.precorrect_global_resident(db, cfg.precorrect,
                                                  log=self.log)
            rd.save_arrays("frag_reads_prec", codes=db.codes_to_host(),
                           lengths=a["lengths"], quals=a["quals"],
                           **({"pairs": a["pairs"]} if "pairs" in a else {}))
            self._register_resident("frag_reads_prec", db,
                                    drop="frag_reads_filt")
            return {"n_corrections": total}

        return self.run_stage("precorrect", ih, ["frag_reads_prec.npz"], fn)

    def find_errors(self):
        cfg, rd = self.cfg, self.rd
        ih = rd.hash_of("find_errors", str(cfg.spectrum_ec),
                        self._art_hash("frag_reads_prec"))

        def fn():
            a = rd.load_arrays("frag_reads_prec", mmap=True)
            ecfg = cfg.spectrum_ec
            # intra-stage per-round checkpoint: resuming re-seeds the
            # resident cache from the last completed round
            ck_file = rd.file_path("find_errors_progress.npz")
            start_round, total = 0, 0
            db = None
            if os.path.exists(ck_file):
                try:
                    ckp = np.load(ck_file)
                    if str(ckp["ih"]) == ih:
                        start_round = min(int(ckp["next_round"]),
                                          max(ecfg.rounds - 1, 0))
                        total = int(ckp["total"])
                        db = DeviceBatches.from_host(
                            ckp["codes"], a["quals"], cfg.batch_reads,
                            device=self.device)
                        self._read_cache["frag_reads_prec"] = db
                        self.log(f"  [find_errors] resuming at round "
                                 f"{start_round} from intra-stage "
                                 f"checkpoint")
                except (OSError, KeyError, ValueError) as e:
                    self.log(f"  [find_errors] checkpoint unreadable "
                             f"({e}); starting fresh")
            if db is None:
                # reads + quals stay device-resident across all rounds
                db = self._resident_batches("frag_reads_prec")
            # global strong table per round over all batches, then correct
            for r in range(start_round, ecfg.rounds):
                with trace.span("ec.round", round=r):
                    if cfg.fault_stage == f"find_errors@round{r}":
                        raise RuntimeError(
                            f"injected fault in find_errors round {r}")
                    # pre-filter to the strong thresholds during the streamed
                    # merge: the raw (reads x windows) table never materializes
                    if self._mesh is not None:
                        # the mesh path counts straight from the RESIDENT
                        # packed batches (rows split over the shards): no
                        # read-set host round-trip per round
                        from allpathslg_tpu_torch.parallel import \
                            dist_count as dcount
                        ck_acc = dcount.count_resident_streaming_dist(
                            self._mesh, db, ecfg.K,
                            min_count=ecfg.min_strong_count,
                            min_qsum=ecfg.min_strong_qsum)
                    else:
                        ck_acc = kcount.count_resident_streaming(
                            db, ecfg.K, min_count=ecfg.min_strong_count,
                            min_qsum=ecfg.min_strong_qsum)
                    table, n_strong = sec.strong_table(ck_acc, ecfg)
                    del ck_acc  # free the raw table before correction
                    tw_save = sec.compact_strong_table(table, int(n_strong))
                    table = join.hash_table(tw_save)
                    self.log(f"  [find_errors] round {r}: strong table built "
                             f"(scan depth H={table.H})")
                    n_round = 0
                    for i in range(db.n_batches):
                        ow, om, n = sec.correct_round_packed(
                            db.words[i], db.nmask[i], db.qnib[i], db.qpal[i],
                            db.L, table, ecfg)
                        db.update_codes(i, ow, om)
                        n_round += int(n)
                        if (i + 1) % 10 == 0:
                            self.log(f"  [find_errors] round {r}: corrected "
                                     f"{i + 1}/{db.n_batches} batches")
                    total += n_round
                    self.log(f"  [find_errors] round {r}: "
                             f"n_strong={int(n_strong)} fixes={n_round}")
                    if n_round < ecfg.min_round_fixes_frac * db.n_real:
                        break       # fixpoint reached (adaptive round cutoff)
                    if cfg.round_checkpoints and r + 1 < ecfg.rounds:
                        tmp = ck_file + ".tmp"
                        with open(tmp, "wb") as f:
                            np.savez(f, ih=ih, next_round=r + 1, total=total,
                                     codes=db.codes_to_host())
                        os.replace(tmp, ck_file)
                        self.log(f"  [find_errors] round {r}: checkpointed")
            np.save(rd.file_path("strong_table.npy"),
                    kcount._words_to_np(tw_save))
            out_codes = db.codes_to_host()
            extra = {}
            if self._cheat:
                before = self._cheat_true_kmer_frac(a["codes"], cfg.K_ec)
                after = self._cheat_true_kmer_frac(out_codes, cfg.K_ec)
                self.log(f"  [find_errors] CHEAT: true-kmer frac "
                         f"{before} -> {after}")
                extra = {"cheat_true_kmer_frac_before": before,
                         "cheat_true_kmer_frac_after": after}
            rd.save_arrays("frag_reads_edit", codes=out_codes,
                           lengths=a["lengths"], quals=a["quals"],
                           **({"pairs": a["pairs"]} if "pairs" in a else {}))
            self._register_resident("frag_reads_edit", db,
                                    drop="frag_reads_prec")
            if os.path.exists(ck_file):
                os.remove(ck_file)
            return {"n_corrections": total, "n_strong_kmers": int(n_strong),
                    **extra}

        return self.run_stage("find_errors", ih,
                              ["frag_reads_edit.npz", "strong_table.npy"], fn)

    def clean_reads(self):
        cfg, rd = self.cfg, self.rd
        ih = rd.hash_of("clean", str(cfg.spectrum_ec),
                        self._art_hash("frag_reads_edit"))

        def fn():
            a = rd.load_arrays("frag_reads_edit", mmap=True)
            ecfg = cfg.spectrum_ec
            table = self._strong_table()
            db = self._resident_batches("frag_reads_edit")
            lengths, n_real = _pad_batch(a["lengths"], cfg.batch_reads, 0)
            out_l = np.empty_like(lengths)
            kept = 0
            bs = cfg.batch_reads
            for i in range(db.n_batches):
                lb = torch.from_numpy(
                    np.ascontiguousarray(lengths[i * bs:(i + 1) * bs])
                ).to(self.device)
                ow, om, l, k = sec.clean_reads_packed(
                    db.words[i], db.nmask[i], lb, db.L, table, ecfg)
                db.update_codes(i, ow, om)
                out_l[i * bs:(i + 1) * bs] = l.cpu().numpy()
                kept += int(k)
            rd.save_arrays("frag_reads_corr", codes=db.codes_to_host(),
                           lengths=out_l[:n_real], quals=a["quals"],
                           **({"pairs": a["pairs"]} if "pairs" in a else {}))
            self._register_resident("frag_reads_corr", db,
                                    drop="frag_reads_edit")
            return {"n_reads_kept": kept}

        return self.run_stage("clean_reads", ih, ["frag_reads_corr.npz"], fn)

    def fill_fragments(self):
        """Merge overlapping fragment pairs into filled super-reads
        (ref: FillFragments); unfillable pairs pass through unchanged."""
        cfg, rd = self.cfg, self.rd
        from allpathslg_tpu_torch.asm import fill as afill

        ih = rd.hash_of("fill", self._art_hash("frag_reads_corr"))

        def fn():
            # the EC chain is done with the resident read cache: free its
            # device memory before the fill/count stages allocate theirs
            self._read_cache.clear()
            a = rd.load_arrays("frag_reads_corr", mmap=True)
            codes, lengths, quals = a["codes"], a["lengths"], a["quals"]
            pairs = a.get("pairs")
            if pairs is None or not len(pairs):
                rd.save_arrays("filled_reads", codes=codes, lengths=lengths,
                               quals=quals)
                return {"n_filled": 0, "n_passthrough": codes.shape[0]}
            fcfg = afill.FillConfig()
            out_len = fcfg.insert_hi
            P = len(pairs)
            B = max(1, cfg.batch_reads // 4)
            p_pad, n_real_p = _pad_batch(pairs, B, 0)
            m_codes = np.empty((len(p_pad), out_len), np.uint8)
            m_quals = np.empty((len(p_pad), out_len), np.uint8)
            m_len = np.empty(len(p_pad), np.int32)
            m_ok = np.empty(len(p_pad), bool)
            dev = self.device

            def lens(idx):
                return torch.from_numpy(lengths[idx]).to(dev)

            for s in range(0, len(p_pad), B):
                e = s + B
                pp = p_pad[s:e]
                # a batch's uploads, fill_pairs and the copies back
                with trace.span("fill.pairs", pairs=len(pp)):
                    c, q, l, ok = afill.fill_pairs(
                        _packed.device_codes(codes[pp[:, 0]], dev),
                        _packed.device_quals(quals[pp[:, 0]], dev),
                        lens(pp[:, 0]),
                        _packed.device_codes(codes[pp[:, 1]], dev),
                        _packed.device_quals(quals[pp[:, 1]], dev),
                        lens(pp[:, 1]), fcfg, out_len)
                    m_codes[s:e] = c.cpu().numpy()
                    m_quals[s:e] = q.cpu().numpy()
                    m_len[s:e] = l.cpu().numpy()
                    m_ok[s:e] = ok.cpu().numpy()
            m_codes = m_codes[:n_real_p]
            m_quals = m_quals[:n_real_p]
            m_len = m_len[:n_real_p]
            m_ok = m_ok[:n_real_p]
            # SamplePairedReadStats analog for the fragment library: estimate
            # the empirical insert distribution from confident fills, persist
            # the .distribs artifact, and reject fills whose insert size is
            # implausible under it (ref: FillFragments' distribution check)
            if int(m_ok.sum()) >= 200:
                from allpathslg_tpu_torch.utils.intdist import IntDistribution
                dist = IntDistribution.from_samples(m_len[m_ok])
                rd.save_arrays("frag_distribs", **dist.to_arrays())
                lp = dist.logpmf(m_len)
                implausible = m_ok & (lp < np.log(1e-5 / max(len(dist.pmf),
                                                             1)))
                m_ok = m_ok & ~implausible
            # output: filled rows + passthrough originals for failed pairs
            bad = ~m_ok
            pass_idx = np.concatenate([pairs[bad, 0], pairs[bad, 1]])
            L = codes.shape[1]
            pc_ = np.full((len(pass_idx), out_len), 4, np.uint8)
            pq_ = np.zeros((len(pass_idx), out_len), np.uint8)
            pc_[:, :L] = codes[pass_idx]
            pq_[:, :L] = quals[pass_idx]
            out_codes = np.concatenate([m_codes[m_ok], pc_])
            out_quals = np.concatenate([m_quals[m_ok], pq_])
            out_lens = np.concatenate([m_len[m_ok],
                                       lengths[pass_idx]]).astype(np.int32)
            rd.save_arrays("filled_reads", codes=out_codes, lengths=out_lens,
                           quals=out_quals)
            # filled lengths ARE the sampled insert sizes (ref:
            # SamplePairedReadStats for the fragment library)
            fl = m_len[m_ok]
            return {"n_pairs": int(P), "n_filled": int(m_ok.sum()),
                    "n_passthrough": int(len(pass_idx)),
                    "fill_rate": round(float(m_ok.mean()), 3),
                    "frag_insert_mean": (round(float(fl.mean()), 1)
                                         if len(fl) else 0),
                    "frag_insert_sd": (round(float(fl.std()), 1)
                                       if len(fl) else 0)}

        return self.run_stage("fill_fragments", ih, ["filled_reads.npz"], fn)

    def unipaths(self):
        cfg, rd = self.cfg, self.rd
        ih = rd.hash_of("unipaths", cfg.K, cfg.min_kmer_count,
                        self._art_hash("filled_reads"))

        def fn():
            from allpathslg_tpu_torch.asm import localize as aloc
            from allpathslg_tpu_torch.graph import cleanup as gclean
            from allpathslg_tpu_torch.graph import coverage as gcov
            from allpathslg_tpu_torch.graph import pathsdb as pdb
            from allpathslg_tpu_torch.long import eval_by_reads as ebr

            a = rd.load_arrays("filled_reads", mmap=True)
            with trace.span("unipaths.count") as sp:
                if self._mesh is not None:
                    # K=96 table via the distributed sample sort: globally
                    # sorted shards concatenate into the table
                    from allpathslg_tpu_torch.parallel import \
                        dist_count as dcount
                    ck_acc = dcount.table_via_sample_sort(
                        self._mesh, a["codes"], cfg.K,
                        batch_size=cfg.batch_reads,
                        min_count=cfg.min_kmer_count)
                else:
                    ck_acc = kcount.count_reads_streaming(
                        a["codes"], cfg.K, batch_size=cfg.batch_reads,
                        min_count=cfg.min_kmer_count, device=self.device)
                ck_acc = kcount.trim_to_host(ck_acc)
            self.log(f"  [unipaths] K={cfg.K} count: {sp.took} "
                     f"({int(ck_acc.n_unique)} kmers)")
            with trace.span("unipaths.condense") as sp:
                ups, graph, placement = unipath.build_unipaths(
                    ck_acc.words, cfg.K, min_count=cfg.min_kmer_count,
                    counts=ck_acc.counts, with_graph=True,
                    with_placement=True, mesh=self._mesh, device=self.device)
            self.log(f"  [unipaths] condense: {sp.took} ({ups.n} unipaths)")
            # localization: path the filled reads (= insert walks) through
            # the unipath graph, drop uncrossed edges, split threaded
            # repeats (ref: LocalizeReadsLG/MergeNeighborhoods)
            lm = {}
            if ups.n > 1:
                with trace.span("unipaths.path_reads") as sp:
                    rp = pdb.path_reads(placement, a["codes"],
                                        batch_size=cfg.batch_reads)
                self.log(f"  [unipaths] path_reads: {sp.took}")
                with trace.span("unipaths.localize") as sp:
                    ups, graph, lm, rp = aloc.localize_resolve(ups, graph,
                                                               rp)
                self.log(f"  [unipaths] localize_resolve: {sp.took}")
                # truth-free read-support QC of the assembly graph (ref:
                # src/paths/long/EvalByReads — placed/coherent fractions)
                nw = np.maximum(
                    np.asarray(a["lengths"], np.int64) - cfg.K + 1, 0)
                _, _, qc = ebr.classify_reads(rp, graph, nw)
                lm = {**lm,
                      **{f"read_qc_{k}": v for k, v in qc.items()
                         if k != "n_reads"}}
            cn, peak = gcov.copy_numbers(ups)
            # graph simplification: pop het bubbles (ploidy 2), trim spurs,
            # merge linear chains (ref: MergeNeighborhoods2-style cleanup)
            with trace.span("unipaths.simplify") as sp:
                contigs, cm = gclean.simplify(ups, graph, cfg.K,
                                              ploidy=cfg.ploidy)
            self.log(f"  [unipaths] simplify: {sp.took}")
            with trace.span("unipaths.write"):
                bases = (np.concatenate(contigs.seqs) if contigs.seqs
                         else np.zeros(0, np.uint8))
                offsets = np.zeros(len(contigs.seqs) + 1, np.int64)
                np.cumsum([len(s) for s in contigs.seqs], out=offsets[1:])
                # flatten ambiguity records (contig, offset, kept_len, alt...)
                amb_c, amb_off, amb_klen, amb_alt = [], [], [], []
                amb_aoff = [0]
                for ci, alist in enumerate(contigs.ambiguities):
                    for (off, klen, alt) in alist:
                        amb_c.append(ci)
                        amb_off.append(off)
                        amb_klen.append(klen)
                        amb_alt.extend(alt.tolist())
                        amb_aoff.append(len(amb_alt))
                rd.save_arrays("unibases", bases=bases, offsets=offsets,
                               amb_contig=np.asarray(amb_c, np.int32),
                               amb_offset=np.asarray(amb_off, np.int64),
                               amb_kept_len=np.asarray(amb_klen, np.int32),
                               amb_alt=np.asarray(amb_alt, np.uint8),
                               amb_alt_offsets=np.asarray(amb_aoff, np.int64))
            if self._cheat:
                lm = {**lm, **self._cheat_assembly_report(
                    bases, offsets, "unipaths")}
            with trace.span("unipaths.write"):
                recs = [(f"contig_{i}", contigs.seqs[i])
                        for i in range(len(contigs.seqs))]
                fio.write_fasta(rd.file_path("unibases.fasta"), recs)
                self._write_unibases_efasta(contigs)
            lens = [len(s) for s in contigs.seqs]
            st = stats.assembly_stats(lens)
            return {"n_unipaths": ups.n, "n50": st["n50"],
                    "total_bases": st["total_bases"],
                    "n_kmers": int(ck_acc.n_unique),
                    "cn1_frac": round(float((cn == 1).mean()), 3),
                    "coverage_peak": round(peak, 1), **lm, **cm}

        return self.run_stage("unipaths", ih,
                              ["unibases.npz", "unibases.fasta"], fn)

    def _write_unibases_efasta(self, contigs):
        """EFASTA with diploid {kept,alt} blocks (ref: final.contigs.efasta).
        Ambiguity offsets refer to the pre-scaffolding contig set."""
        from allpathslg_tpu_torch.dtypes.reads import string_from_codes
        from allpathslg_tpu_torch.io import efasta as eio
        recs = []
        for ci, seq in enumerate(contigs.seqs):
            alist = sorted(contigs.ambiguities[ci])
            segs = []
            pos = 0
            for (off, klen, alt) in alist:
                if off < pos or off + klen > len(seq):
                    continue
                if off > pos:
                    segs.append(string_from_codes(seq[pos:off]))
                segs.append((string_from_codes(seq[off : off + klen]),
                             string_from_codes(alt)))
                pos = off + klen
            if pos < len(seq):
                segs.append(string_from_codes(seq[pos:]))
            recs.append((f"contig_{ci}", segs))
        eio.write_efasta(self.rd.file_path("unibases.efasta"), recs)

    def _align_reads_to_contigs(self, reads_art: str, out_art: str):
        rd = self.rd
        u = rd.load_arrays("unibases")
        reads = rd.load_arrays(reads_art, mmap=True)
        with trace.span("align.place"):
            al = self._align_arrays(u["bases"], u["offsets"], reads)
        rd.save_arrays(out_art, **al)
        return {"n_aligned": int(al["aligned"].sum()),
                "align_rate": round(float(al["aligned"].mean()), 3)}

    def align_frags(self):
        """Place filled fragment reads on the contigs (for patching/polish)."""
        rd = self.rd
        ih = rd.hash_of("align_frags", self._art_hash("filled_reads"),
                        self._art_hash("unibases"))

        def fn():
            return self._align_reads_to_contigs("filled_reads",
                                                "frag_alignlets")

        return self.run_stage("align_frags", ih, ["frag_alignlets.npz"], fn)

    def jump_ec(self):
        """ErrorCorrectJump: trusted-prefix truncation against the strong
        kmer set of the corrected fragment reads, outie -> innie flip,
        dedupe."""
        rd = self.rd
        from allpathslg_tpu_torch.ec import jump as jec

        ih = rd.hash_of("jump_ec", self._art_hash("jump_reads_orig"),
                        self._art_hash("frag_reads_edit"))

        def fn():
            if not rd.has("jump_reads_orig"):
                return {"skipped": "no jump library"}
            a = rd.load_arrays("jump_reads_orig", mmap=True)
            c, q, l, pair_ok, m = jec.error_correct_jumps(
                a["codes"], a["quals"], a["lengths"], a["pairs"],
                self._strong_table(), device=self.device)
            rd.save_arrays("jump_reads_ec", codes=c, quals=q, lengths=l,
                           pairs=a["pairs"], pair_ok=pair_ok,
                           lib_id=a.get("lib_id",
                                        np.zeros(len(a["pairs"]), np.int32)),
                           lib_sep=a.get("lib_sep", np.array([3000])),
                           lib_sd=a.get("lib_sd", np.array([300])))
            return m

        return self.run_stage("jump_ec", ih, ["jump_reads_ec.npz"], fn)

    def align_jumps(self):
        """AlignPairsToHyper analog: place jump reads on the contig set as
        alignlets, and estimate each library's insert distribution."""
        rd = self.rd
        from allpathslg_tpu_torch.eval import accuracy as eacc
        from allpathslg_tpu_torch.utils.intdist import IntDistribution

        ih = rd.hash_of("align_jumps", self._art_hash("jump_reads_ec"),
                        self._art_hash("unibases"))

        def fn():
            if not rd.has("jump_reads_ec"):
                return {"skipped": "no jump library"}
            u = rd.load_arrays("unibases")
            j = rd.load_arrays("jump_reads_ec", mmap=True)
            with trace.span("align.place"):
                al = self._align_arrays(u["bases"], u["offsets"], j)
            C, D, O, OK = (al[k] for k in ("contig", "anchor", "is_rc",
                                           "aligned"))
            # the true insert distribution PER LIBRARY from same-contig
            # pairs (ref: SamplePairedReadStats -> IntDistribution per
            # library), persisted as one lo_i/pmf_i pair per library for
            # RemodelGaps' MLE. Libraries are split by `lib_id`, as the
            # reference's stage does (ROADMAP.md Queue 3).
            lib_id = np.asarray(j.get("lib_id",
                                      np.zeros(len(j["pairs"]), np.int32)))
            n_libs = int(lib_id.max()) + 1 if len(lib_id) else 1
            dist_arrays = {"n_libs": np.array([n_libs])}
            means, sds = [], []
            hist0 = np.zeros(0, np.int64)
            for li in range(n_libs):
                sel = j["pairs"][lib_id == li]
                imean, isd, hist = eacc.estimate_insert_stats(
                    C, D, O, OK, j["lengths"], sel)
                means.append(round(imean, 1))
                sds.append(round(isd, 1))
                if len(hist):
                    d = IntDistribution.from_histogram(hist).to_arrays()
                    dist_arrays[f"lo_{li}"] = d["lo"]
                    dist_arrays[f"pmf_{li}"] = d["pmf"]
                if li == 0:
                    hist0 = hist
            if len(dist_arrays) > 1:
                rd.save_arrays("jump_distribs", **dist_arrays)
            rd.save_arrays("jump_alignlets", contig=C, anchor=D, is_rc=O,
                           mismatches=al["mismatches"], aligned=OK,
                           insert_hist=hist0)
            return {"n_aligned": int(OK.sum()),
                    "align_rate": round(float(OK.mean()), 3),
                    "insert_mean_est": means[0], "insert_sd_est": sds[0],
                    "lib_insert_means": means, "lib_insert_sds": sds}

        return self.run_stage("align_jumps", ih, ["jump_alignlets.npz"], fn)

    def _strong_table(self):
        """The strong K_ec table of find_errors, hashed on the device."""
        table_np = np.load(self.rd.file_path("strong_table.npy"))
        return join.hash_table(
            [torch.from_numpy(table_np[i].astype(np.int64)).to(self.device)
             for i in range(table_np.shape[0])])

    def _align_arrays(self, bases, offsets, reads) -> Dict[str, np.ndarray]:
        """Place the reads of artifact arrays `reads` on the contigs
        (bases, offsets): alignlet arrays contig, anchor, is_rc,
        mismatches, aligned."""
        cfg = self.cfg
        from allpathslg_tpu_torch.align import lookup as alook

        index = alook.build_index(bases, offsets, K=cfg.K_ec,
                                  device=self.device)
        acfg = alook.AlignConfig(K=cfg.K_ec)
        # contig bases upload ONCE
        fbd = torch.from_numpy(np.asarray(bases)).to(self.device)
        codes, n_real = _pad_batch(reads["codes"], cfg.batch_reads, 4)
        lens, _ = _pad_batch(reads["lengths"], cfg.batch_reads, 0)
        C = np.empty(len(codes), np.int32)
        D = np.empty(len(codes), np.int32)
        O = np.empty(len(codes), bool)
        MM = np.empty(len(codes), np.int32)
        OK = np.empty(len(codes), bool)
        for s in range(0, len(codes), cfg.batch_reads):
            e = s + cfg.batch_reads
            C[s:e], D[s:e], O[s:e], MM[s:e], OK[s:e] = alook.align_reads(
                index, codes[s:e], lens[s:e], acfg, fbd)
        return {"contig": C[:n_real], "anchor": D[:n_real],
                "is_rc": O[:n_real], "mismatches": MM[:n_real],
                "aligned": OK[:n_real]}

    def make_scaffolds(self):
        """MakeScaffolds + RemodelGaps + TagCircularScaffolds."""
        rd = self.rd
        from allpathslg_tpu_torch.scaffold import circular as scirc
        from allpathslg_tpu_torch.scaffold import links as slinks
        from allpathslg_tpu_torch.scaffold import scaffolder
        from allpathslg_tpu_torch.scaffold import superb as ssb
        from allpathslg_tpu_torch.utils.intdist import IntDistribution

        ih = rd.hash_of("scaffolds", self._art_hash("jump_alignlets"),
                        self._art_hash("unibases"))

        def fn():
            u = rd.load_arrays("unibases")
            clens = np.diff(u["offsets"]).astype(np.int64)
            if not rd.has("jump_alignlets"):
                scaffolds = [ssb.Superb([i], [False], [], [])
                             for i in range(len(clens))]
            else:
                al = rd.load_arrays("jump_alignlets")
                j = rd.load_arrays("jump_reads_ec", mmap=True)
                lib_id = np.asarray(j.get("lib_id",
                                          np.zeros(len(j["pairs"]), np.int32)))
                inserts = np.asarray(j["lib_sep"], np.int64).copy()
                insert_sds = np.asarray(j["lib_sd"], np.int64).copy()
                # prefer the data-estimated per-library insert stats when
                # sane
                am = rd.metrics("align_jumps")
                ests = am.get("lib_insert_means",
                              [am.get("insert_mean_est", 0)])
                est_sds = am.get("lib_insert_sds",
                                 [am.get("insert_sd_est", 0)])
                for li in range(min(len(inserts), len(ests))):
                    if ests[li] and 0.5 * inserts[li] < ests[li] \
                            < 2 * inserts[li]:
                        inserts[li] = int(ests[li])
                        insert_sds[li] = max(int(est_sds[li]), 5)
                insert = int(inserts[0])
                insert_sd = int(insert_sds[0])
                lg = slinks.pair_links(al["contig"], al["anchor"], al["is_rc"],
                                       al["aligned"], j["lengths"], j["pairs"],
                                       clens, inserts, insert_sds,
                                       lib_ids=lib_id)
                scaffolds, n_broken = scaffolder.make_scaffolds_iterative(
                    lg, len(clens), clens)
                # RemodelGaps: MLE against the per-library empirical insert
                # distributions when the .distribs artifact exists
                # (ref: RemodelGaps.cc)
                dists = None
                if rd.has("jump_distribs"):
                    da = rd.load_arrays("jump_distribs")
                    if "n_libs" in da:
                        dists = []
                        for li in range(int(da["n_libs"][0])):
                            if f"lo_{li}" in da:
                                dists.append(IntDistribution.from_arrays(
                                    {"lo": da[f"lo_{li}"],
                                     "pmf": da[f"pmf_{li}"]}))
                            else:
                                dists.append(None)
                    else:  # single-library artifact
                        dists = [IntDistribution.from_arrays(da)]
                scaffolds = scaffolder.remodel_gaps(scaffolds, lg, dists)
                # circularity tags (ref: TagCircularScaffolds)
                wraps = slinks.wrap_pair_counts(
                    al["contig"], al["anchor"], al["is_rc"], al["aligned"],
                    j["lengths"], j["pairs"], clens, insert, insert_sd)
                circ = scirc.tag_circular(scaffolds, lg, wraps)
                np.save(rd.file_path("circular_tags.npy"),
                        np.asarray(circ, dtype=bool))
            ssb.write_superb(rd.file_path("assembly.superb"), scaffolds)
            ssb.write_agp(rd.file_path("assembly.agp"), scaffolds, clens)
            slens = [sb.length(clens) for sb in scaffolds]
            st = stats.assembly_stats(slens)
            n_circ = 0
            if os.path.exists(rd.file_path("circular_tags.npy")):
                n_circ = int(np.load(rd.file_path("circular_tags.npy")).sum())
            m = {"n_scaffolds": len(scaffolds),
                 "scaffold_n50": st["n50"],
                 "scaffold_total": st["total_bases"],
                 "n_circular": n_circ}
            if rd.has("jump_alignlets"):
                m["n_junctions_broken"] = int(n_broken)
            return m

        return self.run_stage("make_scaffolds", ih,
                              ["assembly.superb", "assembly.agp"], fn)

    def long_jump_scaffolds(self):
        """Second MakeScaffolds pass with long-jump libraries: scaffolds
        become super-contigs, long-jump pairs join them (ref:
        src/paths/MakeScaffolds*.cc later iterations admitting long jumps;
        SURVEY.md §2.5 row 17)."""
        rd = self.rd
        from allpathslg_tpu_torch.ec import jump as jec
        from allpathslg_tpu_torch.scaffold import longjump as slj
        from allpathslg_tpu_torch.scaffold import superb as ssb

        ih = rd.hash_of("long_jump_scaffolds",
                        self._art_hash("long_jump_reads_orig"),
                        self._art_hash("unibases"),
                        str(rd.metrics("make_scaffolds")))

        def fn():
            if not rd.has("long_jump_reads_orig"):
                return {"skipped": "no long-jump library"}
            # EC exactly like regular jumps (trusted-prefix truncation)
            a = rd.load_arrays("long_jump_reads_orig", mmap=True)
            c, q, l, pair_ok, m = jec.error_correct_jumps(
                a["codes"], a["quals"], a["lengths"], a["pairs"],
                self._strong_table(), device=self.device)
            rd.save_arrays("long_jump_reads_ec", codes=c, quals=q,
                           lengths=l, pairs=a["pairs"], pair_ok=pair_ok)
            am = self._align_reads_to_contigs("long_jump_reads_ec",
                                              "long_jump_alignlets")
            al = rd.load_arrays("long_jump_alignlets")
            u = rd.load_arrays("unibases")
            clens = np.diff(u["offsets"]).astype(np.int64)
            scaffolds = ssb.read_superb(rd.file_path("assembly.superb"))
            lib_id = np.asarray(a.get("lib_id",
                                      np.zeros(len(a["pairs"]), np.int32)))
            out, mm = slj.long_jump_pass(
                scaffolds, clens, al["contig"], al["anchor"], al["is_rc"],
                al["aligned"], l, a["pairs"],
                np.asarray(a.get("lib_sep", np.array([10000])), np.int64),
                np.asarray(a.get("lib_sd", np.array([1000])), np.int64),
                lib_ids=lib_id)
            ssb.write_superb(rd.file_path("assembly.superb"), out)
            ssb.write_agp(rd.file_path("assembly.agp"), out, clens)
            st = stats.assembly_stats([sb.length(clens) for sb in out])
            return {**m, **am, **mm, "scaffold_n50": st["n50"]}

        return self.run_stage("long_jump_scaffolds", ih,
                              ["assembly.superb"], fn)

    def patch_gaps(self):
        """PostPatcher: close scaffold junctions with read pileup
        extensions + banded-DP validation; merged contigs raise contig
        N50."""
        rd = self.rd
        from allpathslg_tpu_torch.asm import patch as apatch
        from allpathslg_tpu_torch.asm.amb import AmbTable
        from allpathslg_tpu_torch.scaffold import superb as ssb

        ih = rd.hash_of("patch_gaps", self._art_hash("frag_alignlets"),
                        self._art_hash("unibases"),
                        self._art_hash("filled_reads"),
                        rd.hash_of(str(rd.metrics("make_scaffolds"))))

        def fn():
            u = rd.load_arrays("unibases")
            scaffolds = ssb.read_superb(rd.file_path("assembly.superb"))
            al = rd.load_arrays("frag_alignlets")
            fr = rd.load_arrays("filled_reads", mmap=True)
            new_contigs, new_scaffolds, n_closed, pieces = \
                apatch.patch_scaffold_gaps(
                    scaffolds, _contig_list(u), fr["codes"], fr["lengths"],
                    al["contig"], al["anchor"], al["is_rc"], al["aligned"],
                    device=self.device)
            # thread diploid ambiguity records through the recomposition
            # (ref: FlattenHKP)
            amb = AmbTable.from_arrays(u).from_pieces(pieces)
            # emit final contig set = contigs referenced by scaffolds
            used = sorted({c for sb in new_scaffolds for c in sb.contig_ids})
            remap = {c: i for i, c in enumerate(used)}
            amb = amb.remap(remap)
            bases, offsets = _flatten([new_contigs[c] for c in used])
            for sb in new_scaffolds:
                sb.contig_ids = [remap[c] for c in sb.contig_ids]
            rd.save_arrays("contigs_final", bases=bases, offsets=offsets,
                           **amb.to_arrays())
            ssb.write_superb(rd.file_path("assembly.superb"), new_scaffolds)
            ssb.write_agp(rd.file_path("assembly.agp"), new_scaffolds,
                          np.diff(offsets))
            return {"n_gaps_closed": int(n_closed),
                    "n_contigs_final": len(used),
                    "n_ambiguities_kept": amb.n}

        return self.run_stage("patch_gaps", ih,
                              ["contigs_final.npz", "assembly.superb",
                               "assembly.agp"], fn)

    def long_read_patch(self):
        """LongReadPostPatcher: close residual scaffold gaps with PacBio
        consensus patches (short-read polish cleans them downstream)."""
        rd = self.rd
        from allpathslg_tpu_torch.asm import longread as alr
        from allpathslg_tpu_torch.asm.amb import AmbTable
        from allpathslg_tpu_torch.asm.patch import _oriented
        from allpathslg_tpu_torch.scaffold import superb as ssb

        ih = rd.hash_of("long_read_patch", self._art_hash("long_reads_orig"),
                        self._art_hash("contigs_final"))

        def fn():
            if not rd.has("long_reads_orig"):
                return {"skipped": "no long reads"}
            u = self._final_contigs()
            contigs = _contig_list(u)
            long_reads = _contig_list(rd.load_arrays("long_reads_orig",
                                                     mmap=True))
            lcfg = alr.LongReadConfig()
            index = alr.LongReadIndex(long_reads, lcfg.K)
            scaffolds = ssb.read_superb(rd.file_path("assembly.superb"))
            n_closed = 0
            amb = AmbTable.from_arrays(u)
            # piece provenance per CURRENT contig: list of
            # (orig_src, flip, lo, hi, src_len, dst_off) in the
            # amb.from_pieces convention — merges compose it, so diploid
            # ambiguity records survive gap closure
            pm = {c: [(c, False, 0, len(contigs[c]), len(contigs[c]), 0)]
                  for c in range(len(contigs))}

            def _compose(plist, flip, base, L_cur):
                out = []
                for (src, fl, lo, hi, slen, doff) in plist:
                    plen = hi - lo
                    if not flip:
                        out.append((src, fl, lo, hi, slen, base + doff))
                    else:
                        out.append((src, not fl, slen - hi, slen - lo, slen,
                                    base + (L_cur - doff - plen)))
                return out

            for sb in scaffolds:
                j = 0
                while j < len(sb.gaps):
                    c1, f1 = sb.contig_ids[j], sb.rc[j]
                    c2, f2 = sb.contig_ids[j + 1], sb.rc[j + 1]
                    s1 = _oriented(np.asarray(contigs[c1]), f1)
                    s2 = _oriented(np.asarray(contigs[c2]), f2)
                    merged = alr.close_gap_with_long_reads(
                        s1, s2, sb.gaps[j], sb.gap_devs[j], long_reads,
                        lcfg, index=index, device=self.device)
                    if merged is not None:
                        contigs.append(merged)
                        nid = len(contigs) - 1
                        base2 = len(merged) - len(s2)
                        pm[nid] = (_compose(pm[c1], f1, 0, len(s1))
                                   + _compose(pm[c2], f2, base2, len(s2)))
                        sb.contig_ids[j : j + 2] = [nid]
                        sb.rc[j : j + 2] = [False]
                        del sb.gaps[j]
                        del sb.gap_devs[j]
                        n_closed += 1
                    else:
                        j += 1
            used = sorted({c for sb in scaffolds for c in sb.contig_ids})
            remap = {c: i for i, c in enumerate(used)}
            bases, offsets = _flatten([contigs[c] for c in used])
            for sb in scaffolds:
                sb.contig_ids = [remap[c] for c in sb.contig_ids]
            rows = [(src, remap[c], fl, lo, hi, slen, doff)
                    for c in used for (src, fl, lo, hi, slen, doff) in pm[c]]
            amb2 = amb.from_pieces(rows)
            rd.save_arrays("contigs_final", bases=bases, offsets=offsets,
                           **amb2.to_arrays())
            ssb.write_superb(rd.file_path("assembly.superb"), scaffolds)
            return {"n_gaps_closed": int(n_closed),
                    "n_ambiguities_kept": amb2.n}

        return self.run_stage("long_read_patch", ih,
                              ["contigs_final.npz", "assembly.superb"], fn)

    def assisted(self):
        """AssistedPatcher (ref: src/paths/assisted/): a related genome
        proposes scaffold-gap patches; reads must confirm every splice."""
        cfg, rd = self.cfg, self.rd
        from allpathslg_tpu_torch.asm import assisted as aast
        from allpathslg_tpu_torch.scaffold import superb as ssb

        ih = rd.hash_of("assisted", self._art_hash("contigs_final"),
                        cfg.assist_ref)

        def fn():
            if not cfg.assist_ref:
                return {"skipped": "no assisting reference"}
            recs = fio.read_fasta(cfg.assist_ref)
            # concatenate records; N separators make invalid kmer windows
            sep = np.full(64, 4, np.uint8)
            parts = []
            for _, seq in recs:
                parts.extend([seq.astype(np.uint8), sep])
            genome = np.concatenate(parts[:-1]) if parts \
                else np.zeros(0, np.uint8)
            contigs = _contig_list(self._final_contigs())
            scaffolds = ssb.read_superb(rd.file_path("assembly.superb"))
            fr = rd.load_arrays("filled_reads", mmap=True)
            acfg = aast.AssistConfig(patch_K=cfg.K_ec)
            # one device even on a mesh, as the reference counts here
            ck = kcount.trim_to_host(kcount.count_reads_streaming(
                fr["codes"], acfg.patch_K, batch_size=cfg.batch_reads,
                device=self.device))
            placements = aast.place_contigs(contigs, genome, acfg,
                                            self.device)
            # chain contigs that jump data left as singletons, then patch
            # every junction (existing + assisted) with read confirmation
            singles = {sb.contig_ids[0] for sb in scaffolds
                       if sb.n_contigs == 1}
            multi = [sb for sb in scaffolds if sb.n_contigs > 1]
            pl_sub = [p if (p is not None and p.contig in singles) else None
                      for p in placements]
            chained = aast.assist_scaffold(pl_sub, len(contigs), acfg)
            chained = [sb for sb in chained
                       if all(c in singles for c in sb.contig_ids)]
            n_joins = sum(max(0, sb.n_contigs - 1) for sb in chained)
            contigs2, scaffolds2, m = aast.assisted_patch(
                multi + chained, contigs, genome, placements, ck, acfg,
                self.device)
            m["n_assisted_joins"] = n_joins
            used = sorted({c for sb in scaffolds2 for c in sb.contig_ids})
            remap = {c: i for i, c in enumerate(used)}
            bases, offsets = _flatten([contigs2[c] for c in used])
            for sb in scaffolds2:
                sb.contig_ids = [remap[c] for c in sb.contig_ids]
            # without the ambiguity arrays, as the reference saves it
            # (ROADMAP.md Queue 3): a diploid run loses its {a,b} records
            rd.save_arrays("contigs_final", bases=bases, offsets=offsets)
            ssb.write_superb(rd.file_path("assembly.superb"), scaffolds2)
            m["n_contigs_placed"] = sum(p is not None for p in placements)
            return m

        return self.run_stage("assisted", ih,
                              ["contigs_final.npz", "assembly.superb"], fn)

    def polish(self):
        """FixSomeIndels-style consensus polish of the final contigs."""
        rd = self.rd
        from allpathslg_tpu_torch.asm import polish as apol
        from allpathslg_tpu_torch.asm.amb import AmbTable

        ih = rd.hash_of("polish", self._art_hash("contigs_final"),
                        self._art_hash("filled_reads"))

        def fn():
            u = self._final_contigs()
            fr = rd.load_arrays("filled_reads", mmap=True)
            # re-place reads on the (patched) contigs
            with trace.span("polish.realign"):
                m = self._align_arrays(u["bases"], u["offsets"], fr)
            bases, n_changed = apol.polish_contigs(
                u["bases"], u["offsets"], fr["codes"], fr["lengths"],
                m["contig"], m["anchor"], m["is_rc"], m["aligned"])
            # indel pass (ref: FixSomeIndels): contested-pileup suspects,
            # banded-DP variant scoring, re-polish substitutions after
            bases, offsets, n_indel, edit_rows = apol.polish_indels(
                bases, u["offsets"], fr["codes"], fr["lengths"],
                m["contig"], m["anchor"], m["is_rc"], m["aligned"],
                device=self.device)
            amb = AmbTable.from_arrays(u)
            if n_indel:
                amb = amb.shift(edit_rows)
                with trace.span("polish.realign"):
                    m2 = self._align_arrays(bases, offsets, fr)
                bases, n_changed2 = apol.polish_contigs(
                    bases, offsets, fr["codes"], fr["lengths"],
                    m2["contig"], m2["anchor"], m2["is_rc"], m2["aligned"])
                n_changed += n_changed2
            else:
                offsets = u["offsets"]
            rd.save_arrays("contigs_final", bases=bases, offsets=offsets,
                           **amb.to_arrays())
            return {"n_bases_fixed": int(n_changed),
                    "n_indels_fixed": int(n_indel)}

        return self.run_stage("polish", ih, ["contigs_final.npz"], fn)

    def clean_final(self):
        """CleanAssembly: drop tiny/contained contigs and scaffolds."""
        cfg, rd = self.cfg, self.rd
        from allpathslg_tpu_torch.asm import clean_assembly as aclean
        from allpathslg_tpu_torch.asm.amb import AmbTable
        from allpathslg_tpu_torch.scaffold import superb as ssb

        ih = rd.hash_of("clean_final", self._art_hash("contigs_final"))

        def fn():
            u = self._final_contigs()
            scaffolds = ssb.read_superb(rd.file_path("assembly.superb"))
            ccfg = aclean.CleanConfig(
                min_contig_len=cfg.min_contig_len or 2 * cfg.K)
            contigs, scaffolds, m, remap = aclean.clean_assembly(
                _contig_list(u), scaffolds, ccfg)
            amb = AmbTable.from_arrays(u).remap(remap)
            bases, offsets = _flatten(contigs)
            rd.save_arrays("contigs_final", bases=bases, offsets=offsets,
                           **amb.to_arrays())
            ssb.write_superb(rd.file_path("assembly.superb"), scaffolds)
            ssb.write_agp(rd.file_path("assembly.agp"), scaffolds,
                          np.diff(offsets))
            return m

        return self.run_stage("clean_final", ih,
                              ["contigs_final.npz", "assembly.superb"], fn)

    def evaluate(self):
        """Reference-based accuracy (ref: AssemblyAccuracy/ScaffoldAccuracy,
        EVALUATION=FULL); runs when a truth genome is present."""
        cfg, rd = self.cfg, self.rd
        from allpathslg_tpu_torch.eval import accuracy as eacc

        ih = rd.hash_of("evaluate", self._art_hash("contigs_final"),
                        self._art_hash("genome_truth"))

        def fn():
            if cfg.evaluation == "NONE":
                return {"skipped": "EVALUATION=NONE"}
            if not rd.has("genome_truth"):
                return {"skipped": "no reference genome"}
            u = self._final_contigs()
            g = rd.load_arrays("genome_truth")["genome"]
            rep = eacc.evaluate(u["bases"], u["offsets"], g,
                                device=self.device)
            rep.update(eacc.base_error_report(u["bases"], u["offsets"], g,
                                              device=self.device))
            return rep

        return self.run_stage("evaluate", ih, [], fn)

    def finalize(self):
        """Final assembly emission: scaffold FASTA + EFASTA
        (ref: FlattenHKP outputs final.assembly.{fasta,efasta})."""
        rd = self.rd
        from allpathslg_tpu_torch.asm.amb import AmbTable
        from allpathslg_tpu_torch.dtypes.reads import string_from_codes
        from allpathslg_tpu_torch.io import efasta as eio
        from allpathslg_tpu_torch.scaffold import superb as ssb

        ih = rd.hash_of("finalize", self._art_hash("unibases"),
                        self._art_hash("contigs_final"),
                        rd.hash_of(str(rd.metrics("make_scaffolds"))))

        def fn():
            u = self._final_contigs()
            contigs = _contig_list(u)
            amb = AmbTable.from_arrays(u)
            scaffolds = ssb.read_superb(rd.file_path("assembly.superb"))
            recs = []
            efrecs = []
            n_amb_out = 0
            for si, sb in enumerate(scaffolds):
                seq = ssb.scaffold_sequence(sb, contigs)
                recs.append((f"scaffold_{si}", seq))
                # ambiguity records mapped into scaffold coordinates
                # (ref: FlattenHKP {a,b} emission)
                blocks = []  # (scaffold_off, kept_len, alt)
                at = 0
                for i, cid in enumerate(sb.contig_ids):
                    clen = len(contigs[cid])
                    for (off, klen, alt) in amb.per_contig(cid):
                        if sb.rc[i]:
                            soff = at + clen - off - klen
                            alt_s = (3 - np.asarray(alt)[::-1]) % 4
                        else:
                            soff = at + off
                            alt_s = np.asarray(alt)
                        blocks.append((int(soff), int(klen),
                                       alt_s.astype(np.uint8)))
                    at += clen
                    if i < len(sb.gaps):
                        at += max(int(sb.gaps[i]), 20)
                segs = []
                pos = 0
                for (soff, klen, alt) in sorted(blocks):
                    if soff < pos or soff + klen > len(seq):
                        continue
                    if soff > pos:
                        segs.append(string_from_codes(seq[pos:soff]))
                    segs.append((string_from_codes(seq[soff: soff + klen]),
                                 string_from_codes(alt)))
                    n_amb_out += 1
                    pos = soff + klen
                if pos < len(seq):
                    segs.append(string_from_codes(seq[pos:]))
                efrecs.append((f"scaffold_{si}", segs or [""]))
            fio.write_fasta(rd.file_path("final.assembly.fasta"), recs)
            eio.write_efasta(rd.file_path("final.assembly.efasta"), efrecs)
            return {"n_records": len(recs), "n_ambiguities": int(n_amb_out)}

        return self.run_stage("finalize", ih,
                              ["final.assembly.fasta", "final.assembly.efasta"],
                              fn)

    def submission_prep(self):
        """NCBI-style submission package: renamed, length-filtered contig
        FASTA + AGP (ref: SubmissionPrep)."""
        cfg, rd = self.cfg, self.rd
        from allpathslg_tpu_torch.scaffold import superb as ssb

        ih = rd.hash_of("submission", self._art_hash("contigs_final"),
                        cfg.min_scaffold_len)

        def fn():
            u = self._final_contigs()
            contigs = _contig_list(u)
            scaffolds = ssb.read_superb(rd.file_path("assembly.superb"))
            clens = np.diff(u["offsets"])
            min_len = cfg.min_scaffold_len or cfg.min_contig_len or 2 * cfg.K
            keep = [sb for sb in scaffolds if sb.length(clens) >= min_len]
            sub = os.path.join(rd.path, "submission")
            os.makedirs(sub, exist_ok=True)
            # renumber contigs in scaffold order (the submission contract)
            recs, agp_scaffs, used = [], [], []
            remap = {}
            for sb in keep:
                for c in sb.contig_ids:
                    if c not in remap:
                        remap[c] = len(recs)
                        recs.append((f"contig{len(recs) + 1:06d}",
                                     contigs[c]))
                        used.append(c)
            for sb in keep:
                sb2 = copy.deepcopy(sb)
                sb2.contig_ids = [remap[c] for c in sb.contig_ids]
                agp_scaffs.append(sb2)
            fio.write_fasta(os.path.join(sub, "contigs.fsa"), recs)
            ssb.write_agp(os.path.join(sub, "assembly.agp"), agp_scaffs,
                          np.asarray([len(contigs[c]) for c in used]))
            srecs = [(f"scaffold{si + 1:06d}",
                      ssb.scaffold_sequence(sb, contigs))
                     for si, sb in enumerate(keep)]
            fio.write_fasta(os.path.join(sub, "scaffolds.fsa"), srecs)
            return {"n_scaffolds_submitted": len(keep),
                    "n_contigs_submitted": len(recs),
                    "min_len": int(min_len)}

        return self.run_stage("submission_prep", ih,
                              ["submission/contigs.fsa",
                               "submission/assembly.agp",
                               "submission/scaffolds.fsa"], fn)

    def _final_contigs(self):
        """contigs_final's arrays once patch_gaps wrote them, else
        unibases'."""
        rd = self.rd
        return rd.load_arrays("contigs_final" if rd.has("contigs_final")
                              else "unibases")

    def _lib_coverage_lines(self, assembly_bases: int) -> List[str]:
        """LibCoverage table (ref: src/paths/reporting/LibCoverage.cc —
        per-library read counts, base counts, sequence & physical cov).
        Reads `lib_ids`, as the reference does (ROADMAP.md Queue 3)."""
        rd = self.rd
        lines = ["library coverage:",
                 f"{'lib':>12} {'type':>6} {'reads':>10} {'bases':>12} "
                 f"{'seq_cov':>8} {'phys_cov':>9}"]
        for art, typ in (("frag_reads_orig", "frag"),
                         ("jump_reads_orig", "jump"),
                         ("long_jump_reads_orig", "ljump")):
            if not rd.has(art):
                continue
            a = rd.load_arrays(art)
            lengths = a["lengths"]
            pairs = a.get("pairs")
            lib_ids = a.get("lib_ids")
            seps = a.get("lib_sep", np.asarray([0]))
            n_libs = len(seps)
            for lib in range(n_libs):
                if pairs is not None and len(pairs) and lib_ids is not None \
                        and len(lib_ids) == len(pairs):
                    sel_pairs = pairs[lib_ids == lib] if n_libs > 1 else pairs
                else:
                    sel_pairs = pairs if pairs is not None else None
                if sel_pairs is not None and len(sel_pairs):
                    ridx = sel_pairs.reshape(-1)
                else:
                    ridx = np.arange(len(lengths))
                nb = int(lengths[ridx].sum())
                seq_cov = nb / max(assembly_bases, 1)
                n_pairs = len(sel_pairs) if sel_pairs is not None else 0
                phys = (n_pairs * int(seps[lib]) / max(assembly_bases, 1)
                        if n_pairs else seq_cov)
                lines.append(f"{typ + str(lib):>12} {typ:>6} {len(ridx):>10} "
                             f"{nb:>12} {seq_cov:>8.1f} {phys:>9.1f}")
        return lines

    def report(self):
        cfg, rd = self.cfg, self.rd
        # the inputs hash covers only unibases, as the reference's does
        # (ROADMAP.md Queue 3: a resumed run can skip a stale report)
        ih = rd.hash_of("report", self._art_hash("unibases"))

        def fn():
            u = self._final_contigs()
            lens = np.diff(u["offsets"])
            min_len = cfg.min_contig_len or 2 * cfg.K
            st = stats.assembly_stats(lens, min_len=min_len)
            lines = ["allpathslg_tpu assembly report",
                     "=" * 32]
            for s in ["validate_inputs", "remove_dodgy", "precorrect",
                      "find_errors", "clean_reads", "fill_fragments",
                      "unipaths", "jump_ec", "align_jumps", "make_scaffolds",
                      "align_frags", "patch_gaps", "long_read_patch",
                      "assisted", "polish", "clean_final", "evaluate"]:
                m = self.rd.metrics(s)
                if m:
                    lines.append(f"[{s}] " + ", ".join(
                        f"{k}={v}" for k, v in m.items()))
            lines.append("")
            lines.append(f"contigs (len >= {min_len}): {st['n_contigs']}")
            lines.append(f"total bases: {st['total_bases']}")
            lines.append(f"contig N50: {st['n50']}")
            lines.append(f"contig N90: {st['n90']}")
            lines.append(f"max contig: {st['max_len']}")
            sm = self.rd.metrics("make_scaffolds")
            if sm and "scaffold_n50" in sm:
                lines.append(f"scaffolds: {sm['n_scaffolds']}")
                lines.append(f"scaffold N50: {sm['scaffold_n50']}")
                lines.append(f"scaffold total: {sm['scaffold_total']}")
            um = self.rd.metrics("unipaths")
            if um and "read_qc_placed_frac" in um:
                lines.append("")
                lines.append(
                    "read-support QC (EvalByReads): "
                    f"placed={um['read_qc_placed_frac']}, "
                    f"coherent={um['read_qc_coherent_frac']}, "
                    "unsupported_transitions="
                    f"{um['read_qc_n_unsupported_transitions']}")
            lines.append("")
            lines.extend(self._lib_coverage_lines(int(st["total_bases"])))
            with open(rd.file_path("assembly.report"), "w") as f:
                f.write("\n".join(lines) + "\n")
            self.log("\n".join(lines))
            return {k: (int(v) if isinstance(v, (int, np.integer))
                        else float(v))
                    for k, v in st.items()}

        return self.run_stage("report", ih, ["assembly.report"], fn)

    def run_contig_slice(self) -> Dict:
        """The minimum slice: inputs -> contigs + report."""
        self.validate_inputs()
        self.remove_dodgy()
        self.precorrect()
        self.find_errors()
        self.clean_reads()
        self.fill_fragments()
        self.unipaths()
        return self.report()

    def run_full(self) -> Dict:
        """Full pipeline: contigs + jump scaffolding + final assembly.

        Independent stages run concurrently in `stage_workers` threads
        (the `make -j` analog of RunAllPathsLG's Makefile DAG): device work
        still serializes on the one device, but host compute, file IO and
        device work overlap (jump EC vs the frag clean/fill chain; frag vs
        jump alignment). Long-jump libraries add a second scaffolding pass
        before patch_gaps; long reads and an `assist_ref` add
        long_read_patch and assisted, in that order, before polish."""
        rd = self.rd
        jobs: Dict[str, tuple] = {
            "validate_inputs": ((), self.validate_inputs),
            "remove_dodgy": ((), self.remove_dodgy),
            "precorrect": (("remove_dodgy",), self.precorrect),
            "find_errors": (("precorrect",), self.find_errors),
            "clean_reads": (("find_errors",), self.clean_reads),
            "fill_fragments": (("clean_reads",), self.fill_fragments),
            "unipaths": (("fill_fragments",), self.unipaths),
        }
        if rd.has("jump_reads_orig"):
            jobs["jump_ec"] = (("find_errors",), self.jump_ec)
            jobs["align_jumps"] = (("jump_ec", "unipaths"), self.align_jumps)
            sc_deps = ("align_jumps", "unipaths")
        else:
            sc_deps = ("unipaths",)
        jobs["make_scaffolds"] = (sc_deps, self.make_scaffolds)
        sc_last = "make_scaffolds"
        if rd.has("long_jump_reads_orig"):
            jobs["long_jump_scaffolds"] = (("make_scaffolds",),
                                           self.long_jump_scaffolds)
            sc_last = "long_jump_scaffolds"
        jobs["align_frags"] = (("unipaths",), self.align_frags)
        jobs["patch_gaps"] = (("align_frags", sc_last), self.patch_gaps)
        tail = "patch_gaps"
        if rd.has("long_reads_orig"):
            jobs["long_read_patch"] = ((tail,), self.long_read_patch)
            tail = "long_read_patch"
        if self.cfg.assist_ref:
            jobs["assisted"] = ((tail,), self.assisted)
            tail = "assisted"
        jobs["polish"] = ((tail,), self.polish)
        jobs["clean_final"] = (("polish",), self.clean_final)
        jobs["finalize"] = (("clean_final",), self.finalize)
        jobs["submission_prep"] = (("clean_final",), self.submission_prep)
        jobs["evaluate"] = (("clean_final",), self.evaluate)
        self._run_dag(jobs, max_workers=self.cfg.stage_workers)
        return self.report()

    def _run_dag(self, jobs: Dict[str, tuple], max_workers: int = 1):
        """Topological thread-pool executor over (deps, fn) jobs. With
        max_workers=1 this is the serial order. Each job's wait, from the
        end of its last dependency (or the DAG's start) to its start on a
        worker, is recorded as the span `dag.wait`."""
        import concurrent.futures as cf

        t_start, ended = time.perf_counter(), {}

        def timed(n, deps, fn):
            def job():
                t = time.perf_counter()
                trace.record("dag.wait", max([t_start] + [
                    ended[d] for d in deps]), t, stage=n, run=self.rd.path)
                try:
                    return fn()
                finally:
                    ended[n] = time.perf_counter()
            return job

        jobs = {n: (deps, timed(n, deps, fn))
                for n, (deps, fn) in jobs.items()}
        if max_workers <= 1:
            done: set = set()
            while len(done) < len(jobs):
                ready = [n for n, (deps, _) in jobs.items()
                         if n not in done and all(d in done for d in deps)]
                if not ready:
                    raise RuntimeError("stage DAG cycle")
                for n in ready:
                    jobs[n][1]()
                    done.add(n)
            return
        done = set()
        futures: Dict[str, cf.Future] = {}
        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            while len(done) < len(jobs):
                for n, (deps, fn) in jobs.items():
                    if (n not in done and n not in futures
                            and all(d in done for d in deps)):
                        futures[n] = ex.submit(fn)
                if not futures:
                    raise RuntimeError("stage DAG cycle")
                finished = [n for n, f in futures.items() if f.done()]
                if not finished:
                    time.sleep(0.05)
                    continue
                for n in finished:
                    futures.pop(n).result()  # re-raise stage failures
                    done.add(n)

    # ---- helpers ----

    def _profiled(self, name: str, fn) -> Dict:
        """fn() under torch.profiler (CPU activity, and CUDA on the card),
        its Chrome trace written to `{profile_dir}/{name}/trace.json`
        (ref: jax.profiler.trace into the same directory) with the
        program's spans of the session added as "X" events. A stage that
        starts while another stage's session is open (stage_workers > 1)
        runs inside that session: its ops and spans go into that stage's
        trace, and it writes none of its own."""
        if not _PROFILE_LOCK.acquire(blocking=False):
            return fn()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            with torch.profiler.profile(activities=acts) as prof:
                t_mark = trace.mark()
                metrics = fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t_end = time.perf_counter()
        finally:
            _PROFILE_LOCK.release()
        out = os.path.join(self.cfg.profile_dir, name)
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, "trace.json")
        prof.export_chrome_trace(path)
        trace.merge_chrome_trace(path, t_mark, t_end,
                                 threading.get_native_id())
        return metrics

    def _check_spectrum_oracle(self, batch, spec, n_sample: int = 512,
                               K: int = None):
        """check_mode: the device k-mer spectrum of the first n_sample
        reads (kmer/count.spectrum_reads on the pipeline's device; on the
        card, the Hopper sort) against the Python oracle. Raises on a
        mismatch."""
        from allpathslg_tpu_torch.eval import oracle
        cfg = self.cfg
        K = cfg.K_ec if K is None else K
        codes = np.asarray(batch.codes)[:n_sample]
        lens = np.asarray(batch.lengths)[:n_sample]
        reads = [codes[i, : lens[i]] for i in range(codes.shape[0])]
        want = oracle.kmer_spectrum(oracle.count_kmers(reads, K),
                                    cfg.max_freq)
        got, _ = kcount.spectrum_reads(
            torch.from_numpy(np.ascontiguousarray(codes)).to(self.device), K,
            cfg.max_freq)
        got = got.cpu().numpy()
        if not (got == want).all():
            bad = np.nonzero(got != want)[0][:5]
            raise AssertionError(
                f"check_mode: device spectrum disagrees with oracle at "
                f"freqs {bad.tolist()} (device {got[bad].tolist()} vs "
                f"oracle {want[bad].tolist()})")
        self.log(f"  [check] spectrum oracle ok on {len(reads)} reads")

    def _art_hash(self, name: str) -> str:
        """Cheap artifact fingerprint: file sizes + mtimes."""
        return self.rd.fingerprint(name)

    # ---- CHEAT-mode truth diagnostics (ref: EVALUATION=CHEAT guiding
    # module internals for debugging) ----

    @property
    def _cheat(self) -> bool:
        return (self.cfg.evaluation == "CHEAT"
                and self.rd.has("genome_truth"))

    def _truth_kmer_set(self, K: int):
        if getattr(self, "_truth_kset", None) is None \
                or self._truth_kset[0] != K:
            from allpathslg_tpu_torch.eval import oracle
            g = self.rd.load_arrays("genome_truth")["genome"]
            self._truth_kset = (K, set(oracle.count_kmers([g], K).keys()))
        return self._truth_kset[1]

    def _cheat_true_kmer_frac(self, codes: np.ndarray, K: int,
                              n_sample: int = 512) -> float:
        """Fraction of a read sample's K-mers present in the truth genome
        (1.0 = error-free reads); the mid-pipeline EC diagnostic."""
        from allpathslg_tpu_torch.eval import oracle
        kset = self._truth_kmer_set(K)
        idx = np.linspace(0, len(codes) - 1, min(n_sample, len(codes)),
                          dtype=np.int64)
        reads = [np.asarray(codes[i]) for i in idx]
        n_in = n_tot = 0
        for ck in (oracle.count_kmers([r], K) for r in reads):
            n_tot += sum(ck.values())
            n_in += sum(v for k, v in ck.items() if k in kset)
        return round(n_in / max(n_tot, 1), 5)

    def _cheat_assembly_report(self, bases, offsets, tag: str) -> Dict:
        """Mid-pipeline truth accuracy of an intermediate contig set."""
        from allpathslg_tpu_torch.eval import accuracy as eacc
        g = self.rd.load_arrays("genome_truth")["genome"]
        rep = eacc.evaluate(np.asarray(bases), np.asarray(offsets), g,
                            device=self.device)
        out = {f"cheat_{k}": v for k, v in rep.items()
               if k in ("genome_covered_frac", "misassembly_breaks",
                        "anchor_place_rate")}
        self.log(f"  [{tag}] CHEAT: " + ", ".join(
            f"{k}={v}" for k, v in out.items()))
        return out
