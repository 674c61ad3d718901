"""Pipeline stages, the contig slice and the fragment alignment (port of
allpathslg_tpu/pipeline/stages.py):

  validate_inputs     (ref: ValidateAllPathsInputs)
  remove_dodgy        (ref: RemoveDodgyReads)
  precorrect          (ref: FindErrors phase 1 / PreCorrect)
  find_errors         (ref: FindErrors phase 2)
  clean_reads         (ref: CleanCorrectedReads)
  fill_fragments      (ref: FillFragments)
  unipaths            (ref: CommonPather + Unipather at K=96, localization,
                       cleanup)
  report              (ref: reporting/ BasicAssemblyStats -> assembly.report)
  align_frags         (ref: AlignPairsToHyper for the fragment library)

`run_contig_slice` runs the first eight in order. Each stage writes the
same named artifacts to the run directory as the reference, byte for
byte, and resumes from the same manifest. The stages run on the torch
device the Pipeline is given; the read set is uploaded once and stays
resident on it across the EC stages (dtypes/devcache).

Not ported yet (see ROADMAP.md): jump_ec, align_jumps, make_scaffolds,
long_jump_scaffolds, patch_gaps, long_read_patch, assisted, polish,
clean_final, finalize, submission_prep, evaluate and `run_full`; and the
options that lead off this slice raise NotImplementedError: a
multi-device mesh (n_devices > 1), profile_dir, check_mode,
evaluation="CHEAT" and jump libraries in validate_inputs.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch

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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to allpathslg_tpu_torch yet "
        f"(ROADMAP.md lists the work still open); run allpathslg_tpu")


class Pipeline:
    """Stage DAG executor with manifest-based resume (ref: make dependency
    semantics of RunAllPathsLG), on one explicit torch device."""

    def __init__(self, rd: RunDir, cfg: AssemblyConfig, log: Callable = print,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Pipeline(device={device!r}): no CUDA device")
        if cfg.n_devices > 1:
            raise _not_ported("n_devices > 1 (mesh-distributed counting)")
        if cfg.profile_dir:
            raise _not_ported("profile_dir (stage tracing)")
        if cfg.evaluation == "CHEAT":
            raise _not_ported('evaluation="CHEAT" (truth diagnostics)')
        self.rd = rd
        self.cfg = cfg
        self.log = log
        # device-resident packed read batches shared ACROSS stages: reads
        # upload once and corrected codes stay on the device
        self._read_cache = {}

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
        """Counting router (one device: kmer.count.count_reads_streaming)."""
        return kcount.count_reads_streaming(
            codes, K, quals, batch_size=self.cfg.batch_reads,
            device=self.device, **kw)

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
        try:
            metrics = fn() or {}
        finally:
            watch.stop()
        dt = time.time() - t0
        self.rd.mark_done(name, inputs_hash, outputs, metrics, dt)
        self.log(f"[{name}] done in {dt:.1f}s {metrics}")
        return metrics

    # ---- stages ----

    def validate_inputs(self):
        cfg, rd = self.cfg, self.rd
        if rd.has("jump_reads_orig"):
            raise _not_ported("validate_inputs over jump libraries")
        if cfg.check_mode:
            raise _not_ported("check_mode (spectrum oracle check)")
        ih = rd.hash_of("validate", K_VALIDATE,
                        self._art_hash("frag_reads_orig"), "nojump")

        def fn():
            a = rd.load_arrays("frag_reads_orig", mmap=True)
            batch = batch_from_codes(a["codes"], a["lengths"], a.get("quals"))
            # spectrum-only streaming: the raw table is discarded per merge
            # pass; K is the reference's 25, independent of K_ec
            _, spec = self._count_streaming(
                np.asarray(batch.codes), K_VALIDATE,
                min_count=1 << 30, spectrum_max_freq=cfg.max_freq)
            # int64 regardless of path (the device-resident path returns
            # int32, the merge path int64 — artifact bytes must match)
            spec = np.asarray(spec, np.int64)
            ana = kspec.analyze(spec)
            frag_row = {
                "n_reads": int(batch.n_reads),
                "n_kmers_distinct": int(spec.sum()),
                "genome_size_est": ana.genome_size_est,
                "coverage_est": ana.coverage_est,
                "spectrum_valley": ana.valley,
                "spectrum_peak": ana.peak,
                "frac_repetitive": round(ana.frac_repetitive, 4),
            }
            if int(a["lengths"].min()) < cfg.K_ec:
                raise ValueError("reads shorter than K_ec")
            rd.save_arrays("kspec_25mer", spectrum=spec)
            return {**frag_row, "libraries": {"frag": frag_row}}

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
                if cfg.fault_stage == f"find_errors@round{r}":
                    raise RuntimeError(
                        f"injected fault in find_errors round {r}")
                # pre-filter to the strong thresholds during the streamed
                # merge: the raw (reads x windows) table never materializes
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
            rd.save_arrays("frag_reads_edit", codes=db.codes_to_host(),
                           lengths=a["lengths"], quals=a["quals"],
                           **({"pairs": a["pairs"]} if "pairs" in a else {}))
            self._register_resident("frag_reads_edit", db,
                                    drop="frag_reads_prec")
            if os.path.exists(ck_file):
                os.remove(ck_file)
            return {"n_corrections": total, "n_strong_kmers": int(n_strong)}

        return self.run_stage("find_errors", ih,
                              ["frag_reads_edit.npz", "strong_table.npy"], fn)

    def clean_reads(self):
        cfg, rd = self.cfg, self.rd
        ih = rd.hash_of("clean", str(cfg.spectrum_ec),
                        self._art_hash("frag_reads_edit"))

        def fn():
            a = rd.load_arrays("frag_reads_edit", mmap=True)
            ecfg = cfg.spectrum_ec
            table_np = np.load(rd.file_path("strong_table.npy"))
            table = join.hash_table(
                [torch.from_numpy(table_np[i].astype(np.int64))
                 .to(self.device) for i in range(table_np.shape[0])])
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
            t0 = time.perf_counter()
            ck_acc = kcount.trim_to_host(self._count_streaming(
                a["codes"], cfg.K, min_count=cfg.min_kmer_count))
            self.log(f"  [unipaths] K={cfg.K} count: "
                     f"{time.perf_counter() - t0:.1f}s "
                     f"({int(ck_acc.n_unique)} kmers)")
            t0 = time.perf_counter()
            ups, graph, placement = unipath.build_unipaths(
                ck_acc.words, cfg.K, min_count=cfg.min_kmer_count,
                counts=ck_acc.counts, with_graph=True, with_placement=True)
            self.log(f"  [unipaths] condense: "
                     f"{time.perf_counter() - t0:.1f}s ({ups.n} unipaths)")
            # localization: path the filled reads (= insert walks) through
            # the unipath graph, drop uncrossed edges, split threaded
            # repeats (ref: LocalizeReadsLG/MergeNeighborhoods)
            lm = {}
            if ups.n > 1:
                t0 = time.perf_counter()
                rp = pdb.path_reads(placement, a["codes"],
                                    batch_size=cfg.batch_reads)
                self.log(f"  [unipaths] path_reads: "
                         f"{time.perf_counter() - t0:.1f}s")
                t0 = time.perf_counter()
                ups, graph, lm, rp = aloc.localize_resolve(ups, graph, rp)
                self.log(f"  [unipaths] localize_resolve: "
                         f"{time.perf_counter() - t0:.1f}s")
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
            t0 = time.perf_counter()
            contigs, cm = gclean.simplify(ups, graph, cfg.K,
                                          ploidy=cfg.ploidy)
            self.log(f"  [unipaths] simplify: "
                     f"{time.perf_counter() - t0:.1f}s")
            bases = (np.concatenate(contigs.seqs) if contigs.seqs
                     else np.zeros(0, np.uint8))
            offsets = np.zeros(len(contigs.seqs) + 1, np.int64)
            np.cumsum([len(s) for s in contigs.seqs], out=offsets[1:])
            # flatten ambiguity records (contig, offset, kept_len, alt...)
            amb_c, amb_off, amb_klen, amb_alt, amb_aoff = [], [], [], [], [0]
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
        cfg, rd = self.cfg, self.rd
        from allpathslg_tpu_torch.align import lookup as alook

        u = rd.load_arrays("unibases")
        j = rd.load_arrays(reads_art, mmap=True)
        index = alook.build_index(u["bases"], u["offsets"], K=cfg.K_ec,
                                  device=self.device)
        acfg = alook.AlignConfig(K=cfg.K_ec)
        fbd = torch.from_numpy(u["bases"]).to(self.device)  # upload ONCE
        codes, n_real = _pad_batch(j["codes"], cfg.batch_reads, 4)
        lens, _ = _pad_batch(j["lengths"], cfg.batch_reads, 0)
        C = np.empty(len(codes), np.int32)
        D = np.empty(len(codes), np.int32)
        O = np.empty(len(codes), bool)
        MM = np.empty(len(codes), np.int32)
        OK = np.empty(len(codes), bool)
        for s in range(0, len(codes), cfg.batch_reads):
            e = s + cfg.batch_reads
            C[s:e], D[s:e], O[s:e], MM[s:e], OK[s:e] = alook.align_reads(
                index, codes[s:e], lens[s:e], acfg, fbd)
        rd.save_arrays(out_art, contig=C[:n_real], anchor=D[:n_real],
                       is_rc=O[:n_real], mismatches=MM[:n_real],
                       aligned=OK[:n_real])
        return {"n_aligned": int(OK[:n_real].sum()),
                "align_rate": round(float(OK[:n_real].mean()), 3)}

    def align_frags(self):
        """Place filled fragment reads on the contigs (for patching/polish)."""
        rd = self.rd
        ih = rd.hash_of("align_frags", self._art_hash("filled_reads"),
                        self._art_hash("unibases"))

        def fn():
            return self._align_reads_to_contigs("filled_reads",
                                                "frag_alignlets")

        return self.run_stage("align_frags", ih, ["frag_alignlets.npz"], fn)

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
            u = rd.load_arrays("contigs_final") if rd.has("contigs_final") \
                else rd.load_arrays("unibases")
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

    # ---- helpers ----

    def _art_hash(self, name: str) -> str:
        """Cheap artifact fingerprint: file sizes + mtimes."""
        return self.rd.fingerprint(name)
