"""Pipeline stages, the error-correction front of the contig slice (port of
allpathslg_tpu/pipeline/stages.py):

  validate_inputs     (ref: ValidateAllPathsInputs)
  remove_dodgy        (ref: RemoveDodgyReads)
  precorrect          (ref: FindErrors phase 1 / PreCorrect)
  find_errors         (ref: FindErrors phase 2)
  clean_reads         (ref: CleanCorrectedReads)

Each stage writes the same named artifacts to the run directory as the
reference, byte for byte, and resumes from the same manifest. The stages
run on the torch device the Pipeline is given; the read set is uploaded
once and stays resident on it across the EC stages (dtypes/devcache).

Not ported yet (see ROADMAP.md): fill_fragments, unipaths, report and the
later stages; and the options that lead off this slice raise
NotImplementedError: a multi-device mesh (n_devices > 1), profile_dir,
check_mode, evaluation="CHEAT" and jump libraries in validate_inputs.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List

import numpy as np
import torch

from allpathslg_tpu_torch.dtypes.devcache import DeviceBatches
from allpathslg_tpu_torch.dtypes.reads import batch_from_codes
from allpathslg_tpu_torch.ec import precorrect as pc
from allpathslg_tpu_torch.ec import spectrum_ec as sec
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

    # ---- helpers ----

    def _art_hash(self, name: str) -> str:
        """Cheap artifact fingerprint: file sizes + mtimes."""
        return self.rd.fingerprint(name)
