"""One run of one cell: set-up, a closed loop of whole samples for the
window, the check against the plain reference, one JSON result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name BENCHMARK.json gives it:
configs/<config>.json, traffic/<traffic>.json, metrics/<metric>.py and
limits/<workload>.json. The program under test is allpathslg_tpu_torch;
this package imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import sim

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "allpathslg_tpu")
GIB = float(1 << 30)
# stream ids of set_seeds beside the read sets' 0, 1, ...
WARM_UP_SET = (1 << 31) - 1
CHECK_DRAWS = (1 << 31) - 2


def say(*a):
    print(*a, file=sys.stderr, flush=True)


# ---- the cell -------------------------------------------------------------

def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """(BENCHMARK.json, its workload entry, the configuration, the traffic
    mix, the limits) of the cell named `workload`."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"{bench_path.name}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return bench, cell, cfg, traffic, limits


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or
    with `trace` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


# ---- inputs ---------------------------------------------------------------

def set_seeds(seed: int, i: int) -> list:
    """Four seeds for read set i of a run with `seed` (any whole number)."""
    ss = np.random.SeedSequence([seed % (1 << 64), i])
    return [int(x) for x in ss.generate_state(4, np.uint32)]


def make_read_set(cfg: dict, seed: int, i: int, genome_size: int = None,
                  snp_rate: float = 0.0):
    """Read set i of a run: a genome of the configuration's shape and its
    libraries, every draw from (seed, i). With `snp_rate` (the control)
    the reads come from a strain of the genome with that share of SNPs,
    while "genome" stays the genome they are judged against."""
    s = set_seeds(seed, i)
    size = genome_size or cfg["genome_size"]
    genome = sim.repeat_genome(size, s[0], cfg["gc"], cfg["repeat_families"])
    out = {"genome": genome}
    g = sim.mutate_genome(genome, snp_rate, s[3] + 1) if snp_rate else genome
    for lib, outward, sd in (("frag", False, s[1]), ("jump", True, s[2])):
        p = cfg[lib]
        out[lib] = sim.simulate_paired_reads(
            g, p["coverage"], p["read_len"], p["insert"], p["sd"],
            cfg["error_rate"], outward, sd)
    if cfg.get("long"):
        p = cfg["long"]
        out["long"] = sim.simulate_long_reads(
            g, p["coverage"], p["mean_len"], p["min_len"], p["error_rate"],
            s[3])
    return out


def jump_artifact(cfg: dict, jump: dict) -> dict:
    """jump_reads_orig's arrays for one library."""
    return dict(jump, lib_id=np.zeros(len(jump["pairs"]), np.int32),
                lib_sep=np.array([cfg["jump"]["insert"]], np.int32),
                lib_sd=np.array([cfg["jump"]["sd"]], np.int32))


def write_read_set(cfg: dict, traffic: dict, rs: dict, d: Path):
    """Writes read set `rs` under `d` as the entry takes it: `d/files`
    (FASTQ, SAM, sheets) for "assemble", else run-dir artifacts under
    `d/artifacts`; genome_truth there too when the traffic gives one."""
    from allpathslg_tpu_torch.pipeline.rundir import RunDir

    from portbench import readfiles

    shutil.rmtree(d, ignore_errors=True)
    rd = RunDir(str(d / "artifacts"))
    if traffic["entry"] == "assemble":
        readfiles.write_sample_files(
            d / "files", rs["frag"], rs["jump"],
            (cfg["frag"]["insert"], cfg["frag"]["sd"]),
            (cfg["jump"]["insert"], cfg["jump"]["sd"]))
    else:
        rd.save_arrays("frag_reads_orig", **rs["frag"])
        rd.save_arrays("jump_reads_orig", **jump_artifact(cfg, rs["jump"]))
        if "long" in rs:
            rd.save_arrays("long_reads_orig", **rs["long"])
    if traffic["truth_genome"]:
        rd.save_arrays("genome_truth", genome=rs["genome"])


def link_tree(src: Path, dst: Path):
    """dst as a tree of hard links to src's files (the run dir starts
    with the sample's inputs without copying them; stages replace files
    by rename and never write into one)."""
    for root, _, files in os.walk(src):
        out = dst / Path(root).relative_to(src)
        out.mkdir(parents=True, exist_ok=True)
        for f in files:
            os.link(Path(root) / f, out / f)


def written_bytes() -> int:
    """Bytes this process has passed to write() so far (/proc/self/io)."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("wchar:"):
                return int(line.split()[1])
    except OSError:
        pass
    return 0


# ---- one sample -----------------------------------------------------------

CHECK_READS = 4096     # placed fragment reads judged a sample


def assembly_config(cfg: dict):
    from allpathslg_tpu_torch.pipeline.config import AssemblyConfig

    return AssemblyConfig.from_overrides(**cfg["pipeline"])


def run_sample(traffic: dict, acfg, set_dir: Path, rd_path: Path,
               device: str, sync) -> dict:
    """One sample from a run dir where no stage is done: {wall, ingest_s}."""
    from allpathslg_tpu_torch.pipeline.prepare import prepare_inputs
    from allpathslg_tpu_torch.pipeline.rundir import RunDir
    from allpathslg_tpu_torch.pipeline.stages import Pipeline

    shutil.rmtree(rd_path, ignore_errors=True)
    t0 = time.perf_counter()
    link_tree(set_dir / "artifacts", rd_path)
    rd = RunDir(str(rd_path))
    ingest = None
    if traffic["entry"] == "assemble":
        files = set_dir / "files"
        prepare_inputs(rd, str(files / "in_libs.csv"),
                       str(files / "in_groups.csv"), log=lambda *a: None)
        ingest = time.perf_counter() - t0
    pipe = Pipeline(rd, acfg, lambda *a: None, device=device)
    if traffic["entry"] == "contigs":
        pipe.run_contig_slice()
    else:
        pipe.run_full()
    sync()
    return {"wall": time.perf_counter() - t0, "ingest_s": ingest,
            "rd": rd}


def collect(rd, traffic: dict, rng) -> dict:
    """What the check judges, read from a finished sample's run dir, and
    each stage's seconds from its manifest."""
    out = {"stages": {s: r["elapsed_s"]
                      for s, r in rd.manifest["stages"].items()}}
    k = rd.load_arrays("kspec_25mer")
    out["spectra"] = {key: np.asarray(v) for key, v in k.items()}
    if traffic["entry"] == "assemble":
        out["imported"] = {
            art: {key: np.array(v) for key, v in
                  rd.load_arrays(art, mmap=True).items()
                  if key in ("codes", "quals", "lengths", "pairs")}
            for art in ("frag_reads_orig", "jump_reads_orig")}
    u = rd.load_arrays("unibases")
    out["unibases"] = {key: np.asarray(u[key]) for key in ("bases",
                                                           "offsets")}
    if rd.has("frag_alignlets"):
        al = rd.load_arrays("frag_alignlets")
        aligned = np.asarray(al["aligned"])
        placed = np.flatnonzero(aligned)
        pick = np.sort(rng.choice(placed, min(len(placed), CHECK_READS),
                                  replace=False))
        fr = rd.load_arrays("filled_reads", mmap=True)
        out["unplaced"] = {"n_reads": len(fr["lengths"]), "aligned": aligned}
        out["placements"] = {
            "codes": np.array(fr["codes"][pick]),
            "lengths": np.array(fr["lengths"][pick]),
            **{key: np.asarray(al[key])[pick] for key in (
                "contig", "anchor", "is_rc", "mismatches")}}
    if rd.has("contigs_final"):
        c = rd.load_arrays("contigs_final")
        out["assembly"] = {"bases": np.asarray(c["bases"]),
                           "offsets": np.asarray(c["offsets"])}
    else:
        out["assembly"] = out["unibases"]
    return out


# ---- the check ------------------------------------------------------------

def check_samples(samples: list, read_sets: list) -> list:
    """Each sample's compared numbers: [{name: value}]."""
    from portbench import reference as ref

    cache, numbers = {}, []
    for rec in samples:
        i = rec["set"]
        rs = read_sets[i]
        if i not in cache:
            want = {"spectrum": ref.spectrum(rs["frag"]["codes"],
                                             rs["frag"]["lengths"]),
                    "spectrum_jump0": ref.spectrum(rs["jump"]["codes"],
                                                   rs["jump"]["lengths"])}
            g = rs["genome"]
            gk, _, _ = ref.kmer_set(g, np.array([0, len(g)]))
            cache[i] = (want, gk)
        want, gk = cache[i]
        out, got = rec["out"], {}
        got["spectrum_diff"] = sum(
            int(np.abs(np.asarray(out["spectra"].get(key, 0)) - v).sum())
            for key, v in want.items())
        if "imported" in out:
            got["reads_bad"] = sum(
                ref.imported_pair_errors(out["imported"][art], rs[lib])
                for art, lib in (("frag_reads_orig", "frag"),
                                 ("jump_reads_orig", "jump")))
        if "placements" in out:
            got["unplaced_pct"] = ref.unplaced_pct(
                out["unplaced"]["n_reads"], out["unplaced"]["aligned"],
                len(rs["frag"]["pairs"]))
            p = out["placements"]
            got["placements_bad"] = ref.placement_errors(
                p["codes"], p["lengths"], p["contig"], p["anchor"],
                p["is_rc"], p["mismatches"], out["unibases"]["bases"],
                out["unibases"]["offsets"])["bad"]
        got.update(ref.assembly_vs_genome(out["assembly"]["bases"],
                                          out["assembly"]["offsets"], gk))
        numbers.append(got)
    return numbers


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    shown, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        shown[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not v <= lim:
            ok = False
    return ok, shown


def worst(numbers: list) -> dict:
    """The largest reading of each number over the samples."""
    out = {}
    for got in numbers:
        for key, v in got.items():
            out[key] = max(out.get(key, v), v)
    return out


# ---- the run --------------------------------------------------------------

def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(args, t_start: float, device: str = "cuda",
        snp_rate: float = 0.0) -> dict:
    """One run of a cell; returns the result line's object. On "cuda" it
    first looks for the cards the cell asks for. `snp_rate` > 0 runs the
    control (control.py): reads from a strain of each genome."""
    import torch

    bench, cell, cfg, traffic, limits = load_cell(args.workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("portbench: torch.cuda.is_available() is "
                             "false; the benchmark runs on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"portbench: {cell['chips']} cards asked, "
                             f"{torch.cuda.device_count()} found")
    tmp = Path(tempfile.gettempdir()) / f"portbench_{cell['name']}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        return _run(args, t_start, device, bench, cell, cfg, traffic,
                    limits, tmp, snp_rate)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def set_up(args, cfg, traffic, acfg, tmp: Path, device: str, sync,
           snp_rate: float) -> tuple:
    """The read sets, written once under `tmp`, and one small warm-up
    sample: (read sets as made, their dirs, seconds of each part)."""
    from portbench import trace as ptrace

    t = [time.perf_counter()]
    if device == "cuda":
        ptrace.load_kernels()
    t.append(time.perf_counter())
    read_sets, set_dirs = [], []
    for i in range(traffic["read_sets"]):
        rs = make_read_set(cfg, args.seed, i, snp_rate=snp_rate)
        d = tmp / f"set{i}"
        write_read_set(cfg, traffic, rs, d)
        if snp_rate:      # judged against the reads of the genome itself
            rs = make_read_set(cfg, args.seed, i)
        read_sets.append(rs)
        set_dirs.append(d)
    t.append(time.perf_counter())
    warm = make_read_set(cfg, args.seed, WARM_UP_SET,
                         traffic["warmup_genome_size"])
    write_read_set(cfg, traffic, warm, tmp / "warm")
    run_sample(traffic, acfg, tmp / "warm", tmp / "run", device, sync)
    shutil.rmtree(tmp / "run")
    t.append(time.perf_counter())
    # the window starts with no write-back of set-up's files (or of an
    # earlier run's) still pending
    os.sync()
    t.append(time.perf_counter())
    parts = dict(zip(("kernels", "read_sets", "warm_up", "sync"),
                     np.diff(t)))
    return read_sets, set_dirs, parts


def window(args, traffic, acfg, set_dirs, tmp: Path, device: str, sync,
           tracer) -> tuple:
    """Whole samples one after another until args.seconds of sample time
    have passed; the sample running then finishes and counts. Returns
    (samples, their summed wall)."""
    rng = np.random.default_rng(set_seeds(args.seed, CHECK_DRAWS))
    samples, busy = [], 0.0
    while busy < args.seconds:
        i = len(samples) % len(set_dirs)
        wrote = written_bytes()
        with (tracer.sample() if tracer else contextlib.nullcontext()):
            rec = run_sample(traffic, acfg, set_dirs[i], tmp / "run",
                             device, sync)
        busy += rec["wall"]
        rec["set"] = i
        rec["out"] = collect(rec.pop("rd"), traffic, rng)
        shutil.rmtree(tmp / "run")
        rec["wrote"] = written_bytes() - wrote
        samples.append(rec)
    return samples, busy


def _run(args, t_start, device, bench, cell, cfg, traffic, limits, tmp,
         snp_rate):
    import torch

    from portbench import trace as ptrace

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acfg = assembly_config(cfg)
    wrote0 = written_bytes()
    read_sets, set_dirs, parts = set_up(args, cfg, traffic, acfg, tmp,
                                        device, sync, snp_rate)
    setup_s = time.perf_counter() - t_start
    parts["start"] = setup_s - sum(parts.values())
    wrote_setup = written_bytes() - wrote0

    tracer = ptrace.Tracer(device) if args.trace else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    samples, busy = window(args, traffic, acfg, set_dirs, tmp, device,
                           sync, tracer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if tracer:
        tracer.finish()

    # the check, once the window has closed
    t_check = time.perf_counter()
    per_sample = check_samples(samples, read_sets)
    n_failed = sum(not judge(got, limits)[0] for got in per_sample)
    correct, shown = judge(worst(per_sample), limits)
    t_check = time.perf_counter() - t_check

    genome_kb = cfg["genome_size"] / 1000.0
    values = {"genome_kb_per_s": len(samples) * genome_kb / busy,
              "peak_device_gib": peak / GIB, "setup_s": setup_s}
    if tracer:
        from portbench import metrics as pmetrics

        ctx = pmetrics.Context(samples=samples, trace=tracer,
                               device_kind=device_kind(device))
        values = pmetrics.read_all(cell_metrics(bench, cell["name"], True),
                                   ctx)
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell_metrics(bench, cell["name"], bool(tracer))
               if values.get(m["name"]) is not None}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": device_kind(device),
           "count": cell["chips"] if cuda else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(samples),
              "failed": n_failed, "metrics": metrics, "device": dev}
    if tracer:
        dev["busy_s"], dev["window_s"] = tracer.busy_s, tracer.window_s
        result["breakdown"] = tracer.breakdown()
    say(f"[portbench] {cell['name']} seed {args.seed}: {len(samples)} "
        f"samples of {genome_kb:.0f} kb in {busy:.3f} s (each "
        f"{[round(s['wall'], 3) for s in samples]}); set-up {setup_s:.3f} "
        f"s ({', '.join(f'{k} {v:.2f}' for k, v in parts.items())}); "
        f"wrote {wrote_setup / 1e6:.1f} MB in set-up and "
        f"{[round(s['wrote'] / 1e6, 1) for s in samples]} MB a sample; "
        f"check {t_check:.2f} s")
    result["checks"] = shown
    return result


def device_kind(device: str) -> str:
    if device != "cuda":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(0)


def print_result(result: dict) -> int:
    """The checks as the last lines on standard error, then the result as
    the last line of standard output. Returns the exit code: not 0, and
    no result, when a module of JAX or of the JAX package is loaded."""
    bad = forbidden_modules()
    if bad:
        say(f"portbench: JAX or the JAX package was loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        say(f"[check] {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
