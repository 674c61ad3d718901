"""The port's CLI on real-read inputs == the reference's, byte for byte.

Both packages' `pipeline.run.main` run in this one process (jump_ec's
duplicate test is a salted Python `hash`, equal only within a process):
`--frag-fastq` on interleaved FASTQs of a 10 kb genome, and
`--in-libs/--in-groups` on a 20 kb repeat genome with a fragment library
in mate files and two jump libraries, one a SAM with paired and RC flags,
the other mate FASTQs. The sheets store the per-pair library ids as
`lib_ids`, which the stages do not read (they read `lib_id`), so both
packages pool the two jump libraries into library 0 (ROADMAP Queue 3).
Every artifact, file and stage metric must be identical.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.pipeline import run as r_run  # noqa: E402
from allpathslg_tpu.pipeline.rundir import RunDir as RRunDir  # noqa: E402
from allpathslg_tpu_torch.eval import sim  # noqa: E402
from allpathslg_tpu_torch.io import fasta as t_fasta  # noqa: E402
from allpathslg_tpu_torch.io import sam as t_sam  # noqa: E402
from allpathslg_tpu_torch.pipeline import run as t_run  # noqa: E402
from allpathslg_tpu_torch.pipeline.rundir import RunDir as TRunDir  # noqa: E402

torch.set_num_threads(2)
SKIP = {"pipeline.log", "manifest.json"}


def _write_fastq(path, codes, quals, lengths, rows):
    t_fasta.write_fastq(str(path), ((f"r{i}", codes[i, :lengths[i]],
                                     quals[i, :lengths[i]]) for i in rows))


def _write_jump_sam(path, codes, quals, lengths, pairs):
    """Pairs with flags 0x1/0x40/0x80; every other second mate stored
    reverse-complemented with flag 0x10."""
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\n")
        for k, (i, j) in enumerate(pairs):
            for idx, flag in ((i, 0x41), (j, 0x81)):
                c, q = codes[idx, :lengths[idx]], quals[idx, :lengths[idx]]
                if k % 2 and flag == 0x81:
                    flag |= 0x10
                    c, q = (3 - c[::-1]) % 4, q[::-1]
                f.write(f"j{k}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t"
                        f"{t_sam.string_from_codes(c)}\t"
                        f"{(q + 33).astype(np.uint8).tobytes().decode()}\n")


def _run_both(tmp_path, argv, truth=None):
    """Runs both CLIs on argv (plus --run-dir); the port on the CPU."""
    dirs = {}
    for tag, mod, rdcls, extra in (("ref", r_run, RRunDir, []),
                                   ("port", t_run, TRunDir,
                                    ["--device", "cpu"])):
        d = tmp_path / tag
        if truth is not None:
            rdcls(str(d)).save_arrays("genome_truth", genome=truth)
        assert mod.main(["--run-dir", str(d)] + extra + argv) == 0
        dirs[tag] = d
    return dirs["ref"], dirs["port"]


def _assert_run_dirs_equal(ref: Path, port: Path):
    names = sorted(str(p.relative_to(ref)) for p in ref.rglob("*")
                   if p.is_file() and p.name not in SKIP)
    assert names == sorted(str(p.relative_to(port)) for p in port.rglob("*")
                           if p.is_file() and p.name not in SKIP)
    rd_r, rd_t = RRunDir(str(ref)), TRunDir(str(port))
    for name in names:
        if name.endswith(".npz"):
            a, b = rd_r.load_arrays(name[:-4]), rd_t.load_arrays(name[:-4])
            assert sorted(a) == sorted(b), name
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (name, k)
        else:
            assert (ref / name).read_bytes() == (port / name).read_bytes(), \
                name
    stages_r = rd_r.manifest["stages"]
    stages_t = rd_t.manifest["stages"]
    assert sorted(stages_r) == sorted(stages_t)
    for stage in stages_r:
        assert stages_r[stage]["metrics"] == stages_t[stage]["metrics"], stage
    return names, stages_t


def test_cli_frag_fastq(tmp_path):
    g = sim.random_genome(10_000, seed=31)
    b, p, _ = sim.simulate_paired_reads(g, coverage=40, error_rate=0.005,
                                        seed=32)
    codes, quals, lengths = (np.asarray(x) for x in (b.codes, b.quals,
                                                     b.lengths))
    half = len(p.pairs) // 2
    # two files, each pairs interleaved: the CLI pairs (0, 1), (2, 3), ...
    for name, rows in (("a.fastq", p.pairs[:half]), ("b.fastq",
                                                      p.pairs[half:])):
        _write_fastq(tmp_path / name, codes, quals, lengths,
                     np.asarray(rows).reshape(-1))
    ref, port = _run_both(tmp_path, [
        "batch_reads=4096", "--frag-fastq", str(tmp_path / "a.fastq"),
        str(tmp_path / "b.fastq")])
    names, stages = _assert_run_dirs_equal(ref, port)
    f = TRunDir(str(port)).load_arrays("frag_reads_orig")
    order = np.asarray(p.pairs).reshape(-1)
    assert (f["codes"] == codes[order]).all()
    assert (f["pairs"] == np.arange(len(order)).reshape(-1, 2)).all()
    assert "final.assembly.fasta" in names
    assert stages["unipaths"]["metrics"]["n50"] > 4_000


def test_cli_library_sheets_two_jump_libraries(tmp_path):
    g = sim.random_genome(20_000, seed=41)
    g[13_000:15_000] = g[4_000:6_000]          # a repeat for the scaffolds
    fb, fp, _ = sim.simulate_paired_reads(g, coverage=35, error_rate=0.005,
                                          seed=42)
    fc, fq, fl = (np.asarray(x) for x in (fb.codes, fb.quals, fb.lengths))
    fp = np.asarray(fp.pairs)
    _write_fastq(tmp_path / "frag_1.fastq", fc, fq, fl, fp[:, 0])
    _write_fastq(tmp_path / "frag_2.fastq", fc, fq, fl, fp[:, 1])
    j3, j3p, _ = sim.simulate_paired_reads(
        g, coverage=10, error_rate=0.005, insert_mean=3000, insert_sd=300,
        outward=True, seed=43)
    _write_jump_sam(tmp_path / "jump3k.sam", np.asarray(j3.codes),
                    np.asarray(j3.quals), np.asarray(j3.lengths),
                    np.asarray(j3p.pairs))
    j6, j6p, _ = sim.simulate_paired_reads(
        g, coverage=6, error_rate=0.005, insert_mean=6000, insert_sd=600,
        outward=True, seed=44)
    jc, jq, jl = (np.asarray(x) for x in (j6.codes, j6.quals, j6.lengths))
    j6p = np.asarray(j6p.pairs)
    _write_fastq(tmp_path / "jump6k_1.fastq", jc, jq, jl, j6p[:, 0])
    _write_fastq(tmp_path / "jump6k_2.fastq", jc, jq, jl, j6p[:, 1])
    (tmp_path / "in_libs.csv").write_text(
        "library_name,project_name,organism_name,type,paired,frag_size,"
        "frag_stddev,insert_size,insert_stddev,read_orientation,"
        "genomic_start,genomic_end\n"
        "frag,p,o,fragment,1,180,18,,,inward,,\n"
        "jmp3,p,o,jumping,1,,,3000,300,outward,,\n"
        "jmp6,p,o,jumping,1,,,6000,600,outward,,\n")
    (tmp_path / "in_groups.csv").write_text(
        "group_name,library_name,file_name\n"
        "g1,frag,frag_?.fastq\n"
        "g2,jmp3,jump3k.sam\n"
        "g3,jmp6,jump6k_?.fastq\n")
    ref, port = _run_both(tmp_path, [
        "--in-libs", str(tmp_path / "in_libs.csv"),
        "--in-groups", str(tmp_path / "in_groups.csv"), "--ploidy", "2",
        "batch_reads=4096"], truth=g)
    names, stages = _assert_run_dirs_equal(ref, port)
    assert (port / "ploidy").read_text() == "2\n"
    j = TRunDir(str(port)).load_arrays("jump_reads_orig")
    assert j["lib_sep"].tolist() == [3000, 6000]
    assert sorted(set(j["lib_ids"].tolist())) == [0, 1]
    # the stages read lib_id: both libraries pool into one jump library
    assert [k for k in stages["validate_inputs"]["metrics"]["libraries"]
            if k.startswith("jump")] == ["jump0"]
    assert stages["evaluate"]["metrics"]["genome_covered_frac"] > 0.8
    assert "assembly.superb" in names
