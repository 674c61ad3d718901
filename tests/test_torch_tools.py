"""The port's tools CLI == the reference's, subcommand by subcommand.

Each of the eight subcommands (stats, search, mutate, simulate, convert,
kspec, align, longproto) runs through both packages' `tools.main` on the
same files; the port's device subcommands run with `--device cpu`. The
standard output (JSON or TSV) and every file written must be identical.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu import tools as r_tools  # noqa: E402
from allpathslg_tpu_torch import tools as t_tools  # noqa: E402
from allpathslg_tpu_torch.eval import sim  # noqa: E402
from allpathslg_tpu_torch.io import fasta as fio  # noqa: E402
from allpathslg_tpu_torch.io import sam as t_sam  # noqa: E402

torch.set_num_threads(2)
DEVICE_CMDS = ("kspec", "align", "longproto")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    g = sim.random_genome(6000, seed=61)
    fio.write_fasta(str(d / "genome.fasta"),
                    [("chr1", g[:3500]), ("chr2", g[3500:])])
    b, p, _ = sim.simulate_paired_reads(g, coverage=20, read_len=100,
                                        error_rate=0.01, seed=62)
    codes, quals, lengths = (np.asarray(x) for x in (b.codes, b.quals,
                                                     b.lengths))
    codes[5, 10:14] = 4                        # N bases
    fio.write_fastq(str(d / "reads.fastq"), ((f"r{i}", codes[i], quals[i])
                                             for i in range(len(codes))))
    t_sam.write_sam(str(d / "reads.sam"), codes[:40], lengths[:40],
                    quals[:40])
    # reads with an indel each, so that align's rescue runs
    rng = np.random.default_rng(63)
    rows = []
    for i in range(120):
        s = int(rng.integers(0, len(g) - 120))
        r = g[s:s + 101].copy()
        cut = int(rng.integers(30, 70))
        r = np.delete(r, cut) if i % 2 else np.insert(r, cut, r[cut])[:100]
        rows.append(r[:100])
    fio.write_fasta(str(d / "indel_reads.fasta"),
                    [(f"q{i}", r) for i, r in enumerate(rows)])
    gl = sim.random_genome(2000, seed=64)
    lb, _, _ = sim.simulate_paired_reads(gl, coverage=25, read_len=250,
                                         insert_mean=550, insert_sd=20,
                                         error_rate=0.004, seed=65)
    lc, lq = np.asarray(lb.codes), np.asarray(lb.quals)
    fio.write_fastq(str(d / "long.fastq"), ((f"l{i}", lc[i], lq[i])
                                            for i in range(len(lc))))
    return d


def _both(capsys, tmp, name, argv_of):
    """Runs both mains on argv_of(out_dir); (ref stdout, port stdout,
    ref out dir, port out dir)."""
    outs = []
    for tag, mod in (("ref", r_tools), ("port", t_tools)):
        od = tmp / tag
        od.mkdir(exist_ok=True)
        argv = argv_of(od)
        if tag == "port" and argv[0] in DEVICE_CMDS:
            argv = argv + ["--device", "cpu"]
        assert mod.main(argv) == 0
        outs.append(capsys.readouterr().out.replace(str(od), "OUT"))
    return outs[0], outs[1], tmp / "ref", tmp / "port"


def _same_files(ref, port, names):
    for n in names:
        assert (ref / n).read_bytes() == (port / n).read_bytes(), n


@pytest.mark.parametrize("src", ["reads.fastq", "genome.fasta"])
def test_stats(capsys, tmp_path, files, src):
    a, b, _, _ = _both(capsys, tmp_path, "stats",
                       lambda od: ["stats", str(files / src)])
    assert a == b and json.loads(b)["n_reads"] > 0


def test_search(capsys, tmp_path, files):
    g = fio.read_fasta(str(files / "genome.fasta"))[1][1]
    q = "".join("ACGT"[c] for c in g[100:112]).lower()
    a, b, _, _ = _both(capsys, tmp_path, "search",
                       lambda od: ["search", str(files / "genome.fasta"), q])
    assert a == b and "chr2\t100\t+" in b


def test_mutate(capsys, tmp_path, files):
    a, b, ref, port = _both(capsys, tmp_path, "mutate", lambda od: [
        "mutate", str(files / "genome.fasta"), "--out",
        str(od / "mut.fasta"), "--snp-rate", "0.01", "--seed", "3"])
    assert a == b
    _same_files(ref, port, ["mut.fasta"])


def test_simulate(capsys, tmp_path, files):
    a, b, ref, port = _both(capsys, tmp_path, "simulate", lambda od: [
        "simulate", str(files / "genome.fasta"), "--out",
        str(od / "sim.fastq"), "--coverage", "5", "--read-len", "80",
        "--seed", "4"])
    assert a == b
    _same_files(ref, port, ["sim.fastq"])


@pytest.mark.parametrize("src,dst", [
    ("reads.fastq", "x.npz"), ("reads.sam", "x.npz"),
    ("genome.fasta", "x"), ("npz", "back.fastq"), ("npz", "back.fasta")])
def test_convert(capsys, tmp_path, files, src, dst):
    if src == "npz":
        src_path = tmp_path / "in.npz"
        r_tools.main(["convert", str(files / "reads.fastq"), "--out",
                      str(src_path)])
        capsys.readouterr()
    else:
        src_path = files / src
    a, b, ref, port = _both(capsys, tmp_path, "convert", lambda od: [
        "convert", str(src_path), "--out", str(od / dst)])
    assert a == b
    if src == "npz":
        _same_files(ref, port, [dst])
        return
    name = dst if dst.endswith(".npz") else dst + ".npz"
    za, zb = np.load(ref / name), np.load(port / name)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].tobytes() == \
            zb[k].tobytes(), k


@pytest.mark.parametrize("k", [25, 24])
def test_kspec(capsys, tmp_path, files, k):
    a, b, _, _ = _both(capsys, tmp_path, "kspec", lambda od: [
        "kspec", str(files / "reads.fastq"), "--k", str(k)])
    assert a == b and json.loads(b)["genome_size_est"] > 0


@pytest.mark.parametrize("reads", ["reads.fastq", "indel_reads.fasta"])
def test_align(capsys, tmp_path, files, reads):
    a, b, _, _ = _both(capsys, tmp_path, "align", lambda od: [
        "align", str(files / reads), str(files / "genome.fasta")])
    assert a == b
    rows = [r.split("\t") for r in b.strip().splitlines()]
    assert sum(r[5] == "1" for r in rows) >= 0.8 * len(rows)


def test_longproto(capsys, tmp_path, files):
    a, b, ref, port = _both(capsys, tmp_path, "longproto", lambda od: [
        "longproto", str(files / "long.fastq"), "--out",
        str(od / "contigs.fasta")])
    assert a == b
    _same_files(ref, port, ["contigs.fasta"])
    m = json.loads(b)
    assert m["n_contigs"] >= 1 and m["n_bases_corrected"] > 0


@pytest.mark.parametrize("cmd", DEVICE_CMDS)
def test_device_subcommands_default_to_the_card(files, cmd):
    """Without --device, kspec, align and longproto ask for the card: on a
    machine without one they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"kspec": ["kspec", str(files / "reads.fastq")],
            "align": ["align", str(files / "reads.fastq"),
                      str(files / "genome.fasta")],
            "longproto": ["longproto", str(files / "long.fastq"), "--out",
                          str(files / "never.fasta")]}[cmd]
    with pytest.raises((RuntimeError, AssertionError)):
        t_tools.main(argv)
    assert not (files / "never.fasta").exists()
