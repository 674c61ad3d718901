"""The port's real-read ingest == the reference's, byte for byte.

FASTQ (plain files through each package's native reader, `.gz` through
each package's Python parser), SAM (the fixtures of the reference's
tests/test_prepare_sam.py: paired and RC flags, secondary and
supplementary records, duplicates, `*` qualities; the port's native SAM
reader on edge cases and on the files it declines, each case naming the
parser that ran) and library sheets
(pipeline/prepare.prepare_inputs: mates by `?` and by comma, an
interleaved FASTQ, a SAM jump library, two jump libraries, a long-jump
library and a PacBio FASTQ). Every array, the `ploidy` file and the
prepare log must be identical.
"""

import gzip
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.eval import sim  # noqa: E402
from allpathslg_tpu.io import native_fastq as r_fastq  # noqa: E402
from allpathslg_tpu.io import sam as r_sam  # noqa: E402
from allpathslg_tpu.pipeline import prepare as r_prepare  # noqa: E402
from allpathslg_tpu.pipeline.rundir import RunDir as RRunDir  # noqa: E402
from allpathslg_tpu_torch import trace  # noqa: E402
from allpathslg_tpu_torch.io import fasta as t_fasta  # noqa: E402
from allpathslg_tpu_torch.io import native_fastq as t_fastq  # noqa: E402
from allpathslg_tpu_torch.io import sam as t_sam  # noqa: E402
from allpathslg_tpu_torch.native import build as t_build  # noqa: E402
from allpathslg_tpu_torch.pipeline import prepare as t_prepare  # noqa: E402
from allpathslg_tpu_torch.pipeline.rundir import RunDir as TRunDir  # noqa: E402
from portbench import readfiles  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "allpathslg_tpu_torch"


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _edge_fastq() -> bytes:
    """Records with N and IUPAC codes, lower case, CRLF line ends, ragged
    lengths, qualities above 60 ('~' = 93) and below '!'."""
    rng = np.random.default_rng(7)
    recs = [b"@r0\r\nACGTNRYKMacgtnSWBDHV\r\n+\r\nIIII~~~~!!#5+?@ABCDE\r\n",
            b"@r1 lower\nacgtacgtAC\n+\n~~~~~~~~~~\n",
            b"@r2\nAC\n+\n" + bytes([32, 126]) + b"\n"]
    for i in range(3, 40):   # ragged random reads
        n = int(rng.integers(1, 90))
        seq = rng.choice(np.frombuffer(b"ACGTNacgtRY", np.uint8), n)
        q = rng.integers(33, 127, n).astype(np.uint8)
        end = b"\r\n" if i % 3 == 0 else b"\n"
        recs.append(b"@r%d%s%s%s+%s%s%s" % (i, end, seq.tobytes(), end, end,
                                            q.tobytes(), end))
    return b"".join(recs)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_fastq_edge_cases_equal_the_reference(tmp_path, gz):
    path = tmp_path / ("edge.fastq.gz" if gz else "edge.fastq")
    data = _edge_fastq()
    path.write_bytes(gzip.compress(data) if gz else data)
    got = t_fastq.read_fastq_arrays(str(path))
    _same_arrays(got, r_fastq.read_fastq_arrays(str(path)))
    codes, quals, lengths = got
    assert lengths[0] == 20 and (codes[0, 4:9] == 4).all()
    assert (codes[0, 13:20] == 4).all() and (codes[0, 9:13] < 4).all()
    assert (codes[1, :8] == [0, 1, 2, 3] * 2).all()   # lower case
    # the native reader clamps qualities to 60; the Python parser does not
    assert quals[1, 0] == (93 if gz else 60)


def test_fastq_simulated_reads_round_trip(tmp_path):
    g = sim.random_genome(3000, seed=3)
    b, _, _ = sim.simulate_paired_reads(g, coverage=10, read_len=80,
                                        error_rate=0.01, seed=4)
    codes, quals = np.asarray(b.codes), np.asarray(b.quals)
    path = str(tmp_path / "sim.fastq")
    t_fasta.write_fastq(path, ((f"r{i}", codes[i], quals[i])
                               for i in range(len(codes))))
    got = t_fastq.read_fastq_arrays(path)
    _same_arrays(got, r_fastq.read_fastq_arrays(path))
    assert (got[0] == codes).all() and (got[1] == quals).all()


@pytest.mark.parametrize("name, loader, prefix", [
    ("fastq_reader", "fastq_lib", "fastq"),
    ("sam_reader", "sam_lib", "sam"),
])
def test_native_reader_builds_outside_the_package(name, loader, prefix):
    before = {p for p in PORT_DIR.rglob("*") if "__pycache__" not in p.parts}
    lib = getattr(t_build, loader)()
    assert getattr(lib, f"{prefix}_scan") and getattr(lib, f"{prefix}_load")
    so = Path(lib._name)
    assert so.parent == t_build.BUILD_DIR == ROOT / "build" / "native"
    assert so.name.startswith(f"lib{name}_") and so.exists()
    after = {p for p in PORT_DIR.rglob("*") if "__pycache__" not in p.parts}
    assert after == before
    assert not list(PORT_DIR.rglob("*.so"))


def _sim_reads(n_pairs=60, L=70, seed=2, genome_seed=1, G=4000):
    g = sim.random_genome(G, seed=genome_seed)
    batch, pairs, _ = sim.simulate_paired_reads(
        g, coverage=2 * n_pairs * L / G, read_len=L, error_rate=0.01,
        seed=seed)
    return (np.asarray(batch.codes), np.asarray(batch.quals),
            np.asarray(batch.lengths), np.asarray(pairs.pairs))


def test_sam_round_trip(tmp_path):
    """tests/test_prepare_sam.py::test_sam_roundtrip's fixture."""
    codes, quals, lengths, _ = _sim_reads()
    p = str(tmp_path / "reads.sam")
    t_sam.write_sam(p, codes, lengths, quals)
    q = str(tmp_path / "reads_ref.sam")
    r_sam.write_sam(q, codes, lengths, quals)
    assert Path(p).read_bytes() == Path(q).read_bytes()
    got = t_sam.read_sam(p)
    _same_arrays(got[:4], r_sam.read_sam(p)[:4])
    assert got[4] == r_sam.read_sam(p)[4]
    assert (got[0] == codes).all() and (got[1] == quals).all()
    assert len(got[3]) == 0


def _flag_sam(path):
    """tests/test_prepare_sam.py::test_sam_paired_and_rc_flags' records,
    plus supplementary, duplicate, unpaired, `*`-quality, N-bearing and
    out-of-order mates."""
    seq1, rc2 = "ACGTACGTAA", "AATTGGCCAA"
    rows = [
        ("q", 0x1 | 0x40, seq1, "I" * 10),
        ("q", 0x1 | 0x80 | 0x10, rc2, "I" * 10),
        ("q", 0x1 | 0x80 | 0x100, rc2, "*"),           # secondary
        ("s", 0x1 | 0x80 | 0x800, "ACGT", "IIII"),     # supplementary
        ("m", 0x1 | 0x80 | 0x10, "ACNNTTGA", "*"),     # second mate first
        ("u", 0x4, "GGGNNacgt", "#%&'()*+,"),          # unpaired
        ("d", 0x1 | 0x40 | 0x400, "TTTTCCCC", "~~~~~~~~"),   # duplicate
        ("m", 0x1 | 0x40, "CCCGGGAAAT", "!!!!!!!!!!"),
        ("d", 0x1 | 0x80 | 0x400 | 0x10, "GGGGAAAA", "55555555"),
        ("z", 0x1 | 0x40, "*", "*"),                   # no sequence
    ]
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\n@SQ\tSN:ref\tLN:100\n")
        for name, flag, seq, qual in rows:
            f.write(f"{name}\t{flag}\tref\t5\t60\t*\t*\t0\t0\t{seq}\t"
                    f"{qual}\n")
        f.write("short\tline\n")


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("keep_duplicates", [True, False])
def test_sam_flags_equal_the_reference(tmp_path, gz, keep_duplicates):
    p = tmp_path / "p.sam"
    _flag_sam(p)
    if gz:
        Path(str(p) + ".gz").write_bytes(gzip.compress(p.read_bytes()))
        p = Path(str(p) + ".gz")
    got, counters = _read_sam_traced(p, keep_duplicates)
    want = r_sam.read_sam(str(p), keep_duplicates=keep_duplicates)
    _same_arrays(got[:4], want[:4])
    assert got[4] == want[4]
    # plain files go through the native reader, gzip through Python
    via = "reads_python" if gz else "reads_native"
    assert counters["reads"] == counters[via] == len(got[2])
    # the RC mate comes back in its sequenced orientation
    assert t_sam.string_from_codes(got[0][1, :10]) == "TTGGCCAATT"
    assert got[3][:1].tolist() == [[0, 1]]


def _read_sam_traced(path, keep_duplicates=True):
    """(read_sam's result, or the exception it raised, and the counters
    of its ingest.sam span), under a CPU profiler session."""
    trace.clear()
    got = None
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = t_sam.read_sam(str(path), keep_duplicates=keep_duplicates)
    except Exception as e:  # noqa: BLE001 - compared with the reference's
        got = e
    (sp,) = [s for s in trace.spans() if s.name == "ingest.sam"]
    trace.clear()
    return got, sp.counters


def _sam_lines(rows) -> bytes:
    return b"".join(b"%s\t%s\tref\t5\t60\t*\t*\t0\t0\t%s\t%s\n"
                    % tuple(x.encode() if isinstance(x, str) else x
                            for x in r) for r in rows)


def _edge_sam() -> bytes:
    """QNAMEs on three records, paired records with neither 0x40 nor
    0x80 and with both, an orphan mate, lower-case and IUPAC bases, `*`
    QUAL on a 0x10 record, an empty SEQ, FLAG with leading zeros, tags,
    short and empty lines, and no trailing newline."""
    rows = [
        ("t", "65", "ACGTTGCA", "IIIIHHHH"),
        ("t", "129", "GGGTTT", "ABCDEF"),
        ("t", "65", "CCCAAA", "!!##$$"),          # third record of t
        ("w", "65", "AAAA", "IIII"),
        ("w", "65", "CCCC", "IIII"),              # overwrites the first w
        ("w", "129", "GGGG", "IIII"),             # pairs with the second
        ("n", "1", "acgtRYKMSWBDHVN", "I" * 15),  # neither 0x40 nor 0x80
        ("o", "65", "TTTTAAAA", "55555555"),      # orphan
        ("n", "65", "AACC", "IIII"),
        ("b", "1", "ACGT", "IIII"),
        ("b", "193", "TTGG", "JJJJ"),             # both 0x40 and 0x80
        ("r", "0145", "ACGTNNacgt", "*"),         # 0x91 (RC), `*` QUAL
        ("e", "4", "", ""),                       # empty SEQ is kept
        ("x", "1105", "CCCC", "IIII"),            # 0x451: a duplicate
        ("r", "97", "GATTACA", "0123456"),
        ("d", "1089", "GGCC", "FFFF"),            # 0x441 duplicate
    ]
    body = b"@HD\tVN:1.6\n@SQ\tSN:ref\tLN:100\n" + _sam_lines(rows)
    body += b"\n" + b"\t".join([b"ten"] * 10) + b"\n"
    last = _sam_lines([("q", "17", "ACGTA", "IIIII")])[:-1]
    body += last + b"\tNM:i:0\tXS:Z:+"
    return body


SAM_CASES = {
    # name: (the file's bytes, the parser expected)
    "edge": (_edge_sam, "native"),
    "header_only": (lambda: b"@HD\tVN:1.6\n@SQ\tSN:ref\tLN:100\n",
                    "python"),
    "crlf": (lambda: _edge_sam().replace(b"\n", b"\r\n"), "python"),
    "lone_cr": (lambda: _edge_sam().replace(b"\n", b"\r", 3), "python"),
    "utf8_qname": (lambda: _edge_sam().replace(
        b"\no\t", "\n\u00f6\t".encode()), "python"),
    "plus_flag": (lambda: _edge_sam().replace(b"\nn\t65\t", b"\nn\t+65\t"),
                  "python"),
    "short_qual": (lambda: _edge_sam().replace(b"\t55555555\n", b"\t555\n"),
                   "python"),
    "long_qual": (lambda: _edge_sam().replace(
        b"\tIIII\n", b"\t" + b"I" * 40 + b"\n", 1), "python"),
}


@pytest.mark.parametrize("keep_duplicates", [True, False])
@pytest.mark.parametrize("case", list(SAM_CASES))
def test_sam_native_reader_cases_equal_the_reference(tmp_path, case,
                                                     keep_duplicates):
    """Each case == the reference's read_sam (or raises what it raises),
    and the span names the parser that ran: the native reader, or the
    Python parser where the native one declines the file."""
    make, via = SAM_CASES[case]
    data = make()
    p = tmp_path / f"{case}.sam"
    p.write_bytes(data)
    got, counters = _read_sam_traced(p, keep_duplicates)
    try:
        want = r_sam.read_sam(str(p), keep_duplicates=keep_duplicates)
    except Exception as e:  # noqa: BLE001
        assert type(got) is type(e) and str(got) == str(e)
        assert case == "long_qual"   # its QUAL overruns every row
        return
    assert not isinstance(got, Exception), got
    _same_arrays(got[:4], want[:4])
    assert got[4] == want[4]
    n = len(got[2])
    assert counters == {"reads": n, f"reads_{via}": n,
                        "bytes": len(data)}
    if case == "edge":
        names = got[4]
        assert names.count("t") == 3 and "e" in names
        w = [i for i, x in enumerate(names) if x == "w"]
        assert [w[1], w[2]] in got[3].tolist()
        assert got[2][names.index("e")] == 0
        i = names.index("r")   # the RC record: codes reverse-complemented
        assert t_sam.string_from_codes(got[0][i, :10]) == "ACGTNNACGT"
        assert (got[1][i, :10] == 30).all()
        assert ("x" in names) == keep_duplicates


@pytest.mark.parametrize("L", [37, 101])
def test_sam_native_round_trip_of_benchmark_pairs(tmp_path, L):
    """Mates written as the benchmark's traffic writes them (0x41 / 0x81,
    every odd pair's second mate reverse-complemented with 0x10) read back
    through the native reader as written, == the reference's parse."""
    n_pairs = 3000
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 5, (2 * n_pairs, L)).astype(np.uint8)
    quals = rng.integers(2, 41, (2 * n_pairs, L)).astype(np.uint8)
    pairs = np.arange(2 * n_pairs, dtype=np.int32).reshape(-1, 2)
    p = tmp_path / "jump.sam"
    readfiles.write_pairs_sam(p, codes, quals, pairs, b"j")
    got, counters = _read_sam_traced(p)
    assert counters["reads_native"] == counters["reads"] == 2 * n_pairs
    assert "reads_python" not in counters
    assert (got[0] == codes).all() and (got[1] == quals).all()
    assert (got[2] == L).all() and (got[3] == pairs).all()
    want = r_sam.read_sam(str(p))
    _same_arrays(got[:4], want[:4])
    assert got[4] == want[4]


def test_bam_through_samtools(tmp_path):
    import shutil
    import subprocess

    if not shutil.which("samtools"):
        pytest.skip("samtools is not on PATH")
    codes, quals, lengths, _ = _sim_reads(n_pairs=10)
    sam = str(tmp_path / "r.sam")
    t_sam.write_sam(sam, codes, lengths, quals)
    bam = str(tmp_path / "r.bam")
    subprocess.run(["samtools", "view", "-b", "-o", bam, sam], check=True)
    _same_arrays(t_sam.read_bam(bam)[:4], r_sam.read_bam(bam)[:4])


# ---- library sheets ----

def _write_fastq(path, codes, quals, lengths, prefix="r"):
    t_fasta.write_fastq(str(path), ((f"{prefix}{i}", codes[i, :lengths[i]],
                                     quals[i, :lengths[i]])
                                    for i in range(len(lengths))))


def _write_paired_sam(path, codes, quals, lengths, pairs):
    """Mates as SAM records with paired flags; odd pairs' second mates
    reverse-complemented with flag 0x10, and a secondary copy of one."""
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\n")
        for k, (i, j) in enumerate(pairs):
            for idx, flag in ((i, 0x1 | 0x40), (j, 0x1 | 0x80)):
                c, q = codes[idx, :lengths[idx]], quals[idx, :lengths[idx]]
                if k % 2 and flag & 0x80:
                    flag |= 0x10
                    c, q = (3 - c[::-1]) % 4, q[::-1]
                seq = t_sam.string_from_codes(c)
                qs = (q + 33).astype(np.uint8).tobytes().decode()
                f.write(f"p{k}\t{flag}\tref\t1\t60\t*\t*\t0\t0\t{seq}\t"
                        f"{qs}\n")
                if k == 3:
                    f.write(f"p{k}\t{flag | 0x100}\tref\t9\t0\t*\t*\t0\t0\t"
                            f"{seq}\t*\n")


LIB_HEADER = ("library_name,project_name,organism_name,type,paired,"
              "frag_size,frag_stddev,insert_size,insert_stddev,"
              "read_orientation,genomic_start,genomic_end\n")


@pytest.fixture(scope="module")
def sheets(tmp_path_factory):
    """Files and sheets of every kind prepare_inputs reads."""
    d = tmp_path_factory.mktemp("sheets")
    fc, fq, fl, fp = _sim_reads(n_pairs=60, L=70, seed=2)
    r1, r2 = fp[:, 0], fp[:, 1]
    _write_fastq(d / "fragA_1.fastq", fc[r1], fq[r1], fl[r1])
    _write_fastq(d / "fragA_2.fastq", fc[r2], fq[r2], fl[r2])
    bc, bq, bl, bp = _sim_reads(n_pairs=30, L=90, seed=5)
    _write_fastq(d / "fragB_R1.fastq.gz", bc[bp[:, 0]], bq[bp[:, 0]],
                 bl[bp[:, 0]])
    _write_fastq(d / "fragB_R2.fastq.gz", bc[bp[:, 1]], bq[bp[:, 1]],
                 bl[bp[:, 1]])
    ic, iq, il, ip = _sim_reads(n_pairs=25, L=60, seed=8)
    order = ip.reshape(-1)                     # interleaved (0,1), (2,3)...
    _write_fastq(d / "frag_interleaved.fastq", ic[order], iq[order],
                 il[order])
    jc, jq, jl, jp = _sim_reads(n_pairs=40, L=80, seed=11)
    _write_paired_sam(d / "jump3k.sam", jc, jq, jl, jp)
    kc, kq, kl, kp = _sim_reads(n_pairs=20, L=75, seed=14)
    _write_fastq(d / "jump6k_1.fastq", kc[kp[:, 0]], kq[kp[:, 0]],
                 kl[kp[:, 0]])
    _write_fastq(d / "jump6k_2.fastq", kc[kp[:, 1]], kq[kp[:, 1]],
                 kl[kp[:, 1]])
    lc, lq, ll, lp = _sim_reads(n_pairs=15, L=100, seed=17)
    _write_paired_sam(d / "longjump.sam", lc, lq, ll, lp)
    g = sim.random_genome(6000, seed=19)
    pb, _, _ = sim.simulate_long_reads(g, coverage=3, seed=20)
    with open(d / "pacbio.fastq", "w") as f:
        for i, r in enumerate(pb):
            qs = "5" * len(r)
            f.write(f"@pb{i}\n{t_sam.string_from_codes(r)}\n+\n{qs}\n")
    (d / "in_libs.csv").write_text(
        LIB_HEADER
        + "fragA,p,o,fragment,1,180,18,,,inward,,\n"
        + "fragB,p,o,fragment,1,200,,,,inward,,\n"
        + "fragI,p,o,fragment,1,160,16,,,inward,,\n"
        + "jmp3,p,o,jumping,1,,,3000,300,outward,,\n"
        + "jmp6,p,o,,1,,,6000,600,outward,,\n"
        + "lj,p,o,long_jump,1,,,12000,1200,outward,,\n"
        + "pb,p,o,long,0,,,,,,,\n")
    (d / "in_groups.csv").write_text(
        "group_name,library_name,file_name\n"
        "gA,fragA,fragA_?.fastq\n"
        f'gB,fragB,"{d}/fragB_R1.fastq.gz, {d}/fragB_R2.fastq.gz"\n'
        "gI,fragI,frag_interleaved.fastq\n"
        "gJ3,jmp3,jump3k.sam\n"
        f'gJ6,jmp6,"{d}/jump6k_1.fastq,{d}/jump6k_2.fastq"\n'
        "gL,lj,longjump.sam\n"
        "gP,pb,pacbio.fastq\n")
    return d


def test_sheet_parsing_equals_the_reference(sheets):
    libs_t = t_prepare.read_in_libs(str(sheets / "in_libs.csv"))
    libs_r = r_prepare.read_in_libs(str(sheets / "in_libs.csv"))
    assert ({k: vars(v) for k, v in libs_t.items()}
            == {k: vars(v) for k, v in libs_r.items()})
    assert ([(v.is_fragment, v.sep, v.sd) for v in libs_t.values()]
            == [(v.is_fragment, v.sep, v.sd) for v in libs_r.values()])
    assert (t_prepare.read_in_groups(str(sheets / "in_groups.csv"))
            == r_prepare.read_in_groups(str(sheets / "in_groups.csv")))
    for pattern in ("fragA_?.fastq", "a.fastq,b.fastq", "x.sam"):
        path = str(sheets / pattern)
        assert (t_prepare._load_group_files(path)
                == r_prepare._load_group_files(path))


def _prepare_both(tmp_path, sheets, libs_csv, groups_csv, ploidy):
    logs = {"ref": [], "port": []}
    rds = {}
    for tag, mod, rdcls in (("ref", r_prepare, RRunDir),
                            ("port", t_prepare, TRunDir)):
        rd = rdcls(str(tmp_path / tag))
        counts = mod.prepare_inputs(rd, str(libs_csv), str(groups_csv),
                                    ploidy=ploidy, log=logs[tag].append)
        rds[tag] = (rd, counts)
    assert logs["ref"] == logs["port"]
    assert rds["ref"][1] == rds["port"][1]
    return rds["ref"][0], rds["port"][0], rds["port"][1]


ARTS = ("frag_reads_orig", "jump_reads_orig", "long_jump_reads_orig",
        "long_reads_orig")


def test_prepare_inputs_every_library_kind(tmp_path, sheets):
    rd_r, rd_t, counts = _prepare_both(tmp_path, sheets,
                                       sheets / "in_libs.csv",
                                       sheets / "in_groups.csv", ploidy=2)
    assert set(counts) == set(ARTS)
    for art in ARTS:
        a, b = rd_r.load_arrays(art), rd_t.load_arrays(art)
        assert sorted(a) == sorted(b), art
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (art, k)
    assert (Path(rd_t.file_path("ploidy")).read_bytes()
            == Path(rd_r.file_path("ploidy")).read_bytes() == b"2\n")
    j = rd_t.load_arrays("jump_reads_orig")
    # the reference's key and dtype: int8 lib_ids, two jump libraries
    assert j["lib_ids"].dtype == np.int8 and "lib_id" not in j
    assert sorted(set(j["lib_ids"].tolist())) == [0, 1]
    assert j["lib_sep"].tolist() == [3000, 6000]
    f = rd_t.load_arrays("frag_reads_orig")
    assert f["lib_sep"].tolist() == [180, 200, 160]


def test_prepare_inputs_reads_pair_back(tmp_path, sheets):
    """Mate files and the SAM's RC mates re-pair to the simulated pairs."""
    (sheets / "libs_j.csv").write_text(
        LIB_HEADER + "jmp3,p,o,jumping,1,,,3000,300,outward,,\n")
    (sheets / "groups_j.csv").write_text(
        "group_name,library_name,file_name\ngJ3,jmp3,jump3k.sam\n")
    _, rd_t, _ = _prepare_both(tmp_path, sheets, sheets / "libs_j.csv",
                               sheets / "groups_j.csv", ploidy=1)
    jc, jq, jl, jp = _sim_reads(n_pairs=40, L=80, seed=11)
    a = rd_t.load_arrays("jump_reads_orig")
    assert len(a["pairs"]) == len(jp)
    for (i, j), (si, sj) in zip(a["pairs"], jp):
        for got, want in ((i, si), (j, sj)):
            n = jl[want]
            assert a["lengths"][got] == n
            assert (a["codes"][got, :n] == jc[want, :n]).all()
            assert (a["quals"][got, :n] == jq[want, :n]).all()


def test_smoke_files_import_as_simulated(tmp_path):
    """chip_smoke.py's numpy writers (phase 8's mate FASTQs, paired SAM
    with RC mates and sheets; phase 9's N bases) read back through both
    packages' prepare_inputs as the same artifacts, every pair holding its
    simulated reads."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    g = sim.random_genome(5000, seed=23)
    rng = np.random.default_rng(24)
    libs = []
    for seed, kw in ((25, {}), (26, dict(insert_mean=3000, insert_sd=300,
                                         outward=True))):
        b, p, _ = sim.simulate_paired_reads(g, coverage=8, error_rate=0.01,
                                            seed=seed, **kw)
        lib = dict(codes=np.asarray(b.codes), quals=np.asarray(b.quals),
                   lengths=np.asarray(b.lengths), pairs=np.asarray(p.pairs))
        libs.append(chip_smoke.with_n_bases(lib, rng))
    assert all((lib["codes"] == 4).any() for lib in libs)
    files = tmp_path / "reads"
    chip_smoke.write_read_files(files, libs[0], libs[1], (180, 18),
                                (3000, 300))
    rd_r, rd_t, counts = _prepare_both(tmp_path, files,
                                       files / "in_libs.csv",
                                       files / "in_groups.csv", ploidy=1)
    for art, lib in zip(("frag_reads_orig", "jump_reads_orig"), libs):
        a, b = rd_r.load_arrays(art), rd_t.load_arrays(art)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a), art
        chip_smoke.check_imported_pairs(rd_t, art, lib, "test")
        assert counts[art] == 2 * len(lib["pairs"])
