"""The port's diagnostics == the reference's.

check_mode (validate_inputs' device spectrum of the first 512 reads held
against the Python oracle), evaluation="CHEAT" (find_errors' true-kmer
fractions, unipaths' truth accuracy: the fixture of the reference's
tests/test_aux_subsystems.py::test_cheat_mode_truth_diagnostics), the
oracle functions themselves, and profile_dir (a torch.profiler trace of
each stage, one stage traced at a time as with the reference's
jax.profiler.trace).
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.eval import oracle as r_oracle  # noqa: E402
from allpathslg_tpu.kmer import count as r_count  # noqa: E402
from allpathslg_tpu.pipeline.config import AssemblyConfig as RConfig  # noqa: E402
from allpathslg_tpu.pipeline.rundir import RunDir as RRunDir  # noqa: E402
from allpathslg_tpu.pipeline.run import prepare_sim_inputs as rprepare  # noqa: E402
from allpathslg_tpu.pipeline.stages import Pipeline as RPipeline  # noqa: E402
from allpathslg_tpu_torch.eval import oracle as t_oracle  # noqa: E402
from allpathslg_tpu_torch.kmer import count as t_count  # noqa: E402
from allpathslg_tpu_torch.pipeline import stages as t_stages  # noqa: E402
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig as TConfig  # noqa: E402
from allpathslg_tpu_torch.pipeline.rundir import RunDir as TRunDir  # noqa: E402
from allpathslg_tpu_torch.pipeline.run import prepare_sim_inputs as tprepare  # noqa: E402
from allpathslg_tpu_torch.pipeline.stages import Pipeline as TPipeline  # noqa: E402

torch.set_num_threads(2)
# tests/test_aux_subsystems.py's _mk: 30 kb, 40x at 0.3 % error, seed 3,
# 20x jumps of 2500 +- 250, K=48
SIM = (30000, 40.0, 0.003, 100, 3)
JUMPS = dict(jump_coverage=20.0, jump_insert=2500, jump_sd=250)
CFG = dict(K=48, batch_reads=4096, stage_workers=1)
STAGES = ("validate_inputs", "remove_dodgy", "precorrect", "find_errors",
          "clean_reads", "fill_fragments", "unipaths")


def _pipelines(tmp, **over):
    logs = {"ref": [], "port": []}
    rd_r = RRunDir(str(tmp / "ref"))
    rprepare(rd_r, *SIM, lambda *a: None, **JUMPS)
    rd_t = TRunDir(str(tmp / "port"))
    tprepare(rd_t, *SIM, lambda *a: None, **JUMPS)
    ref = RPipeline(rd_r, RConfig.from_overrides(**CFG, **over),
                    lambda *a: logs["ref"].append(" ".join(map(str, a))))
    port = TPipeline(rd_t, TConfig.from_overrides(**CFG, **over),
                     lambda *a: logs["port"].append(" ".join(map(str, a))),
                     device="cpu")
    return ref, port, logs


@pytest.fixture(scope="module")
def cheat(tmp_path_factory):
    ref, port, logs = _pipelines(tmp_path_factory.mktemp("cheat"),
                                 evaluation="CHEAT", check_mode=True)
    m_r = {s: getattr(ref, s)() for s in STAGES}
    m_t = {s: getattr(port, s)() for s in STAGES}
    return m_r, m_t, logs


@pytest.mark.parametrize("stage", STAGES)
def test_check_and_cheat_metrics_equal_the_reference(cheat, stage):
    m_r, m_t, _ = cheat
    assert json.dumps(m_r[stage], sort_keys=True) == \
        json.dumps(m_t[stage], sort_keys=True)


def test_cheat_metrics_present(cheat):
    _, m_t, logs = cheat
    fe, un = m_t["find_errors"], m_t["unipaths"]
    assert fe["cheat_true_kmer_frac_after"] >= fe["cheat_true_kmer_frac_before"]
    assert fe["cheat_true_kmer_frac_after"] > 0.99
    assert un["cheat_genome_covered_frac"] > 0.9
    assert {"cheat_misassembly_breaks", "cheat_anchor_place_rate"} <= set(un)
    for tag in ("ref", "port"):
        assert "  [check] spectrum oracle ok on 512 reads" in logs[tag]
    cheat_lines = [[m for m in logs[tag] if "CHEAT" in m]
                   for tag in ("ref", "port")]
    assert cheat_lines[0] == cheat_lines[1] and len(cheat_lines[0]) == 2


def test_check_mode_raises_the_reference_message(tmp_path, monkeypatch):
    """A wrong device spectrum fails check_mode with the same text."""
    def wrong(orig):
        def spectrum_reads(codes, K, max_freq=255):
            spec, nu = orig(codes, K, max_freq)
            if torch.is_tensor(spec):
                spec = spec.clone()
                spec[3] += 1
                return spec, nu
            return spec.at[3].add(1), nu
        return spectrum_reads

    monkeypatch.setattr(r_count, "spectrum_reads", wrong(
        r_count.spectrum_reads))
    monkeypatch.setattr(t_count, "spectrum_reads", wrong(
        t_count.spectrum_reads))
    ref, port, _ = _pipelines(tmp_path, check_mode=True)
    msgs = []
    for pipe in (ref, port):
        with pytest.raises(AssertionError) as err:
            pipe.validate_inputs()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith("check_mode: device spectrum disagrees with "
                              "oracle at freqs [3]")


def test_oracle_functions_equal_the_reference():
    rng = np.random.default_rng(5)
    reads = [rng.integers(0, 5 if i % 4 == 0 else 4,
                          int(rng.integers(10, 60))).astype(np.uint8)
             for i in range(40)]
    genome = rng.integers(0, 4, 400).astype(np.uint8)
    reads.append(np.concatenate([genome[:50], genome[:50]]))  # repeats
    for K in (5, 12):
        c_r, c_t = r_oracle.count_kmers(reads, K), t_oracle.count_kmers(
            reads, K)
        assert c_r == c_t and sum(c_t.values()) > 0
        for mf in (3, 255):
            s_r = r_oracle.kmer_spectrum(c_r, mf)
            s_t = t_oracle.kmer_spectrum(c_t, mf)
            assert s_r.dtype == s_t.dtype and (s_r == s_t).all()
        kset = set(r_oracle.count_kmers([genome], K))
        assert r_oracle.unipaths(kset, K) == t_oracle.unipaths(kset, K)
    for fn in ("rc_codes", "kmer_tuple", "canonical_kmer"):
        x = genome[:31]
        a, b = getattr(r_oracle, fn)(x), getattr(t_oracle, fn)(x)
        assert np.array_equal(np.asarray(a), np.asarray(b))
    from allpathslg_tpu_torch.kmer import bits
    for K in (16, 24, 48):
        words = bits.np_pack(genome[:K], K)
        assert (r_oracle.words_to_tuple(np.asarray(words, np.uint32), K)
                == t_oracle.words_to_tuple(np.asarray(words, np.uint32), K)
                == tuple(int(c) for c in genome[:K]))


def test_profile_dir_traces_each_stage(tmp_path):
    """profile_dir on the CPU: one torch.profiler trace a stage, and the
    same artifacts and metrics as a run without it."""
    runs = {}
    for tag, over in (("plain", {}),
                      ("traced", {"profile_dir": str(tmp_path / "trace")})):
        rd = TRunDir(str(tmp_path / tag))
        tprepare(rd, 12000, 30.0, 0.005, 100, 4, lambda *a: None)
        pipe = TPipeline(rd, TConfig.from_overrides(**CFG, **over),
                         lambda *a: None, device="cpu")
        runs[tag] = (rd, {s: getattr(pipe, s)() for s in STAGES[:4]})
    for stage in STAGES[:4]:
        trace = tmp_path / "trace" / stage / "trace.json"
        events = json.loads(trace.read_text())["traceEvents"]
        if stage != "remove_dodgy":     # numpy only: no torch op to trace
            assert any(e.get("cat") == "cpu_op" for e in events), stage
        assert runs["plain"][1][stage] == runs["traced"][1][stage]
    for art in ("kspec_25mer", "frag_reads_filt", "frag_reads_prec",
                "frag_reads_edit"):
        a = runs["plain"][0].load_arrays(art)
        b = runs["traced"][0].load_arrays(art)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a), art


def test_profile_dir_one_stage_at_a_time(tmp_path):
    """A stage that starts while another is traced raises RuntimeError, as
    the reference's jax.profiler.trace ("Profile has already been
    started") does under stage_workers > 1."""
    rd = TRunDir(str(tmp_path / "run"))
    pipe = TPipeline(rd, TConfig.from_overrides(
        profile_dir=str(tmp_path / "trace")), lambda *a: None, device="cpu")
    started, release = threading.Event(), threading.Event()

    def slow():
        started.set()
        release.wait(30)
        return {"ok": 1}

    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "m", pipe._profiled("first", slow)))
    t.start()
    started.wait(30)
    try:
        with pytest.raises(RuntimeError, match="Only one profile may be "
                                               "run at a time"):
            pipe._profiled("second", lambda: {})
    finally:
        release.set()
        t.join(30)
    assert out["m"] == {"ok": 1}
    assert (tmp_path / "trace" / "first" / "trace.json").exists()
    assert not (tmp_path / "trace" / "second").exists()
    assert not t_stages._PROFILE_LOCK.locked()
