"""The port's five EC-front stages == the reference's, byte for byte.

Both packages run validate_inputs -> remove_dodgy -> precorrect ->
find_errors -> clean_reads on the same simulated genome (20 kb x 40x,
batch_reads=4096, as tests/test_pipeline_mesh.py sizes it); every artifact
and every stage metric must be identical. Also: the options that lead off
the ported slice raise NotImplementedError, a CUDA pipeline without a card
raises, and an interrupted find_errors resumes to the same artifacts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.pipeline.config import AssemblyConfig as RConfig  # noqa: E402
from allpathslg_tpu.pipeline.rundir import RunDir as RRunDir  # noqa: E402
from allpathslg_tpu.pipeline.run import prepare_sim_inputs as rprepare  # noqa: E402
from allpathslg_tpu.pipeline.stages import Pipeline as RPipeline  # noqa: E402
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig as TConfig  # noqa: E402
from allpathslg_tpu_torch.pipeline.rundir import RunDir as TRunDir  # noqa: E402
from allpathslg_tpu_torch.pipeline.run import prepare_sim_inputs as tprepare  # noqa: E402
from allpathslg_tpu_torch.pipeline.stages import Pipeline as TPipeline  # noqa: E402

torch.set_num_threads(2)
STAGES = ["validate_inputs", "remove_dodgy", "precorrect", "find_errors",
          "clean_reads"]
ARTIFACTS = ["frag_reads_orig", "genome_truth", "kspec_25mer",
             "frag_reads_filt", "frag_reads_prec", "frag_reads_edit",
             "frag_reads_corr"]
SIM = (20000, 40.0, 0.005, 100, 11)     # genome, coverage, error, len, seed
CFG = dict(batch_reads=4096, stage_workers=1)


def _quiet(*a):
    pass


def _port(path, **over):
    rd = TRunDir(str(path))
    tprepare(rd, *SIM, _quiet)
    return rd, TPipeline(rd, TConfig.from_overrides(**CFG, **over), _quiet,
                         device="cpu")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    rd_r = RRunDir(str(tmp_path_factory.mktemp("ref")))
    rprepare(rd_r, *SIM, _quiet)
    ref = RPipeline(rd_r, RConfig.from_overrides(**CFG), _quiet)
    rd_t, port = _port(tmp_path_factory.mktemp("port"))
    m_r = {s: getattr(ref, s)() for s in STAGES}
    m_t = {s: getattr(port, s)() for s in STAGES}
    return rd_r, m_r, rd_t, m_t


@pytest.mark.parametrize("art", ARTIFACTS)
def test_artifacts_byte_identical(both, art):
    rd_r, _, rd_t, _ = both
    a, b = rd_r.load_arrays(art), rd_t.load_arrays(art)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), (art, k)


def test_strong_table_byte_identical(both):
    rd_r, _, rd_t, _ = both
    a = np.load(rd_r.file_path("strong_table.npy"))
    b = np.load(rd_t.file_path("strong_table.npy"))
    assert a.dtype == b.dtype == np.uint32
    assert a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("stage", STAGES)
def test_stage_metrics_equal(both, stage):
    _, m_r, _, m_t = both
    assert m_r[stage] == m_t[stage]


def test_ec_front_did_work(both):
    _, m_r, _, m_t = both
    assert m_t["precorrect"]["n_corrections"] > 0
    assert m_t["find_errors"]["n_corrections"] > 0
    est = m_t["validate_inputs"]["genome_size_est"]
    assert abs(est - SIM[0]) < 0.2 * SIM[0]


def test_config_json_and_manifest_resume(both):
    _, _, rd_t, _ = both
    assert RConfig.from_overrides(**CFG).to_json() == \
        TConfig.from_overrides(**CFG).to_json()
    # a second pipeline over the same run dir skips every finished stage
    port = TPipeline(rd_t, TConfig.from_overrides(**CFG), _quiet,
                     device="cpu")
    logged = []
    port.log = logged.append
    for s in STAGES:
        getattr(port, s)()
    assert len(logged) == len(STAGES)
    assert all("up to date, skipping" in m for m in logged)


def test_find_errors_resumes_after_fault(both, tmp_path):
    """A fault after round 0 leaves a checkpoint; a fresh pipeline resumes
    from it and writes the uninterrupted run's artifacts."""
    _, _, rd_t, _ = both
    rd, port = _port(tmp_path / "fault", fault_stage="find_errors@round1")
    for s in STAGES[:3]:
        getattr(port, s)()
    with pytest.raises(RuntimeError, match="injected fault"):
        port.find_errors()
    assert (tmp_path / "fault" / "find_errors_progress.npz").exists()
    port = TPipeline(rd, TConfig.from_overrides(**CFG), _quiet, device="cpu")
    port.find_errors()
    port.clean_reads()
    for art in ("frag_reads_edit", "frag_reads_corr"):
        a, b = rd_t.load_arrays(art), rd.load_arrays(art)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("override,stage", [
    (dict(n_devices=2), None),
    (dict(profile_dir="trace"), None),
    (dict(evaluation="CHEAT"), None),
    (dict(check_mode=True), "validate_inputs"),
])
def test_off_slice_options_raise(tmp_path, override, stage):
    with pytest.raises(NotImplementedError, match="not ported"):
        _, port = _port(tmp_path, **override)
        getattr(port, stage)()


def test_jump_library_raises(tmp_path):
    rd, port = _port(tmp_path)
    a = rd.load_arrays("frag_reads_orig")
    rd.save_arrays("jump_reads_orig", **a)
    with pytest.raises(NotImplementedError, match="jump libraries"):
        port.validate_inputs()


def test_cuda_pipeline_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rd = TRunDir(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPipeline(rd, TConfig.from_overrides(**CFG), _quiet, device="cuda")
