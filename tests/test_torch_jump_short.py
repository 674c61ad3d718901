"""A jump library of 2x37 reads (GAGE's S. aureus short jumps) through the
port: jump_ec's trusted-prefix floor, set by AssemblyConfig's
`jump_min_prefix_len`, against the reference's error_correct_jumps at
floors 32 and 40; then run_full from read files at floor 32, judged by
portbench's plain reference against the limits of saureus.assemble.

A 37-base mate never reaches the default floor of 40, so the library
keeps no pair there; at 32 it keeps those whose mates both hold 32
trusted bases.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.ec import jump as rjump  # noqa: E402
from allpathslg_tpu.kmer import kmerize as rkmerize  # noqa: E402
from allpathslg_tpu.ops import join as rjoin  # noqa: E402
from allpathslg_tpu_torch.ec import jump as tjump  # noqa: E402
from allpathslg_tpu_torch.ops import join as tjoin  # noqa: E402
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig  # noqa: E402
from allpathslg_tpu_torch.pipeline.stages import Pipeline  # noqa: E402
from portbench import harness, sim  # noqa: E402

torch.set_num_threads(2)
CELL = "saureus.assemble"
READ_LEN = 37
GENOME = 40_000       # run_full's genome; ~1 min on one CPU worker


@pytest.fixture(scope="module")
def short_mates():
    """Outie 2x37 mates of an AT-rich 30 kb genome, a fifth of them with
    a chimeric tail and 40 pairs copies of others, and the genome's
    24-mers as the strong table."""
    genome = sim.random_genome(30_000, 91, gc=0.33)
    lib = sim.simulate_paired_reads(genome, 10.0, READ_LEN, 3500, 350,
                                    0.01, True, 92)
    codes, pairs = lib["codes"].copy(), lib["pairs"]
    rng = np.random.default_rng(93)
    chim = rng.random(len(codes)) < 0.2
    cut = rng.integers(10, READ_LEN, len(codes))
    tail = np.arange(codes.shape[1])[None, :] >= cut[:, None]
    codes = np.where(chim[:, None] & tail, rng.integers(0, 4, codes.shape),
                     codes).astype(np.uint8)
    dup = rng.choice(len(pairs), 80, replace=False)
    codes[pairs[dup[40:]]] = codes[pairs[dup[:40]]]
    canon, valid = rkmerize.kmer_windows(jnp.asarray(genome[None, :]), 24)
    rows = np.unique(np.stack([np.asarray(w)[0][np.asarray(valid)[0]]
                               for w in canon], 1), axis=0)
    words = [rows[:, i].astype(np.uint32) for i in range(rows.shape[1])]
    return codes, lib["quals"], lib["lengths"], pairs, words


@pytest.mark.parametrize("floor", [32, 40])
def test_error_correct_jumps_at_floor(short_mates, floor):
    """The port's error_correct_jumps == the reference's, byte for byte,
    at the floor; at 40 no 37-base pair survives."""
    codes, quals, lens, pairs, words = short_mates
    ref = rjump.error_correct_jumps(
        codes, quals, lens, pairs,
        rjoin.hash_table([jnp.asarray(w) for w in words]),
        rjump.JumpECConfig(min_prefix_len=floor), batch_size=1024)
    port = tjump.error_correct_jumps(
        codes, quals, lens, pairs,
        tjoin.hash_table([torch.from_numpy(w.astype(np.int64))
                          for w in words]),
        tjump.JumpECConfig(min_prefix_len=floor), batch_size=1024,
        device="cpu")
    for r, t in zip(ref[:4], port[:4]):
        assert r.dtype == t.dtype and r.tobytes() == t.tobytes()
    assert ref[4] == port[4]
    m = port[4]
    if floor == 40:
        assert m["n_pairs_kept"] == 0 and not port[2].any()
    else:
        assert m["n_duplicates"] > 0
        assert 0 < m["n_pairs_kept"] < m["n_pairs_in"]


def test_jump_overrides():
    """`jump_min_prefix_len` sets jump_ec's floor, 40 by default; the JSON
    names it only away from 40; no other `jump_` key is taken; the stage's
    K is K_ec."""
    assert AssemblyConfig().jump_min_prefix_len == 40
    assert "jump_min_prefix_len" not in AssemblyConfig().to_json()
    cfg = AssemblyConfig.from_overrides(jump_min_prefix_len=32, K_ec=25)
    assert cfg.jump_min_prefix_len == 32
    assert '"jump_min_prefix_len": 32' in cfg.to_json()
    assert Pipeline(None, cfg, print, device="cpu")._jump_ec_config() == \
        tjump.JumpECConfig(K=25, min_prefix_len=32)
    for key in ("jump_K", "jump_dedupe", "jump_min_prefix", "min_prefix_len"):
        with pytest.raises(ValueError, match=key):
            AssemblyConfig.from_overrides(**{key: 32})


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """saureus.assemble's configuration cut to a 40 kb genome: one sample
    from mate FASTQs, a SAM of 2x37 jumps and sheets through
    prepare_inputs and run_full on the CPU, at the cell's floor of 32."""
    _, _, cfg, traffic, limits = harness.load_cell(CELL)
    assert cfg["jump"]["read_len"] == READ_LEN
    assert cfg["pipeline"]["jump_min_prefix_len"] == 32
    cfg = dict(cfg, genome_size=GENOME,
               pipeline=dict(cfg["pipeline"], batch_reads=16384))
    tmp = tmp_path_factory.mktemp("saureus")
    rs = harness.make_read_set(cfg, 2**31 + 19, 0)
    harness.write_read_set(cfg, traffic, rs, tmp / "set")
    rec = harness.run_sample(traffic, harness.assembly_config(cfg),
                             tmp / "set", tmp / "run", "cpu", lambda: None)
    yield cfg, traffic, limits, rs, rec["rd"]
    shutil.rmtree(tmp, ignore_errors=True)


def test_run_full_keeps_and_places_short_jumps(full_run):
    cfg, traffic, limits, rs, rd = full_run
    m = {s: rd.metrics(s) for s in ("jump_ec", "align_jumps", "patch_gaps")}
    assert m["jump_ec"]["n_pairs_in"] == len(rs["jump"]["pairs"])
    assert m["jump_ec"]["n_pairs_kept"] > 0.5 * m["jump_ec"]["n_pairs_in"]
    assert abs(m["align_jumps"]["insert_mean_est"] - 3500) <= 0.05 * 3500
    assert m["patch_gaps"]["n_gaps_closed"] >= 1
    out = harness.collect(rd, traffic, np.random.default_rng(5))
    got = harness.check_samples([{"set": 0, "out": out}], [rs])[0]
    correct, shown = harness.judge(got, limits)
    assert correct, shown


def test_jump_ec_reruns_under_another_floor(full_run):
    """The floor is part of jump_ec's input hash: the run dir of a floor
    of 32 does not satisfy a pipeline at 40, which keeps no pair."""
    cfg, _, _, _, rd = full_run
    kept = rd.metrics("jump_ec")["n_pairs_kept"]
    over = dict(cfg["pipeline"], jump_min_prefix_len=40)
    logged = []
    Pipeline(rd, AssemblyConfig.from_overrides(**over), logged.append,
             device="cpu").jump_ec()
    assert not any("up to date, skipping" in m for m in logged)
    assert rd.metrics("jump_ec")["n_pairs_kept"] == 0 < kept
