"""The port's assisted assembly == the reference's.

tests/test_assisted.py's 24 kb genome and its relative (0.3 % SNPs) go
through allpathslg_tpu.asm.assisted and its port: contig placements,
assisted scaffolds and assisted patching (a supported gap that closes, an
unsupported one that is rejected) must be equal. On the CPU the port runs
its plain banded DP; the reference runs its own (JAX on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.asm import assisted as rast  # noqa: E402
from allpathslg_tpu.kmer import count as rcount  # noqa: E402
from allpathslg_tpu_torch.asm import assisted as tast  # noqa: E402
from allpathslg_tpu_torch.eval import sim  # noqa: E402
from allpathslg_tpu_torch.kmer import count as tcount  # noqa: E402

torch.set_num_threads(2)


def _rc(seq):
    return (3 - seq)[::-1].astype(np.uint8)


@pytest.fixture(scope="module")
def genome():
    return sim.random_genome(24_000, seed=11)


@pytest.fixture(scope="module")
def relative(genome):
    return sim.mutate_genome(genome, 0.003, seed=12)


def _rows(sbs):
    return [(list(map(int, s.contig_ids)), [bool(x) for x in s.rc],
             list(map(int, s.gaps)), list(map(int, s.gap_devs)))
            for s in sbs]


def _placements(pl):
    return [None if p is None else
            (p.contig, bool(p.rc), p.ref_start, p.ref_end, p.n_anchors,
             p.anchor_frac) for p in pl]


CONTIG_SETS = {
    "placed_and_junk": lambda g: [
        g[1_000:6_000], _rc(g[8_000:13_000]), g[15_000:20_000],
        sim.random_genome(3_000, seed=99)],
    "out_of_order": lambda g: [
        g[15_000:20_000], _rc(g[8_000:13_000]), g[1_000:6_000],
        sim.random_genome(2_500, seed=98)],
    "contained_and_short": lambda g: [
        g[2_000:12_000], g[4_000:7_000], g[100:120], _rc(g[12_500:23_000])],
}


@pytest.mark.parametrize("which", sorted(CONTIG_SETS))
def test_place_and_scaffold_equal(genome, relative, which):
    contigs = CONTIG_SETS[which](genome)
    r_pl = rast.place_contigs(contigs, relative)
    t_pl = tast.place_contigs(contigs, relative, device="cpu")
    assert _placements(r_pl) == _placements(t_pl)
    assert sum(p is not None for p in t_pl) >= 2
    assert (_rows(rast.assist_scaffold(r_pl, len(contigs)))
            == _rows(tast.assist_scaffold(t_pl, len(contigs))))


def _read_kmers(genome, seed, K=24):
    reads, _, _ = sim.simulate_paired_reads(
        genome, coverage=30.0, read_len=100, error_rate=0.0, seed=seed)
    r = rcount.trim_to_host(rcount.count_reads(jnp.asarray(reads.codes), K))
    t = tcount.trim_to_host(tcount.count_reads(
        torch.from_numpy(np.asarray(reads.codes)), K))
    return r, t


@pytest.mark.parametrize("support", ["reads_of_genome", "unrelated_reads"])
def test_assist_assembly_equal(genome, relative, support):
    """A 600 bp gap between two contigs: the genome's own reads confirm
    the relative's patch and it closes; reads of another genome do not
    and it is rejected."""
    contigs = [genome[500:9_000], genome[9_600:19_500]]
    src = genome if support == "reads_of_genome" else \
        sim.random_genome(24_000, seed=77)
    r_ck, t_ck = _read_kmers(src, 5 if support == "reads_of_genome" else 6)
    r_c, r_sb, r_m = rast.assist_assembly(contigs, relative, read_kmers=r_ck)
    t_c, t_sb, t_m = tast.assist_assembly(contigs, relative, read_kmers=t_ck,
                                          device="cpu")
    assert r_m == t_m
    assert _rows(r_sb) == _rows(t_sb)
    assert [c.tobytes() for c in r_c] == [c.tobytes() for c in t_c]
    if support == "reads_of_genome":
        assert t_m["n_patches_closed"] == 1
    else:
        assert t_m["n_patches_closed"] == 0 and t_m["n_patches_rejected"] >= 1


@pytest.mark.parametrize("side", ["end", "start"])
def test_junction_refinement_equal(genome, relative, side):
    """The B = 1, band-16 junction DP: exact coordinates on the relative,
    including a flank that does not align (a junk contig end)."""
    cfg_r, cfg_t = rast.AssistConfig(), tast.AssistConfig()
    junk = sim.random_genome(400, seed=3)
    for at, seq in ((9_000, genome[500:9_000]), (15_000, genome[10_000:15_000]),
                    (9_000, junk)):
        if side == "end":
            r = rast._refine_end(seq, relative, at, cfg_r)
            t = tast._refine_end(seq, relative, at, cfg_t, device="cpu")
        else:
            r = rast._refine_start(seq, relative, at - len(seq), cfg_r)
            t = tast._refine_start(seq, relative, at - len(seq), cfg_t,
                                   device="cpu")
        assert r == t
