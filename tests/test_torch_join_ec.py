"""Port joins and error correction vs the reference, exactly: the hashed
join (shift, H and bucket_starts identical), the binary-search join,
precorrect (single batch, stats tables, the global resident two-pass),
strong_table, correct_round_packed and clean_reads_packed; plus state
handed from the reference to the port through allpathslg_tpu_torch.convert.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.dtypes import devcache as rdev  # noqa: E402
from allpathslg_tpu.dtypes import packed as rpk  # noqa: E402
from allpathslg_tpu.ec import precorrect as rpc  # noqa: E402
from allpathslg_tpu.ec import spectrum_ec as rsec  # noqa: E402
from allpathslg_tpu.eval import sim as rsim  # noqa: E402
from allpathslg_tpu.kmer import count as rcount  # noqa: E402
from allpathslg_tpu.ops import join as rjoin  # noqa: E402
from allpathslg_tpu_torch import convert  # noqa: E402
from allpathslg_tpu_torch.dtypes import devcache as tdev  # noqa: E402
from allpathslg_tpu_torch.ec import precorrect as tpc  # noqa: E402
from allpathslg_tpu_torch.ec import spectrum_ec as tsec  # noqa: E402
from allpathslg_tpu_torch.kmer import count as tcount  # noqa: E402
from allpathslg_tpu_torch.ops import join as tjoin  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
SENT = 0xFFFFFFFF


def _w(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np64(x):
    return np.asarray(x).astype(np.int64)


def _eq(ref, port):
    assert np.array_equal(_np64(ref), port.cpu().numpy().astype(np.int64))


def _packed(codes, quals):
    """(reference args, port args): words, nmask, qnib, qpal, L. The
    simulator's quals take more than 16 values, so qnib is None and qpal
    holds the raw quals (the reference's fallback)."""
    w, m, L = rpk.pack_codes(codes)
    qn, qp, _ = rpk.pack_quals(quals)
    ref = (jnp.asarray(w), jnp.asarray(m),
           None if qn is None else jnp.asarray(qn), jnp.asarray(qp), L)
    port = (_w(w), _w(m), None if qn is None else _w(qn),
            torch.from_numpy(np.asarray(qp)), L)
    return ref, port


@pytest.fixture(scope="module")
def sim_reads():
    """Simulated reads with errors: 6 kb genome, 30x, 100 bp."""
    g = rsim.random_genome(6000, seed=5)
    b, _, _ = rsim.simulate_paired_reads(g, coverage=30, error_rate=0.01,
                                         seed=6)
    return np.asarray(b.codes), np.asarray(b.quals)


# ---- joins ------------------------------------------------------------------

def _table(M, W, seed, pad=1 << 10):
    rng = np.random.default_rng(seed)
    rows = np.unique(rng.integers(0, 1 << 12, (M, W)).astype(np.uint32),
                     axis=0)
    tw = [rows[:, w].copy() for w in range(W)]
    pay = rng.integers(1, 1 << 20, len(tw[0])).astype(np.int32)
    tw = [np.concatenate([w, np.full(pad, SENT, np.uint32)]) for w in tw]
    pay = np.concatenate([pay, np.zeros(pad, np.int32)])
    hit = rng.integers(0, len(rows), 3000)
    qw = [np.concatenate([w[hit], rng.integers(0, 1 << 12, 3000)
                          .astype(np.uint32)]) for w in tw]
    return tw, pay, qw


@pytest.mark.parametrize("W", [1, 2, 3])
def test_hashed_join_identical_to_reference(W):
    tw, pay, qw = _table(20000, W, seed=W)
    rh, rws, rps, rbs, rshift, rH = rjoin.build_hashed(
        [jnp.asarray(w) for w in tw], payloads=[jnp.asarray(pay)])
    th, tws, tps, tbs, tshift, tH = tjoin.build_hashed(
        [_w(w) for w in tw], payloads=[torch.from_numpy(pay)])
    assert (rshift, rH) == (tshift, tH)
    _eq(rh, th)
    _eq(rbs, tbs)
    for a, b in zip(rws, tws):
        _eq(a, b)
    _eq(rps[0], tps[0])
    rf, rp = rjoin.lookup_hashed(rh, rbs, rws, [jnp.asarray(q) for q in qw],
                                 rshift, rH, payload=rps[0], default=0)
    tf, tp = tjoin.lookup_hashed(th, tbs, tws, [_w(q) for q in qw],
                                 tshift, tH, payload=tps[0], default=0)
    _eq(rf, tf)
    _eq(rp, tp)
    rf, ri = rjoin.lookup_hashed(rh, rbs, rws, [jnp.asarray(q) for q in qw],
                                 rshift, rH)
    tf, ti = tjoin.lookup_hashed(th, tbs, tws, [_w(q) for q in qw],
                                 tshift, tH)
    _eq(rf, tf)
    _eq(ri, ti)


def test_searchsorted_join_identical_to_reference():
    tw, pay, qw = _table(5000, 2, seed=9)
    rp, rf = rjoin.lookup_payload([jnp.asarray(w) for w in tw],
                                  jnp.asarray(pay),
                                  [jnp.asarray(q) for q in qw], -1)
    tp, tf = tjoin.lookup_payload([_w(w) for w in tw], torch.from_numpy(pay),
                                  [_w(q) for q in qw], -1)
    _eq(rp, tp)
    _eq(rf, tf)
    ri, _ = rjoin.searchsorted_words([jnp.asarray(w) for w in tw],
                                     [jnp.asarray(q) for q in qw])
    ti, _ = tjoin.searchsorted_words([_w(w) for w in tw], [_w(q) for q in qw])
    _eq(ri, ti)


# ---- precorrect -------------------------------------------------------------

def test_precorrect_single_batch_matches_reference(sim_reads):
    codes, quals = sim_reads
    ro, rn = rpc.precorrect(jnp.asarray(codes), jnp.asarray(quals))
    to, tn = tpc.precorrect(torch.from_numpy(codes), torch.from_numpy(quals))
    assert int(rn) == int(tn) and int(tn) > 0
    _eq(ro, to)


@pytest.mark.parametrize("blocked", [False, True])
def test_precorrect_stats_tables_match_reference(sim_reads, blocked):
    codes, quals = sim_reads
    ref, port = _packed(codes[:512], quals[:512])
    if blocked:
        r = rpc.precorrect_stats_batch_packed_blocked(*ref, jnp.uint32(1), 3)
        t = tpc.precorrect_stats_batch_packed_blocked(*port, 1, 3)
    else:
        r = rpc.precorrect_stats_batch_packed(*ref)
        t = tpc.precorrect_stats_batch_packed(*port)
    for a, b in zip(r.words, t.words):
        _eq(a, b)
    _eq(r.counts, t.counts)
    assert int(r.n_unique) == int(t.n_unique)


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_precorrect_global_resident_matches_reference(sim_reads, n_blocks):
    codes, quals = sim_reads
    rdb = rdev.DeviceBatches.from_host(codes, quals, 512)
    tdb = tdev.DeviceBatches.from_host(codes, quals, 512, device=CPU)
    rn = rpc.precorrect_global_resident(rdb, n_blocks=n_blocks)
    tn = tpc.precorrect_global_resident(tdb, n_blocks=n_blocks)
    assert rn == tn and tn > 0
    assert np.array_equal(rdb.codes_to_host(), tdb.codes_to_host())


# ---- spectrum EC ------------------------------------------------------------

@pytest.fixture(scope="module")
def strong(sim_reads):
    """Both packages' strong tables from the same counts."""
    codes, quals = sim_reads
    cfg_r, cfg_t = rsec.SpectrumECConfig(), tsec.SpectrumECConfig()
    rck = rcount.count_reads(jnp.asarray(codes), 24, jnp.asarray(quals))
    tck = tcount.count_reads(torch.from_numpy(codes), 24,
                             torch.from_numpy(quals))
    rt, rn = rsec.strong_table(rck, cfg_r)
    tt, tn = tsec.strong_table(tck, cfg_t)
    return (rsec.compact_strong_table(rt, int(rn)), int(rn),
            tsec.compact_strong_table(tt, int(tn)), int(tn))


def test_strong_table_matches_reference(strong):
    rt, rn, tt, tn = strong
    assert rn == tn > 0
    assert rt[0].shape[0] == tt[0].shape[0] == 1 << 18
    for a, b in zip(rt, tt):
        _eq(a, b)


@pytest.mark.parametrize("table_kind", ["hashed", "sorted"])
def test_correct_round_packed_matches_reference(sim_reads, strong,
                                                table_kind):
    codes, quals = sim_reads
    rt, _, tt, _ = strong
    if table_kind == "hashed":
        rtab, ttab = rjoin.hash_table(rt), tjoin.hash_table(tt)
    else:
        rtab, ttab = rt, tt
    ref, port = _packed(codes, quals)
    cfg_r, cfg_t = rsec.SpectrumECConfig(), tsec.SpectrumECConfig()
    rw, rm, rn = rsec.correct_round_packed(*ref, rtab, cfg_r)
    tw, tm, tn = tsec.correct_round_packed(*port, ttab, cfg_t)
    assert int(rn) == int(tn) > 0
    _eq(rw, tw)
    _eq(rm, tm)


def test_correct_round_column_zero_fix_matches_reference(strong):
    """A read whose only suspect is base 0: the reference's scatter writes
    the unused slots back over column 0 after the fix, and the port keeps
    that order."""
    rt, _, tt, _ = strong
    genome = rsim.random_genome(6000, seed=5)
    codes = np.stack([genome[i:i + 100] for i in range(0, 3000, 100)])
    codes[:, 0] = (codes[:, 0] + 1) % 4
    quals = np.full(codes.shape, 20, np.uint8)
    cfg_r, cfg_t = rsec.SpectrumECConfig(), tsec.SpectrumECConfig()
    ro, rn = rsec.correct_round(jnp.asarray(codes), jnp.asarray(quals),
                                rjoin.hash_table(rt), cfg_r)
    to, tn = tsec.correct_round(torch.from_numpy(codes),
                                torch.from_numpy(quals),
                                tjoin.hash_table(tt), cfg_t)
    assert int(rn) == int(tn)
    _eq(ro, to)


def test_clean_reads_packed_matches_reference(sim_reads, strong):
    codes, _ = sim_reads
    rt, _, tt, _ = strong
    lengths = np.random.default_rng(1).integers(
        20, 101, len(codes)).astype(np.int32)
    w, m, L = rpk.pack_codes(codes)
    cfg_r, cfg_t = rsec.SpectrumECConfig(), tsec.SpectrumECConfig()
    rw, rm, rl, rk = rsec.clean_reads_packed(
        jnp.asarray(w), jnp.asarray(m), jnp.asarray(lengths), L,
        rjoin.hash_table(rt), cfg_r)
    tw, tm, tl, tk = tsec.clean_reads_packed(
        _w(w), _w(m), torch.from_numpy(lengths), L, tjoin.hash_table(tt),
        cfg_t)
    assert int(rk) == int(tk)
    _eq(rw, tw)
    _eq(rm, tm)
    _eq(rl, tl)
    assert tl.dtype == torch.int32


# ---- reference state into the port (convert.py) ----------------------------

def test_reference_state_feeds_the_port(sim_reads, strong):
    """The reference's tables and resident batches, converted, drive the
    port's next step to the reference's own result."""
    codes, quals = sim_reads
    rt, rn, _, _ = strong
    rht = rjoin.hash_table(rt)
    tht = convert.hashed_table(rht.hash_fp, rht.words, rht.payloads,
                               rht.bucket_starts, rht.shift, rht.H, CPU)
    rdb = rdev.DeviceBatches.from_host(codes, quals, 512)
    tdb = convert.device_batches(rdb.batch, rdb.L, rdb.n_real, rdb.words,
                                 rdb.nmask, rdb.qnib, rdb.qpal, device=CPU)
    assert np.array_equal(tdb.codes_to_host(), rdb.codes_to_host())
    cfg_r, cfg_t = rsec.SpectrumECConfig(), tsec.SpectrumECConfig()
    for i in range(rdb.n_batches):
        rw, rm, _ = rsec.correct_round_packed(
            rdb.words[i], rdb.nmask[i], rdb.qnib[i], rdb.qpal[i], rdb.L,
            rht, cfg_r)
        tw, tm, _ = tsec.correct_round_packed(
            tdb.words[i], tdb.nmask[i], tdb.qnib[i], tdb.qpal[i], tdb.L,
            tht, cfg_t)
        _eq(rw, tw)
        _eq(rm, tm)
    # a strong_table.npy and a counted table convert the same way
    table_np = np.stack([np.asarray(w) for w in rt])
    assert all(torch.equal(a, b) for a, b in zip(
        convert.strong_table(table_np, CPU), [_w(w) for w in rt]))
    rck = rcount.count_reads(jnp.asarray(codes[:64]), 24,
                             jnp.asarray(quals[:64]))
    tck = convert.counted_kmers(rck.words, rck.counts, rck.qsum,
                                rck.n_unique, CPU)
    tt2, tn2 = tsec.strong_table(tck, cfg_t)
    rt2, rn2 = rsec.strong_table(rck, cfg_r)
    assert int(rn2) == int(tn2)
    for a, b in zip(rt2, tt2):
        _eq(a, b)
