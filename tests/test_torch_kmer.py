"""Port k-mer layer vs the reference, exactly: bits, 2-bit packing,
kmerize, count_reads (with and without quals), the flagship
spectrum_step(K=24), every count_reads_streaming regime and the resident
streaming counter, plus the simulator and the config tree.
Same numpy inputs (from a seed) through both packages."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.dtypes import devcache as rdev  # noqa: E402
from allpathslg_tpu.dtypes import packed as rpk  # noqa: E402
from allpathslg_tpu.eval import sim as rsim  # noqa: E402
from allpathslg_tpu.kmer import bits as rbits  # noqa: E402
from allpathslg_tpu.kmer import count as rcount  # noqa: E402
from allpathslg_tpu.kmer import kmerize as rkmer  # noqa: E402
from allpathslg_tpu.models import flagship as rflag  # noqa: E402
from allpathslg_tpu.pipeline.config import AssemblyConfig as RConfig  # noqa: E402
from allpathslg_tpu_torch.dtypes import devcache as tdev  # noqa: E402
from allpathslg_tpu_torch.dtypes import packed as tpk  # noqa: E402
from allpathslg_tpu_torch.eval import sim as tsim  # noqa: E402
from allpathslg_tpu_torch.kmer import bits as tbits  # noqa: E402
from allpathslg_tpu_torch.kmer import count as tcount  # noqa: E402
from allpathslg_tpu_torch.kmer import kmerize as tkmer  # noqa: E402
from allpathslg_tpu_torch.models import flagship as tflag  # noqa: E402
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig as TConfig  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _reads(n=300, L=60, seed=0, n_rate=0.01):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < n_rate] = 4
    quals = rng.integers(2, 41, (n, L)).astype(np.uint8)
    return codes, quals


def _w(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq_words(ref, port):
    assert len(ref) == len(port)
    for r, t in zip(ref, port):
        assert np.array_equal(np.asarray(r).astype(np.int64), t.numpy())


def _eq_table(r, t):
    _eq_words(r.words, t.words)
    assert np.array_equal(np.asarray(r.counts), t.counts.numpy())
    assert (r.qsum is None) == (t.qsum is None)
    if r.qsum is not None:
        assert np.array_equal(np.asarray(r.qsum), t.qsum.numpy())
    assert int(r.n_unique) == int(t.n_unique)


# ---- bits -----------------------------------------------------------------

@pytest.mark.parametrize("K", [5, 16, 24, 25, 33])
def test_bits_match_reference(K):
    rng = np.random.default_rng(K)
    n = 500
    codes = rng.integers(0, 4, (n, K)).astype(np.uint8)
    W = rbits.n_words(K)
    words = [np.zeros(n, np.uint32) for _ in range(W)]
    for j in range(K):
        words[j // 16] |= (codes[:, j].astype(np.uint32)
                           << np.uint32(30 - 2 * (j % 16)))
    rw = [jnp.asarray(w) for w in words]
    tw = [_w(w) for w in words]
    _eq_words(rbits.rc_words(rw, K), tbits.rc_words(tw, K))
    rc, rrc = rbits.canonical(rw, K)
    tc, trc = tbits.canonical(tw, K)
    _eq_words(rc, tc)
    assert np.array_equal(np.asarray(rrc), trc.numpy())
    other = [w[::-1].copy() for w in words]
    assert np.array_equal(
        np.asarray(rbits.lex_less(rw, [jnp.asarray(o) for o in other])),
        tbits.lex_less(tw, [_w(o) for o in other]).numpy())
    for seed in (0, 7):
        assert np.array_equal(
            np.asarray(rbits.hash_words(rw, seed)).astype(np.int64),
            tbits.hash_words(tw, seed).numpy())
    j = rng.integers(0, K, n).astype(np.int32)
    base = rng.integers(0, 4, n).astype(np.uint8)
    _eq_words(rbits.put_base_dyn(rw, jnp.asarray(j), jnp.asarray(base)),
              tbits.put_base_dyn(tw, torch.from_numpy(j),
                                 torch.from_numpy(base)))
    _eq_words(rbits.mask_base_dyn(rw, jnp.asarray(j)),
              tbits.mask_base_dyn(tw, torch.from_numpy(j)))
    assert np.array_equal(np.asarray(rbits.get_base_dyn(rw, jnp.asarray(j))),
                          tbits.get_base_dyn(tw, torch.from_numpy(j)).numpy())
    _eq_words(rbits.mask_base(rw, K // 2), tbits.mask_base(tw, K // 2))
    assert np.array_equal(np.asarray(rbits.get_base(rw, K - 1)),
                          tbits.get_base(tw, K - 1).numpy())
    _eq_words(rbits.shift_append(rw, jnp.asarray(base), K),
              tbits.shift_append(tw, torch.from_numpy(base), K))
    _eq_words(rbits.shift_prepend(rw, 2, K), tbits.shift_prepend(tw, 2, K))
    assert np.array_equal(np.asarray(rbits.is_sentinel(rw)),
                          tbits.is_sentinel(tw).numpy())


# ---- packing --------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 31, 100, 150])
def test_packing_bit_identical(L):
    codes, quals = _reads(n=64, L=L, seed=L, n_rate=0.05)
    w, m, _ = rpk.pack_codes(codes)
    tw, tm, _ = tpk.pack_codes(codes)
    assert np.array_equal(w, tw) and np.array_equal(m, tm)
    dev_w, dev_m = tpk.pack_codes_device(torch.from_numpy(codes))
    rw, rm = rpk.pack_codes_device(jnp.asarray(codes))
    assert np.array_equal(np.asarray(rw).astype(np.int64), dev_w.numpy())
    assert np.array_equal(np.asarray(rm).astype(np.int64), dev_m.numpy())
    assert np.array_equal(
        tpk.unpack_codes(tpk.to_device_words(w, CPU),
                         tpk.to_device_words(m, CPU), L).numpy(), codes)
    assert np.array_equal(tpk.unpack_codes_host(w, m, L), codes)
    q16 = (quals // 4) * 4                      # <= 16 distinct values
    for q in (q16, quals):
        nib, pal, _ = rpk.pack_quals(q)
        tnib, tpal, _ = tpk.pack_quals(q)
        assert (nib is None) == (tnib is None)
        assert np.array_equal(pal, tpal)
        got = tpk.device_quals(q, CPU).numpy()
        assert np.array_equal(got, np.asarray(rpk.device_quals(q)))
        assert np.array_equal(got, q)
    assert np.array_equal(tpk.device_codes(codes, CPU).numpy(), codes)


# ---- kmerize + count --------------------------------------------------------

@pytest.mark.parametrize("K", [16, 24, 25, 33])
def test_kmer_windows_match_reference(K):
    codes, _ = _reads(n=100, L=70, seed=K)
    rc, rv = rkmer.kmer_windows(jnp.asarray(codes), K)
    tc, tv = tkmer.kmer_windows(torch.from_numpy(codes), K)
    _eq_words(rc, tc)
    assert np.array_equal(np.asarray(rv), tv.numpy())
    rf, rfv = rkmer.kmer_windows_fwd(jnp.asarray(codes), K)
    tf, tfv = tkmer.kmer_windows_fwd(torch.from_numpy(codes), K)
    _eq_words(rf, tf)
    assert np.array_equal(np.asarray(rfv), tfv.numpy())
    rfl, rm = rkmer.flatten_kmers(rc, rv, K)
    tfl, tm = tkmer.flatten_kmers(tc, tv, K)
    _eq_words(rfl, tfl)
    assert np.array_equal(np.asarray(rm), tm.numpy())


@pytest.mark.parametrize("K", [24, 25])
@pytest.mark.parametrize("with_quals", [False, True])
def test_count_reads_matches_reference(K, with_quals):
    codes, quals = _reads(seed=K + with_quals)
    q = quals if with_quals else None
    r = rcount.count_reads(jnp.asarray(codes), K,
                           None if q is None else jnp.asarray(q))
    t = tcount.count_reads(torch.from_numpy(codes), K,
                           None if q is None else torch.from_numpy(q))
    _eq_table(r, t)
    assert np.array_equal(np.asarray(rcount.spectrum(r, 63)),
                          tcount.spectrum(t, 63).numpy())
    _eq_table(rcount.trim_to_host(r), tcount.trim_to_host(t))
    _eq_table(rcount.pad_table_quantized(rcount.trim_to_host(r), 1 << 12),
              tcount.pad_table_quantized(tcount.trim_to_host(t), 1 << 12))


def test_spectrum_step_k24_matches_reference():
    codes, quals = _reads(n=256, L=100, seed=24)
    rs, rn = rflag.spectrum_step(jnp.asarray(codes), K=24, max_freq=255)
    ts, tn = tflag.spectrum_step(torch.from_numpy(codes), K=24, max_freq=255)
    assert ts.dtype == torch.int32 and ts.shape == (256,)
    assert np.array_equal(np.asarray(rs), ts.numpy())
    assert int(rn) == int(tn)
    rs, rn, rq = rflag.spectrum_step_weighted(jnp.asarray(codes),
                                              jnp.asarray(quals), K=24)
    ts, tn, tq = tflag.spectrum_step_weighted(torch.from_numpy(codes),
                                              torch.from_numpy(quals), K=24)
    assert np.array_equal(np.asarray(rs), ts.numpy())
    assert int(rn) == int(tn)
    assert np.array_equal(np.asarray(rq), tq.numpy())


def test_merge_and_recount_match_reference():
    codes, quals = _reads(seed=3)
    half = len(codes) // 2
    ra = rcount.count_reads(jnp.asarray(codes[:half]), 24,
                            jnp.asarray(quals[:half]))
    rb = rcount.count_reads(jnp.asarray(codes[half:]), 24,
                            jnp.asarray(quals[half:]))
    ta = tcount.count_reads(torch.from_numpy(codes[:half]), 24,
                            torch.from_numpy(quals[:half]))
    tb = tcount.count_reads(torch.from_numpy(codes[half:]), 24,
                            torch.from_numpy(quals[half:]))
    _eq_table(rcount.merge_tables([ra, rb]), tcount.merge_tables([ta, tb]))


# ---- streaming regimes ------------------------------------------------------

REGIMES = {
    "device_resident": dict(device_budget_bytes=1 << 40),
    "incremental_merge": dict(device_budget_bytes=1, merge_group=3),
    "host_spill": dict(device_budget_bytes=1, merge_group=2,
                       acc_budget_bytes=1),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("with_quals", [False, True])
def test_count_reads_streaming_regimes_match_reference(regime, with_quals):
    codes, quals = _reads(n=600, L=40, seed=2)
    q = quals if with_quals else None
    kw = dict(batch_size=64, min_count=3, min_qsum=50 if with_quals else 0,
              spectrum_max_freq=63, **REGIMES[regime])
    r, rspec = rcount.count_reads_streaming(codes, 16, q, **kw)
    t, tspec = tcount.count_reads_streaming(codes, 16, q, device=CPU, **kw)
    _eq_table(rcount.trim_to_host(r), tcount.trim_to_host(t))
    assert np.array_equal(np.asarray(rspec), tspec)
    assert np.asarray(rspec).dtype == tspec.dtype


@pytest.mark.parametrize("regime", ["incremental_merge", "host_spill"])
def test_count_resident_streaming_matches_reference(regime):
    codes, quals = _reads(n=500, L=50, seed=4)
    kw = {k: v for k, v in REGIMES[regime].items()
          if k != "device_budget_bytes"}
    rdb = rdev.DeviceBatches.from_host(codes, quals, 64)
    tdb = tdev.DeviceBatches.from_host(codes, quals, 64, device=CPU)
    r = rcount.count_resident_streaming(rdb, 24, min_count=2, min_qsum=60,
                                        **kw)
    t = tcount.count_resident_streaming(tdb, 24, min_count=2, min_qsum=60,
                                        **kw)
    _eq_table(rcount.trim_to_host(r), tcount.trim_to_host(t))
    assert np.array_equal(rdb.codes_to_host(), tdb.codes_to_host())


def test_streaming_counter_matches_reference():
    codes, quals = _reads(n=400, L=40, seed=6)
    rs, ts = rcount.StreamingCounter(3), tcount.StreamingCounter(3)
    for s in range(0, 400, 50):
        rs.add(rcount.count_reads(jnp.asarray(codes[s:s + 50]), 16,
                                  jnp.asarray(quals[s:s + 50])))
        ts.add(tcount.count_reads(torch.from_numpy(codes[s:s + 50]), 16,
                                  torch.from_numpy(quals[s:s + 50])))
    _eq_table(rcount.trim_to_host(rs.finish(min_count=2)),
              tcount.trim_to_host(ts.finish(min_count=2)))


# ---- simulator + config ------------------------------------------------------

def test_simulator_byte_identical():
    rg = rsim.random_genome(5000, seed=3)
    tg = tsim.random_genome(5000, seed=3)
    assert rg.tobytes() == tg.tobytes()
    rb, rp, rt = rsim.simulate_paired_reads(rg, coverage=20, seed=4)
    tb, tp, tt = tsim.simulate_paired_reads(tg, coverage=20, seed=4)
    for a, b in ((rb.codes, tb.codes), (rb.lengths, tb.lengths),
                 (rb.quals, tb.quals), (rp.pairs, tp.pairs),
                 (rt.error_mask, tt.error_mask),
                 (rt.read_starts, tt.read_starts)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_config_json_identical():
    kw = dict(batch_reads=4096, min_winner=5, ec_rounds=2)
    r = RConfig.from_overrides(**kw)
    t = TConfig.from_overrides(**kw)
    assert r.to_json() == t.to_json()
    assert str(r.precorrect) == str(t.precorrect)
    assert str(r.spectrum_ec) == str(t.spectrum_ec)
    assert json.loads(t.to_json())["spectrum_ec"]["rounds"] == 2
