"""The port's synchronization layer against the JAX reference: the S&C
correlator, AGC, the localize and extract plain versions (against the
Pallas kernels in interpret mode), candidate extraction, greedy
selection, compaction, CFO correction and detect_frames as a whole."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.kernels import sync as ref_ksync
from ofdm_uhd_tpu.kernels.pallas_extract import extract_frames_pallas
from ofdm_uhd_tpu.kernels.pallas_localize import localize_pallas
from ofdm_uhd_tpu.phy import agc as ref_agc
from ofdm_uhd_tpu.phy import sync as ref_sync
from ofdm_uhd_tpu_torch.channel import make_capture
from ofdm_uhd_tpu_torch.core.spec import ChannelSpec, config
from ofdm_uhd_tpu_torch.kernels import sync as ksync
from ofdm_uhd_tpu_torch.kernels.extract import extract_frames
from ofdm_uhd_tpu_torch.kernels.localize import localize
from ofdm_uhd_tpu_torch.phy import agc, sync
from ofdm_uhd_tpu_torch.pipeline import TxPipeline

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.mark.parametrize("l", [32, 128])
def test_sc_correlate_metric_agc_match(l):
    rng = np.random.default_rng(l)
    r = _cplx(rng, 2, 3000) * np.float32(0.3)
    p, rr = ksync.sc_correlate(_t(r), l)
    m = ksync.sc_metric(p, rr)
    for c in range(2):
        p_ref, rr_ref = ref_ksync.sc_correlate(jnp.asarray(r[c]), l)
        m_ref = ref_ksync.sc_metric(p_ref, rr_ref)
        # same pairwise-doubling order; |.| and complex products may round
        # differently by an ulp
        np.testing.assert_allclose(p[c].numpy(), np.asarray(p_ref),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rr[c].numpy(), np.asarray(rr_ref),
                                   rtol=1e-6)
        np.testing.assert_allclose(m[c].numpy(), np.asarray(m_ref),
                                   rtol=1e-5, atol=1e-7)
        x_ref, g_ref = ref_agc.agc_normalize(jnp.asarray(r[c]))
        x, g = agc.agc_normalize(_t(r[c]))
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-6)
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("seed", range(4))
def test_localize_plain_matches_pallas(seed):
    spec = config("c3")
    rng = np.random.default_rng(seed)
    nd = 12000
    m = (rng.random((2, nd)) ** 4).astype(np.float32)          # spiky metric
    m[:, 500:820] = 0.9                                        # flat plateau
    p = _cplx(rng, 2, nd)
    cand = np.sort(rng.integers(0, nd - 2 * spec.sym_len, (2, 14)), axis=1)
    # the plateau, a candidate running past nd, and the sentinel nd
    cand = np.concatenate([cand, np.tile([[480, nd - 100, nd]], (2, 1))],
                          axis=1).astype(np.int32)
    d, eps = localize(_t(m), _t(p), _t(cand), spec.sym_len, spec.cp)
    assert d.dtype == torch.int32 and eps.dtype == torch.float32
    for c in range(2):
        d_ref, e_ref = localize_pallas(jnp.asarray(m[c]), jnp.asarray(p[c]),
                                       jnp.asarray(cand[c]), spec.sym_len,
                                       spec.cp)
        np.testing.assert_array_equal(d[c].numpy(), np.asarray(d_ref))
        np.testing.assert_allclose(eps[c].numpy(), np.asarray(e_ref),
                                   atol=1e-6)


def test_extract_plain_matches_pallas():
    rng = np.random.default_rng(3)
    n, fl = 9000, 4032
    cap = _cplx(rng, 2, n)
    ds = np.array([[0, 17, 1023, 1024, 4000, n - 100, n, n + 77, -5],
                   [5, 130, 2047, 999, 3333, n - 4032, n - 1, 2 * n, 0]],
                  np.int32)
    got = extract_frames(_t(cap), _t(ds), fl)
    for c in range(2):
        ref = extract_frames_pallas(jnp.asarray(cap[c]), jnp.asarray(ds[c]),
                                    fl)
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", range(4))
def test_first_k_indices_match(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20000, 40000))
    rise = np.zeros((2, n), bool)
    for c in range(2):
        pts = rng.choice(n, size=int(rng.integers(0, 60)), replace=False)
        rise[c, pts] = True
    if seed % 2:                 # overfill one block: 12 edges in 512
        rise[1, 1024:1048:2] = True
    for k in (16, 64):
        idx, sat = sync._first_k_indices(_t(rise), k, sentinel=n)
        for c in range(2):
            i_ref, s_ref = ref_sync._first_k_indices(
                jnp.asarray(rise[c]), k, sentinel=n, with_sat=True)
            np.testing.assert_array_equal(idx[c].numpy(), np.asarray(i_ref))
            assert bool(sat[c]) == bool(s_ref)
    assert bool(sat[1]) == bool(seed % 2)


def _geometry(seed):
    """The randomized candidate geometries of the reference's
    tests/unit/test_select_doubling.py."""
    spec = config("c3")
    rng = np.random.default_rng(seed)
    m = int(rng.integers(4, 80)) if seed < 18 else int(rng.integers(300, 700))
    nd = 200000
    n_found = int(rng.integers(0, m + 1))
    base = np.sort(rng.integers(0, nd, n_found))
    if n_found > 2:
        base[1] = base[0] + int(rng.integers(1, spec.sym_len))
    cand = np.concatenate([base, np.full(m - n_found, nd)]).astype(np.int32)
    ds = np.maximum(cand - int(rng.integers(0, spec.cp + 1)), 0).astype(
        np.int32)
    valid = rng.random(m) < 0.8
    return cand, ds, valid, cand < nd


@pytest.mark.parametrize("seed", range(24))
def test_select_matches_scan_and_doubling(seed):
    spec, rspec = config("c3"), ref_config("c3")
    cand, ds, valid, found = _geometry(seed)
    slack = spec.sym_len
    args = [jnp.asarray(a) for a in (cand, ds, valid, found)]
    scan = np.asarray(ref_sync._select_scan(rspec, *args, slack))
    dbl = np.asarray(ref_sync._select_doubling(rspec, *args, slack))
    got = sync._select(spec, *(_t(a[None]) for a in (cand, ds, valid, found)),
                       slack=slack)
    np.testing.assert_array_equal(got[0].numpy(), scan)
    np.testing.assert_array_equal(got[0].numpy(), dbl)


def test_select_dead_halt_and_batch():
    spec, rspec = config("c1"), ref_config("c1")
    fl = spec.frame_len
    cand = np.array([[100, 100 + fl + 10, 100 + 2 * fl + 20],
                     [50, 60, 50 + fl + 5]], np.int32)
    valid = np.array([[True, False, True], [True, True, True]])
    found = np.ones_like(valid)
    got = sync._select(spec, _t(cand), _t(cand), _t(valid), _t(found),
                       slack=spec.sym_len)
    for c in range(2):
        ref = ref_sync._select_scan(rspec, jnp.asarray(cand[c]),
                                    jnp.asarray(cand[c]),
                                    jnp.asarray(valid[c]),
                                    jnp.asarray(found[c]), spec.sym_len)
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(ref))
    assert got[0].tolist() == [True, False, False]     # chain dies at 1
    assert got[1].tolist() == [True, False, True]      # 60 re-crossing


@pytest.mark.parametrize("mf", [3, 40, 700])
def test_compact_matches_blocks(mf):
    rng = np.random.default_rng(mf)
    m = 700
    keeps = rng.random((2, m)) < 0.3
    ds = rng.integers(0, 10**6, (2, m)).astype(np.int32)
    eps = rng.normal(size=(2, m)).astype(np.float32)
    got = sync._compact(_t(ds), _t(eps), _t(keeps), mf)
    for c in range(2):
        ref = ref_sync._compact_blocks(jnp.asarray(ds[c]), jnp.asarray(eps[c]),
                                       jnp.asarray(keeps[c]), mf)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[c].numpy(), np.asarray(r))


def test_cfo_correct_and_integer_cfo_match():
    spec, rspec = config("c3"), ref_config("c3")
    rng = np.random.default_rng(11)
    payloads = rng.integers(0, 2, (4, spec.payload_bits_per_frame))
    frames = TxPipeline(spec)(_t(payloads)).numpy()
    # integer shifts the search must find, plus a fractional part
    shifts = np.array([0.0, 2.0, -3.0, 1.0], np.float32)
    n = np.arange(spec.frame_len)
    rot = np.exp(2j * np.pi * shifts[:, None] * n / spec.n_sc)
    frames = (frames * rot).astype(np.complex64)
    eps = rng.uniform(-0.5, 0.5, 4).astype(np.float32)
    got = sync.cfo_correct(_t(frames), _t(eps), spec.n_sc)
    ref = ref_sync.cfo_correct(jnp.asarray(frames), jnp.asarray(eps),
                               spec.n_sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    k = sync.integer_cfo(spec, _t(frames))
    k_ref = ref_sync.integer_cfo(rspec, jnp.asarray(frames))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(k.numpy(), shifts)


@pytest.mark.parametrize("name", ["c1", "c2"])
def test_detect_frames_match(name):
    spec, rspec = config(name), ref_config(name).with_(kernel_backend="auto")
    rng = np.random.default_rng(4)
    n_frames, mf = 5, 7
    payloads = rng.integers(0, 2, (n_frames, spec.payload_bits_per_frame))
    frames = TxPipeline(spec)(_t(payloads)).numpy()
    caps = []
    for seed in range(2):
        ch = ChannelSpec(snr_db=20.0, cfo=0.3 + 0.2 * seed,
                         phase_noise_std=1e-4, timing_offset=60 + 40 * seed,
                         multipath_taps=(1.0, 0.3j) if name == "c2" else ())
        caps.append(make_capture(frames, ch, spec.n_sc, gap=150 + 50 * seed,
                                 seed=seed).astype(np.complex64))
    n = max(len(c) for c in caps)
    caps = np.stack([np.pad(c, (0, n - len(c))) for c in caps])
    ds, eps, valid, sat = sync.detect_frames(spec, _t(caps), mf)
    for c in range(2):
        d_ref, e_ref, v_ref, s_ref = ref_sync.detect_frames(
            rspec, jnp.asarray(caps[c]), mf, with_sat=True)
        np.testing.assert_array_equal(ds[c].numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(valid[c].numpy(), np.asarray(v_ref))
        assert bool(sat[c]) == bool(s_ref)
        v = np.asarray(v_ref)
        np.testing.assert_allclose(eps[c].numpy()[v], np.asarray(e_ref)[v],
                                   atol=1e-5)
    assert int(valid.sum()) == 2 * n_frames
