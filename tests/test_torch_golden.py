"""The port's float64 golden oracle (ofdm_uhd_tpu_torch/golden/) and
phy/agc.agc_normalize_np against the reference's on seeded inputs,
exactly: the same NumPy operations in the same order give the same bits
and the same float64 values, so every comparison is np.array_equal (or
==), with no tolerance. Then the pinned fixtures through the port's
GoldenModem and RxPipeline, the oracle's own first-principles tests
(after tests/unit/test_golden_{bits,modem}.py) on the port's copy, and
the golden comparisons of tests/integration/test_pipelines.py with the
port's pipelines on the CPU (valid slots only: the bits of empty slots
decode noise and may differ with float32 rounding)."""

import os
import zlib

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.golden import bits as RB
from ofdm_uhd_tpu.golden import modem as RM
from ofdm_uhd_tpu.golden import resample as RR
from ofdm_uhd_tpu.golden import sync as RS
from ofdm_uhd_tpu.golden import GoldenModem as RefModem
from ofdm_uhd_tpu.phy import agc as RA
from ofdm_uhd_tpu.core import spec as ref_spec

from ofdm_uhd_tpu_torch.channel import apply_channel, make_capture
from ofdm_uhd_tpu_torch.core.spec import (MOD_BITS, PUNCTURE, TAIL_BITS,
                                          ChannelSpec, WaveformSpec, config)
from ofdm_uhd_tpu_torch.golden import GoldenModem
from ofdm_uhd_tpu_torch.golden import bits as B
from ofdm_uhd_tpu_torch.golden import modem as M
from ofdm_uhd_tpu_torch.golden import resample as R
from ofdm_uhd_tpu_torch.golden import sync as S
from ofdm_uhd_tpu_torch.phy import agc as A
from ofdm_uhd_tpu_torch.pipeline import RxPipeline, TxPipeline

torch.set_num_threads(2)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
CONFIGS = ["c1", "c2", "c3", "c4", "c5"]
MODS = list(MOD_BITS)
RATES = list(PUNCTURE)
# the branches the named configs leave off: smoothing, MMSE, SFO
# tracking, TX windowing, punctured rates
VARIANTS = {
    "c2_smooth_mmse": dict(chanest_smooth=5, eq_mode="mmse"),
    "c2_sfo_window": dict(sfo_track=True, tx_window=4),
    "c2_rate34": dict(fec_rate="3/4"),
    "c1_rate23_bpsk": dict(fec_rate="2/3", modulation="bpsk"),
}


def rng_for(name):
    return np.random.default_rng(zlib.crc32(name.encode()) % 2**31)


def pair(name):
    """(the port's spec, the reference's) for a config or a variant."""
    if name in VARIANTS:
        base, kw = name[:2], VARIANTS[name]
        return config(base).with_(**kw), ref_spec.config(base).with_(**kw)
    return config(name), ref_spec.config(name)


def cplx(r, *shape):
    return r.standard_normal(shape) + 1j * r.standard_normal(shape)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def same_result(a, b):
    """Two RxFrameResults field for field."""
    return (same(a.payload, b.payload) and a.crc_ok == b.crc_ok
            and a.evm_db == b.evm_db and same(a.data_syms, b.data_syms)
            and same(a.cpe, b.cpe))


# ------------------------------------------------------------ bits.py


@pytest.mark.parametrize("n,seed", [(0, 0x5D), (1, 0x5D), (500, 0x5D),
                                    (777, 0x13)])
def test_scramble_equals_reference(n, seed):
    b = rng_for(f"scr{n}").integers(0, 2, n).astype(np.uint8)
    assert same(B.scramble(b, seed), RB.scramble(b, seed))
    assert same(B.descramble(b, seed), RB.descramble(b, seed))


def test_parity_equals_reference():
    x = np.arange(128)
    assert same(B._parity(x), RB._parity(x))
    assert same(B._parity(77), RB._parity(77))


@pytest.mark.parametrize("n", [1, 7, 64, 571])
def test_conv_encode_equals_reference(n):
    b = rng_for(f"enc{n}").integers(0, 2, n).astype(np.uint8)
    assert same(B.conv_encode(b), RB.conv_encode(b))


def test_viterbi_tables_equal_reference():
    got, want = B._viterbi_tables(), RB._viterbi_tables()
    for b in (0, 1):
        for k in ("next", "out_a", "out_b"):
            assert same(got[b][k], want[b][k])


@pytest.mark.parametrize("n", [16, 300])
@pytest.mark.parametrize("noise", [0.0, 0.8, 3.0])
def test_viterbi_decode_equals_reference(n, noise):
    r = rng_for(f"vit{n}{noise}")
    msg = np.concatenate([r.integers(0, 2, n).astype(np.uint8),
                          np.zeros(TAIL_BITS, np.uint8)])
    llr = 1.0 - 2.0 * B.conv_encode(msg) + noise * r.standard_normal(
        2 * len(msg))
    assert same(B.viterbi_decode(llr), RB.viterbi_decode(llr))


def test_viterbi_decode_rejects_odd_length():
    with pytest.raises(ValueError):
        B.viterbi_decode(np.zeros(5))


@pytest.mark.parametrize("rate", RATES)
def test_puncture_depuncture_equal_reference(rate):
    full = 2 * 6 * 40
    r = rng_for(f"punc{rate}")
    coded = r.integers(0, 2, full).astype(np.uint8)
    kept = B.puncture(coded, rate)
    assert same(kept, RB.puncture(coded, rate))
    llr = r.standard_normal(len(kept))
    assert same(B.depuncture_llr(llr, rate, full),
                RB.depuncture_llr(llr, rate, full))


@pytest.mark.parametrize("name", CONFIGS)
def test_interleavers_equal_reference(name):
    n_cbps = config(name).coded_bits_per_sym
    r = rng_for(f"ilv{name}")
    bits = r.integers(0, 2, 3 * n_cbps).astype(np.uint8)
    llr = r.standard_normal(3 * n_cbps)
    assert same(B.interleave(bits, n_cbps), RB.interleave(bits, n_cbps))
    assert same(B.deinterleave(bits, n_cbps), RB.deinterleave(bits, n_cbps))
    assert same(B.deinterleave_soft(llr, n_cbps),
                RB.deinterleave_soft(llr, n_cbps))


# ----------------------------------------------------------- modem.py


@pytest.mark.parametrize("mod", MODS)
def test_qam_equals_reference(mod):
    r = rng_for(f"qam{mod}")
    bits = r.integers(0, 2, MOD_BITS[mod] * 500).astype(np.uint8)
    assert same(M.qam_map(bits, mod), RM.qam_map(bits, mod))
    syms = RM.qam_map(bits, mod) + 0.2 * cplx(r, 500)
    csi = r.random(500)
    assert same(M.qam_demap_hard(syms, mod), RM.qam_demap_hard(syms, mod))
    assert same(M.qam_demap_llr(syms, mod), RM.qam_demap_llr(syms, mod))
    assert same(M.qam_demap_llr(syms, mod, csi=csi),
                RM.qam_demap_llr(syms, mod, csi=csi))


@pytest.mark.parametrize("name", CONFIGS + list(VARIANTS))
def test_symbol_chain_equals_reference(name):
    """build_grid, ofdm_modulate / demodulate (at two shifts), the channel
    and noise estimates, equalize, track_phase and evm_db on seeded
    grids and samples."""
    spec, ref = pair(name)
    r = rng_for(f"sym{name}")
    data = cplx(r, spec.n_data_syms, spec.n_data_sc)
    grid = M.build_grid(spec, data)
    assert same(grid, RM.build_grid(ref, data))
    x = M.ofdm_modulate(spec, grid)
    assert same(x, RM.ofdm_modulate(ref, grid))
    y = x + 0.05 * cplx(r, len(x))
    for shift in (0, min(4, spec.cp // 4)):
        g = M.ofdm_demodulate(spec, y, shift=shift)
        assert same(g, RM.ofdm_demodulate(ref, y, shift=shift))
    h = M.estimate_channel(spec, g)
    assert same(h, RM.estimate_channel(ref, g))
    assert M.estimate_noise(spec, g) == RM.estimate_noise(ref, g)
    eq = M.equalize(spec, g, h)
    assert same(eq, RM.equalize(ref, g, h))
    d, cpe = M.track_phase(spec, eq)
    d_ref, cpe_ref = RM.track_phase(ref, eq)
    assert same(d, d_ref) and same(cpe, cpe_ref)
    assert M.evm_db(d, data) == RM.evm_db(d, data)


@pytest.mark.parametrize("width", [0, 1, 3, 7])
def test_smooth_occ_equals_reference(width):
    h = cplx(rng_for(f"smooth{width}"), 52)
    assert same(M.smooth_occ(h, width), RM.smooth_occ(h, width))


# -------------------------------------------------------- resample.py


@pytest.mark.parametrize("l,m", [(1, 1), (8, 1), (1, 8), (3, 2)])
def test_resample_equals_reference(l, m):
    r = rng_for(f"rs{l}{m}")
    x = cplx(r, 400)
    assert same(R.resample(x, l, m), RR.resample(x, l, m))
    h = R.design_lowpass(max(l, 2), m)
    assert same(R.resample(x, l, m, h), RR.resample(x, l, m, h))
    assert same(R.upfirdn(h, x, l, m), RR.upfirdn(h, x, l, m))
    xr = r.standard_normal(300)
    assert same(R.upfirdn(h, xr, l, m), RR.upfirdn(h, xr, l, m))
    assert same(R.fir_filter(x, h), RR.fir_filter(x, h))


# ------------------------------------------------------------ sync.py


@pytest.mark.parametrize("name", CONFIGS)
def test_sync_equals_reference(name):
    """sc_metric, detect_plateau, coarse_sync, integer_cfo and cfo_correct
    on a seeded capture of two frames with CFO (C4 at baseband)."""
    spec, ref = pair(name)
    gm = GoldenModem(spec)
    r = rng_for(f"sync{name}")
    pays = r.integers(0, 2, (2, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in pays])
    cap = make_capture(frames, ChannelSpec(snr_db=20.0, cfo=1.3,
                                           timing_offset=150),
                       spec.n_sc, gap=300, seed=3)
    p, rr = S.sc_metric(spec, cap)
    p_ref, rr_ref = RS.sc_metric(ref, cap)
    assert same(p, p_ref) and same(rr, rr_ref)
    m = np.abs(p) ** 2 / np.maximum(rr, 1e-12) ** 2
    for span in (None, spec.sym_len):
        assert S.detect_plateau(m, 0.5, span=span) == RS.detect_plateau(
            m, 0.5, span=span)
    d, eps = S.coarse_sync(spec, cap)
    assert (d, eps) == RS.coarse_sync(ref, cap)
    fr = S.cfo_correct(cap[max(d, 0):max(d, 0) + spec.frame_len], eps,
                       spec.n_sc, phase0=0.3)
    assert same(fr, RS.cfo_correct(cap[max(d, 0):max(d, 0) + spec.frame_len],
                                   eps, spec.n_sc, phase0=0.3))
    assert S.integer_cfo(spec, fr) == RS.integer_cfo(ref, fr)
    assert S.integer_cfo(spec, fr, search=2) == RS.integer_cfo(ref, fr,
                                                               search=2)


def test_sync_edges_equal_reference():
    spec, ref = pair("c1")
    short = np.ones(spec.n_sc - 1, complex)
    for a, b in zip(S.sc_metric(spec, short), RS.sc_metric(ref, short)):
        assert same(a, b)
    for m in (np.zeros(0), np.full(10, 0.1)):
        assert S.detect_plateau(m) == RS.detect_plateau(m) == -1
    noise = cplx(rng_for("syncnoise"), 3000) * 1e-3
    assert S.coarse_sync(spec, noise) == RS.coarse_sync(ref, noise)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 0.0])
def test_agc_normalize_np_equals_reference(scale):
    x = cplx(rng_for(f"agc{scale}"), 500) * scale
    assert same(A.agc_normalize_np(x), RA.agc_normalize_np(x))
    assert same(A.agc_normalize_np(x, 2.0), RA.agc_normalize_np(x, 2.0))


# ----------------------------------------------------------- chain.py


@pytest.mark.parametrize("name", ["c1", "c2", "c4", "c2_smooth_mmse",
                                  "c2_sfo_window", "c2_rate34",
                                  "c1_rate23_bpsk"])
def test_golden_modem_equals_reference(name):
    """GoldenModem.encode_frame_bits, tx, rx_aligned (at two shifts) and
    rx_capture give the reference's outputs on a few seeded frames."""
    spec, ref = pair(name)
    gm, rm = GoldenModem(spec), RefModem(ref)
    r = rng_for(f"chain{name}")
    n = 2 if name == "c4" else 3
    pays = r.integers(0, 2, (n, spec.payload_bits_per_frame)).astype(np.uint8)
    assert same(gm.encode_frame_bits(pays[0]), rm.encode_frame_bits(pays[0]))
    frames = gm.tx(pays)
    assert same(frames, rm.tx(pays))
    ch = ChannelSpec(snr_db=18.0, multipath_taps=(1.0, 0.2 - 0.1j))
    rx_in = np.stack([apply_channel(f, ch, spec.n_sc, seed=i)
                      for i, f in enumerate(frames)])
    for shift in (0, 2):
        got = gm.rx_aligned(rx_in, shift=shift)
        want = rm.rx_aligned(rx_in, shift=shift)
        assert len(got) == len(want) == n
        assert all(same_result(a, b) for a, b in zip(got, want))
    assert all(res.crc_ok for res in got)
    cap = make_capture(frames, ChannelSpec(snr_db=25.0, cfo=0.4,
                                           timing_offset=100),
                       spec.n_sc, gap=spec.n_sc, seed=5)
    got = gm.rx_capture(cap, max_frames=n + 1)
    want = rm.rx_capture(cap, max_frames=n + 1)
    assert len(got) == len(want) == n
    for (d, e, a), (d_r, e_r, b) in zip(got, want):
        assert d == d_r and e == e_r and same_result(a, b)
        assert a.crc_ok


def test_golden_modem_rejects_a_wrong_payload_length():
    with pytest.raises(ValueError):
        GoldenModem(config("c1")).encode_frame_bits(np.zeros(3, np.uint8))


@pytest.mark.parametrize("name", ["c1", "c2", "c3"])
def test_pinned_capture_decodes(name):
    """The frozen captures decode the same forever: the port's GoldenModem
    gives the pinned payloads and starts (eps within 1e-6: the fixture's
    eps came from the float64 capture, the stored one is complex64), and
    the port's RxPipeline on the CPU the pinned payloads and starts."""
    z = np.load(os.path.join(FIXDIR, f"golden_{name}.npz"))
    spec = config(name)
    results = GoldenModem(spec).rx_capture(z["capture"].astype(np.complex128))
    assert len(results) == len(z["payloads"])
    for (d, eps, r), p, d0, e0 in zip(results, z["payloads"], z["starts"],
                                      z["eps"]):
        assert r.crc_ok and np.array_equal(r.payload, p)
        assert d == d0
        assert abs(eps - e0) < 1e-6
    out = RxPipeline(spec).rx_capture(torch.from_numpy(z["capture"]),
                                      max_frames=6)
    n = len(z["payloads"])
    assert int(out["valid"].sum()) == n and bool(out["valid"][:n].all())
    assert bool(out["crc_ok"][:n].all())
    assert np.array_equal(out["payload"][:n].numpy(), z["payloads"])
    assert np.array_equal(out["d"][:n].numpy(), z["starts"])


# ---------------------- first principles (tests/unit/test_golden_bits.py)


def test_scramble_is_involution():
    b = rng_for("inv").integers(0, 2, 500).astype(np.uint8)
    assert np.array_equal(B.descramble(B.scramble(b)), b)
    assert not np.array_equal(B.scramble(b), b)  # actually whitens


def test_conv_encode_known_impulse():
    b = np.zeros(7, dtype=np.uint8)
    b[0] = 1
    out = B.conv_encode(b)
    # g0 = 1011011, g1 = 1111001 (MSB = current bit)
    assert np.array_equal(out[0::2], [1, 0, 1, 1, 0, 1, 1])
    assert np.array_equal(out[1::2], [1, 1, 1, 1, 0, 0, 1])


@pytest.mark.parametrize("n", [64, 571])
def test_viterbi_noiseless_roundtrip(n):
    b = rng_for(f"vnr{n}").integers(0, 2, n).astype(np.uint8)
    coded = B.conv_encode(np.concatenate([b, np.zeros(TAIL_BITS, np.uint8)]))
    assert np.array_equal(B.viterbi_decode(1.0 - 2.0 * coded)[:n], b)


def test_viterbi_corrects_errors():
    n = 400
    b = rng_for("vce").integers(0, 2, n).astype(np.uint8)
    coded = B.conv_encode(np.concatenate([b, np.zeros(TAIL_BITS, np.uint8)]))
    llr = 1.0 - 2.0 * coded.astype(np.float64)
    # isolated flips every 40 coded bits: always correctable at K=7
    # rate 1/2 (free distance 10)
    llr[7::40] *= -1.0
    assert np.array_equal(B.viterbi_decode(llr)[:n], b)
    # soft information helps: attenuated wrong bits also decode
    llr2 = 1.0 - 2.0 * coded.astype(np.float64)
    llr2[5::17] *= -0.25
    assert np.array_equal(B.viterbi_decode(llr2)[:n], b)


def test_interleave_roundtrip():
    n_cbps = 96
    b = rng_for("ilr").integers(0, 2, n_cbps * 12).astype(np.uint8)
    assert np.array_equal(B.deinterleave(B.interleave(b, n_cbps), n_cbps), b)
    # spreads adjacency: consecutive coded bits land >= n_cbps/16 apart
    perm = B.interleave_perm(n_cbps)
    assert np.min(np.abs(np.diff(perm))) >= n_cbps // 16


# --------------------- first principles (tests/unit/test_golden_modem.py)


@pytest.mark.parametrize("mod", MODS)
def test_qam_roundtrip_and_power(mod):
    bits = rng_for(f"qrt{mod}").integers(0, 2, MOD_BITS[mod] * 4096).astype(
        np.uint8)
    syms = M.qam_map(bits, mod)
    assert np.isclose(np.mean(np.abs(syms) ** 2), 1.0, atol=0.05)
    assert np.array_equal(M.qam_demap_hard(syms, mod), bits)
    # LLR signs agree with the bits on clean symbols (llr > 0 <=> bit 0)
    llr = M.qam_demap_llr(syms, mod)
    assert np.array_equal((llr < 0).astype(np.uint8), bits)


def test_ofdm_parseval_and_grid_roundtrip():
    spec = WaveformSpec()
    grid = cplx(rng_for("parseval"), spec.n_syms, spec.n_sc)
    x = M.ofdm_modulate(spec, grid)
    assert len(x) == spec.frame_len
    # the ortho IFFT preserves power (the CP copies aside)
    body = x.reshape(spec.n_syms, spec.sym_len)[:, spec.cp:]
    assert np.isclose(np.sum(np.abs(body) ** 2), np.sum(np.abs(grid) ** 2))
    np.testing.assert_allclose(M.ofdm_demodulate(spec, x), grid, atol=1e-10)


@pytest.mark.parametrize("cfg", ["c1", "c2", "c3"])
def test_loopback_noiseless_bit_exact(cfg):
    spec = config(cfg)
    modem = GoldenModem(spec)
    payloads = rng_for(f"lnb{cfg}").integers(
        0, 2, (3, spec.payload_bits_per_frame)).astype(np.uint8)
    for p, r in zip(payloads, modem.rx_aligned(modem.tx(payloads))):
        assert r.crc_ok and np.array_equal(r.payload, p)
        assert r.evm_db < -100  # numerically clean


def test_c2_multipath_qam16():
    spec = config("c2")
    modem = GoldenModem(spec)
    payloads = rng_for("gc2").integers(
        0, 2, (20, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = modem.tx(payloads)
    ch = ChannelSpec(snr_db=25.0, multipath_taps=(1.0, 0.4 - 0.2j, 0.1j))
    rx = np.stack([apply_channel(frames[i], ch, spec.n_sc, seed=i)
                   for i in range(len(frames))])
    for p, r in zip(payloads, modem.rx_aligned(rx, shift=4)):
        assert r.crc_ok and np.array_equal(r.payload, p)
        assert r.evm_db < -15


def test_schmidl_cox_timing_and_cfo():
    spec = config("c3")
    frame = GoldenModem(spec).modulate_frame(rng_for("sct").integers(
        0, 2, spec.payload_bits_per_frame).astype(np.uint8))
    cap = make_capture(frame[None, :], ChannelSpec(snr_db=20.0, cfo=0.37,
                                                   timing_offset=333),
                       spec.n_sc, gap=400, seed=7)
    d, eps = S.coarse_sync(spec, cap)
    assert abs(eps - 0.37) < 0.02
    # timing within the CP window (early by <= cp is recoverable)
    assert -spec.cp <= d - 333 <= spec.cp // 2


@pytest.mark.parametrize("k", [-2, 0, 3])
def test_integer_cfo_detection(k):
    spec = config("c3")
    frame = GoldenModem(spec).modulate_frame(rng_for("icfo").integers(
        0, 2, spec.payload_bits_per_frame).astype(np.uint8))
    true_eps = k + 0.21
    cap = make_capture(frame[None, :], ChannelSpec(snr_db=20.0, cfo=true_eps),
                       spec.n_sc, gap=200, seed=11)
    d, eps_f = S.coarse_sync(spec, cap)
    d = max(d, 0)  # sync may report a few samples early at offset 0
    fr = S.cfo_correct(cap[d: d + spec.frame_len], eps_f, spec.n_sc)
    assert abs((eps_f + S.integer_cfo(spec, fr)) - true_eps) < 0.05


def test_c3_capture_rx_end_to_end():
    spec = config("c3")
    modem = GoldenModem(spec)
    payloads = rng_for("c3e2e").integers(
        0, 2, (4, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.stack([modem.modulate_frame(p) for p in payloads])
    ch = ChannelSpec(snr_db=28.0, cfo=1.3, phase_noise_std=5e-4,
                     timing_offset=250)
    results = modem.rx_capture(make_capture(frames, ch, spec.n_sc, gap=300,
                                            seed=3))
    assert len(results) == 4
    for (d, eps, r), p in zip(results, payloads):
        assert abs(eps - 1.3) < 0.05
        assert r.crc_ok and np.array_equal(r.payload, p)


def test_resampler_roundtrip():
    t = np.arange(4096)
    # bandlimited test signal, well inside the passband
    x = (np.exp(1j * 2 * np.pi * 0.03 * t)
         + 0.5 * np.exp(1j * 2 * np.pi * 0.011 * t))
    up = R.resample(x, 8, 1)
    assert len(up) == 8 * len(x)
    # the interior matches (the edges have filter transients)
    np.testing.assert_allclose(R.resample(up, 1, 8)[200:-200], x[200:-200],
                               atol=1e-3)


def test_c4_resampled_loopback():
    spec = config("c4")
    modem = GoldenModem(spec)
    payloads = rng_for("c4lb").integers(
        0, 2, (2, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = modem.tx(payloads)           # at the radio rate (8x)
    assert frames.shape[1] == spec.frame_len_radio
    for p, r in zip(payloads, modem.rx_aligned(frames)):
        assert r.crc_ok and np.array_equal(r.payload, p)


def test_awgn_qpsk_ber_matches_theory():
    """Uncoded QPSK BER ~ Q(sqrt(2 Eb/N0)) within 0.5 dB."""
    from scipy.special import erfc
    spec = WaveformSpec(n_sc=64, cp=16, modulation="qpsk", n_data_syms=40)
    snr_db = 7.0
    rng = np.random.default_rng(5)
    nbits = nerr = 0
    for trial in range(8):
        coded = rng.integers(0, 2, spec.coded_bits_per_frame).astype(np.uint8)
        syms = M.qam_map(coded, "qpsk").reshape(spec.n_data_syms,
                                                spec.n_data_sc)
        x = M.ofdm_modulate(spec, M.build_grid(spec, syms))
        y = apply_channel(x, ChannelSpec(snr_db=snr_db), spec.n_sc,
                          seed=trial)
        # identity channel, known perfectly: demap the data bins directly
        data = M.ofdm_demodulate(spec, y)[2:, spec.data_bins]
        nerr += np.sum(M.qam_demap_hard(data.reshape(-1), "qpsk") != coded)
        nbits += len(coded)
    # subcarrier SNR = sample SNR x N / n_occupied; Eb/N0 = Es/N0 / 2
    ebn0 = 10 ** (snr_db / 10.0) * spec.n_sc / spec.n_occupied / 2
    lo = 0.5 * erfc(np.sqrt(ebn0 * 10 ** 0.05))
    hi = 0.5 * erfc(np.sqrt(ebn0 / 10 ** 0.05))
    assert lo * 0.8 <= nerr / nbits <= hi * 1.2


# ------------- the port's pipelines against the port's golden chain
# (after tests/integration/test_pipelines.py)


def payloads_for(spec, n, r):
    return r.integers(0, 2, (n, spec.payload_bits_per_frame)).astype(np.uint8)


@pytest.mark.parametrize("name", ["c1", "c2", "c3", "c4"])
def test_tx_matches_golden(name):
    spec = config(name)
    p = payloads_for(spec, 2, rng_for("txg"))
    frames = TxPipeline(spec)(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(frames, GoldenModem(spec).tx(p), atol=2e-5)


def test_c1_loopback_bit_exact_vs_golden():
    spec = config("c1")
    p = payloads_for(spec, 100, rng_for("c1pipe"))
    frames = TxPipeline(spec)(torch.from_numpy(p)).numpy()
    ch = ChannelSpec(snr_db=12.0)
    rx_in = np.stack([apply_channel(frames[i], ch, spec.n_sc, seed=50 + i)
                      for i in range(100)])
    out = RxPipeline(spec).rx_aligned(
        torch.from_numpy(rx_in.astype(np.complex64)))
    assert bool(out["crc_ok"].all())
    assert np.array_equal(out["payload"].numpy(), p)
    gold = GoldenModem(spec).rx_aligned(rx_in)
    assert all(g.crc_ok and np.array_equal(g.payload, pp)
               for g, pp in zip(gold, p))


def test_c3_capture_sync_rx():
    """C3 capture with CFO and phase noise: the pipeline's valid slots are
    the golden chain's frames, their starts within the CP."""
    spec = config("c3")
    p = payloads_for(spec, 4, rng_for("c3pipe"))
    gm = GoldenModem(spec)
    frames = np.stack([gm.modulate_frame(x) for x in p])
    ch = ChannelSpec(snr_db=28.0, cfo=1.3, phase_noise_std=5e-4,
                     timing_offset=400)
    cap = make_capture(frames, ch, spec.n_sc, gap=300, seed=9)
    out = RxPipeline(spec).rx_capture(
        torch.from_numpy(cap.astype(np.complex64)), max_frames=6)
    valid = out["valid"].numpy()
    assert valid.sum() == 4 and valid[:4].all()
    assert bool(out["crc_ok"][:4].all())
    assert np.array_equal(out["payload"][:4].numpy(), p)
    np.testing.assert_allclose(out["eps"][:4].numpy(), 1.3, atol=0.05)
    gold = gm.rx_capture(cap)
    assert [r.crc_ok for _, _, r in gold] == [True] * 4
    np.testing.assert_allclose(out["d"][:4].numpy(),
                               [d for d, _, _ in gold], atol=spec.cp)


def test_qam256_loopback_bit_exact():
    """256-QAM end to end (the dense constellation needs ~35+ dB): TX ->
    AWGN + multipath -> aligned RX, post-FEC bit-exact, and the pipeline
    equal to the golden chain."""
    spec = config("c2").with_(modulation="qam256")
    p = payloads_for(spec, 12, rng_for("q256"))
    frames = TxPipeline(spec)(torch.from_numpy(p)).numpy()
    ch = ChannelSpec(snr_db=40.0, multipath_taps=(1.0, 0.08 + 0.05j))
    rx_in = np.stack([apply_channel(frames[i], ch, spec.n_sc, seed=90 + i)
                      for i in range(12)])
    out = RxPipeline(spec, shift=min(4, spec.cp // 4)).rx_aligned(
        torch.from_numpy(rx_in.astype(np.complex64)))
    assert bool(out["crc_ok"].all())
    assert np.array_equal(out["payload"].numpy(), p)
    gold = GoldenModem(spec).rx_aligned(rx_in)
    assert all(g.crc_ok for g in gold)
    assert np.array_equal(np.stack([g.payload for g in gold]),
                          out["payload"].numpy())
