"""The port's host layer (spec, tables, golden helpers, channel models,
convert.py) equals the JAX reference's, array for array."""

import dataclasses

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.channel import models as ref_models
from ofdm_uhd_tpu.core import spec as ref_spec
from ofdm_uhd_tpu.golden import bits as ref_gbits
from ofdm_uhd_tpu.golden import modem as ref_gmodem
from ofdm_uhd_tpu.phy import tables as ref_tables
from ofdm_uhd_tpu_torch import convert
from ofdm_uhd_tpu_torch.channel import models
from ofdm_uhd_tpu_torch.core import spec
from ofdm_uhd_tpu_torch.golden import bits as gbits
from ofdm_uhd_tpu_torch.golden import modem as gmodem
from ofdm_uhd_tpu_torch.phy import tables

torch.set_num_threads(2)

CONFIGS = ("c1", "c2", "c3", "c4", "c5")
VARIANTS = {"c3-punct34-smooth": dict(fec_rate="3/4", chanest_smooth=3,
                                      sfo_track=True, eq_mode="mmse")}


def _pair(name):
    if name in VARIANTS:
        kw = VARIANTS[name]
        return spec.config("c3").with_(**kw), ref_spec.config("c3").with_(**kw)
    return spec.config(name), ref_spec.config(name)


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def test_constants_equal():
    for name in ("MOD_BITS", "CONV_K", "CONV_POLY_A", "CONV_POLY_B",
                 "CRC_BITS", "TAIL_BITS"):
        assert getattr(spec, name) == getattr(ref_spec, name)
    assert set(spec.PUNCTURE) == set(ref_spec.PUNCTURE)
    for k, (pat, num, den) in ref_spec.PUNCTURE.items():
        p2, n2, d2 = spec.PUNCTURE[k]
        np.testing.assert_array_equal(p2, pat)
        assert (n2, d2) == (num, den)
    assert (dataclasses.asdict(spec.ChannelSpec())
            == dataclasses.asdict(ref_spec.ChannelSpec()))


@pytest.mark.parametrize("name", CONFIGS + tuple(VARIANTS))
def test_spec_equal(name):
    s, r = _pair(name)
    assert dataclasses.asdict(s) == dataclasses.asdict(r)
    assert convert.spec_from_reference(dataclasses.asdict(r)) == s
    for attr in ("occupied_bins", "guard_bins", "pilot_positions",
                 "data_positions", "pilot_bins", "data_bins"):
        np.testing.assert_array_equal(getattr(s, attr), getattr(r, attr))
    for attr in ("bits_per_qam", "n_pilots", "n_data_sc",
                 "coded_bits_per_sym", "coded_bits_per_frame",
                 "uncoded_bits_per_frame", "payload_bits_per_frame",
                 "sym_len", "n_syms", "frame_len", "frame_len_radio"):
        assert getattr(s, attr) == getattr(r, attr), attr


def test_spec_validation_matches():
    for bad in (dict(modulation="qam1024"), dict(n_sc=100), dict(cp=64),
                dict(fec_rate="5/6"), dict(kernel_backend="cuda")):
        with pytest.raises(ValueError):
            ref_spec.WaveformSpec(**bad)
        with pytest.raises(ValueError):
            spec.WaveformSpec(**bad)


@pytest.mark.parametrize("name", CONFIGS + tuple(VARIANTS))
def test_spec_tables_equal(name):
    s, r = _pair(name)
    _assert_tree_equal(tables.frame_tables(s), ref_tables.frame_tables(r))
    _assert_tree_equal(tables.selection_tables(s),
                       ref_tables.selection_tables(r))
    _assert_tree_equal(tables.interleave_tables(s.coded_bits_per_sym),
                       ref_tables.interleave_tables(r.coded_bits_per_sym))
    _assert_tree_equal(tables.scramble_seq(s.uncoded_bits_per_frame),
                       ref_tables.scramble_seq(r.uncoded_bits_per_frame))


@pytest.mark.parametrize("mod", sorted(spec.MOD_BITS))
def test_qam_tables_equal(mod):
    _assert_tree_equal(tables.qam_tables(mod), ref_tables.qam_tables(mod))
    assert gmodem.qam_scale(mod) == ref_gmodem.qam_scale(mod)


def test_code_tables_equal():
    _assert_tree_equal(tables.parity7_lut(), ref_tables.parity7_lut())
    _assert_tree_equal(tables.conv_output_luts(),
                       ref_tables.conv_output_luts())
    _assert_tree_equal(tables.viterbi_tables(), ref_tables.viterbi_tables())
    for nb, lut in ref_gmodem._AXIS_LUT.items():
        np.testing.assert_array_equal(gmodem._AXIS_LUT[nb], lut)
    for l, m in ((8, 1), (1, 4), (3, 2)):
        _assert_tree_equal(tables.resample_filter(l, m),
                           ref_tables.resample_filter(l, m))


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4"])
def test_puncture_tables_equal(rate):
    # the depuncture one-hot is [kept, full]: compare at a small length
    _assert_tree_equal(tables.puncture_tables(rate, 1152),
                       ref_tables.puncture_tables(rate, 1152))
    np.testing.assert_array_equal(tables.puncture_kept(rate, 1152),
                                  ref_tables.puncture_tables(rate, 1152)["kept"])


@pytest.mark.parametrize("n_bits", [1, 33, 538])
def test_crc_matrix_equal(n_bits):
    # the C3 size (6874 bits) is checked in test_torch_rx_slice.py, whose
    # reference run builds that matrix anyway
    _assert_tree_equal(tables.crc_matrix(n_bits),
                       ref_tables.crc_matrix(n_bits))


@pytest.mark.parametrize("seed", range(3))
def test_golden_bits_equal(seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    np.testing.assert_array_equal(gbits.crc32_bits(bits),
                                  ref_gbits.crc32_bits(bits))
    for s in (gbits.SCRAMBLER_SEED, gbits.PILOT_SEED, 1 + seed):
        np.testing.assert_array_equal(gbits.lfsr_sequence(97, s),
                                      ref_gbits.lfsr_sequence(97, s))
    np.testing.assert_array_equal(gbits.pilot_polarity(12),
                                  ref_gbits.pilot_polarity(12))
    for rate in ("1/2", "2/3", "3/4"):
        np.testing.assert_array_equal(gbits.puncture_mask(rate, 1152),
                                      ref_gbits.puncture_mask(rate, 1152))
    np.testing.assert_array_equal(gbits.interleave_perm(576),
                                  ref_gbits.interleave_perm(576))


def test_tables_from_reference():
    s, r = _pair("c1")
    ref = {
        "scramble_seq": ref_tables.scramble_seq(r.uncoded_bits_per_frame),
        "crc_matrix": ref_tables.crc_matrix(r.payload_bits_per_frame),
        "conv_output_luts": ref_tables.conv_output_luts(),
        "viterbi_tables": ref_tables.viterbi_tables(),
        "interleave_tables": ref_tables.interleave_tables(
            r.coded_bits_per_sym),
        "qam_tables": ref_tables.qam_tables(r.modulation),
        "frame_tables": ref_tables.frame_tables(r),
        "selection_tables": ref_tables.selection_tables(r),
    }
    port = {
        "scramble_seq": tables.scramble_seq(s.uncoded_bits_per_frame),
        "crc_matrix": tables.crc_matrix(s.payload_bits_per_frame),
        "conv_output_luts": tables.conv_output_luts(),
        "viterbi_tables": tables.viterbi_tables(),
        "interleave_tables": tables.interleave_tables(s.coded_bits_per_sym),
        "qam_tables": tables.qam_tables(s.modulation),
        "frame_tables": tables.frame_tables(s),
        "selection_tables": tables.selection_tables(s),
    }
    _assert_tree_equal(convert.tables_from_reference(ref), port)
    _assert_tree_equal(convert.tables_from_reference(port), ref)


@pytest.mark.parametrize("seed", range(2))
def test_channel_models_equal(seed):
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(3, 400))
              + 1j * rng.normal(size=(3, 400))).astype(np.complex64)
    taps = (1.0, 0.2 - 0.1j)
    for cls, mod in ((spec.ChannelSpec, models),
                     (ref_spec.ChannelSpec, ref_models)):
        ch = cls(snr_db=12.0, cfo=0.3, phase_noise_std=1e-3,
                 multipath_taps=taps, timing_offset=17)
        out = mod.make_capture(frames, ch, 64, gap=50, seed=seed)
        if mod is models:
            got = out
        else:
            np.testing.assert_array_equal(got, out)
