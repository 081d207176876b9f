"""The reference's numerics cases (tests/property/test_numerics.py) and
its capture edge cases from tests/integration/test_pipelines.py (near
back-to-back frames, noise only, sc16 against fc32), held against the
reference on the CPU: the same inputs through both packages' pipelines,
`d`, `valid`, `crc_ok` and the valid slots' payloads exactly, eps and
EVM within tolerance on the valid slots, and the reference test's own
assertions on the port's output. jax_debug_nans has no torch
counterpart: `evm_db`, `cpe` and `eps` are checked finite instead."""

import zlib

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.channel import make_capture as ref_make_capture
from ofdm_uhd_tpu.core.spec import ChannelSpec as RefChannel
from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.golden import GoldenModem as RefGolden
from ofdm_uhd_tpu.pipeline import RxPipeline as RefRx
from ofdm_uhd_tpu.pipeline import TxPipeline as RefTx

from ofdm_uhd_tpu_torch.pipeline import RxPipeline, TxPipeline

from tests.test_torch_faults import (assert_finite, capture_both,
                                     port_spec, same_slots)

torch.set_num_threads(2)


def aligned_both(rspec, frames, **kw):
    """rx_aligned of the same complex64 frames in both packages: (port,
    reference) results as numpy, CRC and payloads equal."""
    frames = np.array(frames, np.complex64)
    want = {k: np.asarray(v) for k, v in
            RefRx(rspec, **kw).rx_aligned(frames).items()}
    got = {k: v.numpy() for k, v in RxPipeline(port_spec(rspec), **kw)
           .rx_aligned(torch.from_numpy(frames)).items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["crc_ok"], want["crc_ok"])
    np.testing.assert_array_equal(got["payload"], want["payload"])
    assert_finite(got)
    return got, want


def test_chain_finite():
    """The reference's jax_debug_nans case: C1 TX -> aligned RX, every
    frame decodes and every float is finite. The frames are noiseless, so
    EVM sits at the float32 floor in both packages (below -120 dB), where
    its value is rounding noise and is not compared across them."""
    spec = ref_config("c1")
    rng = np.random.default_rng(0)
    p = rng.integers(0, 2, (2, spec.payload_bits_per_frame)).astype(np.uint8)
    got, want = aligned_both(spec, RefTx(spec)(p))
    assert got["crc_ok"].all()
    np.testing.assert_array_equal(got["payload"], p)
    assert want["evm_db"].max() < -120 and got["evm_db"].max() < -120


def test_degenerate_inputs_no_nans():
    spec = ref_config("c1")
    zeros = np.zeros((2, spec.frame_len), dtype=np.complex64)
    got, _ = aligned_both(spec, zeros)   # all-zero frames: EQ guards divide
    assert not got["crc_ok"].any()
    # idle capture through the sync path
    idle = np.zeros(4 * spec.frame_len, dtype=np.complex64)
    out = capture_both(spec, idle, 3)
    assert not out["valid"].any()
    assert np.isfinite(out["eps"]).all()


def test_noiseless_evm_floor():
    """The f32 chain's EVM floor on noiseless C3 frames is below -120 dB
    in both packages, on the reference's TX frames and on the port's own.
    At the floor EVM is float32 rounding noise, so its value is held to
    the reference's bound, not compared across the packages."""
    spec = ref_config("c3")  # largest constellation
    rng = np.random.default_rng(1)
    p = rng.integers(0, 2, (2, spec.payload_bits_per_frame)).astype(np.uint8)
    got, want = aligned_both(spec, RefTx(spec)(p))
    assert want["evm_db"].max() < -120 and got["evm_db"].max() < -120
    own = RxPipeline(port_spec(spec)).rx_aligned(
        TxPipeline(port_spec(spec))(torch.from_numpy(p)))
    assert float(own["evm_db"].max()) < -120
    assert bool(own["crc_ok"].all())


def test_capture_rx_near_back_to_back_frames():
    """C2 frames 8 samples apart (under the detection anchor's jitter):
    the greedy selector skips none."""
    spec = ref_config("c2")
    r = np.random.default_rng(zlib.crc32(b"b2b") % 2**31)
    n = 8
    p = r.integers(0, 2, (n, spec.payload_bits_per_frame)).astype(np.uint8)
    gm = RefGolden(spec)
    frames = np.stack([gm.modulate_frame(x) for x in p])
    ch = RefChannel(snr_db=28.0, cfo=0.2, timing_offset=50)
    cap = ref_make_capture(frames, ch, spec.n_sc, gap=8, seed=3)
    out = capture_both(spec, cap, n + 2)
    assert int(out["valid"].sum()) == n
    assert out["crc_ok"][:n].all()
    assert np.array_equal(out["payload"][:n], p)


def test_capture_rx_noise_only_no_false_detects():
    spec = ref_config("c3")
    r = np.random.default_rng(zlib.crc32(b"noise") % 2**31)
    noise = (r.standard_normal(30000) + 1j * r.standard_normal(30000)
             ).astype(np.complex64)
    out = capture_both(spec, noise, 4)
    assert not out["valid"].any()
    assert not out["crc_ok"].any()


@pytest.fixture(scope="module")
def sc16_case():
    """The reference test's C3 capture (4 frames, gap 400, CFO 0.6) and
    its full-scale sc16 planes."""
    spec = ref_config("c3")
    rng = np.random.default_rng(17)
    gm = RefGolden(spec)
    pays = rng.integers(0, 2, (4, spec.payload_bits_per_frame)
                        ).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in pays])
    ch = RefChannel(snr_db=26.0, cfo=0.6, timing_offset=200)
    cap = ref_make_capture(frames, ch, spec.n_sc, gap=400,
                           seed=17).astype(np.complex64)
    planes = np.stack([cap.real, cap.imag])
    iq = np.round(planes * (32767.0 / np.max(np.abs(planes)))
                  ).astype(np.int16)
    return spec, pays, cap, iq


@pytest.mark.parametrize("form", ["sc16", "fc32", "sc16_batched"])
def test_rx_capture_sc16_matches_fc32(sc16_case, form):
    """sc16 planes (one capture, and the batched [2, C, n] form) and the
    fc32 capture each decode the sent frames, as the reference does on
    the same input (diag=False)."""
    spec, pays, cap, iq = sc16_case
    if form == "fc32":
        x, call = cap, "rx_capture"
    else:
        x = iq if form == "sc16" else np.stack([iq, iq], axis=1)
        call = "rx_capture_sc16"
    want = {k: np.asarray(v) for k, v in getattr(
        RefRx(spec, diag=False), call)(x, max_frames=6).items()}
    got = {k: v.numpy() for k, v in getattr(
        RxPipeline(port_spec(spec), diag=False), call)(
            torch.from_numpy(x), max_frames=6).items()}
    same_slots(got, want)
    crc = got["crc_ok"][..., :4]
    assert crc.all()
    payload = got["payload"][..., :4, :]
    assert np.array_equal(payload.reshape((-1,) + pays.shape)[0], pays)
    assert np.array_equal(payload.reshape((-1,) + pays.shape)[-1], pays)
