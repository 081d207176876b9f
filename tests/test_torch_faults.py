"""The reference's fault-injection cases (tests/property/
test_fault_injection.py) held against the reference on the CPU: the same
impaired captures go through the reference's RxPipeline.rx_capture (and
its StreamRx over a (1, 4) mesh) and through the port's, which must give
the reference's `d`, `valid`, `crc_ok` and valid slots' payloads exactly
(the stream: every frame's start, CRC and payload), eps within 1e-5 and
EVM within 0.01 dB on the valid slots; and the reference test's own
assertions hold for the port's output. The reference checks its chain
for NaNs with jax_debug_nans; torch has no counterpart, so `evm_db`,
`cpe` and `eps` are checked finite instead."""

import dataclasses
import zlib

import jax
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.channel import apply_channel as ref_apply_channel
from ofdm_uhd_tpu.channel import make_capture as ref_make_capture
from ofdm_uhd_tpu.core.spec import ChannelSpec as RefChannel
from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.golden import GoldenModem as RefGolden
from ofdm_uhd_tpu.pipeline import RxPipeline as RefRx
from ofdm_uhd_tpu.pipeline.stream import StreamRx as RefStreamRx
from ofdm_uhd_tpu.shard.mesh import make_mesh as ref_make_mesh

from ofdm_uhd_tpu_torch.convert import spec_from_reference
from ofdm_uhd_tpu_torch.pipeline import RxPipeline, StreamRx
from ofdm_uhd_tpu_torch.shard import make_mesh

torch.set_num_threads(2)

EPS_TOL = 1e-5      # CFO estimate, subcarrier spacings
EVM_TOL = 0.01      # dB


def port_spec(rspec):
    return spec_from_reference(dataclasses.asdict(rspec))


def frames_for(spec, n, seed):
    """The reference test's frames: GoldenModem payloads from its seed."""
    rng = np.random.default_rng(zlib.crc32(f"fault{seed}".encode()) % 2**31)
    gm = RefGolden(spec)
    payloads = rng.integers(0, 2, (n, spec.payload_bits_per_frame)
                            ).astype(np.uint8)
    return [gm.modulate_frame(p) for p in payloads], payloads


def assert_finite(out):
    for k in ("evm_db", "cpe", "eps"):
        if k in out:
            assert np.isfinite(out[k]).all(), k


def same_slots(got, want):
    """The port's capture result against the reference's: detection, CRC
    and the valid slots' payloads exactly, eps and EVM within tolerance
    on the valid slots, every float finite."""
    assert set(got) == set(want)
    for k in ("d", "valid", "crc_ok"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    valid = want["valid"].astype(bool)
    np.testing.assert_array_equal(got["payload"][valid],
                                  want["payload"][valid])
    np.testing.assert_allclose(got["eps"][valid], want["eps"][valid],
                               atol=EPS_TOL)
    np.testing.assert_allclose(got["evm_db"][valid], want["evm_db"][valid],
                               atol=EVM_TOL)
    assert_finite(got)


def capture_both(rspec, cap, max_frames):
    """rx_capture of the same complex64 capture in both packages; the
    port's result (numpy), checked against the reference's."""
    cap = cap.astype(np.complex64)
    want = {k: np.asarray(v) for k, v in
            RefRx(rspec).rx_capture(cap, max_frames=max_frames).items()}
    got = {k: v.numpy() for k, v in RxPipeline(port_spec(rspec)).rx_capture(
        torch.from_numpy(cap), max_frames=max_frames).items()}
    same_slots(got, want)
    return got


def test_reacquire_after_sample_gap():
    spec = ref_config("c3")
    frames, payloads = frames_for(spec, 2, 1)
    stream = np.concatenate([
        np.zeros(300, complex), frames[0],
        np.zeros(3 * spec.frame_len, complex),   # long signal loss
        frames[1], np.zeros(300, complex)])
    cap = ref_apply_channel(stream, RefChannel(snr_db=25.0), spec.n_sc,
                            seed=1)
    out = capture_both(spec, cap, 4)
    assert out["valid"].sum() == 2
    assert out["crc_ok"][:2].all()
    assert np.array_equal(out["payload"][:2], payloads)


def test_level_drop_between_frames():
    spec = ref_config("c3")
    frames, payloads = frames_for(spec, 2, 2)
    stream = np.concatenate([
        np.zeros(200, complex), frames[0], np.zeros(400, complex),
        0.1 * frames[1], np.zeros(200, complex)])
    cap = ref_apply_channel(stream, RefChannel(snr_db=35.0), spec.n_sc,
                            seed=2)
    out = capture_both(spec, cap, 4)
    assert out["valid"].sum() == 2
    assert out["crc_ok"][:2].all()
    assert np.array_equal(out["payload"][:2], payloads)


def test_cfo_step_between_frames():
    spec = ref_config("c3")
    frames, payloads = frames_for(spec, 2, 3)

    def cfo(x, eps):
        n = np.arange(len(x))
        return x * np.exp(1j * 2 * np.pi * eps * n / spec.n_sc)
    stream = np.concatenate([
        np.zeros(200, complex), cfo(frames[0], 0.8),
        np.zeros(400, complex), cfo(frames[1], -1.7),
        np.zeros(200, complex)])
    cap = ref_apply_channel(stream, RefChannel(snr_db=28.0), spec.n_sc,
                            seed=3)
    out = capture_both(spec, cap, 4)
    assert out["valid"].sum() == 2
    assert out["crc_ok"][:2].all()
    assert np.array_equal(out["payload"][:2], payloads)
    eps = out["eps"][:2]
    assert abs(eps[0] - 0.8) < 0.05 and abs(eps[1] + 1.7) < 0.05


def test_corrupted_frame_flagged_not_fatal():
    spec = ref_config("c3")
    frames, payloads = frames_for(spec, 3, 4)
    f1 = frames[1].copy()
    f1[spec.sym_len * 3: spec.sym_len * 9] = 0  # burst puncture
    stream = np.concatenate([
        np.zeros(200, complex), frames[0], np.zeros(300, complex),
        f1, np.zeros(300, complex), frames[2], np.zeros(200, complex)])
    cap = ref_apply_channel(stream, RefChannel(snr_db=30.0), spec.n_sc,
                            seed=4)
    out = capture_both(spec, cap, 5)
    assert out["valid"].sum() == 3
    assert out["crc_ok"][0] and out["crc_ok"][2]
    assert not out["crc_ok"][1]                  # flagged, not false-accepted
    assert np.array_equal(out["payload"][0], payloads[0])
    assert np.array_equal(out["payload"][2], payloads[2])


@pytest.mark.parametrize("scale", [1.0, 3000.0, 1e-3])
def test_agc_extreme_levels_capture(scale):
    spec = ref_config("c3")
    frames, payloads = frames_for(spec, 2, 5)
    stream = np.concatenate([np.zeros(300, complex), frames[0],
                             np.zeros(500, complex), frames[1],
                             np.zeros(300, complex)])
    cap = ref_apply_channel(stream, RefChannel(snr_db=25.0), spec.n_sc,
                            seed=5)
    out = capture_both(spec, cap * scale, 4)
    assert out["crc_ok"][:2].all()
    assert np.array_equal(out["payload"][:2], payloads)


@pytest.mark.parametrize("reshard", [False, True])
def test_agc_level_drop_stream(reshard):
    """A 20 dB level drop mid-stream over a (1, 4) mesh, with and without
    the demod reshard: the port's frames are the reference's."""
    spec = ref_config("c5")
    n_fr, gap, offset = 8, 500, 700
    frames, payloads = frames_for(spec, n_fr, 11)
    ch = RefChannel(snr_db=26.0, cfo=0.4, timing_offset=offset)
    cap = ref_make_capture(np.stack(frames), ch, spec.n_sc, gap=gap,
                           seed=11).astype(np.complex64)
    # drop to 0.1x from frame 4 onward (between frames, not mid-frame)
    cut = offset + 4 * (spec.frame_len + gap) - gap // 2
    cap[cut:] *= np.float32(0.1)
    chunk = 4 * 2 * (spec.frame_len + spec.n_sc)
    ref = RefStreamRx(spec, mesh=ref_make_mesh(
        1, 4, devices=jax.devices()[:4]), chunk_len=chunk, reshard=reshard)
    want = ref.process(cap) + ref.flush()
    rx = StreamRx(port_spec(spec), mesh=make_mesh(1, 4, ["cpu"] * 4),
                  chunk_len=chunk, reshard=reshard)
    got = rx.process(cap) + rx.flush()
    assert len(got) == len(want) == n_fr
    for g, w, p in zip(got, want, payloads):
        assert g.start == w.start and g.crc_ok == w.crc_ok
        assert g.crc_ok
        assert np.array_equal(g.payload, w.payload)
        assert np.array_equal(g.payload, p)
        assert abs(g.eps - w.eps) <= EPS_TOL
        assert abs(g.evm_db - w.evm_db) <= EVM_TOL
        assert np.isfinite(g.eps) and np.isfinite(g.evm_db)
