"""The noise-floor-adaptive (CFAR) S&C threshold, port against reference,
after tests/unit/test_cfar_detection.py: `RxPipeline(...,
sync_threshold_mode="cfar")` and `StreamRx(..., threshold_mode="cfar")`
beside the reference's on identical numpy captures.

The threshold decides `m >= thr`, so it must equal the reference's to the
bit: clip(16 * median(M), 0.05, threshold) with jnp.median's midpoint of
the two middle values where the row length is even. Exact: `d`, `valid`,
`crc_ok` and the payload of every slot; `eps` within 1e-5 subcarrier
spacings (float32 rounding of XLA's and PyTorch's complex arithmetic).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.channel import make_capture as ref_make_capture
from ofdm_uhd_tpu.core.spec import ChannelSpec as RefChannelSpec
from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.golden import GoldenModem
from ofdm_uhd_tpu.pipeline.rx import RxPipeline as RefRx
from ofdm_uhd_tpu.pipeline.stream import StreamRx as RefStreamRx
from ofdm_uhd_tpu.shard.mesh import make_mesh as ref_make_mesh
from ofdm_uhd_tpu_torch.convert import spec_from_reference
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.phy import sync
from ofdm_uhd_tpu_torch.pipeline import RxPipeline, StreamRx
from ofdm_uhd_tpu_torch.shard import make_mesh

torch.set_num_threads(2)

MAX_FRAMES = 8


def _port_spec(rspec):
    return spec_from_reference(dataclasses.asdict(rspec))


def _capture(rspec, n_frames, snr_db, seed):
    """tests/unit/test_cfar_detection.py's capture: golden frames, gap 800,
    timing offset 400."""
    rng = np.random.default_rng(seed)
    gm = GoldenModem(rspec)
    payloads = rng.integers(0, 2, (n_frames, rspec.payload_bits_per_frame)
                            ).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    cap = ref_make_capture(frames, RefChannelSpec(snr_db=snr_db,
                                                  timing_offset=400),
                           rspec.n_sc, gap=800, seed=seed)
    return cap.astype(np.complex64), payloads


def _ref_out(rspec, cap, mode):
    out = RefRx(rspec, sync_threshold_mode=mode).rx_capture(
        cap, max_frames=MAX_FRAMES)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_out(rspec, cap, mode):
    out = RxPipeline(_port_spec(rspec), sync_threshold_mode=mode).rx_capture(
        torch.from_numpy(cap), max_frames=MAX_FRAMES)
    return {k: v.numpy() for k, v in out.items()}


def _same(got, want):
    for k in ("d", "valid", "crc_ok", "payload"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["eps"][want["valid"]],
                               want["eps"][want["valid"]], atol=1e-5)


@pytest.mark.parametrize("cfg,snr_db", [("c1", 2.0), ("c3", 0.0)])
def test_cfar_detects_below_fixed_threshold_as_the_reference(cfg, snr_db):
    """At 2 dB (c1) and 0 dB (c3) the fixed threshold drops frames and
    CFAR finds all five preambles; the port gives the reference's slots
    in both modes."""
    rspec = ref_config(cfg)
    cap, _ = _capture(rspec, 5, snr_db, seed=3)
    got = {mode: _port_out(rspec, cap, mode) for mode in ("fixed", "cfar")}
    for mode, out in got.items():
        _same(out, _ref_out(rspec, cap, mode))
    assert int(got["cfar"]["valid"].sum()) == 5
    assert int(got["fixed"]["valid"].sum()) < 5


def test_cfar_pure_noise_no_false_alarms():
    rspec = ref_config("c1")
    rng = np.random.default_rng(9)
    noise = (rng.normal(size=50000) + 1j * rng.normal(size=50000)
             ).astype(np.complex64) * 0.3
    out = _port_out(rspec, noise, "cfar")
    assert int(out["valid"].sum()) == 0 and int(out["crc_ok"].sum()) == 0
    _same(out, _ref_out(rspec, noise, "cfar"))


def test_cfar_matches_fixed_on_clean_capture():
    rspec = ref_config("c3")
    cap, payloads = _capture(rspec, 4, 25.0, seed=5)
    fixed, cfar = (_port_out(rspec, cap, m) for m in ("fixed", "cfar"))
    for k in ("d", "valid", "crc_ok", "payload"):
        np.testing.assert_array_equal(fixed[k], cfar[k], err_msg=k)
    assert cfar["crc_ok"].sum() == 4
    np.testing.assert_array_equal(cfar["payload"][cfar["valid"]], payloads)


@pytest.mark.parametrize("nd", [64, 1000, 999])
def test_cfar_threshold_bit_equal_to_the_reference(nd):
    """The threshold of every row equals jnp's clip(16 * median) to the
    bit, even and odd row lengths, across scales where the clip is and is
    not active; on even rows torch.median (the lower middle value) would
    not give it."""
    rng = np.random.default_rng(nd)
    scale = np.logspace(-5, -1, 40, dtype=np.float32)[:, None]
    m = (rng.random((40, nd), dtype=np.float32) * scale).astype(np.float32)
    got = sync.cfar_threshold(torch.from_numpy(m), 0.5, 16.0)
    assert got.shape == (40, 1) and got.dtype == torch.float32
    want = np.stack([np.asarray(jnp.clip(16.0 * jnp.median(jnp.asarray(r)),
                                         0.05, 0.5)) for r in m])
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    lower = torch.clamp(16.0 * torch.median(torch.from_numpy(m), -1).values,
                        0.05, 0.5)
    assert bool((lower != got[:, 0]).any()) == (nd % 2 == 0)


def test_detect_frames_cfar_exact():
    """detect_frames(threshold_mode='cfar') on a 2 dB c1 capture, capture
    by capture against the reference's, and an unknown mode refused."""
    from ofdm_uhd_tpu.phy import sync as ref_sync
    rspec = ref_config("c1")
    spec = _port_spec(rspec)
    caps = np.stack([_capture(rspec, 3, 2.0, seed=s)[0] for s in (1, 2)])
    ds, eps, valid, _ = sync.detect_frames(spec, torch.from_numpy(caps), 6,
                                           threshold_mode="cfar")
    for c in range(2):
        r = ref_sync.detect_frames(rspec, jnp.asarray(caps[c]), 6,
                                   threshold_mode="cfar")
        np.testing.assert_array_equal(ds[c].numpy(), np.asarray(r[0]))
        np.testing.assert_array_equal(valid[c].numpy(), np.asarray(r[2]))
    with pytest.raises(ValueError, match="threshold_mode"):
        sync.detect_frames(spec, torch.from_numpy(caps), 6,
                           threshold_mode="adaptive")


def test_cfar_streaming_matches_fixed_and_the_reference():
    """StreamRx(threshold_mode='cfar') over two time shards (each shard's
    median over its own window) decodes the reference's clean stream as
    fixed mode does, and gives the reference's frames."""
    rspec = ref_config("c5")
    spec = _port_spec(rspec)
    gm = GoldenModem(rspec)
    rng = np.random.default_rng(4)
    pls = rng.integers(0, 2, (3, rspec.payload_bits_per_frame)).astype(
        np.uint8)
    stream = np.concatenate(
        [np.zeros(400, np.complex64)]
        + [np.concatenate([gm.modulate_frame(p).astype(np.complex64),
                           np.zeros(500, np.complex64)]) for p in pls])
    chunk = 2 * max(spec.frame_len + spec.n_sc, spec.frame_len + spec.cp)
    policy.reset_launches()
    out = {}
    for mode in ("fixed", "cfar"):
        rx = StreamRx(spec, mesh=make_mesh(1, 2, ["cpu"] * 2),
                      chunk_len=chunk, threshold_mode=mode)
        got = rx.process(stream) + rx.flush()
        ref_rx = RefStreamRx(rspec, mesh=ref_make_mesh(
            1, 2, devices=jax.devices()[:2]), chunk_len=chunk,
            threshold_mode=mode)
        want = ref_rx.process(stream) + ref_rx.flush()
        assert [g.start for g in got] == [w.start for w in want], mode
        assert len(got) == 3 and all(
            g.crc_ok and np.array_equal(g.payload, p)
            for g, p in zip(got, pls)), mode
        for g, w in zip(got, want):
            assert g.crc_ok == w.crc_ok
            np.testing.assert_array_equal(g.payload, w.payload)
            assert abs(g.eps - w.eps) <= 1e-5
        out[mode] = [(g.start, bytes(g.payload)) for g in got]
    assert out["fixed"] == out["cfar"]
    assert policy.launches() == dict.fromkeys(policy.KERNELS, 0)


def test_cfar_anchors_a_c3_frame_early_as_the_reference():
    """A reference divergence the port reproduces: on C3's traffic (gap
    300, 28 dB) the CFAR threshold (~0.09) admits a rising edge before one
    frame's plateau, and detection anchors that frame 588 samples early,
    where the fixed threshold finds it; the port's d equals the
    reference's in both modes. The window is cut from C3's seed-0 capture
    (1024 frames) around that frame."""
    from ofdm_uhd_tpu.phy import sync as ref_sync
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.phy import agc
    spec_r = ref_config("c3")
    spec = _port_spec(spec_r)
    cap, _ = build_capture(spec, 1024, 300, seed=0, device="cpu")
    win = agc.agc_normalize(torch.from_numpy(cap[796_000:826_000]))[0]
    d = {}
    for mode in ("fixed", "cfar"):
        ds, _, valid, _ = sync.detect_frames(spec, win[None], 8,
                                             threshold_mode=mode)
        r = ref_sync.detect_frames(spec_r, jnp.asarray(win.numpy()), 8,
                                   threshold_mode=mode)
        np.testing.assert_array_equal(ds[0].numpy(), np.asarray(r[0]))
        np.testing.assert_array_equal(valid[0].numpy(), np.asarray(r[2]))
        d[mode] = ds[0][valid[0]].tolist()
    assert len(d["fixed"]) == len(d["cfar"]) == 6
    moved = [(a, b) for a, b in zip(d["fixed"], d["cfar"]) if a != b]
    assert len(moved) == 1 and moved[0][0] - moved[0][1] == 588
