"""The sharding layer, port against reference, on identical numpy inputs:
the time-sharded stream (`StreamRx(mesh=make_mesh(1, T, ["cpu"] * T))`
beside the reference's `StreamRx(mesh=make_mesh(1, T))` on the virtual
CPU devices of tests/conftest.py), the frame-parallel TX/RX and the
2-stage pipelined RX.

The stream is the C5 stream of tests/distributed/test_time_parallel.py
(full width, `auto`, gap 500; 16 frames) with a noise burst over one
frame's data symbols, so one owned slot fails its CRC and the TRACK retry
runs. Exact: starts, `crc_ok`, payloads of every owned slot and the
state's counters; `eps` within 1e-5 subcarrier spacings, EVM within 0.01
dB and the tracked channel within 1e-5 (float32 rounding of XLA's and
PyTorch's complex arithmetic, as tests/test_torch_stream.py). The port's
own variants (reshard, the halo dispatch, K-step, sc16, a 2-D mesh) must
give its plain sharded run's frames exactly.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import jax

from ofdm_uhd_tpu.channel import apply_channel
from ofdm_uhd_tpu.channel import make_capture as ref_make_capture
from ofdm_uhd_tpu.core.spec import ChannelSpec as RefChannelSpec
from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.golden import GoldenModem
from ofdm_uhd_tpu.golden import resample as GR
from ofdm_uhd_tpu.pipeline.stream import StreamRx as RefStreamRx
from ofdm_uhd_tpu.shard import frame_parallel as ref_fp
from ofdm_uhd_tpu.shard import mesh as ref_mesh
from ofdm_uhd_tpu.shard.stage_pipeline import \
    rx_aligned_pipelined as ref_rx_aligned_pipelined
from ofdm_uhd_tpu_torch.convert import spec_from_reference
from ofdm_uhd_tpu_torch.core.state import StreamState
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.pipeline import RxPipeline, StreamRx, TxPipeline
from ofdm_uhd_tpu_torch.shard import (make_mesh, rx_frames_sharded,
                                      tx_frames_sharded)
from ofdm_uhd_tpu_torch.shard.mesh import init_distributed, make_stage_mesh
from ofdm_uhd_tpu_torch.shard.stage_pipeline import rx_aligned_pipelined

torch.set_num_threads(2)

N_FRAMES, BURST_FRAME = 16, 14


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()) % 2**31)


def _port_spec(rspec):
    return spec_from_reference(dataclasses.asdict(rspec))


def _cpu_mesh(n_frame, n_time):
    return make_mesh(n_frame, n_time, ["cpu"] * (n_frame * n_time))


def _run(rx, feed, pieces=1):
    step = -(-feed.shape[-1] // pieces)
    got = []
    for lo in range(0, feed.shape[-1], step):
        got += rx.process(feed[..., lo:lo + step])
    return got + rx.flush()


def _same_frames(got, want, exact=False):
    assert [g.start for g in got] == [w.start for w in want]
    for g, w in zip(got, want):
        assert g.crc_ok == w.crc_ok, g.start
        np.testing.assert_array_equal(g.payload, w.payload)
        if exact:
            assert (g.eps, g.evm_db) == (w.eps, w.evm_db), g.start
        else:
            assert abs(g.eps - w.eps) <= 1e-5, (g.start, g.eps, w.eps)
            assert abs(g.evm_db - w.evm_db) <= 0.01, (g.start, g.evm_db,
                                                      w.evm_db)


@pytest.fixture(scope="module")
def stream():
    """The reference test's C5 stream (seed 1), a burst over the data
    symbols of frame BURST_FRAME; chunk = T blocks of max(2H, 4 frames)."""
    rspec = ref_config("c5").with_(kernel_backend="auto")
    gm = GoldenModem(rspec)
    r = _rng("stream1")
    pays = r.integers(0, 2, (N_FRAMES, rspec.payload_bits_per_frame)
                      ).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in pays])
    gap, offset = 500, 700
    ch = RefChannelSpec(snr_db=26.0, cfo=0.7, phase_noise_std=2e-4,
                        timing_offset=offset)
    cap = ref_make_capture(frames, ch, rspec.n_sc, gap=gap, seed=1).astype(
        np.complex64)
    s = offset + BURST_FRAME * (rspec.frame_len + gap) + 2 * rspec.sym_len
    n = rspec.frame_len - 2 * rspec.sym_len
    rms = float(np.sqrt(np.mean(np.abs(cap) ** 2)))
    cap[s:s + n] += (2.0 * rms * (r.standard_normal(n) + 1j
                                  * r.standard_normal(n))).astype(np.complex64)
    h = rspec.frame_len + rspec.n_sc
    cb = max(2 * h, 4 * rspec.frame_len)
    return {"rspec": rspec, "spec": _port_spec(rspec), "cap": cap,
            "pays": pays, "cb": cb}


@pytest.fixture(scope="module")
def port_runs(stream):
    """The port's plain sharded run at T = 2 and 4, and one shard at each
    T's chunk."""
    runs = {}
    for t in (2, 4):
        chunk = t * stream["cb"]
        rx = StreamRx(stream["spec"], mesh=_cpu_mesh(1, t), chunk_len=chunk,
                      steps_per_dispatch=1)
        one = StreamRx(stream["spec"], chunk_len=chunk, steps_per_dispatch=1,
                       device="cpu")
        runs[t] = {"rx": rx, "frames": _run(rx, stream["cap"]),
                   "one": _run(one, stream["cap"]), "chunk": chunk}
    return runs


@pytest.mark.parametrize("t", [2, 4])
def test_sharded_stream_matches_reference(stream, port_runs, t):
    rx_ref = RefStreamRx(stream["rspec"], mesh=ref_mesh.make_mesh(
        1, t, devices=jax.devices()[:t]), chunk_len=port_runs[t]["chunk"],
        steps_per_dispatch=1)
    want = _run(rx_ref, stream["cap"])
    got, rx = port_runs[t]["frames"], port_runs[t]["rx"]
    _same_frames(got, want)
    assert len(got) == N_FRAMES
    assert [g.crc_ok for g in got] == [i != BURST_FRAME
                                       for i in range(N_FRAMES)]
    for i, g in enumerate(got):
        if i != BURST_FRAME:
            np.testing.assert_array_equal(g.payload, stream["pays"][i])
    for f in ("steps", "frames", "crc_ok", "track_wt"):
        assert int(getattr(rx.state, f)) == int(np.asarray(
            getattr(rx_ref.state, f))), f
    assert abs(float(rx.state.eps_track)
               - float(np.asarray(rx_ref.state.eps_track))) <= 1e-6
    np.testing.assert_allclose(rx.state.h_track.numpy(),
                               np.asarray(rx_ref.state.h_track), atol=1e-5)
    assert rx.rescued == rx_ref.rescued


@pytest.mark.parametrize("t", [2, 4])
def test_sharded_stream_equals_one_shard(port_runs, t):
    _same_frames(port_runs[t]["frames"], port_runs[t]["one"])


def _variant(stream, name):
    """The T = 4 stream through one of the port's variants."""
    spec, cap, chunk = stream["spec"], stream["cap"], 4 * stream["cb"]
    mesh = _cpu_mesh(1, 4)
    if name == "sc16":
        planes = np.stack([cap.real, cap.imag])
        iq = np.round(planes * (32767.0 / np.max(np.abs(planes)))
                      ).astype(np.int16)
        rx = StreamRx(spec, mesh=mesh, chunk_len=chunk, steps_per_dispatch=2,
                      input_format="sc16")
        return _run(rx, iq, pieces=3), iq
    kw = {"reshard": {"reshard": True},
          "pallas_halo": {"pallas_halo": True},
          "k_step": {"steps_per_dispatch": 3},
          "frame_axis": {}}[name]
    if name == "frame_axis":
        mesh = _cpu_mesh(2, 4)        # the stream runs on row 0
    rx = StreamRx(spec, mesh=mesh, chunk_len=chunk, **kw)
    return _run(rx, cap, pieces=3 if name == "k_step" else 1), rx


@pytest.mark.parametrize("name", ["reshard", "pallas_halo", "k_step", "sc16",
                                  "frame_axis"])
def test_sharded_stream_variants_equal_plain_run(stream, port_runs, name):
    got, extra = _variant(stream, name)
    want = port_runs[4]["frames"]
    if name != "sc16":
        _same_frames(got, want, exact=True)
        for f in dataclasses.fields(StreamState):
            assert torch.equal(getattr(extra.state, f.name),
                               getattr(port_runs[4]["rx"].state, f.name)), f
        return
    # the fc32 stream fed the same quantized samples, divided by 32767
    deq = ((extra[0].astype(np.float32) + 1j * extra[1].astype(np.float32))
           / 32767.0).astype(np.complex64)
    rx = StreamRx(stream["spec"], mesh=_cpu_mesh(1, 4),
                  chunk_len=4 * stream["cb"], steps_per_dispatch=2)
    ref = _run(rx, deq)
    assert [g.start for g in got] == [w.start for w in ref]
    assert [g.crc_ok for g in got] == [w.crc_ok for w in ref]
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.payload, w.payload)


@pytest.mark.parametrize("reshard", [False, True])
def test_sharded_decode_chooses_algorithm_per_shard(stream, monkeypatch,
                                                    reshard):
    """The Viterbi algorithm depends on the decode batch; the reference
    decodes each shard's slots inside shard_map (mf, or f2 after the
    reshard), so the port's one call over T * mf rows must choose at the
    shard's batch, never at the concatenated one."""
    batches = []
    impl = policy.viterbi_impl

    def spy(size, batch, *a, **kw):
        batches.append(batch)
        return impl(size, batch, *a, **kw)
    monkeypatch.setattr(policy, "viterbi_impl", spy)
    t, cb = 4, stream["cb"]
    rx = StreamRx(stream["spec"], mesh=_cpu_mesh(1, t), chunk_len=t * cb,
                  steps_per_dispatch=1, reshard=reshard)
    got = _run(rx, stream["cap"])
    mf = cb // stream["spec"].frame_len + 2
    want = -(-mf // t) * t if reshard else mf
    # one decode a step, and the TRACK retry's (at mf) where it ran
    assert len(batches) > rx._steps
    assert set(batches) == ({want, mf} if reshard else {mf})
    assert sum(g.crc_ok for g in got) == N_FRAMES - 1


def test_frames_straddling_shard_boundaries():
    """tests/distributed/test_time_parallel.py's placement: one frame
    inside shard 0, one across the shard 0/1 boundary, one across the
    chunk boundary, on an 8-shard mesh."""
    spec = _port_spec(ref_config("c5"))
    h = spec.frame_len + spec.n_sc
    chunk = 8 * 2 * h
    cb = chunk // 8
    gm = GoldenModem(ref_config("c5"))
    r = _rng("straddle")
    pays = r.integers(0, 2, (3, spec.payload_bits_per_frame)).astype(np.uint8)
    stream = np.zeros(2 * chunk, dtype=np.complex64)
    starts = [500, cb - spec.frame_len // 2, chunk - spec.frame_len // 3]
    for s, p in zip(starts, pays):
        stream[s:s + spec.frame_len] += gm.modulate_frame(p).astype(
            np.complex64)
    stream += ((_rng("straddlen").standard_normal(len(stream))
                + 1j * _rng("straddlen2").standard_normal(len(stream)))
               * 0.01).astype(np.complex64)
    rx = StreamRx(spec, mesh=_cpu_mesh(1, 8), chunk_len=chunk)
    got = _run(rx, stream)
    assert len(got) == 3, [g.start for g in got]
    for g, s, p in zip(got, starts, pays):
        assert abs(g.start - s) <= spec.cp and g.crc_ok
        np.testing.assert_array_equal(g.payload, p)


def test_checkpoint_resume_on_mesh(stream, port_runs, tmp_path):
    """A mesh stream saved after two chunks and resumed in a new receiver
    decodes the rest as the uninterrupted run did."""
    spec, cap, chunk = stream["spec"], stream["cap"], 4 * stream["cb"]
    rx1 = StreamRx(spec, mesh=_cpu_mesh(1, 4), chunk_len=chunk,
                   steps_per_dispatch=1)
    cut = 2 * chunk + 123
    part1 = rx1.process(cap[:cut])
    rx1.save_state(str(tmp_path / "st.npz"))
    rx2 = StreamRx(spec, mesh=_cpu_mesh(1, 4), chunk_len=chunk,
                   steps_per_dispatch=2)
    rx2.load_state(str(tmp_path / "st.npz"))
    got = part1 + rx2.process(cap[cut:]) + rx2.flush()
    _same_frames(got, port_runs[4]["frames"], exact=True)


def test_rational_resample_stream_sharded():
    """tests/distributed/test_time_parallel.py's rational 8/3 stream at
    T = 4, n_data_syms = 4: the decimation runs on the whole chunk, then
    the shards; sharded equals one shard, every payload the sent one."""
    rspec = ref_config("c4").with_(n_data_syms=4, resample_l=8,
                                   resample_m=3)
    spec = _port_spec(rspec)
    r = _rng("c4rat")
    gm = GoldenModem(rspec)
    pays = r.integers(0, 2, (3, spec.payload_bits_per_frame)).astype(np.uint8)
    proto = GR.design_lowpass(spec.resample_l, spec.resample_m)
    parts = [np.zeros(4000, complex)]
    for p in pays:
        parts.append(GR.resample(gm.modulate_frame(p), spec.resample_l,
                                 spec.resample_m, proto))
        parts.append(np.zeros(6000, complex))
    stream = np.concatenate(parts)
    stream = (stream + 0.003 * (_rng("c4ratn").standard_normal(len(stream))
                                + 1j * _rng("c4ratn2").standard_normal(
                                    len(stream)))).astype(np.complex64)
    h = spec.frame_len + spec.n_sc
    cb = -(-max(h + 64, 2 * h) // 3) * 3
    rx = StreamRx(spec, mesh=_cpu_mesh(1, 4), chunk_len=4 * cb)
    got = _run(rx, stream)
    assert len(got) == 3, [g.start for g in got]
    for g, p in zip(got, pays):
        assert g.crc_ok
        np.testing.assert_array_equal(g.payload, p)
    one = _run(StreamRx(spec, chunk_len=4 * cb, device="cpu"), stream)
    _same_frames(got, one)


def _aligned_batch(rspec, n, snr, seed):
    rng = np.random.default_rng(seed)
    pays = rng.integers(0, 2, (n, rspec.payload_bits_per_frame)
                        ).astype(np.uint8)
    frames = GoldenModem(rspec).tx(pays)
    rx = np.stack([apply_channel(frames[i], RefChannelSpec(snr_db=snr),
                                 rspec.n_sc, seed=i) for i in range(n)])
    return rx.astype(np.complex64), pays


def test_frame_parallel_matches_reference():
    """C1 at 4 data symbols on a (4, 1) mesh, batch 8 (the shapes of the
    reference's multichip dry run)."""
    rspec = ref_config("c1").with_(n_data_syms=4)
    spec = _port_spec(rspec)
    frames, pays = _aligned_batch(rspec, 8, 25.0, seed=0)
    rmesh = ref_mesh.make_mesh(4, 1, devices=jax.devices()[:4])
    want = ref_fp.rx_frames_sharded(rspec, rmesh)(frames)
    got = rx_frames_sharded(spec, _cpu_mesh(4, 1))(torch.from_numpy(frames))
    for k in ("payload", "crc_ok"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["payload"].numpy(), pays)
    assert int(got["n_ok_global"]) == int(np.asarray(want["n_ok_global"])) \
        == 8
    np.testing.assert_allclose(got["evm_db"].numpy(),
                               np.asarray(want["evm_db"]), atol=0.01)
    assert abs(float(got["mean_evm_global"])
               - float(np.asarray(want["mean_evm_global"]))) <= 0.01
    # and the frame-parallel TX
    tx_want = np.asarray(ref_fp.tx_frames_sharded(rspec, rmesh)(pays))
    tx_got = tx_frames_sharded(spec, _cpu_mesh(4, 1))(torch.from_numpy(pays))
    assert tx_got.shape == tx_want.shape
    assert np.abs(tx_got.numpy() - tx_want).max() <= 1e-5 * np.abs(
        tx_want).max()
    assert torch.equal(tx_got, TxPipeline(spec)(torch.from_numpy(pays)))


def test_stage_pipeline_matches_reference():
    """tests/distributed/test_stage_pipeline.py's C2 batch: 16 frames, 4
    microbatches over a 2-entry stage mesh; equal to rx_aligned too."""
    rspec = ref_config("c2")
    spec = _port_spec(rspec)
    frames, pays = _aligned_batch(rspec, 16, 22.0,
                                  seed=zlib.crc32(b"pp") % 2**31)
    want = ref_rx_aligned_pipelined(rspec, ref_mesh.make_stage_mesh(2),
                                    n_micro=4)(frames)
    x = torch.from_numpy(frames)
    got = rx_aligned_pipelined(spec, make_stage_mesh(2, ["cpu", "cpu"]),
                               n_micro=4)(x)
    for k in ("payload", "crc_ok"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["evm_db"].numpy(),
                               np.asarray(want["evm_db"]), atol=0.01)
    np.testing.assert_array_equal(got["payload"].numpy(), pays)
    fused = RxPipeline(spec).rx_aligned(x)
    for k in got:
        assert torch.equal(got[k], fused[k]), k


def test_mesh_construction(monkeypatch):
    mesh = make_mesh(2, 3, ["cpu"] * 7)
    assert list(mesh.shape.items()) == [("frame", 2), ("time", 3)]
    assert mesh.devices.shape == (2, 3)
    assert mesh.first_device == torch.device("cpu")
    stage = make_stage_mesh(2, ["cpu", "cpu"])
    assert dict(stage.shape) == {"stage": 2}
    with pytest.raises(ValueError):
        make_mesh(1, 4, ["cpu"] * 3)
    with pytest.raises(ValueError):
        make_stage_mesh(2, ["cpu"])
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError):
        # no process group to join: neither a coordinator nor torchrun's
        # environment
        init_distributed()
    assert mesh.ranks is None and not mesh.distributed
    with pytest.raises(ValueError):
        # the shards of one device must be neighbours on the time axis
        StreamRx(_port_spec(ref_config("c5")), mesh=make_mesh(
            1, 3, ["cpu", "meta", "cpu"]), chunk_len=3 * 8576)
    with pytest.raises(ValueError):
        rx_frames_sharded(_port_spec(ref_config("c1")), _cpu_mesh(3, 1))(
            torch.zeros((4, 480), dtype=torch.complex64))
