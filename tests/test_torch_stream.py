"""The C5 streaming receiver, port against reference, on identical numpy
captures: the reference's `StreamRx(..., mesh=make_mesh(1, 1))` beside the
port's `StreamRx` on the CPU.

Depth is cut, widths are not: C5 (256 subcarriers, CP 32, QAM-16) at 7
data symbols instead of 12, so the trellis (2688 steps) is still above
the fused decoder's gate and the `auto` stream decodes through the
windowed Viterbi (windows of 256, overlap 64) at 6 slots per step. One
frame's data symbols are buried under a noise burst, so the stream
returns an owned slot that fails its CRC, where only the reference's
decoding algorithm gives the reference's bits.

Exact: frame starts, `crc_ok`, payloads of every owned slot, the state's
counters. Tolerances: `eps` within 1e-5 subcarrier spacings and EVM within
0.01 dB (float32 rounding of XLA's and PyTorch's complex arithmetic), the
tracked channel within 1e-5 and its CFO within 1e-6.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench_lib import build_capture as ref_build_capture  # noqa: E402
from ofdm_uhd_tpu.core.spec import config as ref_config  # noqa: E402
from ofdm_uhd_tpu.pipeline.stream import StreamRx as RefStreamRx  # noqa: E402
from ofdm_uhd_tpu.shard.mesh import make_mesh  # noqa: E402
from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16  # noqa: E402
from ofdm_uhd_tpu_torch.channel import make_capture  # noqa: E402
from ofdm_uhd_tpu_torch.convert import spec_from_reference  # noqa: E402
from ofdm_uhd_tpu_torch.core.spec import ChannelSpec  # noqa: E402
from ofdm_uhd_tpu_torch.core.state import StreamState  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import policy  # noqa: E402
from ofdm_uhd_tpu_torch.pipeline import StreamRx, TxPipeline  # noqa: E402

torch.set_num_threads(2)

N_FRAMES, GAP, OFFSET, BURST_FRAME = 8, 300, 100, 5


def _port_spec(rspec):
    return spec_from_reference(dataclasses.asdict(rspec))


def _ref_rx(rspec, **kw):
    return RefStreamRx(rspec, mesh=make_mesh(1, 1), **kw)


def _run(rx, feed, split=None, ckpt=None):
    """Frames of process(feed) + flush(); with `split`, feed in two parts
    and save a checkpoint between them."""
    if split is None:
        return rx.process(feed) + rx.flush()
    first = rx.process(feed[..., :split])
    if ckpt is not None:
        rx.save_state(ckpt)
    return first + rx.process(feed[..., split:]) + rx.flush()


def _same_frames(got, want):
    assert [g.start for g in got] == [w.start for w in want]
    for g, w in zip(got, want):
        assert g.crc_ok == w.crc_ok, g.start
        np.testing.assert_array_equal(g.payload, w.payload)
        assert abs(g.eps - w.eps) <= 1e-5, (g.start, g.eps, w.eps)
        assert abs(g.evm_db - w.evm_db) <= 0.01, (g.start, g.evm_db, w.evm_db)


def _same_state(got: StreamState, want) -> None:
    for f in ("steps", "frames", "crc_ok", "track_wt"):
        assert int(getattr(got, f)) == int(np.asarray(getattr(want, f))), f
    assert abs(float(got.eps_track) - float(np.asarray(want.eps_track))) \
        <= 1e-6
    np.testing.assert_allclose(got.h_track.numpy(), np.asarray(want.h_track),
                               atol=1e-5)
    np.testing.assert_allclose(got.tail.numpy(), np.asarray(want.tail),
                               atol=1e-6)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """C5 at 7 symbols, 8 frames, a noise burst over frame 5's data
    symbols; the reference's frames for fc32 (fed in two parts, with a
    checkpoint between them) and for sc16."""
    rspec = ref_config("c5").with_(n_data_syms=7, kernel_backend="auto")
    cap, pays = ref_build_capture(rspec, N_FRAMES, GAP, seed=0)
    s = OFFSET + BURST_FRAME * (rspec.frame_len + GAP) + 2 * rspec.sym_len
    n = rspec.frame_len - 2 * rspec.sym_len
    rng = np.random.default_rng(3)
    rms = float(np.sqrt(np.mean(np.abs(cap) ** 2)))
    cap[s:s + n] += (2.0 * rms * (rng.standard_normal(n) + 1j
                                  * rng.standard_normal(n))).astype(
                                      np.complex64)
    ckpt = str(tmp_path_factory.mktemp("stream") / "ref_ckpt.npz")
    split = len(cap) // 2
    rx = _ref_rx(rspec, steps_per_dispatch=1)
    frames = _run(rx, cap, split, ckpt)
    iq = to_sc16(cap[None])[:, 0]
    rx16 = _ref_rx(rspec, steps_per_dispatch=1, input_format="sc16")
    return {"spec": rspec, "cap": cap, "pays": pays, "iq": iq,
            "split": split, "ckpt": ckpt, "frames": frames, "state": rx.state,
            "rx": rx, "sc16": _run(rx16, iq)}


@pytest.fixture(scope="module")
def port(ref):
    spec = _port_spec(ref["spec"])
    rx = StreamRx(spec, steps_per_dispatch=1, device="cpu")
    policy.reset_launches()
    frames = _run(rx, ref["cap"])
    return {"spec": spec, "rx": rx, "frames": frames,
            "launches": policy.launches()}


def test_stream_frames_match_reference(ref, port):
    _same_frames(port["frames"], ref["frames"])
    got = port["frames"]
    assert len(got) == N_FRAMES
    assert [g.crc_ok for g in got] == [i != BURST_FRAME
                                       for i in range(N_FRAMES)]
    for i, g in enumerate(got):
        assert abs(g.start - (OFFSET + i * (port["spec"].frame_len + GAP))) \
            <= port["spec"].cp
        if i != BURST_FRAME:
            np.testing.assert_array_equal(g.payload, ref["pays"][i])


def test_stream_burst_slot_needs_the_reference_algorithm(ref, port):
    """The CRC-failing slot tells the decoders apart: decoded whole-sequence
    (kernel_backend 'xla') its payload differs from the reference's."""
    rx = StreamRx(port["spec"].with_(kernel_backend="xla"),
                  steps_per_dispatch=1, device="cpu")
    got = _run(rx, ref["cap"])
    assert [g.start for g in got] == [g.start for g in port["frames"]]
    assert not np.array_equal(got[BURST_FRAME].payload,
                              ref["frames"][BURST_FRAME].payload)


def test_stream_state_matches_reference(ref, port):
    _same_state(port["rx"].state, ref["state"])
    assert int(port["rx"].state.frames) == N_FRAMES
    assert int(port["rx"].state.crc_ok) == N_FRAMES - 1
    assert port["rx"].tracking()["track_wt"] == ref["rx"].tracking()[
        "track_wt"]


def test_stream_on_cpu_launches_no_kernel(port):
    assert port["launches"] == dict.fromkeys(policy.KERNELS, 0)


def test_stream_k_step_equals_single_step(ref, port):
    rx = StreamRx(port["spec"], steps_per_dispatch=3, device="cpu")
    got = _run(rx, ref["cap"])
    _same_frames(got, port["frames"])
    for f in dataclasses.fields(StreamState):
        assert torch.equal(getattr(rx.state, f.name),
                           getattr(port["rx"].state, f.name)), f.name


def test_stream_sc16_matches_reference(ref, port):
    rx = StreamRx(port["spec"], steps_per_dispatch=2, input_format="sc16",
                  device="cpu")
    got = _run(rx, ref["iq"])
    _same_frames(got, ref["sc16"])
    assert [g.start for g in got] == [g.start for g in port["frames"]]
    assert [g.crc_ok for g in got] == [g.crc_ok for g in port["frames"]]


def test_stream_resumes_reference_checkpoint(ref, port, tmp_path):
    """The reference's checkpoint, taken between the two feeds, loads in
    the port, which decodes the remaining frames as the reference did; the
    port's checkpoint at the same point has the reference's layout and
    values."""
    rx = StreamRx(port["spec"], steps_per_dispatch=1, device="cpu")
    rx.load_state(ref["ckpt"])
    got = rx.process(ref["cap"][ref["split"]:]) + rx.flush()
    n_done = sum(f.start < got[0].start for f in ref["frames"])
    assert 0 < n_done < N_FRAMES
    _same_frames(got, ref["frames"][n_done:])
    _same_state(rx.state, ref["state"])

    mine = str(tmp_path / "port_ckpt.npz")
    rx = StreamRx(port["spec"], steps_per_dispatch=1, device="cpu")
    rx.process(ref["cap"][:ref["split"]])
    rx.save_state(mine)
    with np.load(mine) as z, np.load(ref["ckpt"]) as r:
        assert sorted(z.files) == sorted(r.files)
        for k in r.files:
            assert z[k].dtype == r[k].dtype and z[k].shape == r[k].shape, k
        for k in ("__buf__", "__steps__", "steps", "frames", "crc_ok",
                  "track_wt"):
            np.testing.assert_array_equal(z[k], r[k], err_msg=k)
        for k in ("tail", "h_track", "eps_track"):
            np.testing.assert_allclose(z[k], r[k], atol=1e-5, err_msg=k)


def test_stream_track_retry_rescues_burst():
    """The burst case of tests/property/test_fault_injection.py at full C5
    width: a noise burst over the last frame's channel-estimation symbol
    fails its first decode; the retry with the tracked channel and CFO
    rescues it in both packages, with the sent payload."""
    rspec = ref_config("c5").with_(sfo_track=True)
    spec = _port_spec(rspec)
    n_fr, gap, offset = 10, 500, 700
    rng = np.random.default_rng(7)
    payloads = rng.integers(0, 2, (n_fr, spec.payload_bits_per_frame)
                            ).astype(np.uint8)
    frames = TxPipeline(spec)(torch.from_numpy(payloads)).numpy()
    ch = ChannelSpec(snr_db=24.0, cfo=0.7, phase_noise_std=1e-4,
                     multipath_taps=(1.0, 0.0, 0.25j, 0.1),
                     timing_offset=offset)
    cap = make_capture(frames, ch, spec.n_sc, gap=gap, seed=7).astype(
        np.complex64)
    s = offset + (n_fr - 1) * (spec.frame_len + gap) + spec.sym_len
    rms = float(np.sqrt(np.mean(np.abs(cap) ** 2)))
    burst = 4.0 * rms * (rng.standard_normal(spec.sym_len)
                         + 1j * rng.standard_normal(spec.sym_len))
    cap[s:s + spec.sym_len] += burst.astype(np.complex64)
    chunk = 4 * 2 * (spec.frame_len + spec.n_sc)

    rx_ref = _ref_rx(rspec, chunk_len=chunk, track_mode=True)
    want = _run(rx_ref, cap)
    rx_no = StreamRx(spec, chunk_len=chunk, track_mode=False, device="cpu")
    assert sum(g.crc_ok for g in _run(rx_no, cap)) == n_fr - 1
    rx = StreamRx(spec, chunk_len=chunk, track_mode=True, device="cpu")
    got = _run(rx, cap)
    _same_frames(got, want)
    assert sum(g.crc_ok for g in got) == n_fr
    assert rx.rescued == rx_ref.rescued >= 1
    assert abs(rx.tracking()["eps_track"] - 0.7) < 0.1
    rescued = [g for g in got if abs(g.start - (s - spec.sym_len)) <= spec.cp]
    assert len(rescued) == 1 and rescued[0].crc_ok
    np.testing.assert_array_equal(rescued[0].payload, payloads[n_fr - 1])


def test_stream_resampled_c4_matches_reference():
    """C4 at 2 data symbols: the stream decimates each radio chunk by 8
    over the carried 192-sample filter tail (valid mode)."""
    rspec = ref_config("c4").with_(n_data_syms=2, kernel_backend="auto")
    spec = _port_spec(rspec)
    cap, pays = ref_build_capture(rspec, 3, GAP, seed=1, cfo=0.1,
                                  phase_noise_std=0.0)
    want = _run(_ref_rx(rspec, steps_per_dispatch=1), cap)
    rx = StreamRx(spec, steps_per_dispatch=1, device="cpu")
    assert rx.state.rtail.shape == (192,)
    got = _run(rx, cap)
    _same_frames(got, want)
    assert [g.crc_ok for g in got] == [True] * 3
    for g, p in zip(got, pays):
        np.testing.assert_array_equal(g.payload, p)


def test_stream_bf16_spec_runs_exact_as_the_reference():
    """A C4 stream whose spec asks for the bf16 filter tier runs, as the
    reference's stream does, which never reads filter_precision: the
    reference's frames, and bit for bit the port's exact-spec stream (the
    stream's decimation is exact float32 whatever the spec says)."""
    rspec = ref_config("c4").with_(n_data_syms=2, kernel_backend="pallas",
                                   filter_precision="bf16")
    spec = _port_spec(rspec)
    cap, pays = ref_build_capture(rspec, 3, GAP, seed=1, cfo=0.1,
                                  phase_noise_std=0.0)
    want = _run(_ref_rx(rspec, steps_per_dispatch=1), cap)
    got = _run(StreamRx(spec, steps_per_dispatch=1, device="cpu"), cap)
    exact = _run(StreamRx(spec.with_(filter_precision="exact"),
                          steps_per_dispatch=1, device="cpu"), cap)
    _same_frames(got, want)
    assert [g.crc_ok for g in got] == [True] * 3
    for g, e, p in zip(got, exact, pays):
        np.testing.assert_array_equal(g.payload, p)
        np.testing.assert_array_equal(g.payload, e.payload)
        assert (g.start, g.crc_ok, g.eps, g.evm_db) == (e.start, e.crc_ok,
                                                        e.eps, e.evm_db)
    assert len(got) == len(exact)


def test_stream_loads_samples_era_checkpoint(ref, port, tmp_path):
    """A checkpoint of the reference's older layout, `samples` (a sample
    count) in place of `steps` and no `__steps__`: the port and the
    reference both resume at samples // chunk_len steps and decode the
    rest of the capture alike."""
    old = str(tmp_path / "samples_ckpt.npz")
    with np.load(ref["ckpt"]) as z:
        steps = int(z["steps"])
        arrays = {k: z[k] for k in z.files if k not in ("steps", "__steps__")}
    rx_ref = _ref_rx(ref["spec"], steps_per_dispatch=1)
    arrays["samples"] = np.int64(steps * rx_ref.chunk_len)
    np.savez(old, **arrays)
    rx_ref.load_state(old)
    rx = StreamRx(port["spec"], steps_per_dispatch=1, device="cpu")
    rx.load_state(old)
    assert 0 < rx._steps == rx_ref._steps == steps
    assert int(rx.state.steps) == int(np.asarray(rx_ref.state.steps))
    rest = ref["cap"][ref["split"]:]
    want = rx_ref.process(rest) + rx_ref.flush()
    got = rx.process(rest) + rx.flush()
    assert got
    _same_frames(got, want)
    _same_state(rx.state, rx_ref.state)


@pytest.mark.parametrize("early", [8, 16])
def test_stream_boundary_duplicate_matches_reference(early):
    """A reference fault the port reproduces: a frame that starts `early`
    samples before a processing window's first sample is owned by the
    step before and detected again at d = 0 by the next step, so the
    stream returns it twice (8 samples: both copies pass their CRC; 16:
    the second fails it). The port returns the reference's frames."""
    rspec = ref_config("c5").with_(n_data_syms=7, kernel_backend="auto")
    spec = _port_spec(rspec)
    cb, h = 10368, StreamState.halo_len(spec)
    offset = cb - h - early - 2 * (spec.frame_len + GAP)
    cap, _ = ref_build_capture(rspec, 4, GAP, seed=0, timing_offset=offset)
    want = _run(_ref_rx(rspec, steps_per_dispatch=1), cap)
    got = _run(StreamRx(spec, steps_per_dispatch=1, device="cpu"), cap)
    _same_frames(got, want)
    assert len(got) == 5 and got[3].start == cb - h
    assert got[3].crc_ok == (early == 8)


def test_stream_options_of_later_slices_run():
    """The reference's options run: the CFAR threshold constructs and
    decodes a short stream as the reference does; the mesh, reshard and
    the halo kernel came with the shard/ slice
    (tests/test_torch_shard.py)."""
    spec = _port_spec(ref_config("c5"))
    for kw in ({"threshold_mode": "cfar"}, {"reshard": True},
               {"pallas_halo": True}):
        assert StreamRx(spec, device="cpu", **kw).cb == 16128
    rspec = ref_config("c5").with_(n_data_syms=7, kernel_backend="auto")
    spec = _port_spec(rspec)
    cap, pays = ref_build_capture(rspec, 3, GAP, seed=2,
                                  timing_offset=OFFSET)
    want = _run(_ref_rx(rspec, threshold_mode="cfar"), cap)
    got = _run(StreamRx(spec, device="cpu", threshold_mode="cfar"), cap)
    _same_frames(got, want)
    assert len(got) == 3 and all(g.crc_ok for g in got)
    for g, p in zip(got, pays):
        np.testing.assert_array_equal(g.payload, p)



@pytest.mark.parametrize("entry", ["StreamRx", "StreamState.init",
                                   "StreamState.from_numpy",
                                   "StreamState.load", "build_capture"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Without `device`, the entry points run on the CUDA card: without one
    torch raises, and nothing carries on quietly on the CPU."""
    spec = _port_spec(ref_config("c5").with_(n_data_syms=2))
    state = StreamState.init(spec, device="cpu")
    ckpt = str(tmp_path / "state.npz")
    state.save(ckpt)
    tx_devices = []
    tx_call = TxPipeline.__call__

    def tx_spy(self, payloads):
        tx_devices.append(payloads.device)
        return tx_call(self, payloads)
    monkeypatch.setattr(TxPipeline, "__call__", tx_spy)

    def capture_device():
        build_capture(spec, 1, GAP)
        return tx_devices[0]
    run = {"StreamRx": lambda: StreamRx(spec).state.tail.device,
           "StreamState.init": lambda: StreamState.init(spec).tail.device,
           "StreamState.from_numpy": lambda: StreamState.from_numpy(
               state.to_numpy()).tail.device,
           "StreamState.load": lambda: StreamState.load(ckpt).tail.device,
           "build_capture": capture_device}[entry]
    if torch.cuda.is_available():
        assert run().type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            run()
