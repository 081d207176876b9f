"""The bulk-copy deframer (K12, research/deframe.py) against the JAX
reference's research/pallas_deframe.py in interpret mode: the reference
test's two cases (tests/kernels/test_deframe.py: C3 frames from a 50,000
sample capture against the gather, and two captures at once), offsets past
the capture's end, and negative offsets, where K12 gives an all-zero frame
that neither K2 nor the port's kernels/extract.py gives. Exact: the
deframer copies samples.

Also the reason the port's extraction may clamp: detection never hands
it a negative offset (ROADMAP Queue 3), on C3, C4 and the stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.phy.sync import extract_frames as ref_gather
from ofdm_uhd_tpu.research.pallas_deframe import extract_frames_dma
from ofdm_uhd_tpu_torch.bench_lib import build_capture
from ofdm_uhd_tpu_torch.core.spec import config
from ofdm_uhd_tpu_torch.kernels import extract, policy
from ofdm_uhd_tpu_torch.phy import sync
from ofdm_uhd_tpu_torch.pipeline import RxPipeline, StreamRx
from ofdm_uhd_tpu_torch.research import deframe

torch.set_num_threads(2)


def _cap(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture
def no_launch():
    policy.reset_launches()
    yield
    assert not any(policy.launches().values())


def test_deframe_matches_reference(no_launch):
    spec = ref_config("c3")
    rng = np.random.default_rng(0)
    n = 50000
    cap = _cap(0, n)
    ds = np.sort(rng.integers(0, n - spec.frame_len, 6)).astype(np.int32)
    want = extract_frames_dma(jnp.asarray(cap), jnp.asarray(ds),
                              spec.frame_len)
    _same(deframe.extract_frames_dma(torch.from_numpy(cap),
                                     torch.from_numpy(ds), spec.frame_len),
          want)
    np.testing.assert_array_equal(
        np.asarray(want),
        np.asarray(ref_gather(spec, jnp.asarray(cap), jnp.asarray(ds))))


def test_deframe_batched_matches_reference(no_launch):
    """The reference's vmap over captures is the leading dimension."""
    spec = ref_config("c1")
    rng = np.random.default_rng(1)
    n = 20000
    cap = _cap(1, n)
    caps = np.stack([cap, cap * np.complex64(1 + 1e-6)])
    ds = np.sort(rng.integers(0, n - spec.frame_len, 4)).astype(np.int32)
    dss = np.stack([ds, ds + 5])
    want = jax.vmap(lambda c, d: extract_frames_dma(c, d, spec.frame_len))(
        jnp.asarray(caps), jnp.asarray(dss))
    _same(deframe.extract_frames_dma(torch.from_numpy(caps),
                                     torch.from_numpy(dss), spec.frame_len),
          want)


@pytest.mark.parametrize("frame_len", [37, 200])
def test_deframe_offsets_past_the_end_and_negative(frame_len, no_launch):
    """Offsets past n are clamped to n (zeros), partial frames end in zeros,
    and every negative offset the reference's zero padding reaches
    (-(frame_len rounded up to 128) - 128 <= d < 0) gives a zero frame,
    where K2 and the XLA gather differ (the port's extract_plain clamps
    to 0, as K2 does)."""
    n = 1000
    cap = _cap(frame_len, n)
    reach = -(-frame_len // 128) * 128 + 128
    ds = np.concatenate([
        np.arange(-reach, 0, 7), [-reach, -3, -1],
        [0, 1, 2, 3, n - frame_len, n - frame_len + 1, n - 5, n - 1, n,
         n + 1, 5 * n, 2**31 - 1]]).astype(np.int32)
    want = np.asarray(extract_frames_dma(jnp.asarray(cap), jnp.asarray(ds),
                                         frame_len))
    got = deframe.extract_frames_dma(torch.from_numpy(cap),
                                     torch.from_numpy(ds), frame_len)
    _same(got, want)
    neg = ds < 0
    assert not want[neg].any()
    clamped = extract.extract_plain(torch.from_numpy(cap)[None],
                                    torch.from_numpy(ds)[None], frame_len)[0]
    np.testing.assert_array_equal(clamped[~neg].numpy(), want[~neg])
    assert torch.equal(clamped[neg], clamped[neg][:1].expand(
        int(neg.sum()), frame_len))              # K2: capture[0:frame_len]
    assert np.array_equal(clamped[neg][0].numpy(), cap[:frame_len])


def test_deframe_zero_below_the_reference_reach(no_launch):
    """Further below 0, the reference's interpret mode reads its padded
    capture from the end, as a negative Python index does (the TPU DMA
    would start before the buffer): the port gives zeros there too."""
    n, frame_len = 1000, 37
    cap = _cap(3, n)
    padded = np.concatenate([cap, np.zeros(256, np.complex64)])
    ds = np.array([-400, -300], np.int32)
    want = np.asarray(extract_frames_dma(jnp.asarray(cap), jnp.asarray(ds),
                                         frame_len))
    for i, d in enumerate(ds):
        np.testing.assert_array_equal(want[i],
                                      padded[len(padded) + d:][:frame_len])
    got = deframe.extract_frames_dma(torch.from_numpy(cap),
                                     torch.from_numpy(ds), frame_len)
    assert got.shape == (2, frame_len) and not got.abs().any()


def test_deframe_refuses_bad_arguments():
    cap = torch.from_numpy(_cap(4, 100))
    with pytest.raises(ValueError):
        deframe.extract_frames_dma(cap, torch.zeros(3, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        deframe.extract_frames_dma(cap[None], torch.zeros(3, dtype=torch.int32),
                                   8)


@pytest.fixture
def offsets(monkeypatch):
    """Every ds that detection hands to the extraction, recorded."""
    seen = []

    def record(capture, ds, frame_len):
        seen.append(ds.clone())
        return extract.extract_plain(capture, ds, frame_len)
    monkeypatch.setattr(sync, "_extract", record)
    return seen


@pytest.mark.parametrize("name", ["c3", "c4", "stream"])
def test_detection_offsets_are_never_negative(name, offsets):
    """ROADMAP Queue 3: at a negative offset the reference's three
    extractions disagree (K2 clamps to 0, the XLA gather and K12 give
    zeros), and the port clamps. Detection's localization clamps its
    frame starts at 0 (as the reference's does), so no route meets one:
    captures whose first frame starts at sample 0, on C3, C4 (decimated
    first) and the C5 stream, hand the extraction no negative ds. (The
    stream may report such a frame at start -4: its first window begins
    with the carried zeros, and the offset into the window is >= 0.)"""
    base = {"c3": "c3", "c4": "c4", "stream": "c5"}[name]
    spec = config(base).with_(n_data_syms=2)
    cap, _ = build_capture(spec, 3, 300, seed=5, timing_offset=0,
                           device="cpu")
    x = torch.from_numpy(cap)
    if name == "stream":
        rx = StreamRx(spec.with_(kernel_backend="auto"),
                      steps_per_dispatch=1, device="cpu")
        frames = rx.process(cap) + rx.flush()
        assert [f.crc_ok for f in frames] == [True] * 3
    else:
        out = RxPipeline(spec).rx_capture(x[None], max_frames=5)
        assert int(out["valid"].sum()) == 3
        assert int(out["d"].min()) >= 0
    assert offsets and all(int(ds.min()) >= 0 for ds in offsets)
