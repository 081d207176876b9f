"""chip_smoke.py's own pieces on the CPU: the library calls it times as
`library_ms` compute the functions of the kernels they stand beside (on
the same inputs, to float32 rounding: cuDNN-style convolutions sum in
another order than the plain versions), the bound it reports, and its
refusal to run without a card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ofdm_uhd_tpu_torch.kernels import fir  # noqa: E402
from ofdm_uhd_tpu_torch.phy.tables import resample_filter  # noqa: E402

torch.set_num_threads(2)


def _x(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) + 1j * rng.normal(
        size=shape)).astype(np.complex64))


def _merge(planes, rows, n_out):
    y = planes[:, 0, :n_out]
    return torch.complex(y[:rows], y[rows:])


@pytest.mark.parametrize("stride", [1, 8])
def test_library_fir_is_the_strided_fir(stride):
    taps = resample_filter(8, 1)
    x = _x(stride, 3, 4096)
    got = _merge(chip_smoke.library_fir(torch, x, taps, stride)(), 3,
                 4096 // stride)
    want = fir.decim_plain(x, stride, taps)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("l", [2, 8])
def test_library_interp_is_the_polyphase_interpolation(l):
    taps = resample_filter(l, 1)
    x = _x(l, 2, 1001)
    planes = chip_smoke.library_interp(torch, x, l, taps)()
    assert planes.shape[-1] == 1001 * l
    got = _merge(planes, 2, 1001 * l)
    want = fir.interp_plain(x, l, taps)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_bound_takes_the_larger_time():
    ms, by = chip_smoke.bound(3.35e9, 1.0)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = chip_smoke.bound(1.0, 67e9)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    # C3's K5 RX: 114,912 rows, 256 of each 288 read (the stripped CP is
    # never fetched), 256 written (0.1405 ms)
    ms, by = chip_smoke.bound(*chip_smoke.work_fft(114_912, 256, 256, 256))
    assert by == "bytes" and abs(ms - 0.1405) < 1e-4


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no CUDA device" in res.stderr


def test_halo_bound_at_c5():
    """K10's work at c5_sharded: 3 halos of H = 4288 complex64 samples,
    each read once and written once (16 H bytes), 6.144e-5 ms."""
    ms, by = chip_smoke.bound(16.0 * 4288 * 3, 0.0)
    assert by == "bytes" and abs(ms - 6.144e-5) < 1e-9


def test_check_stream_finds_shard_boundary_duplicates():
    """A frame that starts a few samples before a shard's extended block
    (start = k * Cb - H) is returned again at the block's first sample;
    check_stream keeps every sent frame and returns that duplicate."""
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.core.state import StreamState
    from ofdm_uhd_tpu_torch.pipeline import StreamFrame
    spec = config("c5")
    h = StreamState.halo_len(spec)
    rng = np.random.default_rng(0)
    pays = rng.integers(0, 2, (6, spec.payload_bits_per_frame)).astype(
        np.uint8)
    starts = chip_smoke.C5_OFFSET + np.arange(6) * (spec.frame_len
                                                    + chip_smoke.GAP)
    frames = [StreamFrame(int(s), p, True, 0.1, -30.0)
              for s, p in zip(starts, pays)]
    block = int(starts[3]) + 5 + h          # frame 3 starts 5 before
    dup = StreamFrame(block - h, pays[3], False, 0.1, -20.0)
    got = chip_smoke.check_stream("t", frames[:4] + [dup] + frames[4:], pays,
                                  spec, block)
    assert [d.start for d in got] == [block - h]
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_stream("t", frames[:4] + [dup] + frames[4:], pays,
                                spec, block + 1)
