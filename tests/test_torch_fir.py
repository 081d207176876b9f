"""The port's FIR family (kernels/fir.py) against the JAX reference: the
plain 'same' FIR, polyphase decimation and interpolation against
conv_backend (the XLA forms) and against the Pallas MXU kernels of
pallas_fir_mxu in interpret mode, on the same numpy inputs.

Tolerance atol 2e-5 on unit-variance signals, as the reference's own
tests/kernels/test_mxu_fir.py holds its kernels to conv_backend: the sums
run in another order than the reference's banded matmul."""

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.kernels import conv_backend as CB
from ofdm_uhd_tpu.kernels import pallas_fir_mxu as PM
from ofdm_uhd_tpu.phy.tables import resample_filter as ref_resample_filter
from ofdm_uhd_tpu_torch.kernels import fir as KF
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.phy.tables import resample_filter

torch.set_num_threads(2)

ATOL = 2e-5
TAPS3 = np.asarray([0.25, 0.5, 0.25], np.float32)


def _sig(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _close(got: torch.Tensor, *refs) -> None:
    assert got.dtype == torch.complex64
    for ref in refs:
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_resample_filter_equal():
    for l in (2, 8):
        np.testing.assert_array_equal(resample_filter(l, 1),
                                      np.asarray(ref_resample_filter(l, 1)))


@pytest.mark.parametrize("l", [2, 8])
@pytest.mark.parametrize("taps", ["3tap", "proto"])
def test_branch_matrix_equal(l, taps):
    # the prototype has 193 taps at l = 8 (C4), 49 at l = 2
    taps = TAPS3 if taps == "3tap" else resample_filter(l, 1)
    g, d_min, d_max = KF.branch_matrix(taps, l)
    g_ref, d_min_ref, d_max_ref = CB._branch_matrix(
        tuple(np.asarray(taps, dtype=np.float64)), l)
    assert g.dtype == np.float32 and (d_min, d_max) == (d_min_ref, d_max_ref)
    np.testing.assert_array_equal(g, g_ref)


@pytest.mark.parametrize("shape", [(5000,), (3, 4500), (2, 1000)])
def test_fir_filter_matches(shape):
    taps = resample_filter(8, 1)
    x = _sig(len(shape), shape)
    got = KF.fir_filter(torch.from_numpy(x), taps)
    _close(got, CB.fir_same(x, taps), PM.fir_mxu_pallas(x, taps))


def test_fir_filter_three_taps():
    x = _sig(3, (2, 1000))
    got = KF.fir_filter(torch.from_numpy(x), TAPS3)
    _close(got, CB.fir_same(x, TAPS3), PM.fir_mxu_pallas(x, TAPS3))
    # the 'same' alignment by hand: y[i] = .25 x[i+1] + .5 x[i] + .25 x[i-1]
    xp = np.pad(x, ((0, 0), (1, 1)))
    by_hand = 0.25 * xp[:, 2:] + 0.5 * xp[:, 1:-1] + 0.25 * xp[:, :-2]
    np.testing.assert_allclose(got.numpy(), by_hand, atol=1e-6)


@pytest.mark.parametrize("m,n", [(8, 40960), (2, 9000)])
def test_polyphase_decim_matches(m, n):
    taps = resample_filter(m, 1)
    x = _sig(m, (n,))
    got = KF.polyphase_decim(torch.from_numpy(x), m, taps)
    assert got.shape == (n // m,)
    _close(got, CB.polyphase_decim_xla(x, m, taps),
           PM.polyphase_decim_mxu_pallas(x, m, taps))


@pytest.mark.parametrize("m,taps", [(2, "proto"), (8, "3tap")])
def test_polyphase_decim_batched(m, taps):
    # [3, 4500] rows; 4500 // 2 = 2250 outputs, not a multiple of 256
    taps = resample_filter(m, 1) if taps == "proto" else TAPS3
    n = 4500 if m == 2 else 4496
    x = _sig(7, (3, n))
    got = KF.polyphase_decim(torch.from_numpy(x), m, taps)
    _close(got, CB.polyphase_decim_xla(x, m, taps))
    for r in range(3):     # rows never leak into each other
        _close(KF.polyphase_decim(torch.from_numpy(x[r]), m, taps), got[r])


@pytest.mark.parametrize("l,n", [(8, 5120), (2, 3000)])
def test_polyphase_interp_matches(l, n):
    taps = resample_filter(l, 1)
    x = _sig(l + 1, (n,))
    got = KF.polyphase_interp(torch.from_numpy(x), l, taps)
    assert got.shape == (n * l,)
    _close(got, CB.polyphase_interp_xla(x, l, taps),
           PM.polyphase_interp_mxu_pallas(x, l, taps))


@pytest.mark.parametrize("l,taps", [(2, "proto"), (8, "3tap")])
def test_polyphase_interp_batched(l, taps):
    taps = resample_filter(l, 1) if taps == "proto" else TAPS3
    x = _sig(9, (3, 4500))
    got = KF.polyphase_interp(torch.from_numpy(x), l, taps)
    _close(got, CB.polyphase_interp_xla(x, l, taps))
    for r in range(3):
        _close(KF.polyphase_interp(torch.from_numpy(x[r]), l, taps), got[r])


def test_interp_then_decim_round_trip():
    """Decimating the interpolated signal gives the band-limited input
    back (the C4 TX -> RX pair), away from the edges."""
    taps = resample_filter(8, 1)
    n = 4096
    rng = np.random.default_rng(5)
    spec = np.zeros(n, np.complex64)
    spec[:n // 4] = rng.normal(size=n // 4) + 1j * rng.normal(size=n // 4)
    x = np.fft.ifft(np.roll(spec, -n // 8)).astype(np.complex64) * 40
    up = KF.polyphase_interp(torch.from_numpy(x), 8, taps)
    back = KF.polyphase_decim(up, 8, taps).numpy()
    mid = slice(64, n - 64)
    err = np.abs(back[mid] - x[mid]).max() / np.abs(x[mid]).max()
    assert err < 1e-3


def test_fir_on_cpu_launches_no_kernel():
    policy.reset_launches()
    x = torch.from_numpy(_sig(1, (2, 800)))
    KF.fir_filter(x, TAPS3)
    KF.polyphase_decim(x, 2, TAPS3)
    KF.polyphase_interp(x, 2, TAPS3)
    assert policy.launches() == dict.fromkeys(policy.KERNELS, 0)


@pytest.mark.parametrize("m,taps", [(8, "proto"), (2, "3tap")])
def test_polyphase_decim_stream_matches(m, taps):
    """Valid mode over a carried tail: [C*m + nt - 1] -> [C], as the
    stream decimates each radio chunk (conv_backend.polyphase_decim_stream
    and, at M = 1, rational_decim_stream)."""
    t = resample_filter(m, 1) if taps == "proto" else TAPS3
    x = _sig(m, (2, 300 * m + len(t) - 1))
    got = KF.polyphase_decim_stream(torch.from_numpy(x), m, t)
    assert got.shape == (2, 300)
    _close(got, CB.polyphase_decim_stream(x, m, t),
           CB.rational_decim_stream(x, m, 1, t))
    np.testing.assert_array_equal(
        KF.rational_decim_stream(torch.from_numpy(x), m, 1, t).numpy(),
        got.numpy())


@pytest.mark.parametrize("l,m", [(3, 2), (4, 3)])
def test_rational_decim_stream_matches(l, m):
    """M > 1: the per-phase kernels and the interleave of
    conv_backend.rational_decim_stream (plain on every device)."""
    t = resample_filter(l, m)
    x = _sig(l + m, (1, 60 * l + len(t) - 1))
    got = KF.rational_decim_stream(torch.from_numpy(x), l, m, t)
    assert got.shape == (1, 60 * m)
    _close(got, CB.rational_decim_stream(x, l, m, t))
    with pytest.raises(ValueError):
        KF.rational_decim_stream(torch.from_numpy(x[:, 1:]), l, m, t)
