"""The shifted-FMA filter tier (K11, research/shift.py) against the JAX
reference's research/pallas_shift.py in interpret mode, on the shapes and
numpy inputs (seed 7) of tests/kernels/test_shift_kernels.py: lengths that
cut a tile and its halo (5000, 4500, 9000), multi-row batches, both
resampler factors, short taps.

Tolerances are the reference test's: the FIR family 2e-5 absolute (1e-6
for the 3-tap FIR) on unit-variance signals, since the port's plain
versions sum in another order than the TPU kernels; the S&C P and R 2e-4,
the metric M 1e-3. On the CPU every function takes its plain version and
launches nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.kernels.sync import sc_metric as ref_sc_metric
from ofdm_uhd_tpu.phy.tables import resample_filter
from ofdm_uhd_tpu.research import pallas_shift as PS
from ofdm_uhd_tpu_torch.kernels import fir as KF
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.kernels import sync as KS
from ofdm_uhd_tpu_torch.research import shift

torch.set_num_threads(2)

rng = np.random.default_rng(7)


def _sig(shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def _close(got: torch.Tensor, want, atol=2e-5):
    want = np.asarray(want)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


@pytest.mark.parametrize("shape", [(5000,), (3, 4500), (2, 2, 2048)])
def test_fir_shift_matches_reference(shape):
    taps = np.asarray(resample_filter(8, 1))
    x = _sig(shape)
    _close(shift.fir_shift(torch.from_numpy(x), taps),
           PS.fir_shift_pallas(x, taps))


def test_fir_shift_short_taps():
    """3 taps: the reference's chunk-row kernel (not phase-split)."""
    taps = np.asarray([0.25, 0.5, 0.25], np.float32)
    x = _sig((2, 1000))
    _close(shift.fir_shift(torch.from_numpy(x), taps),
           PS.fir_shift_pallas(x, taps), atol=1e-6)


@pytest.mark.parametrize("m,n", [(8, 40960), (2, 9000)])
def test_decim_shift_matches_reference(m, n):
    taps = np.asarray(resample_filter(m, 1))
    x = _sig((n,))
    got = shift.polyphase_decim_shift(torch.from_numpy(x), m, taps)
    assert got.shape == (n // m,)
    _close(got, PS.polyphase_decim_shift_pallas(x, m, taps))


def test_decim_shift_batched():
    taps = np.asarray(resample_filter(8, 1))
    x = _sig((5, 16384))
    _close(shift.polyphase_decim_shift(torch.from_numpy(x), 8, taps),
           PS.polyphase_decim_shift_pallas(x, 8, taps))


@pytest.mark.parametrize("l,n", [(8, 5120), (2, 3000)])
def test_interp_shift_matches_reference(l, n):
    taps = np.asarray(resample_filter(l, 1))
    x = _sig((n,))
    got = shift.polyphase_interp_shift(torch.from_numpy(x), l, taps)
    assert got.shape == (n * l,)
    _close(got, PS.polyphase_interp_shift_pallas(x, l, taps))


def test_interp_shift_batched():
    taps = np.asarray(resample_filter(8, 1))
    x = _sig((6, 2100))
    _close(shift.polyphase_interp_shift(torch.from_numpy(x), 8, taps),
           PS.polyphase_interp_shift_pallas(x, 8, taps))


def _sc_close(got, want):
    (p, rr), (p_ref, r_ref) = got, (np.asarray(v) for v in want)
    assert p.shape == p_ref.shape and rr.shape == r_ref.shape
    np.testing.assert_allclose(p.numpy(), p_ref, atol=2e-4)
    np.testing.assert_allclose(rr.numpy(), r_ref, atol=2e-4)
    m = KS.sc_metric(p, rr).numpy()
    m_ref = np.asarray(ref_sc_metric(jnp.asarray(p_ref), jnp.asarray(r_ref)))
    np.testing.assert_allclose(m, m_ref, atol=1e-3)


@pytest.mark.parametrize("l,n", [(32, 9000), (128, 20480)])
def test_sc_correlate_shift_matches_reference(l, n):
    x = _sig((n,))
    _sc_close(shift.sc_correlate_shift(torch.from_numpy(x), l),
              PS.sc_correlate_shift_pallas(x, l))


def test_sc_correlate_shift_batched():
    x = _sig((3, 6000))
    _sc_close(shift.sc_correlate_shift(torch.from_numpy(x), 32),
              PS.sc_correlate_shift_pallas(x, 32))


def test_sc_energy_forms_agree():
    """The TPU kernel's energy re*re + im*im and K9's |r|^2 (the plain
    version's r.abs() ** 2) give R within 1e-5 relative, the gate K9 is
    held to against its plain version."""
    x = torch.from_numpy(_sig((3, 6000)))
    _, rr = KS.sc_correlate_plain(x, 32)
    e = x.real * x.real + x.imag * x.imag
    rr_k11 = 0.5 * KS._moving_sum(e, 64)
    assert float(((rr_k11 - rr).abs() / rr.abs()).max()) <= 1e-5


def test_shift_kernel_tables():
    """The coefficients the kernels take, as pallas_shift.py builds its
    tables: the correlation weights w (kernels/banded.py's cache), which
    the decimation reads as the per-phase taps kern[p, d] = w[d*m + p]
    (zero past nt), and the branch matrix, which the interpolation
    reverses by index, kern[q, e] = g[q, nd - 1 - e]."""
    from ofdm_uhd_tpu_torch.kernels import banded as KB
    taps = np.asarray(resample_filter(8, 1), np.float32)
    w, pad_l = KB._weights(taps.tobytes(), torch.device("cpu"))
    assert pad_l == len(taps) - 1 - (len(taps) - 1) // 2
    k97 = taps[::-1]
    want = np.zeros((8, 25), np.float32)
    for t in range(len(taps)):
        want[t % 8, t // 8] = k97[t]
    kern = np.zeros((8, 25), np.float32)
    for p in range(8):
        for d in range(25):
            if d * 8 + p < len(taps):
                kern[p, d] = w[d * 8 + p]
    np.testing.assert_array_equal(kern, want)
    g, nd, d_max = KB._branches(np.asarray(taps, np.float64).tobytes(), 8,
                                torch.device("cpu"))
    g_ref, _, d_max_ref = PS._branch_matrix(tuple(taps.astype(np.float64)),
                                            8)
    assert (nd, d_max) == (g_ref.shape[1], d_max_ref)
    g = g.numpy()
    rev = np.array([[g[q, nd - 1 - e] for e in range(nd)] for q in range(8)])
    np.testing.assert_array_equal(
        rev, np.ascontiguousarray(np.asarray(g_ref)[:, ::-1]))


def test_shift_on_cpu_launches_no_kernel():
    policy.reset_launches()
    x = torch.from_numpy(_sig((2, 800)))
    taps = [0.25, 0.5, 0.25]
    shift.fir_shift(x, taps)
    shift.polyphase_decim_shift(x, 2, taps)
    shift.polyphase_interp_shift(x, 2, taps)
    shift.sc_correlate_shift(x, 32)
    assert policy.launches() == dict.fromkeys(policy.KERNELS, 0)
