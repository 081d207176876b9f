"""The banded filter tier (K8, kernels/banded.py) against the JAX
reference's kernels/pallas_fir.py and pallas_sync.py:sc_correlate_pallas
in interpret mode, on the reference test's shapes and inputs
(tests/kernels/test_pallas_kernels.py: FIR [3, 1000] at 97 taps, the
impulse response, interpolation by 2 and 8 of [2, 700], decimation by 8 of
[2, 4096], the S&C at C3's l = 128 on 3000 samples) and at n = 1003, where
the decimation gives ceil(n/m) outputs.

Tolerances: the filters within 1e-5 of max|y| (float32 sums in another
order than the reference's banded matmul), the S&C P within 1e-5 of
max|P| and R within 1e-5 relative, sample by sample. On the CPU every
function takes its plain version and launches nothing."""

import zlib

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.golden import resample as GR
from ofdm_uhd_tpu.kernels.pallas_fir import (fir_pallas,
                                             polyphase_decim_pallas,
                                             polyphase_interp_pallas)
from ofdm_uhd_tpu.kernels.pallas_sync import sc_correlate_pallas
from ofdm_uhd_tpu_torch.kernels import banded, policy

torch.set_num_threads(2)

TOL = 1e-5


def _crand(name, *shape):
    r = np.random.default_rng(zlib.crc32(name.encode()) % 2**31)
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)
            ).astype(np.complex64)


def _close(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), err


@pytest.fixture(autouse=True)
def _no_launch():
    policy.reset_launches()
    yield
    assert not any(policy.launches().values())


def test_fir_banded_matches_reference():
    taps = GR.design_lowpass(4, 1).astype(np.float32)      # 97 taps
    x = _crand("fir", 3, 1000)
    want = fir_pallas(x, taps)
    _close(banded.fir_banded(torch.from_numpy(x), taps), want)
    # blk is the TPU's block; the card and the plain version ignore it
    _close(banded.fir_banded(torch.from_numpy(x), taps, blk=256), want)


def test_fir_banded_impulse_response():
    taps = np.arange(1, 12, dtype=np.float32)
    x = np.zeros((1, 300), dtype=np.complex64)
    x[0, 100] = 1.0
    y = banded.fir_banded(torch.from_numpy(x), taps)
    _close(y, fir_pallas(x, taps))
    half = (len(taps) - 1) // 2
    expect = np.zeros(300)
    expect[100 - half: 100 - half + len(taps)] = taps
    np.testing.assert_allclose(y[0].real.numpy(), expect, atol=1e-5)


@pytest.mark.parametrize("l", [2, 8])
def test_interp_banded_matches_reference(l):
    taps = GR.design_lowpass(l, 1)
    x = _crand(f"interp{l}", 2, 700)
    got = banded.polyphase_interp_banded(torch.from_numpy(x), l, taps)
    assert got.shape == (2, 700 * l)
    _close(got, polyphase_interp_pallas(x, l, taps))


@pytest.mark.parametrize("n", [4096, 1003])
def test_decim_banded_matches_reference(n):
    """The reference decimates by keeping every m-th sample of the full-rate
    FIR: ceil(n/m) outputs (126 at n = 1003, where n // m = 125)."""
    m = 8
    taps = GR.design_lowpass(m, 1)
    x = _crand("decim" if n == 4096 else f"decim{n}", 2, n)
    got = banded.polyphase_decim_banded(torch.from_numpy(x), m, taps)
    assert got.shape == (2, -(-n // m))
    _close(got, polyphase_decim_pallas(x, m, taps))


@pytest.mark.parametrize("shape", [(3000,), (2, 3000)])
def test_sc_correlate_banded_matches_reference(shape):
    """C3's l = 128: direct window sums, 1-D and batched (the reference
    takes any leading shape)."""
    l = ref_config("c3").n_sc // 2
    x = _crand("sync", *shape)
    p, rr = banded.sc_correlate_banded(torch.from_numpy(x), l)
    p_ref, rr_ref = (np.asarray(a) for a in sc_correlate_pallas(x, l))
    nd = shape[-1] - 2 * l + 1
    assert p.shape == rr.shape == shape[:-1] + (nd,)
    assert rr.dtype == torch.float32
    _close(p, p_ref)
    rel = np.abs(rr.numpy() - rr_ref) / np.abs(rr_ref)
    assert rel.max() <= TOL, rel.max()


def test_sc_correlate_banded_is_a_window_sum():
    """The plain version sums each window directly: R at lag d is half the
    energy of r[d : d + 2l], P the lag products of r[d : d + l]."""
    x = torch.from_numpy(_crand("window", 700))
    l = 48
    p, rr = banded.sc_correlate_banded(x, l)
    xd = x.numpy().astype(np.complex128)
    for d in (0, 17, 700 - 2 * l):
        want_r = 0.5 * np.sum(np.abs(xd[d: d + 2 * l]) ** 2)
        want_p = np.sum(np.conj(xd[d: d + l]) * xd[d + l: d + 2 * l])
        assert abs(float(rr[d]) - want_r) <= 1e-5 * want_r
        assert abs(complex(p[d]) - want_p) <= 1e-5 * abs(want_p) + 1e-4


def test_banded_refuses_bad_arguments():
    x = torch.from_numpy(_crand("bad", 2, 64))
    with pytest.raises(ValueError):
        banded.sc_correlate_banded(x, 40)            # 2l > n
    with pytest.raises(ValueError):
        banded.sc_correlate_banded(x.real.contiguous(), 8)
