"""The interleaved FIR tier (K13, research/fir_ilv.py) against the JAX
reference's research/pallas_fir_ilv.py in interpret mode at its default
precision (HIGHEST), on numpy inputs made from a seed: the 193-tap FIR,
the 8x and 2x decimations (n // m outputs: 125 at n = 1003) and
interpolations, 1-D, batched and N-D inputs.

Tolerance: within 1e-5 of max|y| (float32 sums in another order than the
reference's banded row product). On the CPU every function takes its
plain version and launches nothing."""

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.phy.tables import resample_filter
from ofdm_uhd_tpu.research import pallas_fir_ilv as PI
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.research import fir_ilv

torch.set_num_threads(2)

TOL = 1e-5
rng = np.random.default_rng(13)


def _sig(shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
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


@pytest.mark.parametrize("shape", [(1003,), (2, 1003), (2, 2, 512)])
def test_fir_ilv_matches_reference(shape):
    taps = np.asarray(resample_filter(8, 1))                 # 193 taps
    x = _sig(shape)
    _close(fir_ilv.fir_ilv(torch.from_numpy(x), taps),
           PI.fir_ilv_pallas(x, taps))


def test_fir_ilv_short_taps():
    taps = np.asarray([0.25, 0.5, 0.25], np.float32)
    x = _sig((3, 700))
    _close(fir_ilv.fir_ilv(torch.from_numpy(x), taps),
           PI.fir_ilv_pallas(x, taps))


@pytest.mark.parametrize("m,shape", [(8, (2, 1003)), (8, (4096,)),
                                     (2, (3, 900))])
def test_decim_ilv_matches_reference(m, shape):
    taps = np.asarray(resample_filter(m, 1))
    x = _sig(shape)
    got = fir_ilv.polyphase_decim_ilv(torch.from_numpy(x), m, taps)
    assert got.shape == shape[:-1] + (shape[-1] // m,)
    _close(got, PI.polyphase_decim_ilv_pallas(x, m, taps))


@pytest.mark.parametrize("l,shape", [(8, (2, 700)), (8, (513,)),
                                     (2, (2, 700))])
def test_interp_ilv_matches_reference(l, shape):
    taps = np.asarray(resample_filter(l, 1))
    x = _sig(shape)
    got = fir_ilv.polyphase_interp_ilv(torch.from_numpy(x), l, taps)
    assert got.shape == shape[:-1] + (shape[-1] * l,)
    _close(got, PI.polyphase_interp_ilv_pallas(x, l, taps))


def test_ilv_precision():
    """'highest', the reference's default, is the float32 function; any
    other precision is not ported and raises."""
    taps = np.asarray(resample_filter(8, 1))
    x = torch.from_numpy(_sig((2, 640)))
    assert torch.equal(fir_ilv.fir_ilv(x, taps, precision="highest"),
                       fir_ilv.fir_ilv(x, taps))
    for fn, args in ((fir_ilv.fir_ilv, (taps,)),
                     (fir_ilv.polyphase_decim_ilv, (8, taps)),
                     (fir_ilv.polyphase_interp_ilv, (8, taps))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(x, *args, precision="default")
