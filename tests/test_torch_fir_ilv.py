"""The interleaved FIR tier (K13, research/fir_ilv.py) against the JAX
reference's research/pallas_fir_ilv.py in interpret mode at its default
precision (HIGHEST), on numpy inputs made from a seed: the 193-tap FIR,
the 8x and 2x decimations (n // m outputs: 125 at n = 1003) and
interpolations, 1-D, batched and N-D inputs.

At precision="default" (the reference's Precision.DEFAULT: one bf16 pass
of the TPU's MXU) the port runs the bf16 filter tier. As in
tests/test_torch_fir_bf16.py, the reference's dot ignores the precision
on the CPU and computes exact float32, so the port's bf16 plain versions
are held to the reference's own float32 K13 run on bf16-rounded planes
and taps (rounded with JAX's bf16, nearest even), within 1e-5 of max|y|;
the reference's K13 at DEFAULT in interpret mode is within 1e-2 of them
and differs from them by more than 1e-4, which records that it computed
exact.

Tolerance: within 1e-5 of max|y| (float32 sums in another order than the
reference's banded row product). On the CPU every function takes its
plain version and launches nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.phy.tables import resample_filter
from ofdm_uhd_tpu.research import pallas_fir_ilv as PI
from ofdm_uhd_tpu_torch.kernels import fir as KF
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.research import fir_ilv

torch.set_num_threads(2)

TOL = 1e-5
DEFAULT = jax.lax.Precision.DEFAULT
rng = np.random.default_rng(13)


def _sig(shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err
    return err


def _bf(a):
    """Round float32 values to bf16 (JAX's, nearest even), as float32."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _bfc(x):
    return (_bf(x.real) + 1j * _bf(x.imag)).astype(np.complex64)


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


# (kind, factor, shape): the FIR, the decimations, the interpolations
DEFAULT_CASES = [("fir", 1, (1003,)), ("fir", 1, (2, 2, 512)),
                 ("decim", 8, (2, 1003)), ("decim", 2, (3, 900)),
                 ("interp", 8, (2, 700)), ("interp", 2, (513,))]


def _port(kind, x, f, taps, precision):
    if kind == "fir":
        return fir_ilv.fir_ilv(x, taps, precision=precision)
    if kind == "decim":
        return fir_ilv.polyphase_decim_ilv(x, f, taps, precision=precision)
    return fir_ilv.polyphase_interp_ilv(x, f, taps, precision=precision)


def _reference(kind, x, f, taps, **kw):
    if kind == "fir":
        return PI.fir_ilv_pallas(x, taps, **kw)
    if kind == "decim":
        return PI.polyphase_decim_ilv_pallas(x, f, taps, **kw)
    return PI.polyphase_interp_ilv_pallas(x, f, taps, **kw)


@pytest.mark.parametrize("kind,f,shape", DEFAULT_CASES)
def test_default_matches_reference_on_rounded_inputs(kind, f, shape):
    """precision='default' on the CPU (the bf16 plain versions) against
    the reference's float32 K13 on bf16-rounded planes and taps (the
    interpolation's branch matrix is the taps times L, exact for L a power
    of two, so rounding the taps first rounds the band)."""
    taps = np.asarray(resample_filter(max(f, 8), 1))          # 193 taps
    x = _sig(shape)
    got = _port(kind, torch.from_numpy(x), f, taps, "default")
    _close(got, _reference(kind, _bfc(x), f, _bf(taps)))


@pytest.mark.parametrize("kind", ["fir", "decim", "interp"])
def test_reference_default_computes_exact_on_the_cpu(kind):
    """The reference's K13 at Precision.DEFAULT in interpret mode agrees
    with the port's bf16 plain versions within 1e-2 of max|y|, differs
    from them by more than 1e-4, and equals its own HIGHEST result within
    1e-5: XLA's CPU dot ignores the precision."""
    taps = np.asarray(resample_filter(8, 1))
    x = _sig((2, 2048))
    want = _reference(kind, x, 8, taps, precision=DEFAULT)
    err = _close(_port(kind, torch.from_numpy(x), 8, taps, "default"),
                 want, tol=1e-2)
    assert err > 1e-4 * np.abs(np.asarray(want)).max()
    _close(torch.from_numpy(np.array(_reference(kind, x, 8, taps))), want)


def test_ilv_precision():
    """'highest', the reference's default, is the float32 function;
    'default' the bf16 tier's plain versions (kernels/fir.py), not the
    float32 one; any other precision raises."""
    taps = np.asarray(resample_filter(8, 1))
    x = torch.from_numpy(_sig((2, 640)))
    assert torch.equal(fir_ilv.fir_ilv(x, taps, precision="highest"),
                       fir_ilv.fir_ilv(x, taps))
    for kind, plain, exact in (
            ("fir", lambda: KF.decim_plain_bf16(x, 1, taps),
             lambda: KF.decim_plain(x, 1, taps)),
            ("decim", lambda: KF.decim_plain_bf16(x, 8, taps),
             lambda: KF.decim_plain(x, 8, taps)),
            ("interp", lambda: KF.interp_plain_bf16(x, 8, taps),
             lambda: KF.interp_plain(x, 8, taps))):
        got = _port(kind, x, 8, taps, "default")
        assert torch.equal(got, plain())
        assert not torch.equal(got, exact())
        for bad in ("high", "bf16", "HIGHEST"):
            with pytest.raises(ValueError, match="precision"):
                _port(kind, x, 8, taps, bad)
