"""The CP-fused FFT forms (K5) of the port, their plain versions on the
CPU, against the JAX reference's Pallas kernels in interpret mode
(kernels/pallas_fft.cp_strip_fft_pallas and ifft_cp_pallas), and the frame
layer that routes them under kernel_backend='pallas'.

Tolerance: the reference's own (tests/kernels/test_pallas_kernels.py
test_pallas_fused_cp_fft), 2e-4 * sqrt(n) absolute: its kernel is a dense
float32 DFT matmul, the port's plain version torch.fft, and the two round
differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.kernels.pallas_fft import cp_strip_fft_pallas, ifft_cp_pallas
from ofdm_uhd_tpu.phy import frame as ref_frame
from ofdm_uhd_tpu_torch.core.spec import config
from ofdm_uhd_tpu_torch.kernels import fft as K1
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.phy import frame

torch.set_num_threads(2)

GEOMETRIES = [(64, 16), (256, 32), (512, 64)]


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _close(got, ref, n):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, atol=2e-4 * np.sqrt(n))


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("n,cp", GEOMETRIES)
def test_cp_strip_fft_matches_pallas(n, cp, shift):
    x = _cplx(np.random.default_rng(n + shift), 3, 14, n + cp)
    start = cp - shift
    ref = cp_strip_fft_pallas(jnp.asarray(x), start, n)
    _close(K1.cp_strip_fft(torch.from_numpy(x), start, n), ref, n)
    _close(K1.cp_strip_fft_plain(torch.from_numpy(x), start, n), ref, n)


@pytest.mark.parametrize("n,cp", GEOMETRIES)
def test_ifft_cp_matches_pallas(n, cp):
    g = _cplx(np.random.default_rng(n), 3, 14, n)
    ref = ifft_cp_pallas(jnp.asarray(g), cp)
    _close(K1.ifft_cp(torch.from_numpy(g), cp), ref, n)
    got = K1.ifft_cp_plain(torch.from_numpy(g), cp)
    _close(got, ref, n)
    assert torch.equal(got[..., :cp], got[..., n:])       # the prefix


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("name", ["c1", "c3"])
def test_ofdm_demodulate_pallas_matches(name, shift):
    """Under 'pallas' the frame layer's CP strip + FFT is the fused form,
    on both sides; the port's equals its own 'xla' route bit for bit on
    the CPU (the same torch.fft on the same window)."""
    s = config(name).with_(kernel_backend="pallas")
    r = ref_config(name).with_(kernel_backend="pallas")
    x = _cplx(np.random.default_rng(shift), 4, s.frame_len)
    got = frame.ofdm_demodulate(s, torch.from_numpy(x), shift=shift)
    _close(got, ref_frame.ofdm_demodulate(r, jnp.asarray(x), shift=shift),
           s.n_sc)
    assert torch.equal(got, frame.ofdm_demodulate(
        config(name), torch.from_numpy(x), shift=shift))


@pytest.mark.parametrize("name", ["c2", "c3"])
def test_ofdm_modulate_pallas_matches(name):
    s = config(name).with_(kernel_backend="pallas")
    r = ref_config(name).with_(kernel_backend="pallas")
    grid = _cplx(np.random.default_rng(7), 2, s.n_syms, s.n_sc)
    got = frame.ofdm_modulate(s, torch.from_numpy(grid))
    _close(got, ref_frame.ofdm_modulate(r, jnp.asarray(grid)), s.n_sc)
    assert torch.equal(got, frame.ofdm_modulate(config(name),
                                                torch.from_numpy(grid)))


def test_k5_wrappers_reject_what_the_kernel_does_not_take():
    x = torch.zeros((2, 80), dtype=torch.complex64)
    with pytest.raises(ValueError):
        K1.cp_strip_fft(x, 16, 48)                 # not a power of two
    with pytest.raises(ValueError):
        K1.cp_strip_fft(torch.zeros((2, 1100), dtype=torch.complex64), 76,
                        1024)                      # above 512
    with pytest.raises(ValueError):
        K1.cp_strip_fft(x, 20, 64)                 # window leaves the row
    with pytest.raises(ValueError):
        K1.cp_strip_fft(x.real, 16, 64)            # not complex64
    with pytest.raises(ValueError):
        K1.ifft_cp(torch.zeros((2, 96), dtype=torch.complex64), 16)
    with pytest.raises(ValueError):
        K1.ifft_cp(torch.zeros((2, 64), dtype=torch.complex64), 65)
    with pytest.raises(ValueError):                # the kernel needs CUDA
        K1._fft_cp_cuda("cpfft", x, 64, 16, 0, inverse=False)


def test_k5_on_cpu_launches_no_kernel():
    policy.reset_launches()
    x = torch.zeros((3, 80), dtype=torch.complex64)
    K1.cp_strip_fft(x, 12, 64)
    K1.ifft_cp(x[:, :64], 16)
    assert policy.launches() == dict.fromkeys(policy.KERNELS, 0)
