"""The port's FFT (plain version) and frame layer against the JAX
reference: kernels/pallas_fft.fft_pallas in interpret mode, and
phy/frame.py's demodulate / chanest / EQ / phase tracking / TX grid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.core.spec import config as ref_config
from ofdm_uhd_tpu.kernels.pallas_fft import fft_pallas
from ofdm_uhd_tpu.phy import frame as ref_frame
from ofdm_uhd_tpu_torch.core.spec import config
from ofdm_uhd_tpu_torch.kernels import fft as K1
from ofdm_uhd_tpu_torch.phy import frame

torch.set_num_threads(2)

RTOL = 1e-5       # float32 transforms: error relative to the largest value

VARIANTS = {
    "c3": {},
    "c3-mmse-sfo-smooth": dict(eq_mode="mmse", sfo_track=True,
                               chanest_smooth=3),
}


def _specs(name):
    kw = VARIANTS[name]
    return (config("c3").with_(**kw),
            ref_config("c3").with_(kernel_backend="auto", **kw))


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _close(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = np.max(np.abs(got - ref))
    assert err <= rtol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


@pytest.mark.parametrize("n", [64, 256, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_plain_matches_pallas(n, inverse):
    x = _cplx(np.random.default_rng(n), 3, 5, n)
    ref = fft_pallas(jnp.asarray(x), inverse=inverse)
    f = K1.ifft if inverse else K1.fft
    _close(f(torch.from_numpy(x)), ref)
    _close(K1.fft_plain(torch.from_numpy(x), inverse=inverse), ref)


@pytest.mark.parametrize("shift", [0, 4])
def test_ofdm_demodulate_matches(shift):
    s, r = _specs("c3")
    x = _cplx(np.random.default_rng(shift), 4, s.frame_len)
    _close(frame.ofdm_demodulate(s, torch.from_numpy(x), shift=shift),
           ref_frame.ofdm_demodulate(r, jnp.asarray(x), shift=shift))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_chanest_eq_phase_match(name):
    s, r = _specs(name)
    rng = np.random.default_rng(5)
    grid = _cplx(rng, 3, s.n_syms, s.n_sc)
    tg, jg = torch.from_numpy(grid), jnp.asarray(grid)
    h = frame.estimate_channel(s, tg)
    h_ref = ref_frame.estimate_channel(r, jg)
    _close(h, h_ref)
    # the downstream stages take the SAME h, so each is checked alone
    jh = jnp.asarray(h.numpy())
    _close(frame.estimate_noise(s, tg), ref_frame.estimate_noise(r, jg))
    eq = frame.equalize(s, tg, h)
    _close(eq, ref_frame.equalize(r, jg, jh))
    data, cpe = frame.track_phase(s, eq)
    data_ref, cpe_ref = ref_frame.track_phase(r, jnp.asarray(eq.numpy()))
    _close(data, data_ref)
    np.testing.assert_allclose(cpe.numpy(), np.asarray(cpe_ref), atol=1e-5)
    _close(frame.data_csi(s, h), ref_frame.data_csi(r, jh))


@pytest.mark.parametrize("tx_window", [0, 8])
def test_tx_grid_and_modulate_match(tx_window):
    s = config("c3").with_(tx_window=tx_window)
    r = ref_config("c3").with_(tx_window=tx_window)
    data = _cplx(np.random.default_rng(9), 2, s.n_data_syms, s.n_data_sc)
    grid = frame.build_grid(s, torch.from_numpy(data))
    np.testing.assert_array_equal(
        grid.numpy(), np.asarray(ref_frame.build_grid(r, jnp.asarray(data))))
    _close(frame.ofdm_modulate(s, grid),
           ref_frame.ofdm_modulate(r, jnp.asarray(grid.numpy())))
