"""The port's one-pass S&C front end (kernels/scfront.py, its plain version
on the CPU) against the JAX reference: the XLA compose sc_correlate +
sc_metric, and the fused Pallas kernel sc_frontend_pallas in interpret
mode, on the same numpy inputs.

Tolerances as the reference's tests/kernels/test_scfront.py holds its
kernel to the compose: P within 2e-4 * sqrt(l), M within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.kernels import sync as ref_ksync
from ofdm_uhd_tpu.kernels.pallas_scfront import sc_frontend_pallas
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.kernels import sync as ksync
from ofdm_uhd_tpu_torch.kernels.scfront import sc_frontend

torch.set_num_threads(2)


def _sig(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _check(p, m, r, l):
    """p, m [n] (numpy) against both reference forms for r [n]."""
    nd = r.shape[-1] - 2 * l + 1
    assert p.shape == m.shape == (nd,)
    p0, rr0 = ref_ksync.sc_correlate(jnp.asarray(r), l, "xla")
    m0 = np.asarray(ref_ksync.sc_metric(p0, rr0))
    p1, m1 = sc_frontend_pallas(jnp.asarray(r), l)
    for p_ref, m_ref in ((p0, m0), (p1, m1)):
        np.testing.assert_allclose(p, np.asarray(p_ref),
                                   atol=2e-4 * np.sqrt(l))
        np.testing.assert_allclose(m, np.asarray(m_ref), atol=1e-5)


@pytest.mark.parametrize("n,l", [(9000, 512), (20000, 128)])
def test_sc_frontend_matches(n, l):
    r = _sig(l, (n,))
    p, m = sc_frontend(torch.from_numpy(r), l)
    assert p.dtype == torch.complex64 and m.dtype == torch.float32
    _check(p.numpy(), m.numpy(), r, l)


@pytest.mark.parametrize("l", [128, 512])
def test_sc_frontend_batched(l):
    r = _sig(3, (3, 6000))
    p, m = sc_frontend(torch.from_numpy(r), l)
    assert p.shape == m.shape == (3, 6000 - 2 * l + 1)
    for c in range(3):
        _check(p[c].numpy(), m[c].numpy(), r[c], l)


def test_sc_frontend_is_the_plain_compose():
    """On the CPU sc_frontend is sc_metric(*sc_correlate): bit for bit, with
    zeros where the input is idle (R <= 1e-12)."""
    r = _sig(4, (2, 5000))
    r[:, 1000:3000] = 0
    p, m = sc_frontend(torch.from_numpy(r), 128)
    p0, rr0 = ksync.sc_correlate(torch.from_numpy(r), 128)
    assert torch.equal(p, p0)
    assert torch.equal(m, ksync.sc_metric(p0, rr0))
    assert bool((m[:, 1000:2744] == 0).all())


def test_sc_frontend_on_cpu_launches_no_kernel():
    policy.reset_launches()
    sc_frontend(torch.from_numpy(_sig(5, (1, 2000))), 32)
    assert policy.launches() == dict.fromkeys(policy.KERNELS, 0)
