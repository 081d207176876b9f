"""The boxcar S&C correlator (K9) of the port, its plain version on the
CPU, against the JAX reference's sc_correlate_mxu (kernels/pallas_sync.py,
whose Pallas call K7b runs in interpret mode), and the detection route
that takes it under kernel_backend='pallas'.

Tolerances as the reference's tests hold its S&C kernels to the XLA
compose (tests/kernels/test_scfront.py): P within 2e-4 * sqrt(l), M within
1e-5; R within 1e-5 of max R. The reference sums each boxcar as a banded
matmul with a ones band, the port by pairwise doubling, so the two agree
to float32 rounding, not bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.kernels import sync as ref_ksync
from ofdm_uhd_tpu.kernels.pallas_sync import sc_correlate_mxu
from ofdm_uhd_tpu_torch.core.spec import config
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.kernels import sync as ksync
from ofdm_uhd_tpu_torch.phy import sync

torch.set_num_threads(2)


def _sig(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.mark.parametrize("l", [32, 128])
def test_sc_correlate_matches_mxu(l):
    r = _sig(l, (2, 7001))
    r[1, 2000:4000] = 0                           # idle stretch: M = 0
    p, rr = ksync.sc_correlate(torch.from_numpy(r), l)
    nd = r.shape[-1] - 2 * l + 1
    assert p.shape == rr.shape == (2, nd)
    assert p.dtype == torch.complex64 and rr.dtype == torch.float32
    p_ref, rr_ref = sc_correlate_mxu(jnp.asarray(r), l)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref),
                               atol=2e-4 * np.sqrt(l))
    rr_ref = np.asarray(rr_ref)
    np.testing.assert_allclose(rr.numpy(), rr_ref, atol=1e-5 * rr_ref.max())
    m = ksync.sc_metric(p, rr)
    m_ref = np.asarray(ref_ksync.sc_metric(p_ref, jnp.asarray(rr_ref)))
    np.testing.assert_allclose(m.numpy(), m_ref, atol=1e-5)
    assert bool((m[1, 2000:4000 - 2 * l + 1] == 0).all())


def test_sc_correlate_r_is_the_last_doubling_level():
    """R = 0.5 * (S_L[d] + S_L[d+L]) with S_L the L-window energy sums:
    the reference K9's construction of R, and the plain version's last
    doubling step, bit for bit."""
    l = 32
    r = torch.from_numpy(_sig(1, (3, 3000)))
    _, rr = ksync.sc_correlate(r, l)
    s_l = ksync._moving_sum(r.abs() ** 2, l)
    nd = rr.shape[-1]
    assert torch.equal(rr, 0.5 * (s_l[:, :nd] + s_l[:, l:l + nd]))


@pytest.mark.parametrize("backend,route", [("pallas", "sccorr"),
                                           ("auto", "scfront"),
                                           ("xla", "scfront")])
@pytest.mark.parametrize("name", ["c2", "c3"])
def test_sc_front_routes_as_the_reference(monkeypatch, name, backend, route):
    """C2 (l = 32) under 'pallas' takes the boxcar correlator and the
    metric (ofdm_uhd_tpu/phy/sync.py:66-75); C3 (l = 128) the fused front
    end; 'auto' and 'xla' the compose, which K6 sums in the same order.
    Both routes give the same P and M."""
    spec = config(name).with_(kernel_backend=backend)
    taken = []
    for mod, fn in (("sc_correlate", sync.sc_correlate),
                    ("sc_frontend", sync.sc_frontend)):
        def spy(*a, _fn=fn, _mod=mod):
            taken.append(_mod)
            return _fn(*a)
        monkeypatch.setattr(sync, mod, spy)
    cap = torch.from_numpy(_sig(2, (2, 5000)))
    p, m = sync.sc_front(spec, cap)
    l = spec.n_sc // 2
    want = "sc_correlate" if (route == "sccorr" and l % 128) else "sc_frontend"
    assert taken == [want]
    p0, rr0 = ksync.sc_correlate_plain(cap, l)
    assert torch.equal(p, p0)
    assert torch.equal(m, ksync.sc_metric(p0, rr0))


def test_sccorr_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ksync.sc_rows("sccorr", torch.zeros((2, 100), dtype=torch.complex64),
                      48)                          # not a power of two
    with pytest.raises(ValueError):
        ksync.sc_rows("sccorr", torch.zeros((2, 63), dtype=torch.complex64),
                      32)                          # nd < 1
    with pytest.raises(ValueError):
        ksync.sc_rows("sccorr", torch.zeros((2, 100)), 32)


def test_sccorr_on_cpu_launches_no_kernel():
    policy.reset_launches()
    ksync.sc_correlate(torch.from_numpy(_sig(5, (1, 2000))), 32)
    assert policy.launches() == dict.fromkeys(policy.KERNELS, 0)
