"""The port's QAM mapper/demappers equal the JAX reference's phy/qam.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.phy import qam as ref_qam
from ofdm_uhd_tpu_torch.core.spec import MOD_BITS
from ofdm_uhd_tpu_torch.phy import qam

torch.set_num_threads(2)

MODS = sorted(MOD_BITS)


@pytest.mark.parametrize("mod", MODS)
def test_qam_map_exact(mod):
    rng = np.random.default_rng(1)
    b = rng.integers(0, 2, (3, 40 * MOD_BITS[mod])).astype(np.uint8)
    got = qam.qam_map(torch.from_numpy(b), mod)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_qam.qam_map(jnp.asarray(b), mod)))


@pytest.mark.parametrize("mod", MODS)
def test_qam_demap_match(mod):
    rng = np.random.default_rng(2)
    syms = ((rng.normal(size=(2, 5, 60)) + 1j * rng.normal(size=(2, 5, 60)))
            * 0.8).astype(np.complex64)
    csi = rng.uniform(0.1, 3.0, size=(2, 5, 60)).astype(np.float32)
    ts, tc = torch.from_numpy(syms), torch.from_numpy(csi)
    # squared distances, minima and the CSI product: the same float32
    # operations as the reference, so the LLRs are exact
    np.testing.assert_array_equal(
        qam.qam_demap_llr(ts, mod, csi=tc).numpy(),
        np.asarray(ref_qam.qam_demap_llr(jnp.asarray(syms), mod,
                                         csi=jnp.asarray(csi))))
    np.testing.assert_array_equal(
        qam.qam_demap_llr(ts, mod).numpy(),
        np.asarray(ref_qam.qam_demap_llr(jnp.asarray(syms), mod)))
    hard = qam.qam_demap_hard(ts, mod)
    np.testing.assert_array_equal(
        hard.numpy(), np.asarray(ref_qam.qam_demap_hard(jnp.asarray(syms), mod)))
    # hard decisions of clean symbols give back their bits
    b = rng.integers(0, 2, (4, 30 * MOD_BITS[mod])).astype(np.uint8)
    clean = qam.qam_map(torch.from_numpy(b), mod)
    np.testing.assert_array_equal(qam.qam_demap_hard(clean, mod).numpy(), b)
