"""The port's bit layer equals the JAX reference's phy/bits.py exactly:
scrambler, CRC, encoder, interleaver, puncturing and the plain Viterbi
decoder (the CPU route of kernels/viterbi.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.phy import bits as ref_bits
from ofdm_uhd_tpu_torch.kernels import policy
from ofdm_uhd_tpu_torch.kernels.viterbi import viterbi, viterbi_plain
from ofdm_uhd_tpu_torch.phy import bits

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _coded_llrs(rng, bsz, n, snr_db):
    """LLRs of tail-terminated codewords through BPSK + AWGN."""
    info = rng.integers(0, 2, (bsz, n)).astype(np.uint8)
    info[:, -6:] = 0
    coded = np.asarray(ref_bits.conv_encode(jnp.asarray(info)))
    sigma = 10 ** (-snr_db / 20)
    y = (1.0 - 2.0 * coded) + sigma * rng.normal(size=coded.shape)
    return (2 * y / sigma**2).astype(np.float32), info


@pytest.mark.parametrize("case", ["decodable", "random", "c3_length",
                                  "ties"])
def test_viterbi_plain_matches_scan(case):
    rng = np.random.default_rng(7)
    if case == "decodable":
        llr, info = _coded_llrs(rng, 6, 300, snr_db=4.0)
    elif case == "random":                 # undecodable: no codeword
        llr = rng.normal(scale=3.0, size=(5, 2 * 257)).astype(np.float32)
    elif case == "c3_length":              # C3 trellis, n = 6912 steps
        llr, info = _coded_llrs(rng, 2, 6912, snr_db=6.0)
    else:                                  # coarse LLRs force metric ties
        llr = rng.integers(-2, 3, size=(4, 2 * 200)).astype(np.float32)
    ref = np.asarray(ref_bits.viterbi_decode(jnp.asarray(llr)))
    got = viterbi_plain(_t(llr))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    if case in ("decodable", "c3_length"):
        np.testing.assert_array_equal(got.numpy(), info)


def test_viterbi_dispatch_cpu_uses_plain():
    policy.reset_launches()
    llr = _t(np.random.default_rng(1).normal(size=(2, 64)).astype(np.float32))
    np.testing.assert_array_equal(viterbi(llr).numpy(),
                                  viterbi_plain(llr).numpy())
    assert bits.viterbi_decode is viterbi
    assert policy.launches()["viterbi"] == 0     # no kernel on the CPU


@pytest.mark.parametrize("n", [7, 200, 6880])
def test_scramble_crc_encode_match(n):
    rng = np.random.default_rng(n)
    b = rng.integers(0, 2, (3, n)).astype(np.uint8)
    np.testing.assert_array_equal(bits.scramble(_t(b)).numpy(),
                                  np.asarray(ref_bits.scramble(jnp.asarray(b))))
    np.testing.assert_array_equal(
        bits.descramble(_t(b), seed=0x11).numpy(),
        np.asarray(ref_bits.descramble(jnp.asarray(b), seed=0x11)))
    np.testing.assert_array_equal(
        bits.conv_encode(_t(b)).numpy(),
        np.asarray(ref_bits.conv_encode(jnp.asarray(b))))
    if n <= 200:        # the reference's CRC matrix is O(n^2) to build
        crc = bits.crc32(_t(b))
        np.testing.assert_array_equal(
            crc.numpy(), np.asarray(ref_bits.crc32(jnp.asarray(b))))
        assert bits.crc32_check(_t(b), crc).all()
        bad = crc.clone()
        bad[1, 5] ^= 1
        np.testing.assert_array_equal(
            bits.crc32_check(_t(b), bad).numpy(),
            np.asarray(ref_bits.crc32_check(jnp.asarray(b),
                                            jnp.asarray(bad.numpy()))))


@pytest.mark.parametrize("n_cbps", [96, 1152])
def test_interleave_match(n_cbps):
    rng = np.random.default_rng(n_cbps)
    x = rng.normal(size=(2, 3 * n_cbps)).astype(np.float32)
    np.testing.assert_array_equal(
        bits.interleave(_t(x), n_cbps).numpy(),
        np.asarray(ref_bits.interleave(jnp.asarray(x), n_cbps)))
    np.testing.assert_array_equal(
        bits.deinterleave_soft(_t(x), n_cbps).numpy(),
        np.asarray(ref_bits.deinterleave_soft(jnp.asarray(x), n_cbps)))


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4"])
def test_puncture_match(rate):
    rng = np.random.default_rng(3)
    full = 1152
    coded = rng.integers(0, 2, (2, full)).astype(np.uint8)
    p = bits.puncture(_t(coded), rate)
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(ref_bits.puncture(jnp.asarray(coded), rate)))
    llr = rng.normal(size=(2, p.shape[-1])).astype(np.float32)
    np.testing.assert_array_equal(
        bits.depuncture_llr(_t(llr), rate, full).numpy(),
        np.asarray(ref_bits.depuncture_llr(jnp.asarray(llr), rate, full)))
