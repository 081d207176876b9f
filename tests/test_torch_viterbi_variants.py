"""The reference's three Viterbi decode variants (research/
viterbi_variants.py: state-major, radix-4, both) against the port's, on
the CPU: the same LLRs, made from a numpy seed, through the reference's
functions and through ofdm_uhd_tpu_torch.research.viterbi_variants. The
bits must be exactly equal to the reference's, and to the port's
viterbi_plain and the reference's phy/bits.py viterbi_decode, which all
of them twin.

Inputs: decodable noisy LLRs as the reference's probe
scripts/r5_probe_vit.py makes them (seeded bits through the port's
conv_encode, +-1 plus 0.45 Gaussian noise) at n = 96 and 384 steps;
integer LLRs in {-2, ..., 2}, whose path metrics tie often (a tie keeps
predecessor 0); an odd n, where both radix-4 forms fall back to the
whole-sequence decoder; and a 1-D row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.phy.bits import viterbi_decode as ref_viterbi_decode
from ofdm_uhd_tpu.research import viterbi_variants as ref_variants
from ofdm_uhd_tpu_torch.kernels import viterbi as KV
from ofdm_uhd_tpu_torch.phy.bits import conv_encode
from ofdm_uhd_tpu_torch.research import viterbi_variants as variants

torch.set_num_threads(2)

NAMES = ("viterbi_decode_smaj", "viterbi_decode_radix4",
         "viterbi_decode_smaj_radix4")
ROWS = 3


def _noisy(n: int, seed: int) -> np.ndarray:
    """[ROWS, 2n] decodable LLRs: r5_probe_vit.py's recipe."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(ROWS, n)).astype(np.uint8)
    coded = conv_encode(torch.from_numpy(bits)).numpy()
    clean = (1.0 - 2.0 * coded).astype(np.float32)
    return clean + 0.45 * rng.normal(size=clean.shape).astype(np.float32)


def _ties(n: int, seed: int) -> np.ndarray:
    """[ROWS, 2n] integer LLRs in {-2, ..., 2}: many equal metrics."""
    rng = np.random.default_rng(seed)
    return rng.integers(-2, 3, size=(ROWS, 2 * n)).astype(np.float32)


INPUTS = {
    "noisy-96": lambda: _noisy(96, 1),
    "noisy-384": lambda: _noisy(384, 2),
    "ties-96": lambda: _ties(96, 3),
    "odd-97": lambda: _noisy(97, 4),
    "odd-ties-41": lambda: _ties(41, 5),
    "row-96": lambda: _noisy(96, 6)[0],
}


@pytest.fixture(scope="module")
def decoded():
    """Every input through the reference's viterbi_decode and the port's
    viterbi_plain, which must agree."""
    out = {}
    for key, make in INPUTS.items():
        llr = make()
        want = np.asarray(ref_viterbi_decode(jnp.asarray(llr)))
        plain = KV.viterbi_plain(torch.from_numpy(np.atleast_2d(llr)))
        out[key] = (llr, want, plain.numpy())
    return out


@pytest.mark.parametrize("key", INPUTS)
def test_plain_decoder_is_the_reference_scan(decoded, key):
    llr, want, plain = decoded[key]
    np.testing.assert_array_equal(plain, np.atleast_2d(want))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", INPUTS)
def test_variant_equals_reference_bit_for_bit(decoded, key, name):
    llr, want, plain = decoded[key]
    ref = np.asarray(getattr(ref_variants, name)(jnp.asarray(llr)))
    got = getattr(variants, name)(torch.from_numpy(llr))
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == ref.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.atleast_2d(got.numpy()), plain)


def test_noisy_inputs_decode_to_the_sent_bits():
    """The noisy inputs are decodable: the decoders recover the encoded
    bits (a check of the inputs, not of a variant)."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, size=(ROWS, 96)).astype(np.uint8)
    got = variants.viterbi_decode_smaj(torch.from_numpy(_noisy(96, 1)))
    assert float((got.numpy() != bits).mean()) < 0.1


def test_ties_tie():
    """The integer inputs do make equal candidate metrics: at least one
    step of the plain ACS has c0 == c1 in a state reachable from 0."""
    llr = torch.from_numpy(_ties(96, 3))
    sa, sb = KV._signs(llr.device)
    pm = torch.full((ROWS, 64), -1e30)
    pm[:, 0] = 0.0
    s = torch.arange(64)
    ties = 0
    for t in range(96):
        bm = sa * llr[:, 2 * t, None] + sb * llr[:, 2 * t + 1, None]
        c0 = pm[:, (s & 31) << 1] + bm
        c1 = pm[:, ((s & 31) << 1) | 1] - bm
        ties += int(((c0 == c1) & (c0 > -1e29)).sum())
        pm = torch.where(c1 > c0, c1, c0)
    assert ties > 0


@pytest.mark.parametrize("name", NAMES[1:])
def test_radix4_at_odd_n_is_the_fallback(decoded, name):
    """At odd n the radix-4 forms give exactly what their fallback,
    kernels/viterbi.py viterbi (viterbi_plain on a CPU tensor), gives."""
    for key in ("odd-97", "odd-ties-41"):
        llr = torch.from_numpy(decoded[key][0])
        got = getattr(variants, name)(llr)
        assert torch.equal(got, KV.viterbi(llr.contiguous()))


@pytest.mark.parametrize("name", NAMES)
def test_variant_accepts_other_float_dtypes(name):
    """float64 LLRs decode as their float32 values, as the reference
    casts them."""
    llr = _noisy(96, 7)
    got = getattr(variants, name)(torch.from_numpy(llr.astype(np.float64)))
    want = getattr(variants, name)(torch.from_numpy(llr))
    assert torch.equal(got, want)
