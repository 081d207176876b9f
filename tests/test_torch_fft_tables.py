"""What kernels/fft.py hands the FFT kernel (csrc/fft.cu), on the CPU: the
plan of passes and the twiddle table, entry for entry in the order the
kernel reads it, and a model of the kernel's Stockham indexing (thread t
of a transform holds samples t + T m; output r of butterfly j goes to
(j // NS) NS R + j % NS + r NS) that turns the table into numpy's FFT."""

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.kernels import fft

NS_ALL = [1 << k for k in range(1, 12)]


@pytest.mark.parametrize("n", NS_ALL)
def test_plan_is_radix_16_then_the_rest(n):
    radices = fft.plan(n)
    assert int(np.prod(radices)) == n
    assert len(radices) == -(-(n.bit_length() - 1) // 4)
    assert all(r == 16 for r in radices[:-1]) and radices[-1] in (2, 4, 8,
                                                                  16)
    assert fft.plan(256) == [16, 16] and fft.plan(1024) == [16, 16, 4]


@pytest.mark.parametrize("n", NS_ALL)
def test_twiddle_table_is_float64_cast_in_kernel_order(n):
    """Pass p > 0 of radix R after NS points: entry (r - 1) NS + q is
    exp(-2 pi i q r / (NS R)), computed in float64 as exp(-2 pi i k / n)
    with k = q r n / (NS R), then cast to complex64."""
    want, ns = [], 1
    for p, radix in enumerate(fft.plan(n)):
        if p > 0:
            for r in range(1, radix):
                for q in range(ns):
                    k = q * r * (n // (ns * radix))
                    want.append(np.complex64(np.exp(-2j * np.pi * k / n)))
        ns *= radix
    got = fft.twiddle_table(n)
    assert got.dtype == np.complex64 and got.shape == (len(want),)
    assert np.array_equal(got, np.array(want, dtype=np.complex64))
    dev = fft._twiddles(n, torch.device("cpu"))
    assert dev.dtype == torch.complex64
    assert np.array_equal(dev.numpy(), got)


def _kernel_model(x, table):
    """The kernel's arithmetic in float64, by its indices: E = min(n, 16)
    samples a thread, T = n / E threads, the pass's twiddle of butterfly
    j and input r at table[offset + (r - 1) NS + j % NS]."""
    n = x.shape[-1]
    e = min(n, 16)
    t_n = n // e
    v = x[:, (np.arange(t_n)[:, None] + t_n * np.arange(e))]   # [rows, T, E]
    offset, ns = 0, 1
    for p, radix in enumerate(fft.plan(n)):
        out = np.empty(x.shape, complex)
        for t in range(t_n):
            for b in range(e // radix):
                j = t + b * t_n
                a = v[:, t, b + np.arange(radix) * (e // radix)]
                if p > 0:
                    w = table[offset + (np.arange(1, radix) - 1) * ns
                              + j % ns]
                    a = np.concatenate([a[:, :1], a[:, 1:] * w], axis=1)
                a = np.fft.fft(a, axis=1)
                d = (j // ns) * ns * radix + j % ns
                out[:, d + np.arange(radix) * ns] = a
        if p > 0:
            offset += (radix - 1) * ns
        ns *= radix
        v = out[:, (np.arange(t_n)[:, None] + t_n * np.arange(e))]
    return out / np.sqrt(n)


@pytest.mark.parametrize("n", NS_ALL)
def test_kernel_indexing_over_the_table_is_the_fft(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    got = _kernel_model(x, fft.twiddle_table(n).astype(complex))
    want = np.fft.fft(x, norm="ortho")
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
