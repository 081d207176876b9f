"""integer_cfo(..., eps_pre=) against the reference's, on the CPU.

The reference's phy/sync.py integer_cfo takes eps_pre, a fractional CFO
by which it derotates the sym-B window alone before the search, so that a
caller can apply one ramp at eps_pre + k to the frame instead of two (its
stream step's CFO_ORDER = 'fused', a switch the port does not keep: see
tests/test_torch_counterparts.py). The port's integer_cfo takes the same
argument.

Held here: the port's integer_cfo(eps_pre=) gives exactly the
reference's k, and its own two-ramp k, on C5 frames (7 data symbols, as
tests/test_torch_stream.py builds C5) at integer CFOs from -3 to 3
spacings; the window it derotates is bit for bit that slice of
cfo_correct's frames; without eps_pre it gives the reference's k.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench_lib import build_capture as ref_build_capture  # noqa: E402
from ofdm_uhd_tpu.core.spec import config as ref_config  # noqa: E402
from ofdm_uhd_tpu.phy import sync as ref_sync  # noqa: E402
from ofdm_uhd_tpu_torch.convert import spec_from_reference  # noqa: E402
from ofdm_uhd_tpu_torch.phy import sync as PS  # noqa: E402

torch.set_num_threads(2)

N_FRAMES, GAP, OFFSET = 8, 300, 100
# per-frame CFOs: k from -3 to 3
FRAME_CFOS = (-3.3, -1.6, -0.4, 0.2, 0.8, 1.7, 2.4, 3.1)


def _rspec():
    return ref_config("c5").with_(n_data_syms=7, kernel_backend="auto")


@pytest.fixture(scope="module")
def frames():
    """8 C5 frames cut at their sent starts from a capture without CFO,
    each then turned by one of FRAME_CFOS; and the fractional CFO a
    detector would leave (the CFO less its integer part, off by 0.013)."""
    rspec = _rspec()
    cap, _ = ref_build_capture(rspec, N_FRAMES, GAP, seed=5, cfo=0.0)
    fl = rspec.frame_len
    starts = OFFSET + np.arange(N_FRAMES) * (fl + GAP)
    fr = np.stack([cap[s:s + fl] for s in starts])
    n = np.arange(fl)
    c = np.asarray(FRAME_CFOS)
    fr = (fr * np.exp(2j * np.pi * c[:, None] * n / rspec.n_sc)).astype(
        np.complex64)
    eps = (c - np.round(c) + 0.013).astype(np.float32)
    return rspec, fr, eps


def test_integer_cfo_with_eps_pre_matches_reference(frames):
    rspec, fr, eps = frames
    spec = spec_from_reference(dataclasses.asdict(rspec))
    want = np.asarray(ref_sync.integer_cfo(rspec, jnp.asarray(fr),
                                           eps_pre=jnp.asarray(eps)))
    got = PS.integer_cfo(spec, torch.from_numpy(fr),
                         eps_pre=torch.from_numpy(eps))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.round(FRAME_CFOS))


def test_integer_cfo_with_eps_pre_equals_two_ramp_k(frames):
    rspec, fr, eps = frames
    spec = spec_from_reference(dataclasses.asdict(rspec))
    x, e = torch.from_numpy(fr), torch.from_numpy(eps)
    fused = PS.integer_cfo(spec, x, eps_pre=e)
    two = PS.integer_cfo(spec, PS.cfo_correct(x, e, spec.n_sc))
    assert torch.equal(fused, two)
    assert bool((two != 0).any())


def test_integer_cfo_window_is_the_derotated_frames_slice(frames):
    """The window integer_cfo derotates is, bit for bit, that slice of
    cfo_correct's frames: the same float32 phase expression on the same
    sample indices."""
    rspec, fr, eps = frames
    spec = spec_from_reference(dataclasses.asdict(rspec))
    x, e = torch.from_numpy(fr), torch.from_numpy(eps)
    start = spec.sym_len + spec.cp
    seen = {}
    plain_fft = torch.fft.fft

    def fft(win, norm):
        seen["win"] = win.clone()
        return plain_fft(win, norm=norm)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.fft, "fft", fft)
    try:
        PS.integer_cfo(spec, x, eps_pre=e)
    finally:
        mp.undo()
    whole = PS.cfo_correct(x, e, spec.n_sc)[..., start:start + spec.n_sc]
    assert torch.equal(torch.view_as_real(seen["win"]),
                       torch.view_as_real(whole))


def test_integer_cfo_without_eps_pre_is_unchanged(frames):
    rspec, fr, _ = frames
    spec = spec_from_reference(dataclasses.asdict(rspec))
    want = np.asarray(ref_sync.integer_cfo(rspec, jnp.asarray(fr)))
    got = PS.integer_cfo(spec, torch.from_numpy(fr))
    np.testing.assert_array_equal(got.numpy(), want)
