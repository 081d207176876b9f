"""Rehearsals of chip_smoke.py's variants phase on the CPU at tiny sizes,
with K4 and the stream path's wrappers patched to their plain versions
with a launch count and the card's events to host-clock stand-ins
(tests/test_torch_chip_smoke.py's `on_host` and `_patch_rx_path`)."""

import pytest
import torch

from .test_torch_chip_smoke import (_patch_rx_path, chip_smoke,  # noqa: F401
                                    on_host, policy)


def test_variants_phase_rehearsal(on_host, monkeypatch):
    """run_variants at a tiny trellis: its counted run launches K4 once
    for each radix-4 form's fallback at odd n and nothing else, every
    decoder equals K4 at every group size on both batches, and the
    counted run's launches join K4's kernels-line entry under the
    `variants` path."""
    from ofdm_uhd_tpu_torch.kernels import viterbi
    _patch_rx_path(monkeypatch)
    groups = []

    def k4(x, group=None, traceback=True):
        policy.count_launch("viterbi")
        groups.append(group)
        return viterbi.viterbi_plain(x)
    monkeypatch.setattr(viterbi, "_viterbi_cuda", k4)
    monkeypatch.setattr(chip_smoke, "VARIANT_STEPS", 40)
    monkeypatch.setattr(chip_smoke, "VARIANT_ROWS", (3, 2))
    monkeypatch.setattr(chip_smoke, "VARIANT_ODD", (2, 1, 41))
    out = chip_smoke.run_variants(torch, torch.device("cpu"))
    assert out["launches"]["viterbi"] == 2
    assert sum(out["launches"].values()) == 2
    assert set(viterbi.K4_GROUPS) <= set(groups)
    assert out["shape"] == [5, 80] and out["odd_shape"] == [3, 82]
    assert out["kernels"] == {}
    by_path = chip_smoke.path_launches({"variants": out})
    assert by_path["variants"]["viterbi"] == 2


def test_variants_phase_fails_on_a_wrong_bit(on_host, monkeypatch):
    """A decoder that differs from K4 in one bit fails the phase."""
    from ofdm_uhd_tpu_torch.research import viterbi_variants
    _patch_rx_path(monkeypatch)
    monkeypatch.setattr(chip_smoke, "VARIANT_STEPS", 40)
    monkeypatch.setattr(chip_smoke, "VARIANT_ROWS", (3, 2))
    monkeypatch.setattr(chip_smoke, "VARIANT_ODD", (2, 1, 41))
    good = viterbi_variants.viterbi_decode_smaj

    def flipped(llr):
        bits = good(llr).clone()
        bits[-1, 7] ^= 1
        return bits
    monkeypatch.setattr(viterbi_variants, "viterbi_decode_smaj", flipped)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="viterbi_decode_smaj on the even .* 1 bits"):
        chip_smoke.run_variants(torch, torch.device("cpu"))
