"""The port's sweeps and evm_budget harnesses against the reference's
(bench/sweeps.py, bench/evm_budget.py) on the same seeds, on the CPU.

sweeps at C2, SNR 10 and 14 dB (at 10 some frames fail), 8 frames, flat
and over the C2 multipath channel: frames, post-FEC FER and the
pre-FEC bit errors exactly (the hard decisions of symbols that both
packages demodulate to float32 rounding: a symbol within that rounding of
a decision boundary could go either way, and none lies there at these
seeds); the analytic columns to 1e-12 relative; EVM
within 0.01 dB (PERF.md §2's tolerance for the port against the
reference). evm_budget at C2, 16 frames: every row within 0.01 dB.
"""

import pytest

from .torch_harness_ref import run_port, run_reference

CODED_BITS_C2 = 2304


@pytest.mark.parametrize("channel", [[], ["--multipath", "c2"]],
                         ids=["flat", "multipath"])
def test_sweeps_equal_the_reference(tmp_path, channel):
    argv = ["--config", "c2", "--snrs", "10,14", "--frames", "8", *channel]
    ref = run_reference("sweeps.py", argv, str(tmp_path / "ref.jsonl"))
    got = run_port("sweeps", argv, str(tmp_path / "port.jsonl"))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in ("config", "eq", "multipath", "snr_db", "frames",
                  "post_fec_fer"):
            assert g[k] == r[k], k
        assert round(g["pre_fec_ber"] * g["frames"] * CODED_BITS_C2) == \
            round(r["pre_fec_ber"] * r["frames"] * CODED_BITS_C2)
        for k in ("theory_ber", "chain_expected_ber"):
            assert g[k] == pytest.approx(r[k], rel=1e-12, abs=0), k
        assert abs(g["evm_db"] - r["evm_db"]) <= 0.01
    assert got[0]["post_fec_fer"] > 0 and got[1]["post_fec_fer"] == 0


def test_evm_budget_equals_the_reference(tmp_path):
    argv = ["--config", "c2", "--frames", "16"]
    ref = run_reference("evm_budget.py", argv, str(tmp_path / "ref.jsonl"))
    got = run_port("evm_budget", argv, str(tmp_path / "port.jsonl"))
    assert len(got) == len(ref) == 1
    (g,), (r,) = got, ref
    assert {k: v for k, v in g.items() if k != "evm_db"} == \
        {k: v for k, v in r.items() if k != "evm_db"}
    assert list(g["evm_db"]) == list(r["evm_db"]) == [
        "genie-all", "est-H", "est-H+CPE", "chain-aligned", "chain-capture"]
    for row in r["evm_db"]:
        assert abs(g["evm_db"][row] - r["evm_db"][row]) <= 0.01, row
