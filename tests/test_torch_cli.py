"""The port's tools (ofdm_uhd_tpu_torch/cli/) on the CPU: as subprocesses
with --device cpu, as a user runs them (C1 tx -> rx bit-exact, the
reference's tx file decoded bit-exact, C2 loopback with multipath, rx
--aligned), load_spec against the reference's, and, on this card-less
machine, a non-zero exit without --device (the tools never fall back to
the CPU quietly)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.cli import config as ref_config
from ofdm_uhd_tpu.cli import tx as ref_tx

from ofdm_uhd_tpu_torch.cli import config as C
from ofdm_uhd_tpu_torch.cli import loopback, rx, tx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(tool, *args, device="cpu"):
    """python -m ofdm_uhd_tpu_torch.cli.<tool> from the repository's root,
    on two threads as this file's own torch; --device cpu unless device
    is None."""
    extra = ("--device", device) if device else ()
    return subprocess.run(
        [sys.executable, "-m", f"ofdm_uhd_tpu_torch.cli.{tool}", *args,
         *extra], capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))


def ok(res):
    assert res.returncode == 0, (res.stdout, res.stderr)
    return res.stderr


def test_tx_rx_roundtrip(tmp_path):
    cap, bits = str(tmp_path / "tx.npy"), str(tmp_path / "bits.npy")
    err = ok(run_cli("tx", "--config", "c1", "--frames", "5", "--out", cap,
                     "--bits-out", bits, "--gap", "200"))
    assert f"wrote 5 frames (6600 samples) to {cap}" in err
    err = ok(run_cli("rx", "--config", "c1", "--capture", cap,
                     "--expect-bits", bits, "--max-frames", "8"))
    assert "post-FEC BER: 0/2690 = 0.00e+00 (bit-exact)" in err, err
    assert "frames: 5 detected, 5 crc-ok" in err


@pytest.mark.parametrize("name", ["c1", "c2"])
def test_rx_decodes_the_references_tx_file(tmp_path, name):
    """The reference's cli.tx (JAX on the CPU) writes a capture; the
    port's cli.rx decodes it bit-exact and writes the payloads out."""
    cap, bits = str(tmp_path / "ref.npy"), str(tmp_path / "bits.npy")
    got = str(tmp_path / "got.npy")
    ref_tx.main(["--config", name, "--frames", "4", "--out", cap,
                 "--bits-out", bits, "--gap", "100", "--seed", "3"])
    err = ok(run_cli("rx", "--config", name, "--capture", cap,
                     "--expect-bits", bits, "--bits-out", got))
    assert "(bit-exact)" in err and "4 crc-ok" in err, err
    assert np.array_equal(np.load(got), np.load(bits))


def test_rx_reports_the_references_errors_on_a_clipped_sc16_file(
        tmp_path, capsys):
    """cli.tx writes the frames unscaled, and an sc16 file clips them at
    full scale (write_capture's contract): the reference's cli.rx decodes
    no frame of such a C1 file, and the port's reports the same errors and
    the same EVM."""
    from ofdm_uhd_tpu.cli import rx as ref_rx
    cap, bits = str(tmp_path / "ref.iq"), str(tmp_path / "bits.npy")
    ref_tx.main(["--config", "c1", "--frames", "3", "--out", cap,
                 "--bits-out", bits, "--gap", "50"])
    capsys.readouterr()
    ref_rx.main(["--config", "c1", "--capture", cap, "--expect-bits", bits])
    want = capsys.readouterr().err.splitlines()
    got = ok(run_cli("rx", "--config", "c1", "--capture", cap,
                     "--expect-bits", bits)).splitlines()
    assert "(ERRORS)" in want[0] and "0 crc-ok" in want[1]
    assert got[0] == want[0]
    assert got[1].split(";")[:2] == want[1].split(";")[:2]


@pytest.mark.parametrize("sync", [False, True])
def test_loopback_multipath(sync):
    args = ["--config", "c2", "--frames", "10", "--snr", "25",
            "--multipath", "1,0.3-0.2j"] + (["--sync"] if sync else [])
    err = ok(run_cli("loopback", *args))
    assert "10/10 frames crc-ok; post-FEC BIT-EXACT" in err, err


def test_rx_aligned(tmp_path):
    """--aligned decodes back-to-back frames at the sidecar's gap."""
    cap, bits = str(tmp_path / "tx.npy"), str(tmp_path / "bits.npy")
    ok(run_cli("tx", "--config", "c2", "--frames", "3", "--out", cap,
               "--bits-out", bits, "--gap", "40", "--seed", "1"))
    err = ok(run_cli("rx", "--config", "c2", "--capture", cap,
                     "--expect-bits", bits, "--aligned"))
    assert "(bit-exact)" in err and "3 detected, 3 crc-ok" in err, err


@pytest.mark.parametrize("tool,args", [
    ("tx", ["--out", "unused.npy", "--frames", "1"]),
    ("rx", ["--capture", os.path.join("tests", "fixtures", "unused.npy")]),
    ("loopback", ["--frames", "1"]),
])
def test_tools_without_a_card_fail(tool, args, tmp_path):
    """With no card and no --device cpu the tools fail with torch's
    error, never with a quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run on it")
    if tool == "rx":
        np.save(tmp_path / "cap.npy", np.zeros(4000, np.complex64))
        args = ["--capture", str(tmp_path / "cap.npy")]
    if tool == "tx":
        args = ["--out", str(tmp_path / "tx.npy"), "--frames", "1"]
    res = run_cli(tool, *args, device=None)
    assert res.returncode != 0
    assert "CUDA" in res.stderr
    assert "crc-ok" not in res.stderr and "wrote" not in res.stderr


@pytest.mark.parametrize("name,overrides", [
    ("c1", []), ("c3", []), ("c5", []),
    ("c2", ["mod=qam64", "n_sc=128", "cp=32"]),
    ("c1", ["fec_rate=3/4", "sfo_track=True", "chanest_smooth=3"]),
    ("configs/c4.json", ["eq_mode=mmse"]),
])
def test_load_spec_equals_the_reference(name, overrides):
    """Named configs (configs/<name>.json), JSON paths and --set overrides
    (mod -> modulation) give the reference's spec field for field."""
    path = os.path.join(REPO, name) if name.endswith(".json") else name
    got = C.load_spec(path, overrides)
    want = ref_config.load_spec(path, overrides)
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
        f: getattr(want, f) for f in want.__dataclass_fields__}


def test_common_args_and_channel():
    import argparse
    p = argparse.ArgumentParser()
    C.add_common_args(p)
    p.add_argument("--snr", type=float, default=30.0)
    args = p.parse_args(["--config", "c2", "--backend", "pallas", "--set",
                         "mod=qpsk", "--snr", "12"])
    assert args.device == "cuda"
    spec = C.spec_from_args(args)
    assert spec.kernel_backend == "pallas" and spec.modulation == "qpsk"
    ch = C.channel_from_args(args)
    assert ch.snr_db == 12.0 and ch.cfo == 0.0 and ch.timing_offset == 0


def test_tools_in_process(tmp_path, capsys):
    """main(argv) in process at --device cpu: tx writes the capture and
    its sidecar, rx reports the frames, loopback returns 0 on BIT-EXACT."""
    cap, bits = str(tmp_path / "tx.npy"), str(tmp_path / "bits.npy")
    tx.main(["--config", "c1", "--frames", "3", "--out", cap, "--bits-out",
             bits, "--gap", "50", "--device", "cpu"])
    assert os.path.exists(cap + ".json")
    rx.main(["--config", "c1", "--capture", cap, "--expect-bits", bits,
             "--device", "cpu", "--threshold", "0.4"])
    assert "(bit-exact)" in capsys.readouterr().err
    assert loopback.main(["--config", "c1", "--frames", "4", "--snr", "15",
                          "--device", "cpu"]) == 0
    assert "4/4 frames crc-ok" in capsys.readouterr().err


# ------------------------------------------------------------ metrics.py


def test_evm_and_ber_equal_the_reference():
    from ofdm_uhd_tpu import metrics as ref_metrics
    from ofdm_uhd_tpu_torch import metrics
    r = np.random.default_rng(8)
    ideal = r.standard_normal(300) + 1j * r.standard_normal(300)
    meas = ideal + 0.1 * r.standard_normal(300)
    assert metrics.evm_db(meas, ideal) == ref_metrics.evm_db(meas, ideal)
    a, b = r.integers(0, 2, (4, 50)), r.integers(0, 2, (4, 50))
    assert metrics.ber(a, b) == ref_metrics.ber(a, b)
    with pytest.raises(ValueError):
        metrics.ber(a, b[:3])


@pytest.mark.parametrize("with_valid", [True, False])
def test_run_metrics_equal_the_reference(with_valid):
    """update_batch on the port's tensor dicts counts what the reference's
    counts on the same values as arrays; update_stream and summary's
    counters likewise."""
    from types import SimpleNamespace
    from ofdm_uhd_tpu import metrics as ref_metrics
    from ofdm_uhd_tpu_torch import metrics
    r = np.random.default_rng(9)
    host = {"crc_ok": r.random((2, 6)) > 0.3,
            "evm_db": r.standard_normal((2, 6)) - 20.0}
    if with_valid:
        host["valid"] = r.random((2, 6)) > 0.2
        host["crc_ok"] &= host["valid"]
    ours, ref = metrics.RunMetrics(), ref_metrics.RunMetrics()
    ours.update_batch({k: torch.from_numpy(v) for k, v in host.items()}, 5000)
    ref.update_batch(host, 5000)
    frames = [SimpleNamespace(crc_ok=bool(i % 2), evm_db=-20.0 - i)
              for i in range(3)]
    ours.update_stream(frames)
    ref.update_stream(frames)
    for f in ("samples", "frames_detected", "frames_ok", "evm_sum", "evm_n"):
        assert getattr(ours, f) == getattr(ref, f), f
    s, s_ref = ours.summary(), ref.summary()
    assert s.keys() == s_ref.keys()
    for k in ("samples", "frames_detected", "frames_ok", "frame_ok_rate",
              "mean_evm_db"):
        assert s[k] == s_ref[k], k
    assert s["wall_s"] > 0 and s["msamples_per_s"] > 0


def test_jsonl_logger(tmp_path):
    import json
    from ofdm_uhd_tpu_torch.metrics import JsonlLogger
    log = JsonlLogger(str(tmp_path / "run.jsonl"))
    log.log({"frames_ok": 3})
    log.log({"frames_ok": 4, "cell": "c3"})
    lines = [json.loads(x) for x in (tmp_path / "run.jsonl").read_text()
             .splitlines()]
    assert [x["frames_ok"] for x in lines] == [3, 4]
    assert lines[1]["cell"] == "c3" and all("ts" in x for x in lines)
