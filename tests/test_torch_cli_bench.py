"""The port's bench tool (ofdm_uhd_tpu_torch/cli/bench.py) against the
reference's (ofdm_uhd_tpu/cli/bench.py) on the CPU: both run in this
process on identical arguments at small sizes, in every mode (aligned;
capture, sc16 and fc32; stream, host-fed and resident), and their
records agree: the same keys, the same counts and settings, and EVM
within the rounding step of the records. Also: the tool accepts every
argument of the reference's plus --device, fails without a card unless
asked for the CPU, appends its record to --jsonl, and writes a
torch.profiler trace into --trace-dir as a `python -m` subprocess."""

import argparse
import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import ofdm_uhd_tpu.pipeline.stream as ref_stream
from ofdm_uhd_tpu.cli import bench as ref_bench
from ofdm_uhd_tpu.shard.mesh import make_mesh as ref_make_mesh

from ofdm_uhd_tpu_torch.cli import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)

RUNS = {
    "c1_aligned": ["--config", "c1", "--mode", "aligned", "--frames", "4"],
    "c3_capture_sc16": ["--config", "c3", "--mode", "capture", "--input",
                        "sc16", "--frames", "4"],
    "c3_capture_fc32": ["--config", "c3", "--mode", "capture", "--frames",
                        "4"],
    "c5_stream": ["--config", "c5", "--mode", "stream", "--chunk", "16384",
                  "--ksteps", "2", "--frames", "4"],
    "c5_stream_resident": ["--config", "c5", "--mode", "stream", "--chunk",
                           "16384", "--ksteps", "2", "--frames", "4",
                           "--resident"],
}
ITERS = ["--iters", "2"]
# fields that are measurements or name the machine, not the run
TIMING = {"msamples_per_s", "frames_per_s", "device"}
# the records round EVM to 0.01 dB: values that agree to well under it can
# still round one step apart
EVM_TOL = 0.01 + 1e-9


def record(main, argv) -> dict:
    """main(argv)'s printed JSON record."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    """The reference's record of each run, made once on first use. Its
    StreamRx without a mesh spans every JAX device (8 virtual CPU devices
    here, tests/conftest.py); the port's is one shard on --device, and the
    two agree on a machine with one device, so the reference's stream
    runs over one device."""
    cache = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_stream, "make_mesh",
               lambda n_frame=1, n_time=1, devices=None: ref_make_mesh(1, 1))

    def get(name):
        if name not in cache:
            cache[name] = record(ref_bench.main, RUNS[name] + ITERS)
        return cache[name]
    yield get
    mp.undo()


@pytest.mark.parametrize("name", list(RUNS))
def test_record_equals_the_references(reference, name):
    want = reference(name)
    got = record(bench.main, RUNS[name] + ITERS + ["--device", "cpu"])
    assert set(got) == set(want)
    assert got["device"] == "cpu"
    for k in set(want) - TIMING - {"evm_db"}:
        assert got[k] == want[k], k
    frames = 4 * 2 if name.startswith("c5") else 4
    assert got["frames_ok"] == frames
    if "evm_db" in want:
        # the mean over every slot, the empty ones included: the empty
        # slots' EVM agrees here too, so the record's own field is held
        assert abs(got["evm_db"] - want["evm_db"]) <= EVM_TOL
    assert got["msamples_per_s"] > 0 and got["frames_per_s"] > 0


class _Parsed(Exception):
    pass


def _options(main) -> set:
    """The option strings main's parser defines (parsing stops there)."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["opts"] = set(self._option_string_actions)
        raise _Parsed
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Parsed):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["opts"]


def test_accepts_every_argument_of_the_references():
    want = _options(ref_bench.main)
    got = _options(bench.main)
    assert got == want | {"--device"}


def test_without_a_card_it_fails():
    """With no card and no --device cpu the tool fails with torch's
    error and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    res = subprocess.run(
        [sys.executable, "-m", "ofdm_uhd_tpu_torch.cli.bench", "--frames",
         "1", "--iters", "1"], capture_output=True, text=True, cwd=REPO,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO,
                              OMP_NUM_THREADS="2"))
    assert res.returncode != 0
    assert "CUDA" in res.stderr
    assert res.stdout.strip() == ""


def test_jsonl_appends_the_record(tmp_path):
    path = tmp_path / "bench.jsonl"
    argv = RUNS["c1_aligned"][:-1] + ["2", "--iters", "1", "--device", "cpu",
                                      "--jsonl", str(path)]
    printed = [record(bench.main, argv) for _ in range(2)]
    lines = [json.loads(s) for s in path.read_text().splitlines()]
    assert len(lines) == 2
    for line, rec in zip(lines, printed):
        ts = line.pop("ts")
        assert isinstance(ts, float) and line == rec


def test_trace_dir_writes_a_trace(tmp_path):
    """As a user runs it: `python -m` with --trace-dir writes one Chrome
    trace of the timed loop, whose events include the chain's operators,
    and prints the record on its last line."""
    trace_dir = tmp_path / "trace"
    res = subprocess.run(
        [sys.executable, "-m", "ofdm_uhd_tpu_torch.cli.bench", "--config",
         "c1", "--frames", "2", "--iters", "1", "--device", "cpu",
         "--trace-dir", str(trace_dir)], capture_output=True, text=True,
        cwd=REPO, timeout=300, env=dict(os.environ, PYTHONPATH=REPO,
                                        OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["frames_ok"] == rec["frames"] == 2
    files = glob.glob(str(trace_dir / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
