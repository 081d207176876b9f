"""The reference's harnesses (bench/*.py), run in this test process on
the JAX package (tests/conftest.py keeps JAX on the CPU), for the port's
harnesses (ofdm_uhd_tpu_torch/harness/) to be held against: each script
runs as its own __main__ with the given arguments and --jsonl, and its
records are read back."""

import contextlib
import importlib.util
import io
import os
import runpy
import sys

import bench_lib  # noqa: F401  (this checkout's, before a script's path)
import ofdm_uhd_tpu.cli.config  # noqa: F401
from ofdm_uhd_tpu_torch.harness import read_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_reference(script: str, argv: list, out: str) -> list:
    """bench/<script> with argv and --jsonl out; its records. The scripts
    put the repository's root and bench/ on sys.path by fixed paths:
    sys.path is restored afterwards, and bench/sweeps.py (which
    evm_budget imports by that path) is this checkout's."""
    path = os.path.join(REPO, "bench", script)
    spec = importlib.util.spec_from_file_location(
        "sweeps", os.path.join(REPO, "bench", "sweeps.py"))
    sweeps = importlib.util.module_from_spec(spec)
    saved = sys.argv, list(sys.path), sys.modules.get("sweeps")
    try:
        spec.loader.exec_module(sweeps)
        sys.modules["sweeps"] = sweeps
        sys.argv = [path, *argv, "--jsonl", out]
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv, sys.path[:] = saved[0], saved[1]
        if saved[2] is None:
            sys.modules.pop("sweeps", None)
        else:
            sys.modules["sweeps"] = saved[2]
    return read_jsonl(out)


def run_port(name: str, argv: list, out: str) -> list:
    """ofdm_uhd_tpu_torch.harness.<name>.main(argv + --device cpu --jsonl
    out); its records."""
    mod = importlib.import_module(f"ofdm_uhd_tpu_torch.harness.{name}")
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main([*argv, "--device", "cpu", "--jsonl", out])
    return read_jsonl(out)
