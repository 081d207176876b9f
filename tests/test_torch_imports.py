"""The port stands alone: every module imports without JAX or the
reference package, and kernels are chosen by the tensor's device."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import ofdm_uhd_tpu_torch
from ofdm_uhd_tpu_torch.kernels import policy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESSES = ("stages", "roofline", "sweeps", "detect_sweep", "evm_budget",
             "pod", "pp_ab")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        ofdm_uhd_tpu_torch.__path__, "ofdm_uhd_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("kernels.viterbi", "kernels.halo", "shard.mesh",
              "shard.frame_parallel", "shard.stage_pipeline",
              "shard.time_parallel", "research.shift", "kernels.banded",
              "research.fir_ilv", "research.deframe", "golden.sync",
              "golden.chain", "metrics", "io.capture", "io.native",
              "cli.config", "cli.tx", "cli.rx", "cli.loopback",
              "cli.pod_rx", "cli.bench", "shard.collectives",
              *(f"harness.{h}" for h in HARNESSES)):
        assert "ofdm_uhd_tpu_torch." + m in mods
    code = (
        "import importlib, sys\n"
        "for m in sys.argv[1:]:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ofdm_uhd_tpu' or m.startswith('ofdm_uhd_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('ok', len(sys.argv) - 1)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"ok {len(mods)}"


def test_cpu_tensor_takes_plain_version():
    x = torch.zeros(4)
    assert policy.use_kernel(x) is False
    with policy.plain_versions():
        assert policy.use_kernel(x) is False


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        policy.use_kernel(torch.zeros(4, device="meta"))


def test_plain_versions_switch_restores():
    assert policy._STATE.forced_plain is False
    with pytest.raises(RuntimeError):
        with policy.plain_versions():
            assert policy._STATE.forced_plain is True
            raise RuntimeError("leave the block")
    assert policy._STATE.forced_plain is False


def test_launch_counts_reset():
    policy.count_launch("fft")
    assert policy.launches()["fft"] >= 1
    policy.reset_launches()
    assert policy.launches() == dict.fromkeys(policy.KERNELS, 0)


@pytest.mark.parametrize("name", HARNESSES)
def test_harness_defaults_to_the_card_and_raises_without_one(name,
                                                             monkeypatch):
    """Each harness's --device defaults to cuda; with no card it raises
    before any work, never running on the CPU instead."""
    import importlib
    mod = importlib.import_module(f"ofdm_uhd_tpu_torch.harness.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main([])
