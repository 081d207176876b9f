"""The stream over a mesh that spans processes, on the CPU: two worker
processes in a gloo group on 127.0.0.1, each naming 4 `cpu` entries, so
the mesh is (1, 8), as tests/distributed/test_multihost.py runs the
reference (2 processes x 4 virtual CPU devices). The workers are this
file run as a script (`--worker`); they import the port alone.

Cases, every one read from one module-scoped spawn: C1 with 5 frames
(the reference's multihost_worker.py stream), and the C5 stream of
tests/test_torch_shard.py (16 frames, a burst over one frame's data
symbols so the TRACK retry runs) plain, with the slot reshard, with the
halo kernel's dispatch, fed as sc16, in K = 2 dispatches, and saved on
rank 0 after one chunk and resumed by a fresh pair of processes; and
the frame axis over (8, 1), the stage axis with a stage a process, and
the stream on a (2, 4) mesh whose frame rows are one process each (C1's
8 aligned frames, the C5 feed), each equal to the one-process run's on
the same virtual mesh, key for key. Each
case holds both ranks' frames against the port's one-process run on
`make_mesh(1, 8, ["cpu"] * 8)` exactly (starts, crc_ok, payloads, eps,
EVM: the rows are gathered and summed as the one-process run sums them)
and against the reference's StreamRx on the 8 virtual JAX devices of
tests/conftest.py (the halo, K = 2 and checkpoint cases against its
plain C5 run: REFERENCE_RUN; starts, crc_ok, payloads exactly; eps
within 1e-5 subcarrier spacings, EVM within 0.01 dB:
tests/test_torch_shard.py's tolerances for float32 rounding of XLA's and
PyTorch's arithmetic). The
carried state is bit-identical on both ranks and equal to the one-process
run's. `cli.pod_rx --distributed` as two processes writes the one-process
tool's bits. Every wait has a timeout: a hung worker is killed and the
test fails.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, PER_PROCESS, WORLD = 8, 4, 2
N_C5, BURST = 16, 14
CASES = ("c1", "c5", "reshard", "pallas_halo", "sc16", "k_step",
         "checkpoint")
TIMEOUT_S = 240
# the reference's run each case is held against: the halo kernel, the
# K-step dispatch and the checkpoint do not change the reference's frames,
# so those cases share its plain C5 run (its halo kernel takes a 1-D mesh
# only: on the ('frame', 'time') mesh its remote DMA raises)
REFERENCE_RUN = {"pallas_halo": "c5", "k_step": "c5", "checkpoint": "c5"}


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()) % 2**31)


# ---- the cases, run by the workers and by this process alike ----

def _chunk_c5():
    from ofdm_uhd_tpu_torch.core.spec import config
    spec = config("c5")
    return T * 2 * (spec.frame_len + spec.n_sc)


def _case(name, root):
    """(spec, feed, StreamRx keywords, pieces) of a case; the checkpoint
    case's keywords are its first receiver's."""
    from ofdm_uhd_tpu_torch.core.spec import config
    if name == "c1":
        return config("c1"), np.load(os.path.join(root, "c1.npy")), {}, 1
    spec = config("c5").with_(kernel_backend="auto")
    cap = np.load(os.path.join(root, "c5.npy"))
    kw = {"chunk_len": _chunk_c5(), "steps_per_dispatch": 1}
    if name == "sc16":
        kw.update(steps_per_dispatch=2, input_format="sc16")
        return spec, np.load(os.path.join(root, "c5_iq.npy")), kw, 3
    kw.update({"reshard": {"reshard": True},
               "pallas_halo": {"pallas_halo": True},
               "k_step": {"steps_per_dispatch": 2}}.get(name, {}))
    return spec, cap, kw, 1


def _feed(rx, feed, pieces=1):
    step = -(-feed.shape[-1] // pieces)
    got = []
    for lo in range(0, feed.shape[-1], step):
        got += rx.process(feed[..., lo:lo + step])
    return got + rx.flush()


def _cut():
    return _chunk_c5() + 123


def run_case(name, mesh, root, ckpt):
    """The case's frames and final receiver on `mesh`; the checkpoint case
    saves to `ckpt` after its first chunk and resumes in a new receiver
    (the workers resume in a fresh pair of processes instead)."""
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    spec, feed, kw, pieces = _case(name, root)
    rx = StreamRx(spec, mesh=mesh, **kw)
    if name != "checkpoint":
        return _feed(rx, feed, pieces), rx
    part = rx.process(feed[:_cut()])
    rx.save_state(ckpt)
    return part + resume(spec, mesh, feed, ckpt), rx


def resume(spec, mesh, feed, ckpt):
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    rx = StreamRx(spec, mesh=mesh, chunk_len=_chunk_c5(),
                  steps_per_dispatch=2)
    rx.load_state(ckpt)
    return rx.process(feed[_cut():]) + rx.flush()


def _save(path, frames, rx):
    np.savez(path, starts=np.array([f.start for f in frames], np.int64),
             crc_ok=np.array([f.crc_ok for f in frames], bool),
             payloads=np.array([f.payload for f in frames], np.uint8),
             eps=np.array([f.eps for f in frames], np.float64),
             evm=np.array([f.evm_db for f in frames], np.float64),
             rescued=np.int64(rx.rescued if rx is not None else -1),
             **{"state_" + k: v for k, v in (
                 rx.state.to_numpy().items() if rx is not None else ())})


# ---- the worker: this file run as a script ----

def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return type(e).__name__
    return "none"


def run_axes(meshes, root):
    """C1's aligned frames through rx_frames_sharded on meshes['frame']
    and rx_aligned_pipelined (2 microbatches) on meshes['stage'], and the
    C5 case's stream on meshes['rows'] ((2, 4): one frame row a process
    across two) -> {name: result dict, or (frames, receiver)}."""
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import rx_frames_sharded
    from ofdm_uhd_tpu_torch.shard.stage_pipeline import rx_aligned_pipelined
    c1 = config("c1")
    frames = torch.from_numpy(np.load(os.path.join(root, "c1_frames.npy")))
    spec, feed, kw, _ = _case("c5", root)
    rx = StreamRx(spec, mesh=meshes["rows"], **kw)
    return {"frame_parallel": rx_frames_sharded(c1, meshes["frame"])(frames),
            "stage_pipeline": rx_aligned_pipelined(c1, meshes["stage"], 2)(
                frames),
            "stream_rows": (_feed(rx, feed), rx)}


def _save_axes(root, tag, runs):
    for name, res in runs.items():
        if isinstance(res, dict):
            np.savez(os.path.join(root, f"{name}_{tag}.npz"),
                     **{k: v.numpy() for k, v in res.items()})
        else:
            _save(os.path.join(root, f"{name}_{tag}.npz"), *res)


def worker(args):
    """One rank: every case on the (1, 8) mesh, then the frame and stage
    axes and the stream on a (2, 4) mesh, and the raising path (phase
    'run'); or the checkpoint case's second half (phase 'resume')."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh
    from ofdm_uhd_tpu_torch.shard.mesh import (init_distributed,
                                               make_stage_mesh)
    init_distributed(f"127.0.0.1:{args.port}", WORLD, args.rank,
                     device="cpu")
    mesh = make_mesh(1, T, ["cpu"] * PER_PROCESS)
    ckpt = os.path.join(args.root, "ckpt.npz")
    out = os.path.join(args.root, "{}_r%d.npz" % args.rank)
    if args.phase == "resume":
        spec, feed, _, _ = _case("checkpoint", args.root)
        _save(out.format("resume"), resume(spec, mesh, feed, ckpt), None)
        dist.destroy_process_group()
        return
    for name in CASES:
        if name == "checkpoint":
            spec, feed, kw, _ = _case(name, args.root)
            rx = StreamRx(spec, mesh=mesh, **kw)
            part = rx.process(feed[:_cut()])
            rx.save_state(ckpt)
            _save(out.format(name), part, rx)
        else:
            frames, rx = run_case(name, mesh, args.root, None)
            _save(out.format(name), frames, rx)
    rows = make_mesh(2, 4, ["cpu"] * 4)
    _save_axes(args.root, f"r{args.rank}", run_axes(
        {"frame": make_mesh(T, 1, ["cpu"] * PER_PROCESS),
         "stage": make_stage_mesh(2, ["cpu"]), "rows": rows}, args.root))
    checks = {
        "mesh_ranks": mesh.ranks.tolist(),
        "first_device": str(mesh.first_device),
        "unequal_counts": _raises(
            lambda: make_mesh(1, 9, ["cpu"] * (4 + args.rank))),
        "rows_ranks": rows.ranks.tolist(),
    }
    with open(os.path.join(args.root, f"checks_r{args.rank}.json"),
              "w") as f:
        json.dump(checks, f)
    dist.destroy_process_group()


# ---- the test process ----

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        env.pop(k, None)
    return dict(env, **extra)


def _spawn_workers(root, phase):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", "--port",
         str(port), "--rank", str(r), "--root", root, "--phase", phase],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=_env()) for r in range(WORLD)]


def _pod_rx(root, distributed):
    """cli.pod_rx on C1 over 8 cpu entries: one process, or two under
    torchrun's environment set by hand."""
    args = [sys.executable, "-m", "ofdm_uhd_tpu_torch.cli.pod_rx",
            "--config", "c1", "--capture", os.path.join(root, "c1.npy"),
            "--device", "cpu", "--devices", str(T)]
    if not distributed:
        return [subprocess.Popen(
            args + ["--bits-out", os.path.join(root, "pod_one.npy")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=_env())]
    port = str(_free_port())
    return [subprocess.Popen(
        args + ["--distributed", "--bits-out",
                os.path.join(root, "pod_two.npy")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(r),
                 WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r)))
        for r in range(WORLD)]


def _wait(procs, what):
    """Every process's (rc, stdout, stderr); on a timeout kill them all
    and fail."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"{what}: a process hung past {TIMEOUT_S} s")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, (what, out, err[-3000:])
    return outs


def _write_inputs(root):
    """C1: multihost_worker.py's 5 frames; C5: tests/test_torch_shard.py's
    16-frame stream with its burst, and its sc16 planes."""
    from ofdm_uhd_tpu_torch.channel import apply_channel, make_capture
    from ofdm_uhd_tpu_torch.core.spec import ChannelSpec, config
    from ofdm_uhd_tpu_torch.golden import GoldenModem
    spec = config("c1")
    rng = np.random.default_rng(7)
    pays = rng.integers(0, 2, (5, spec.payload_bits_per_frame)).astype(
        np.uint8)
    gm = GoldenModem(spec)
    cap = make_capture(np.stack([gm.modulate_frame(p) for p in pays]),
                       ChannelSpec(snr_db=25.0, cfo=0.2, timing_offset=111),
                       spec.n_sc, gap=150, seed=5).astype(np.complex64)
    np.save(os.path.join(root, "c1.npy"), cap)
    np.save(os.path.join(root, "c1_pays.npy"), pays)
    # 8 aligned frames for the frame and stage axes
    pays8 = rng.integers(0, 2, (8, spec.payload_bits_per_frame)).astype(
        np.uint8)
    np.save(os.path.join(root, "c1_frames.npy"), np.stack([
        apply_channel(gm.modulate_frame(p), ChannelSpec(snr_db=25.0),
                      spec.n_sc, seed=i)
        for i, p in enumerate(pays8)]).astype(np.complex64))
    spec = config("c5")
    gm = GoldenModem(spec)
    r = _rng("stream1")
    pays = r.integers(0, 2, (N_C5, spec.payload_bits_per_frame)).astype(
        np.uint8)
    gap, offset = 500, 700
    cap = make_capture(np.stack([gm.modulate_frame(p) for p in pays]),
                       ChannelSpec(snr_db=26.0, cfo=0.7,
                                   phase_noise_std=2e-4,
                                   timing_offset=offset),
                       spec.n_sc, gap=gap, seed=1).astype(np.complex64)
    s = offset + BURST * (spec.frame_len + gap) + 2 * spec.sym_len
    n = spec.frame_len - 2 * spec.sym_len
    rms = float(np.sqrt(np.mean(np.abs(cap) ** 2)))
    cap[s:s + n] += (2.0 * rms * (r.standard_normal(n) + 1j
                                  * r.standard_normal(n))).astype(np.complex64)
    np.save(os.path.join(root, "c5.npy"), cap)
    np.save(os.path.join(root, "c5_pays.npy"), pays)
    planes = np.stack([cap.real, cap.imag])
    np.save(os.path.join(root, "c5_iq.npy"), np.round(
        planes * (32767.0 / np.max(np.abs(planes)))).astype(np.int16))


def _reference(name, root):
    """The reference's StreamRx on the 8 virtual JAX devices, the case's
    receiver arguments and feed (the checkpoint case: uninterrupted)."""
    import jax
    from ofdm_uhd_tpu.core.spec import config as ref_config
    from ofdm_uhd_tpu.pipeline.stream import StreamRx as RefStreamRx
    from ofdm_uhd_tpu.shard import mesh as ref_mesh
    _, feed, kw, pieces = _case(name, root)
    rspec = (ref_config("c1") if name == "c1"
             else ref_config("c5").with_(kernel_backend="auto"))
    rx = RefStreamRx(rspec, mesh=ref_mesh.make_mesh(
        1, T, devices=jax.devices()[:T]), **kw)
    return _feed(rx, feed, pieces)


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of the two workers (and of pod_rx, one process and two)
    while this process runs the one-process cases and the reference; then
    the checkpoint's fresh pair."""
    from ofdm_uhd_tpu_torch.shard import make_mesh
    from ofdm_uhd_tpu_torch.shard.mesh import make_stage_mesh
    torch.set_num_threads(2)
    root = str(tmp_path_factory.mktemp("dist"))
    _write_inputs(root)
    workers = _spawn_workers(root, "run")
    pods = _pod_rx(root, False) + _pod_rx(root, True)
    try:
        mesh = make_mesh(1, T, ["cpu"] * T)
        one = {}
        for name in CASES:
            frames, rx = run_case(name, mesh, root,
                                  os.path.join(root, "one_ckpt.npz"))
            path = os.path.join(root, f"one_{name}.npz")
            _save(path, frames, rx if name != "checkpoint" else None)
            one[name] = _load(path)
        _save_axes(root, "one", run_axes(
            {"frame": make_mesh(T, 1, ["cpu"] * T),
             "stage": make_stage_mesh(2, ["cpu"] * 2),
             "rows": make_mesh(2, 4, ["cpu"] * 8)}, root))
        ref = {name: _reference(name, root) for name in CASES
               if name not in REFERENCE_RUN}
        worker_out = _wait(workers, "workers")
        pod_out = _wait(pods, "pod_rx")
    finally:
        for p in workers + pods:
            if p.poll() is None:
                p.kill()
    _wait(_spawn_workers(root, "resume"), "resume workers")
    two = {}
    for name in CASES:
        two[name] = [_load(os.path.join(root, f"{name}_r{r}.npz"))
                     for r in range(WORLD)]
    for r in range(WORLD):
        part2 = _load(os.path.join(root, f"resume_r{r}.npz"))
        joined = {k: np.concatenate([two["checkpoint"][r][k], part2[k]])
                  for k in ("starts", "crc_ok", "payloads", "eps", "evm")}
        two["checkpoint"][r] = joined
    checks = [json.load(open(os.path.join(root, f"checks_r{r}.json")))
              for r in range(WORLD)]
    axes = {name: {tag: _load(os.path.join(root, f"{name}_{tag}.npz"))
                   for tag in ("one", "r0", "r1")}
            for name in ("frame_parallel", "stage_pipeline", "stream_rows")}
    return {"root": root, "one": one, "two": two, "ref": ref,
            "checks": checks, "axes": axes, "workers": worker_out,
            "pods": pod_out}


def _same(got, want, exact):
    np.testing.assert_array_equal(got["starts"], want["starts"])
    np.testing.assert_array_equal(got["crc_ok"], want["crc_ok"])
    np.testing.assert_array_equal(got["payloads"], want["payloads"])
    if exact:
        np.testing.assert_array_equal(got["eps"], want["eps"])
        np.testing.assert_array_equal(got["evm"], want["evm"])
    else:
        assert np.abs(got["eps"] - want["eps"]).max() <= 1e-5
        assert np.abs(got["evm"] - want["evm"]).max() <= 0.01


@pytest.mark.parametrize("name", CASES)
def test_two_processes_equal_one_process(runs, name):
    for got in runs["two"][name]:
        _same(got, runs["one"][name], exact=True)
    n = len(runs["one"][name]["starts"])
    pays = np.load(os.path.join(runs["root"], "c1_pays.npy" if name == "c1"
                                else "c5_pays.npy"))
    assert n == len(pays)
    assert list(runs["one"][name]["crc_ok"]) == [
        name == "c1" or i != BURST for i in range(n)]
    for i, p in enumerate(runs["one"][name]["payloads"]):
        if name == "c1" or i != BURST:
            np.testing.assert_array_equal(p, pays[i])


@pytest.mark.parametrize("name", CASES)
def test_two_processes_equal_reference(runs, name):
    want = runs["ref"][REFERENCE_RUN.get(name, name)]
    want = {"starts": np.array([f.start for f in want]),
            "crc_ok": np.array([f.crc_ok for f in want]),
            "payloads": np.array([np.asarray(f.payload) for f in want]),
            "eps": np.array([f.eps for f in want]),
            "evm": np.array([f.evm_db for f in want])}
    for got in runs["two"][name]:
        _same(got, want, exact=False)


@pytest.mark.parametrize("name", [c for c in CASES if c != "checkpoint"])
def test_tracker_state_is_one_replica(runs, name):
    """The carried state (tracker, counters, tails) is bit-identical on
    both ranks and equal to the one-process run's; the TRACK retry
    rescued as many frames."""
    a, b = runs["two"][name]
    one = runs["one"][name]
    keys = [k for k in one if k.startswith("state_")]
    assert "state_h_track" in keys and "state_track_wt" in keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], one[k])
    assert a["rescued"] == b["rescued"] == one["rescued"]


def test_pod_rx_two_processes_write_the_one_process_bits(runs):
    root = runs["root"]
    np.testing.assert_array_equal(np.load(os.path.join(root, "pod_two.npy")),
                                  np.load(os.path.join(root, "pod_one.npy")))
    np.testing.assert_array_equal(np.load(os.path.join(root, "pod_two.npy")),
                                  np.load(os.path.join(root, "c1_pays.npy")))
    lines = [err.strip().splitlines()[-1] for _, _, err in runs["pods"]]
    assert all(line.startswith(f"mesh time={T}: 5 frames, 5 crc-ok; EVM ")
               for line in lines), lines
    # both ranks' summaries agree up to their throughputs
    head = {line.split(" dB;")[0] for line in lines}
    assert len(head) == 1, lines


def test_process_mesh_and_raising_paths(runs):
    """The process mesh, unequal entry counts raising, and the frame axis,
    the stage axis and the (2, 4) stream, which now run across the two
    processes: each rank's result equal to the one-process run's on the
    same virtual mesh, every key bit for bit, the stream's state too."""
    for r, c in enumerate(runs["checks"]):
        assert c["mesh_ranks"] == [[0] * PER_PROCESS + [1] * PER_PROCESS]
        assert c["first_device"] == "cpu"
        assert c["unequal_counts"] == "ValueError"
        assert c["rows_ranks"] == [[0] * 4, [1] * 4]
    for name, got in runs["axes"].items():
        one = got["one"]
        # the C5 feed's burst frame fails its CRC, as in the (1, 8) cases
        assert list(one["crc_ok"]) == ([i != BURST for i in range(N_C5)]
                                       if name == "stream_rows"
                                       else [True] * 8)
        for r in (0, 1):
            assert set(got[f"r{r}"]) == set(one), name
            for k in one:
                assert got[f"r{r}"][k].dtype == one[k].dtype
                assert torch.equal(torch.from_numpy(got[f"r{r}"][k]),
                                   torch.from_numpy(one[k])), (name, k)


def test_nccl_takes_one_rank_a_card():
    """The backend choice, without NCCL: nccl for cards, gloo for the
    CPU, and two ranks on one card of one host refused under nccl."""
    from ofdm_uhd_tpu_torch.shard.mesh import select_backend
    assert select_backend([("a", ["cuda:0"]), ("a", ["cuda:1"])]) == "nccl"
    assert select_backend([("a", ["cpu"]), ("a", ["cpu"])]) == "gloo"
    assert select_backend([("a", ["cuda:0"]), ("b", ["cuda:0"])]) == "nccl"
    with pytest.raises(ValueError, match="one rank a card"):
        select_backend([("a", ["cuda:0"] * 2), ("a", ["cuda:0"] * 2)])
    with pytest.raises(ValueError):
        select_backend([("a", ["cuda:0"]), ("a", ["cuda:0"])], "nccl")
    with pytest.raises(ValueError):
        select_backend([("a", ["cpu"]), ("a", ["cpu"])], "nccl")
    with pytest.raises(ValueError):
        select_backend([("a", ["cpu"]), ("a", ["cuda:0"])])
    # gloo takes two ranks on one card (it stages through the host)
    assert select_backend([("a", ["cuda:0"]), ("a", ["cuda:0"])],
                          "gloo") == "gloo"



def test_joining_names_a_card_or_the_cpu(monkeypatch):
    """init_distributed picks its device before it joins: a bare 'cuda'
    is cuda:LOCAL_RANK (else the process id), which under NCCL must be a
    card of its own (one rank a card) and only under gloo may share one;
    on a host without cards 'cuda' raises and only 'cpu' runs on the
    CPU. No group is joined where it raises."""
    import torch.distributed as dist
    from ofdm_uhd_tpu_torch.shard import mesh as M
    joined = []
    monkeypatch.setattr(M, "_LOCAL", [])
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.append(backend))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(ValueError, match="init_distributed first"):
        M.local_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in (None, "gloo", "nccl"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            M.init_distributed("127.0.0.1:1", 2, 1, backend=backend)
    assert joined == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # two ranks, one card: NCCL refuses the second before joining
    with pytest.raises(ValueError, match="one rank a card"):
        M.init_distributed("127.0.0.1:1", 2, 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="one rank a card"):
        M.init_distributed("127.0.0.1:1", 2, 0, backend="nccl")
    assert joined == []
    # gloo shares the card: rank 1 on cuda:0
    assert M.init_distributed("127.0.0.1:1", 2, 1, backend="gloo") == \
        torch.device("cuda", 0)
    assert joined == ["gloo"] and M.local_device() == torch.device("cuda", 0)
    monkeypatch.delenv("LOCAL_RANK")
    assert M.init_distributed("127.0.0.1:1", 2, 1, device="cpu") == \
        torch.device("cpu")
    assert joined == ["gloo", "gloo"]
    assert M._default_device("cuda", "gloo", 5) == torch.device("cuda", 0)
    assert M._default_device("cuda:0", "nccl", 5) == torch.device("cuda", 0)


def test_pod_rx_distributed_needs_a_card():
    """`pod_rx --distributed` under its default --device cuda on a host
    without a card (none visible) exits non-zero before it joins a group or reads the
    capture, as the one-process tool does: the CPU only by --device cpu."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0")
    p = subprocess.run(
        [sys.executable, "-m", "ofdm_uhd_tpu_torch.cli.pod_rx", "--config",
         "c5", "--capture", os.path.join(REPO, "no_such_capture.npy"),
         "--devices", "2", "--distributed"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "no CUDA card" in p.stderr, p.stderr[-2000:]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--phase", choices=["run", "resume"], required=True)
    sys.path.insert(0, REPO)
    worker(ap.parse_args())
