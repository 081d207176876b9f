"""The frame and stage axes, and the stream on a ('frame', 'time') mesh,
over meshes that span processes, on the CPU: four worker processes in a
gloo group on 127.0.0.1 (`device="cpu"`; its store served by this
process: ofdm_uhd_tpu_torch/shard/spawn.py). The workers are this file run
as a script (`--worker`); they import the port alone. One spawn serves
every case.

Cases (the reference's tests/distributed/test_stage_pipeline.py and
test_combined_mesh.py, and tests/test_torch_shard.py's frame axis):
  frame         C1 at 4 data symbols, 8 frames, rx_frames_sharded and
                tx_frames_sharded over a (4, 1) mesh, one entry a process;
  stage_c2      C2, 16 frames, 4 microbatches, rx_aligned_pipelined with
                its stages on ranks 0 and 1 (ranks 2 and 3 own no entry);
  stage_c4      C4 at 2 data symbols, 8 frames, 2 microbatches, as above;
  on the one (2, 4) mesh of two entries a process (each frame row spans
  two processes):
  mesh_frame    C1 frame-parallel, 6 frames;
  mesh_stream   the C5 stream, 6 frames, at the reference test's chunk;
  mesh_both     a C1 batch of 4 frames and a 2-frame C5 stream
                (noiseless: its EVM, at the float32 floor, is held below
                -120 dB in both packages, as PERF.md §2 holds such
                frames), interleaved on the mesh;
  reshard       mesh_stream's feed with reshard=True;
  checkpoint    the C5 capture twice at a chunk of 8 (frame_len + n_sc),
                saved after its first chunk (rank 0 writes), then loaded
                by this process alone.
Every rank's result equals the port's one-process run on the same
virtual mesh (`make_mesh(..., ["cpu"] * n)`): every returned key bit for
bit (torch.equal, dtypes and shapes), the streams' frames and carried
StreamState. And it equals the reference on the 8 virtual JAX devices of
tests/conftest.py: payloads, crc_ok, frame starts and n_ok_global
exactly; EVM and mean_evm_global within 0.01 dB; eps within 1e-5 (PERF.md
§2's tolerances); TX frames within 1e-5 of max|y|. The stage cases
equal the port's fused rx_aligned too. A frame row whose processes own
unequal shares raises ValueError on every rank; layouts NCCL refuses
still raise. Every wait has a timeout: a hung worker is killed and the
test fails.
"""

import argparse
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.shard.spawn import (exit_worker, hosted_store,
                                            worker_env)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 240
BATCH_CASES = ("frame", "stage_c2", "stage_c4", "mesh_frame", "mesh_both")
STREAM_CASES = ("mesh_stream", "mesh_both", "reshard", "checkpoint")


# ---- the cases, run by the workers and by this process alike ----

def _specs():
    from ofdm_uhd_tpu_torch.core.spec import config
    return {"c1": config("c1").with_(n_data_syms=4), "c2": config("c2"),
            "c4": config("c4").with_(n_data_syms=2), "c5": config("c5")}


def _chunk(spec):
    """tests/distributed/test_combined_mesh.py's chunk."""
    h = spec.frame_len + spec.n_sc
    return 4 * max(2 * h, 4 * spec.frame_len)


def _ckpt_chunk(spec):
    """The checkpoint case's chunk: blocks of 2 (frame_len + n_sc), so
    that its feed (the C5 capture twice) takes two steps and a flush."""
    return 8 * (spec.frame_len + spec.n_sc)


def _cut(spec):
    return _ckpt_chunk(spec) + 123


def _stream(rx, feed):
    return rx.process(feed) + rx.flush()


def run_cases(meshes, root, ckpt):
    """Every case on meshes {'frame': (4, 1), 'stage': 2 stages, '2d':
    (2, 4)} -> {case: results}: batch cases a dict of tensors, stream
    cases (frames, receiver); the checkpoint case saves to `ckpt` after
    its first chunk and returns that part."""
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import rx_frames_sharded, tx_frames_sharded
    from ofdm_uhd_tpu_torch.shard.stage_pipeline import rx_aligned_pipelined
    specs = _specs()
    ld = lambda name: torch.from_numpy(np.load(os.path.join(root, name)))
    out = {}
    got = rx_frames_sharded(specs["c1"], meshes["frame"])(ld("c1_frames.npy"))
    got["tx"] = tx_frames_sharded(specs["c1"], meshes["frame"])(
        ld("c1_pays.npy"))
    out["frame"] = got
    out["stage_c2"] = rx_aligned_pipelined(specs["c2"], meshes["stage"], 4)(
        ld("c2_frames.npy"))
    out["stage_c4"] = rx_aligned_pipelined(specs["c4"], meshes["stage"], 2)(
        ld("c4_frames.npy"))
    mesh = meshes["2d"]
    out["mesh_frame"] = rx_frames_sharded(specs["c1"], mesh)(
        ld("c1_frames6.npy"))
    c5, chunk = specs["c5"], _chunk(specs["c5"])
    feed = np.load(os.path.join(root, "c5.npy"))
    rx = StreamRx(c5, mesh=mesh, chunk_len=chunk)
    out["mesh_stream"] = (_stream(rx, feed), rx)
    # interleaved: the batch, then the stream, on the same mesh object
    batch_fn = rx_frames_sharded(specs["c1"], mesh)
    stream_rx = StreamRx(c5, mesh=mesh, chunk_len=chunk)
    batch = batch_fn(ld("c1_frames4.npy"))
    out["mesh_both"] = (_stream(stream_rx, np.load(os.path.join(
        root, "c5_two.npy"))), stream_rx, batch)
    rx = StreamRx(c5, mesh=mesh, chunk_len=chunk, reshard=True)
    out["reshard"] = (_stream(rx, feed), rx)
    rx = StreamRx(c5, mesh=mesh, chunk_len=_ckpt_chunk(c5))
    part = rx.process(np.load(os.path.join(root, "c5_twice.npy"))[
        :_cut(c5)])
    rx.save_state(ckpt)
    out["checkpoint"] = (part, rx)
    return out


def resume(mesh, root, ckpt):
    """The checkpoint case's second half from `ckpt`, in a new receiver."""
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    spec = _specs()["c5"]
    rx = StreamRx(spec, mesh=mesh, chunk_len=_ckpt_chunk(spec))
    rx.load_state(ckpt)
    return _stream(rx, np.load(os.path.join(root, "c5_twice.npy"))[
        _cut(spec):]), rx


def _save(root, tag, results):
    """Each case's results as .npz: a batch case's tensors by key (the
    interleaved case's batch as batch_*), a stream case's frames and
    state."""
    for name, res in results.items():
        arrays = {}
        if isinstance(res, dict):
            arrays = {k: v.numpy() for k, v in res.items()}
        else:
            frames, rx = res[0], res[1]
            if len(res) == 3:
                arrays = {"batch_" + k: v.numpy() for k, v in res[2].items()}
            arrays.update(
                starts=np.array([f.start for f in frames], np.int64),
                crc_ok=np.array([f.crc_ok for f in frames], bool),
                payloads=np.array([f.payload for f in frames], np.uint8),
                eps=np.array([f.eps for f in frames], np.float64),
                evm=np.array([f.evm_db for f in frames], np.float64),
                **{"state_" + k: v for k, v in rx.state.to_numpy().items()})
        np.savez(os.path.join(root, f"{name}_{tag}.npz"), **arrays)


# ---- the worker: this file run as a script ----

def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "none"


def worker(args):
    """One rank: every case on meshes that span the four processes, then
    the raising layout."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh
    from ofdm_uhd_tpu_torch.shard.mesh import (init_distributed,
                                               make_stage_mesh)
    init_distributed(f"127.0.0.1:{args.port}", WORLD, args.rank,
                     device="cpu")
    meshes = {"frame": make_mesh(4, 1, ["cpu"]),
              "stage": make_stage_mesh(2, ["cpu"]),
              "2d": make_mesh(2, 4, ["cpu"] * 2)}
    _save(args.root, f"r{args.rank}", run_cases(
        meshes, args.root, os.path.join(args.root, "ckpt.npz")))
    checks = {
        "ranks": {k: m.ranks.tolist() for k, m in meshes.items()},
        "own_rows": meshes["2d"].own_rows(),
        "row_ranks": [meshes["2d"].row_ranks(f) for f in range(2)],
        # row 0 of a (1, 3) mesh over two entries a process: [0, 0, 1]
        "unequal_row": _raises(lambda: StreamRx(
            _specs()["c1"], mesh=make_mesh(1, 3, ["cpu"] * 2))),
    }
    with open(os.path.join(args.root, f"checks_r{args.rank}.json"),
              "w") as f:
        json.dump(checks, f)
    dist.destroy_process_group()


# ---- the test process ----

def _spawn(root, port):
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", "--port",
         str(port), "--rank", str(r), "--root", root],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=worker_env(REPO)) for r in range(WORLD)]


def _wait(procs):
    """Every worker's exit; on a timeout kill them all and fail."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"a worker hung past {TIMEOUT_S} s")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, (out, err[-3000:])


def _aligned(rspec, n, snr, seed):
    """tests/distributed/test_stage_pipeline.py's batches."""
    from ofdm_uhd_tpu.channel import apply_channel
    from ofdm_uhd_tpu.core.spec import ChannelSpec
    from ofdm_uhd_tpu.golden import GoldenModem
    rng = np.random.default_rng(seed)
    pays = rng.integers(0, 2, (n, rspec.payload_bits_per_frame)
                        ).astype(np.uint8)
    frames = GoldenModem(rspec).tx(pays)
    rx = np.stack([apply_channel(frames[i], ChannelSpec(snr_db=snr),
                                 rspec.n_sc, seed=i) for i in range(n)])
    return rx.astype(np.complex64), pays


def _write_inputs(root, rspecs):
    """The reference tests' inputs, from the reference's golden modem and
    channel (numpy)."""
    from ofdm_uhd_tpu.channel import make_capture
    from ofdm_uhd_tpu.core.spec import ChannelSpec
    from ofdm_uhd_tpu.golden import GoldenModem
    pp = zlib.crc32(b"pp") % 2**31
    for name, (spec, n, snr, seed) in {
            "c1_frames": (rspecs["c1"], 8, 25.0, 0),
            "c1_frames6": (rspecs["c1"], 6, 25.0, 0),
            "c1_frames4": (rspecs["c1"], 4, 25.0, 7),
            "c2_frames": (rspecs["c2"], 16, 22.0, pp),
            "c4_frames": (rspecs["c4"], 8, 30.0, pp)}.items():
        frames, pays = _aligned(spec, n, snr, seed)
        np.save(os.path.join(root, name + ".npy"), frames)
        np.save(os.path.join(root, name.replace("frames", "pays") + ".npy"),
                pays)
    spec = rspecs["c5"]
    gm = GoldenModem(spec)
    pays = np.random.default_rng(11).integers(
        0, 2, (6, spec.payload_bits_per_frame)).astype(np.uint8)
    cap = make_capture(np.stack([gm.modulate_frame(p) for p in pays]),
                       ChannelSpec(snr_db=26.0, cfo=0.4, timing_offset=500),
                       spec.n_sc, gap=600, seed=3).astype(np.complex64)
    np.save(os.path.join(root, "c5.npy"), cap)
    np.save(os.path.join(root, "c5_twice.npy"), np.concatenate([cap, cap]))
    np.save(os.path.join(root, "c5_pays.npy"), pays)
    pls = np.random.default_rng(8).integers(
        0, 2, (2, spec.payload_bits_per_frame)).astype(np.uint8)
    two = np.concatenate(
        [np.zeros(300, np.complex64)]
        + [np.concatenate([gm.modulate_frame(p).astype(np.complex64),
                           np.zeros(400, np.complex64)]) for p in pls])
    np.save(os.path.join(root, "c5_two.npy"), two)
    np.save(os.path.join(root, "c5_two_pays.npy"), pls)


def _reference(root, rspecs):
    """The reference's runs on the 8 virtual JAX devices, as numpy."""
    import jax
    from ofdm_uhd_tpu.pipeline.stream import StreamRx as RefStreamRx
    from ofdm_uhd_tpu.shard import frame_parallel as ref_fp
    from ofdm_uhd_tpu.shard import mesh as ref_mesh
    from ofdm_uhd_tpu.shard.stage_pipeline import rx_aligned_pipelined
    ld = lambda name: np.load(os.path.join(root, name))
    dev = jax.devices()
    host = lambda d: {k: np.asarray(v) for k, v in d.items()}
    frame_mesh = ref_mesh.make_mesh(4, 1, devices=dev[:4])
    mesh2d = ref_mesh.make_mesh(2, 4, devices=dev[:8])
    out = {"frame": host(ref_fp.rx_frames_sharded(rspecs["c1"], frame_mesh)(
        ld("c1_frames.npy")))}
    out["frame"]["tx"] = np.asarray(ref_fp.tx_frames_sharded(
        rspecs["c1"], frame_mesh)(ld("c1_pays.npy")))
    stage = ref_mesh.make_stage_mesh(2)
    out["stage_c2"] = host(rx_aligned_pipelined(rspecs["c2"], stage, 4)(
        ld("c2_frames.npy")))
    out["stage_c4"] = host(rx_aligned_pipelined(rspecs["c4"], stage, 2)(
        ld("c4_frames.npy")))
    out["mesh_frame"] = host(ref_fp.rx_frames_sharded(rspecs["c1"], mesh2d)(
        ld("c1_frames6.npy")))
    chunk = _chunk(rspecs["c5"])
    rx = RefStreamRx(rspecs["c5"], mesh=mesh2d, chunk_len=chunk)
    out["mesh_stream"] = _frames(_stream(rx, ld("c5.npy")))
    batch = host(ref_fp.rx_frames_sharded(rspecs["c1"], mesh2d)(
        ld("c1_frames4.npy")))
    rx = RefStreamRx(rspecs["c5"], mesh=mesh2d, chunk_len=chunk)
    out["mesh_both"] = _frames(_stream(rx, ld("c5_two.npy")))
    out["mesh_both"].update({"batch_" + k: v for k, v in batch.items()})
    rx = RefStreamRx(rspecs["c5"], mesh=mesh2d,
                     chunk_len=_ckpt_chunk(rspecs["c5"]))
    out["checkpoint"] = _frames(_stream(rx, ld("c5_twice.npy")))
    return out


def _frames(frames):
    return {"starts": np.array([f.start for f in frames], np.int64),
            "crc_ok": np.array([f.crc_ok for f in frames], bool),
            "payloads": np.array([np.asarray(f.payload) for f in frames],
                                 np.uint8),
            "eps": np.array([f.eps for f in frames], np.float64),
            "evm": np.array([f.evm_db for f in frames], np.float64)}


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of the four workers while this process writes nothing
    more but runs the one-process cases and the reference; then the
    workers' checkpoint loaded here."""
    import dataclasses
    from ofdm_uhd_tpu.core.spec import config as ref_config
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh
    from ofdm_uhd_tpu_torch.shard.mesh import make_stage_mesh
    torch.set_num_threads(2)
    root = str(tmp_path_factory.mktemp("axes"))
    rspecs = {"c1": ref_config("c1").with_(n_data_syms=4),
              "c2": ref_config("c2"),
              "c4": ref_config("c4").with_(n_data_syms=2),
              "c5": ref_config("c5")}
    # the port's specs are the reference's, field for field
    assert all(dataclasses.asdict(rspecs[k]) == dataclasses.asdict(v)
               for k, v in _specs().items())
    _write_inputs(root, rspecs)
    store = hosted_store(TIMEOUT_S)
    workers = _spawn(root, store.port)
    try:
        mesh2d = make_mesh(2, 4, ["cpu"] * 8)
        one = run_cases({"frame": make_mesh(4, 1, ["cpu"] * 4),
                         "stage": make_stage_mesh(2, ["cpu"] * 2),
                         "2d": mesh2d}, root,
                        os.path.join(root, "one_ckpt.npz"))
        _save(root, "one", one)
        ref = _reference(root, rspecs)
        _wait(workers)
    finally:
        for p in workers:
            if p.poll() is None:
                p.kill()
                p.communicate()
        del store
    resumed = {"one": resume(mesh2d, root, os.path.join(root,
                                                        "one_ckpt.npz")),
               "workers": resume(mesh2d, root, os.path.join(root,
                                                            "ckpt.npz"))}
    c5 = _specs()["c5"]
    whole = _frames(_stream(StreamRx(c5, mesh=mesh2d,
                                     chunk_len=_ckpt_chunk(c5)),
                            np.load(os.path.join(root, "c5_twice.npy"))))
    for k, res in resumed.items():
        _save(root, "resumed_" + k, {"checkpoint": res})
    cases = BATCH_CASES + STREAM_CASES
    return {
        "root": root, "ref": ref, "whole": whole,
        "one": {c: _load(os.path.join(root, f"{c}_one.npz")) for c in cases},
        "ranks": {c: [_load(os.path.join(root, f"{c}_r{r}.npz"))
                      for r in range(WORLD)] for c in cases},
        "resumed": {k: _load(os.path.join(root, f"checkpoint_resumed_{k}"
                                          ".npz")) for k in resumed},
        "checks": [json.load(open(os.path.join(root, f"checks_r{r}.json")))
                   for r in range(WORLD)]}


def _equal(got, want):
    """Every key of want in got, bit for bit, dtype and shape included."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert torch.equal(torch.from_numpy(got[k]),
                           torch.from_numpy(want[k])), k


@pytest.mark.parametrize("case", sorted(set(BATCH_CASES + STREAM_CASES)))
def test_every_rank_equals_one_process(runs, case):
    """Each rank's result is the one-process run's on the same virtual
    mesh: every key of the batch dicts (n_ok_global, mean_evm_global
    too), every stream frame, and the carried StreamState on every rank."""
    for got in runs["ranks"][case]:
        _equal(got, runs["one"][case])


def _close_batch(got, want, keys):
    for k in keys:
        g, w = got[k], want[k]
        if k in ("payload", "crc_ok", "n_ok_global"):
            np.testing.assert_array_equal(g, w)
        elif k in ("evm_db", "mean_evm_global"):
            assert np.abs(g - w).max() <= 0.01, k
        else:
            raise KeyError(k)


@pytest.mark.parametrize("case", ["frame", "mesh_frame"])
def test_frame_axis_equals_reference(runs, case):
    want = runs["ref"][case]
    pays = np.load(os.path.join(runs["root"], "c1_pays.npy" if case == "frame"
                                else "c1_pays6.npy"))
    for got in runs["ranks"][case]:
        _close_batch(got, want, ("payload", "crc_ok", "n_ok_global",
                                 "evm_db", "mean_evm_global"))
        np.testing.assert_array_equal(got["payload"], pays)
        assert int(got["n_ok_global"]) == len(pays)
        assert set(got) == set(want) | ({"tx"} if case == "frame" else set())
    if case == "frame":
        for got in runs["ranks"][case]:
            tx, ref_tx = got["tx"], want["tx"]
            assert tx.shape == ref_tx.shape
            assert np.abs(tx - ref_tx).max() <= 1e-5 * np.abs(ref_tx).max()


@pytest.mark.parametrize("case", ["stage_c2", "stage_c4"])
def test_stage_axis_equals_reference_and_fused(runs, case):
    """Stages on ranks 0 and 1; ranks 2 and 3 own no entry and return the
    outputs all the same. Equal to the reference within PERF.md §2's
    tolerances, and bit for bit to the port's fused rx_aligned."""
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline
    spec = _specs()[case[-2:]]
    name = case[-2:] + "_frames.npy"
    fused = RxPipeline(spec).rx_aligned(torch.from_numpy(np.load(
        os.path.join(runs["root"], name))))
    pays = np.load(os.path.join(runs["root"], case[-2:] + "_pays.npy"))
    for got in runs["ranks"][case]:
        assert set(got) == {"payload", "crc_ok", "evm_db"}
        _close_batch(got, runs["ref"][case], got)
        for k in got:
            assert torch.equal(torch.from_numpy(got[k]), fused[k]), k
        assert got["crc_ok"].all()
        np.testing.assert_array_equal(got["payload"], pays)


@pytest.mark.parametrize("case", ["mesh_stream", "mesh_both"])
def test_stream_on_2d_mesh_equals_reference(runs, case):
    """The stream on the (2, 4) mesh across four processes: the reference's
    frames (starts, crc_ok, payloads exactly; eps within 1e-5, EVM within
    0.01 dB), every sent frame decoded; the interleaved batch too."""
    want = runs["ref"][case]
    pays = np.load(os.path.join(runs["root"], "c5_pays.npy"
                                if case == "mesh_stream"
                                else "c5_two_pays.npy"))
    for got in runs["ranks"][case]:
        for k in ("starts", "crc_ok", "payloads"):
            np.testing.assert_array_equal(got[k], want[k])
        assert np.abs(got["eps"] - want["eps"]).max() <= 1e-5
        if case == "mesh_stream":
            assert np.abs(got["evm"] - want["evm"]).max() <= 0.01
        else:
            # noiseless frames: both at the float32 floor, not compared
            assert got["evm"].max() < -120 and want["evm"].max() < -120
        assert got["crc_ok"].all() and len(got["starts"]) == len(pays)
        np.testing.assert_array_equal(got["payloads"], pays)
        if case == "mesh_both":
            batch = {k[6:]: v for k, v in got.items()
                     if k.startswith("batch_")}
            ref = {k[6:]: v for k, v in want.items()
                   if k.startswith("batch_")}
            _close_batch(batch, ref, ("payload", "crc_ok", "n_ok_global",
                                      "evm_db", "mean_evm_global"))
            np.testing.assert_array_equal(batch["payload"], np.load(
                os.path.join(runs["root"], "c1_pays4.npy")))


def test_state_is_one_replica_on_every_rank(runs):
    """The carried StreamState of every stream case is bit-identical on
    all four ranks (two frame rows, each a replica)."""
    for case in STREAM_CASES:
        ranks = runs["ranks"][case]
        keys = [k for k in ranks[0] if k.startswith("state_")]
        assert "state_h_track" in keys and "state_frames" in keys
        for got in ranks[1:]:
            for k in keys:
                np.testing.assert_array_equal(got[k], ranks[0][k])


def test_reshard_and_checkpoint_on_2d_mesh(runs):
    """reshard=True on the (2, 4) mesh gives the plain stream's frames
    (starts, crc_ok, payloads; eps and EVM within the tolerances) and the
    reference's; the checkpoint rank 0 wrote on the (2, 4) mesh loads in
    one process and carries on to that process's own run's frames and
    state, bit for bit: to the frames of one uninterrupted run, and the
    reference's frames. Its feed takes two steps, the first before the
    cut, so the checkpoint carries a tracked channel."""
    base, ref = runs["one"]["mesh_stream"], runs["ref"]["mesh_stream"]
    for want in (base, ref):
        for got in runs["ranks"]["reshard"]:
            for k in ("starts", "crc_ok", "payloads"):
                np.testing.assert_array_equal(got[k], want[k])
            assert np.abs(got["eps"] - want["eps"]).max() <= 1e-5
            assert np.abs(got["evm"] - want["evm"]).max() <= 0.01
    one, workers = runs["resumed"]["one"], runs["resumed"]["workers"]
    _equal(workers, one)
    part = runs["ranks"]["checkpoint"][0]
    assert len(part["starts"]) and part["state_track_wt"] > 0
    keys = ("starts", "crc_ok", "payloads", "eps", "evm")
    joined = {k: np.concatenate([part[k], workers[k]]) for k in keys}
    for k in keys:
        np.testing.assert_array_equal(joined[k], runs["whole"][k])
    ref = runs["ref"]["checkpoint"]
    for k in ("starts", "crc_ok", "payloads"):
        np.testing.assert_array_equal(joined[k], ref[k])
    assert np.abs(joined["eps"] - ref["eps"]).max() <= 1e-5
    assert np.abs(joined["evm"] - ref["evm"]).max() <= 0.01


def test_mesh_ownership_and_the_layouts_that_raise(runs):
    """The meshes' ranks and row helpers on every rank; a frame row whose
    processes own unequal shares raises ValueError naming the layout, on
    every rank (none hangs)."""
    for r, c in enumerate(runs["checks"]):
        assert c["ranks"] == {"frame": [[0], [1], [2], [3]],
                              "stage": [0, 1],
                              "2d": [[0, 0, 1, 1], [2, 2, 3, 3]]}
        assert c["own_rows"] == [r // 2]
        assert c["row_ranks"] == [[0, 1], [2, 3]]
        assert "as many shards" in c["unequal_row"], c["unequal_row"]
        assert "[[0, 0, 1]]" in c["unequal_row"]


@pytest.mark.parametrize("devices, ok", [
    ([["cuda:0"]] * 4, False),                       # four ranks, one card
    ([["cuda:0"] * 2, ["cuda:1"] * 2] * 2, False),   # (2, 4) on two cards
    ([[f"cuda:{r}"] * 2 for r in range(4)], True),   # (2, 4), a card a rank
    ([[f"cuda:{r}"] for r in range(4)], True),       # (4, 1), a card a rank
])
def test_nccl_refuses_shared_cards_on_the_new_layouts(devices, ok):
    """The chip's layouts of the frame, stage and (2, 4) meshes: NCCL
    takes them one rank a card and refuses ranks that share one."""
    from ofdm_uhd_tpu_torch.shard.mesh import select_backend
    placements = [("host", d) for d in devices]
    if ok:
        assert select_backend(placements) == "nccl"
    else:
        with pytest.raises(ValueError, match="one rank a card"):
            select_backend(placements, "nccl")
        assert select_backend(placements, "gloo") == "gloo"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--root", required=True)
    sys.path.insert(0, REPO)
    worker(ap.parse_args())
    exit_worker()
