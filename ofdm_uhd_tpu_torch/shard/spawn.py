"""Process groups of worker processes that one parent process starts on
its own host, and the workers' exit: the spawns of the tests and of
chip_smoke.py.

Two rendezvous, both torch.distributed's own:

- hosted: the parent serves the group's TCPStore (`hosted_store`) on a
  port the OS picks for it and holds until the workers have exited, and
  every rank joins it as a client: `worker_env(agent_store=True)` sets
  TORCHELASTIC_USE_AGENT_STORE, under which the tcp:// and env://
  rendezvous make every rank a client of the store at the given address,
  as torchrun's agent hosts its ranks' store. No port is chosen, released
  and bound again later, time in which another process could take it.
- rank 0's: rank 0 serves the store, as a launch by hand with MASTER_PORT
  set does (`worker_env(agent_store=False)`). Its port (`rank0_port`) is
  one below Linux's default ephemeral range (32768-60999), which bind(0)
  and outgoing connections never hand out, so between its choice and
  rank 0's bind only a process that asks for that very number could take
  it.

A worker whose results are written ends by `exit_worker`, without the
interpreter's teardown: in a process that had held a gloo group, torch's
C++ teardown at exit aborted about one worker in thirty under load
(SIGABRT, "terminate called without an active exception", with no Python
frame left), after every result file was written, whichever rank it was
and whether or not it served the store. `cli.pod_rx` and
`harness.pod` end the same way when run as programs."""

from __future__ import annotations

import datetime
import os
import random
import socket
import sys

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK")
RANK0_PORTS = range(24000, 32000)   # below the default ephemeral range


def hosted_store(timeout_s: float):
    """A store served by this process on 127.0.0.1 at a port of the OS's
    choosing (its `port`). Drop the last reference once every worker of
    its spawn has exited."""
    import torch.distributed as dist
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def rank0_port() -> int:
    """A port of RANK0_PORTS that binds on 127.0.0.1 now, for a group whose
    rank 0 serves the store; the search starts at a random port."""
    start = random.randrange(len(RANK0_PORTS))
    for i in range(len(RANK0_PORTS)):
        port = RANK0_PORTS[(start + i) % len(RANK0_PORTS)]
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {RANK0_PORTS}")


def worker_env(repo: str, agent_store: bool = True, threads: int | None = 1,
               **extra) -> dict:
    """A worker's environment: this one without torchrun's variables, the
    repository on PYTHONPATH, `threads` OpenMP threads (None: as this
    process has it), under agent_store every rank a client of a hosted
    store, and `extra`."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env.pop("TORCHELASTIC_USE_AGENT_STORE", None)
    env["PYTHONPATH"] = repo
    if agent_store:
        env["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    return dict(env, **extra)


def exit_worker(rc: int = 0) -> None:
    """Exit with rc at once, once the worker's results are written and its
    group destroyed: its output flushed, no interpreter teardown."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
