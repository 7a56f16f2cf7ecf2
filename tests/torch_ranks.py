"""Start the port's ``torch.distributed`` ranks as processes on this machine.

The ranks meet at a file rendezvous (``init_method="file://..."``, a
``FileStore`` in the caller's own directory): no TCP port is picked, freed
and bound again later, so no other socket can take it in between.  Each rank
writes its output to its own log file; all ranks are polled against one
deadline, and as soon as one exits non-zero the others are killed.  A
failure, or the deadline, raises ``RanksFailed`` with every rank's exit code
and the tail of its log.

A worker is a Python source run as ``python -c worker rank world rdzv *args``
from the repository root, with ``join_group`` defined ahead of it (so no
worker imports this file: a site package named ``tests`` can shadow the
repository's test folder).  It joins the group with

    rank, world, (d,) = join_group()

Used by the port's distributed tests and by ``chip_smoke.py``'s parallel
phase.  Imports nothing of torch until a rank joins.
"""

import inspect
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 300  # the whole spawn, from start to the last rank's exit
# init_process_group's timeout: the rendezvous and every collective; well
# under SPAWN_TIMEOUT_S, so a partner that never arrives raises in the rank
# with a message instead of being killed silently at the deadline
RDZV_TIMEOUT_S = 120
LOG_TAIL_BYTES = 3000
POLL_S = 0.05


class RanksFailed(RuntimeError):
    """A rank exited non-zero, or the ranks outlived their deadline."""


def join_group():
    """In a spawned rank: join the process group the spawner set up.
    Returns (rank, world size, the worker's own arguments).  ``spawn``
    puts this source ahead of each worker's, so it imports what it uses."""
    import datetime
    import sys

    import torch.distributed as dist

    rank, world, rdzv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RDZV_TIMEOUT_S))
    return rank, world, sys.argv[4:]


def _tail(path):
    with open(path, "rb") as fh:
        fh.seek(max(0, os.path.getsize(path) - LOG_TAIL_BYTES))
        return fh.read().decode(errors="replace")


def spawn(worker, n, args, workdir):
    """Run ``worker`` in n processes, rank r logging to ``workdir/rank_r.log``
    and the group meeting at ``workdir/rdzv`` (which must not exist yet).
    Returns when every rank has exited 0; raises ``RanksFailed`` when one
    exits non-zero (the others are killed at once) or SPAWN_TIMEOUT_S after
    the start."""
    workdir = os.fspath(workdir)
    rdzv = os.path.join(workdir, "rdzv")
    if os.path.exists(rdzv):
        raise FileExistsError(f"{rdzv}: a rendezvous file is used once")
    env = dict(os.environ, PYTHONPATH=REPO)
    source = f"RDZV_TIMEOUT_S = {RDZV_TIMEOUT_S}\n{inspect.getsource(join_group)}\n{worker}"
    logs = [os.path.join(workdir, f"rank_{r}.log") for r in range(n)]
    procs = []
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    why = None
    try:
        for r, log in enumerate(logs):
            with open(log, "wb") as fh:
                # -X faulthandler: a rank killed by a signal (an abort in
                # native code) leaves every thread's Python stack in its log
                procs.append(subprocess.Popen(
                    [sys.executable, "-X", "faulthandler", "-c", source, str(r), str(n), rdzv,
                     *map(str, args)],
                    stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=REPO))
        while why is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                why = f"rank {bad[0]} exited with code {codes[bad[0]]}"
            elif all(c == 0 for c in codes):
                return
            elif time.monotonic() > deadline:
                why = f"timed out after {SPAWN_TIMEOUT_S} s"
            else:
                time.sleep(POLL_S)
    finally:
        alive = [p for p in procs if p.poll() is None]
        for p in alive:
            p.kill()
        for p in procs:
            p.wait()
    report = [f"{n} spawned ranks failed: {why}"]
    for r, (p, log) in enumerate(zip(procs, logs)):
        state = f"exit code {p.returncode}" + (" (killed here)" if p in alive else "")
        report.append(f"--- rank {r}: {state}; last {LOG_TAIL_BYTES} bytes of {log}:\n"
                      f"{_tail(log)}")
    raise RanksFailed("\n".join(report))
