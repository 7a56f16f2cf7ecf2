"""The rank spawner of the port's distributed tests (tests/torch_ranks.py):
a failing or hung rank fails the test at once, and the message holds every
rank's exit code and the tail of its log."""

import time

import pytest

from tests import torch_ranks
from tests.test_torch_sharding import spawn

EXITS = r"""
import os, sys, time
rank, ready = int(sys.argv[1]), os.path.join(os.path.dirname(sys.argv[3]), "ready")
print(f"rank {rank} at the rendezvous", flush=True)
if rank == 0:
    open(ready, "w").close()
    time.sleep(60)  # a partner left waiting
while not os.path.exists(ready):  # rank 1 fails once rank 0 has logged
    time.sleep(0.01)
sys.exit(3)
"""

SLEEPS = r"""
import sys, time
print(f"rank {sys.argv[1]} before the sleep", flush=True)
time.sleep(60)
print("never printed")
"""

JOINS = r"""
import torch
import torch.distributed as dist
rank, world, (d,) = join_group()  # defined ahead of this source by tests/torch_ranks.py
x = torch.tensor([rank + 1.0])
dist.all_reduce(x)
open(f"{d}/sum_{rank}", "w").write(str(float(x)))
dist.destroy_process_group()
"""


def test_a_failing_rank_fails_the_spawn_at_once(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception) as e:
        spawn(EXITS, 2, [], tmp_path)
    assert time.monotonic() - t0 < 30  # not the 300 s budget
    msg = str(e.value)
    assert "rank 1 exited with code 3" in msg
    assert "--- rank 1: exit code 3;" in msg
    assert "--- rank 0: exit code -9 (killed here)" in msg
    for r in (0, 1):
        assert f"rank {r} at the rendezvous" in msg


def test_a_hung_rank_fails_at_the_deadline_with_its_partial_log(tmp_path, monkeypatch):
    monkeypatch.setattr(torch_ranks, "SPAWN_TIMEOUT_S", 5)
    t0 = time.monotonic()
    with pytest.raises(torch_ranks.RanksFailed) as e:
        torch_ranks.spawn(SLEEPS, 2, [], tmp_path)
    assert 5 <= time.monotonic() - t0 < 30
    msg = str(e.value)
    assert "timed out after 5 s" in msg
    for r in (0, 1):
        assert f"--- rank {r}: exit code -9 (killed here)" in msg
        assert f"rank {r} before the sleep" in msg
    assert "never printed" not in msg


def test_ranks_meet_at_the_file_rendezvous(tmp_path):
    spawn(JOINS, 2, [tmp_path], tmp_path)
    assert [(tmp_path / f"sum_{r}").read_text() for r in (0, 1)] == ["3.0", "3.0"]
    with pytest.raises(FileExistsError):  # a rendezvous file is never reused
        (tmp_path / "rdzv").touch()
        torch_ranks.spawn(JOINS, 2, [tmp_path], tmp_path)
