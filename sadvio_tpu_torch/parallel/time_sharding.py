"""IMU preintegration sharded along time over a ``torch.distributed`` mesh.

Port of ``sadvio_tpu/parallel/time_sharding.py``.  Preintegration is a
monoid: each rank reduces its N/D chunk of the sample stream to a
``ChunkSummary`` (``models/imu.py:chunk_summary``, log-depth scans), the D
summaries (a few hundred bytes each) are gathered in one collective and
folded in rank order with ``combine_summary``.  Communication is D small
states per interval whatever the sample count.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sadvio_tpu_torch.models import imu as imu_mod
from sadvio_tpu_torch.parallel.sharding import all_reduce, device_mesh
from sadvio_tpu_torch.utils.struct import tree_leaves, tree_map, tree_unflatten


def make_time_mesh(n_devices=None) -> DeviceMesh:
    """1-D mesh whose axis ``t`` shards the IMU sample stream."""
    return device_mesh((n_devices or dist.get_world_size(),), ("t",))


def preintegrate_time_sharded(acc, gyr, dt, ba, bg, params: imu_mod.ImuParams,
                              mesh: DeviceMesh) -> imu_mod.Preintegration:
    """``imu.preintegrate`` over a time-sharded mesh.  Every rank passes the
    whole buffer (acc, gyr (N,3), dt (N,), N divisible by the mesh size;
    padding samples have dt == 0) and gets the same result."""
    n_dev = mesh.size()
    n = acc.shape[0]
    if n % n_dev:
        raise ValueError(f"sample count {n} not divisible by mesh size {n_dev}")
    chunk = n // n_dev
    lo = mesh.get_local_rank("t") * chunk
    s = imu_mod.chunk_summary(acc[lo:lo + chunk], gyr[lo:lo + chunk], dt[lo:lo + chunk],
                              ba, bg, params)
    _, rows = all_reduce([], [x[None] for x in tree_leaves(s)], mesh.get_group("t"))
    gathered = tree_unflatten(s, rows)  # (D, ...) per-chunk summaries in rank order
    total = tree_map(lambda x: x[0], gathered)
    for d in range(1, n_dev):
        total = imu_mod.combine_summary(total, tree_map(lambda x, d=d: x[d], gathered))
    return imu_mod.summary_to_preintegration(total, ba, bg)
