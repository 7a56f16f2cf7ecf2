"""Gauss-Newton pose-graph optimization over relative-pose edges.

Port of ``sadvio_tpu/backend/posegraph.py``: the consumer of the edges that
``marginalize_relative`` and the loop closures archive.  Residuals are the
whitened relative-pose retraction errors; the normal system is assembled
with one ``torch.func.jacfwd`` over the stacked node deltas and solved
densely (M nodes -> 6M x 6M).  Node 0 is gauge-fixed.  The edge
bookkeeping (inflation, composition, compaction, packing) is host numpy in
float64, as in the JAX package; edges are matched to nodes by timestamp.
"""

from __future__ import annotations

import numpy as np
import torch

from sadvio_tpu_torch.backend import factors as F
from sadvio_tpu_torch.backend.marginalization import sqrt_psd
from sadvio_tpu_torch.utils import geometry as geo


def inflate_edge_info(inf, P_a, P_b, eps=1e-12):
    """Weight an edge by its endpoints' frame-rate pose covariance: edge
    covariance = edge covariance + P_a + P_b on the shared [omega, nu]
    chart, so a high-uncertainty keyframe yields a weaker edge."""
    inf = np.asarray(inf, np.float64)
    cov = np.linalg.pinv(0.5 * (inf + inf.T))
    cov = cov + np.asarray(P_a, np.float64) + np.asarray(P_b, np.float64)
    out = np.linalg.pinv(0.5 * (cov + cov.T) + eps * np.eye(6))
    return (0.5 * (out + out.T)).astype(np.float64)


def _np_so3_exp(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _np_so3_log(R):
    c = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-9:
        return np.zeros(3)
    if th > np.pi - 1e-3:
        # near pi the antisymmetric part vanishes: take the axis from the
        # symmetric part ((R+I)/2 -> a a^T at pi), the largest column.  The
        # sign of the axis is left as that column gives it, as in the JAX
        # package (at pi both signs name the same rotation).
        A = (R + np.eye(3)) / 2
        i = int(np.argmax(np.diag(A)))
        a = A[:, i] / max(np.sqrt(max(A[i, i], 0.0)), 1e-12)
        a = a / max(np.linalg.norm(a), 1e-12)
        return th * a
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * w


def relative_pose(R_a, t_a, R_b, t_b):
    """Measured retraction a -> b on the SO3 x R3 chart of the edges:
    [log(Ra^T Rb), Ra^T (tb - ta)], host float64."""
    R_a, R_b = np.asarray(R_a, np.float64), np.asarray(R_b, np.float64)
    return np.concatenate([_np_so3_log(R_a.T @ R_b),
                           R_a.T @ (np.asarray(t_b, np.float64) - np.asarray(t_a, np.float64))])


def compose_edge(dx_ab, inf_ab, dx_bc, inf_bc):
    """Compose consecutive edges a->b, b->c into one a->c.

    Measurement: T_ac = T_ab T_bc on the (omega, nu) chart.  Information:
    first-order covariance composition cov_ac = cov_ab + Ad_ab cov_bc
    Ad_ab^T with the SE(3) adjoint (correlations between the two edges are
    dropped, which is conservative)."""
    dx_ab = np.asarray(dx_ab, np.float64)
    dx_bc = np.asarray(dx_bc, np.float64)
    R_ab = _np_so3_exp(dx_ab[:3])
    R_bc = _np_so3_exp(dx_bc[:3])
    t_ab, t_bc = dx_ab[3:], dx_bc[3:]
    dx_ac = np.concatenate([_np_so3_log(R_ab @ R_bc), t_ab + R_ab @ t_bc])

    def cov_of(inf):
        inf = np.asarray(inf, np.float64)
        return np.linalg.pinv(0.5 * (inf + inf.T))

    tx = np.array([[0, -t_ab[2], t_ab[1]], [t_ab[2], 0, -t_ab[0]], [-t_ab[1], t_ab[0], 0]])
    Ad = np.zeros((6, 6))
    Ad[:3, :3] = R_ab
    Ad[3:, 3:] = R_ab
    Ad[3:, :3] = tx @ R_ab
    cov = cov_of(inf_ab) + Ad @ cov_of(inf_bc) @ Ad.T
    inf = np.linalg.pinv(0.5 * (cov + cov.T) + 1e-12 * np.eye(6))
    return dx_ac, 0.5 * (inf + inf.T)


def compact_archive(nodes, edges, keep_last):
    """Bound the archived pose graph: remove the oldest chain-interior nodes
    until len(nodes) <= keep_last, composing each removed node's two
    incident chain edges into one.

    Never removed: node 0 (gauge anchor), the newest node, and any endpoint
    of a non-chain (loop-closure or cross-gap) edge, so the cap is soft when
    many closures exist.  A removed node that has only its left chain edge
    takes that edge with it, as in the JAX package.

    Returns (nodes, edges, remap): remap (old_len,) int32 maps old archive
    indices to new ones (a removed node maps to its surviving left
    neighbour); apply it to stored provenance such as GlobalMap.src."""
    n_old = len(nodes)
    if n_old <= keep_last:
        return nodes, edges, np.arange(n_old, dtype=np.int32)
    pos = {}
    for i, (ts, _, _) in enumerate(nodes):
        pos.setdefault(float(ts), i)
    chain = {}  # left-node ts -> edge spanning (pos p, pos p+1)
    other = []  # loop edges + edges naming unknown or duplicate nodes
    protected = set()
    for e in edges:
        i, j = pos.get(float(e[0])), pos.get(float(e[1]))
        if i is not None and j == i + 1 and float(e[0]) not in chain:
            chain[float(e[0])] = e
        else:
            other.append(e)
            protected |= {float(e[0]), float(e[1])}
    order = [float(ts) for ts, _, _ in nodes]
    keep = [True] * n_old
    removed = 0
    k = 1
    while removed < n_old - keep_last and k < n_old - 1:
        ts_b = order[k]
        if ts_b in protected:
            k += 1
            continue
        a = k - 1
        while a > 0 and not keep[a]:
            a -= 1
        ts_a = order[a]
        e_ab = chain.pop(ts_a, None)
        e_bc = chain.pop(ts_b, None)
        if e_ab is not None and e_bc is not None:
            dx, inf = compose_edge(e_ab[2], e_ab[3], e_bc[2], e_bc[3])
            chain[ts_a] = (e_ab[0], e_bc[1], dx, inf)
        keep[k] = False
        removed += 1
        k += 1
    new_nodes = [nodes[i] for i in range(n_old) if keep[i]]
    new_edges = list(chain.values()) + other
    remap = np.zeros((n_old,), np.int32)
    new_i = 0
    prev_surv = 0
    for i in range(n_old):
        if keep[i]:
            remap[i] = new_i
            prev_surv = new_i
            new_i += 1
        else:
            remap[i] = prev_surv
    return new_nodes, new_edges, remap


def optimize_pose_graph(R, t, node_mask, ea, eb, dx, sqrt_inf, edge_mask, iters: int = 10,
                        damping: float = 1e-6):
    """Gauss-Newton over SE(3) nodes with relative-pose edges.

    R (M,3,3), t (M,3): initial node poses (world-from-body).  ea/eb (E,)
    int: edge endpoints; dx (E,6): measured retraction a->b; sqrt_inf
    (E,6,6): whitening.  Node 0 is held fixed (gauge).  Returns (R, t,
    cost at the last linearization)."""
    M = R.shape[0]
    dev, dt_ = t.device, t.dtype
    ea, eb = ea.long(), eb.long()
    # nodes no live edge touches cannot be corrected; left free they would
    # put damping-scale diagonal blocks beside edge-information blocks in
    # one H.  They are clamped like the gauge node.
    touched = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    touched[torch.where(edge_mask, ea, M)] = True
    touched[torch.where(edge_mask, eb, M)] = True
    free = node_mask & (torch.arange(M, device=dev) > 0) & touched[:M]
    fixed = ~free.repeat_interleave(6)
    eye = torch.eye(M * 6, dtype=dt_, device=dev)
    cost = torch.zeros((), dtype=dt_, device=dev)
    if ea.numel() == 0:
        return R, t, cost

    def residuals(dz, Rc, tc):
        d = dz.reshape(M, 6) * free[:, None]
        Rn, tn = geo.pose_retract(Rc, tc, d)
        r = F.relative_pose_residual(Rn[ea], tn[ea], Rn[eb], tn[eb], dx, sqrt_inf)
        return torch.where(edge_mask[:, None], r, torch.zeros_like(r)).reshape(-1)

    z0 = torch.zeros(M * 6, dtype=dt_, device=dev)
    for _ in range(iters):
        J = torch.func.jacfwd(residuals)(z0, R, t)
        r = residuals(z0, R, t)
        H = J.T @ J + damping * eye
        H = torch.where(fixed[:, None] | fixed[None, :], eye, H)
        g = torch.where(fixed, torch.zeros_like(z0), J.T @ r)
        dz = -torch.linalg.solve(H, g)
        R, t = geo.pose_retract(R, t, dz.reshape(M, 6) * free[:, None])
        cost = (r * r).sum()
    return R, t, cost


def edges_from_archive(pose_graph_edges, kf_ts, dtype=torch.float32, device=None):
    """Pack a list of (ts0, ts1, dx (6,), inf (6,6)) edges into
    optimize_pose_graph inputs; kf_ts are the node timestamps in archive
    order.  Edges naming a timestamp absent from kf_ts are dropped.
    Returns (ea, eb, dx, sqrt_inf, mask)."""
    # the FIRST occurrence of a timestamp wins: a keyframe that is both an
    # archived node and still in the live window anchors its loop-closure
    # edges at the archived copy
    idx = {}
    for i, ts in enumerate(kf_ts):
        idx.setdefault(float(ts), i)
    ea, eb, dxs, infs = [], [], [], []
    for ts0, ts1, d, inf in pose_graph_edges:
        if float(ts0) in idx and float(ts1) in idx:
            ea.append(idx[float(ts0)])
            eb.append(idx[float(ts1)])
            dxs.append(np.asarray(d, np.float32))
            infs.append(np.asarray(inf, np.float32))
    if not ea:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return (z, z, torch.zeros((0, 6), dtype=dtype, device=device),
                torch.zeros((0, 6, 6), dtype=dtype, device=device),
                torch.zeros(0, dtype=torch.bool, device=device))
    W = sqrt_psd(torch.as_tensor(np.stack(infs), dtype=dtype, device=device))
    return (torch.as_tensor(ea, device=device), torch.as_tensor(eb, device=device),
            torch.as_tensor(np.stack(dxs), dtype=dtype, device=device), W,
            torch.ones(len(ea), dtype=torch.bool, device=device))
