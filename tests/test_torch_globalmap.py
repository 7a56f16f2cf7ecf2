"""Global-map archive ring and resurrection of the port against the JAX
package, on the same numpy inputs, and ``from_numpy`` for the map.

Tolerances: ring slots, masks, cursor and provenance identical; archived
positions bit-equal (they are copies); resurrection hits, positions and
provenance identical (descriptor distances are integers; the fixtures keep
the best distances untied).  Where two archive rows claim one detection the
port keeps the row of smallest distance, the lower row on a tie: tested on
the port alone, since the JAX package's scatter leaves that case to the
backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.data import globalmap as jgm
from sadvio_tpu.models import cameras as jcam
from sadvio_tpu_torch.data import globalmap as tgm
from sadvio_tpu_torch.data.convert import from_numpy, unpack_descriptors
from sadvio_tpu_torch.models import cameras as tcam

torch.set_num_threads(2)

T = lambda x: torch.as_tensor(np.array(x))


def _words(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _same_map(gt, gj):
    np.testing.assert_array_equal(gt.mask.numpy(), np.asarray(gj.mask))
    assert int(gt.head) == int(gj.head)
    m = np.asarray(gj.mask)
    np.testing.assert_array_equal(gt.pos.numpy()[m], np.asarray(gj.pos)[m])
    np.testing.assert_array_equal(gt.src.numpy()[m], np.asarray(gj.src)[m])
    np.testing.assert_array_equal(gt.desc.numpy()[m],
                                  unpack_descriptors(np.asarray(gj.desc)).numpy()[m])


@pytest.mark.parametrize("capacity", [8, 16])
def test_archive_ring_identical(rng, capacity):
    gj = jgm.GlobalMap.create(capacity)
    gt = tgm.GlobalMap.create(capacity, device="cpu")
    assert gt.capacity == capacity and gt.desc.dtype == torch.bool
    for k in range(5):  # wraps the ring more than once
        pos = rng.standard_normal((5, 3)).astype(np.float32)
        words = _words(rng, 5)
        alive = rng.uniform(size=5) > 0.3
        src = None if k == 0 else k
        gj = jgm.archive(gj, jnp.asarray(pos), jnp.asarray(words), jnp.asarray(alive),
                         src_idx=None if src is None else jnp.int32(src))
        gt = tgm.archive(gt, T(pos), unpack_descriptors(words), T(alive), src_idx=src)
        _same_map(gt, gj)


def test_archive_refuses_more_rows_than_slots(rng):
    gt = tgm.GlobalMap.create(4, device="cpu")
    with pytest.raises(ValueError):
        tgm.archive(gt, torch.zeros((5, 3)), torch.zeros((5, 256), dtype=torch.bool),
                    torch.ones(5, dtype=torch.bool))


def _scene(rng, L=40):
    pts = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(4, 8, L)],
                   -1).astype(np.float32)
    words = _words(rng, L)
    return pts, words


@pytest.mark.parametrize("search_px,jitter", [(12.0, 1.0), (25.0, 6.0)])
def test_resurrection_identical(rng, search_px, jitter):
    pts, words = _scene(rng)
    L = len(pts)
    camj = jcam.make_pinhole(200.0, 200.0, 160.0, 120.0, 320, 240)
    camt = tcam.make_pinhole(200.0, 200.0, 160.0, 120.0, 320, 240, device="cpu")
    gj = jgm.archive(jgm.GlobalMap.create(64), jnp.asarray(pts), jnp.asarray(words),
                     jnp.ones(L, bool), src_idx=jnp.int32(3))
    gt = from_numpy(jax.tree.map(np.asarray, gj))
    _same_map(gt, gj)
    uv = np.asarray(jcam.project_world(camj, jnp.eye(3), jnp.zeros(3), jnp.eye(3), jnp.zeros(3),
                                       jnp.asarray(pts))[0])
    n_det = 24
    det_uv = (uv[:n_det] + rng.uniform(-jitter, jitter, (n_det, 2))).astype(np.float32)
    det_words = words[:n_det].copy()
    det_words[16:] = _words(rng, n_det - 16)  # unknown descriptors must not resurrect
    det_valid = np.ones(n_det, bool)
    det_valid[3] = False
    eye, z = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    lj, hj, sj = jgm.resurrect(gj, camj, jnp.eye(3), jnp.zeros(3), jnp.eye(3), jnp.zeros(3),
                               jnp.asarray(det_uv), jnp.asarray(det_words),
                               jnp.asarray(det_valid), search_px=search_px)
    lt, ht, st = tgm.resurrect(gt, camt, T(eye), T(z), T(eye), T(z), T(det_uv),
                               unpack_descriptors(det_words), T(det_valid), search_px=search_px)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert 10 <= ht[:16].sum() and not ht[3] and ht[16:].sum() <= 1
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy()[ht.numpy()] == 3).all() and (st.numpy()[~ht.numpy()] == -1).all()


def test_resurrect_duplicate_claims_keep_the_closest_row(monkeypatch):
    """Two archive rows matched to one detection: the smaller distance wins,
    the lower row on a tie, whatever order a scatter would apply them in."""
    gm = tgm.GlobalMap.create(6, device="cpu")
    pos = torch.arange(18, dtype=torch.float32).reshape(6, 3) + 10.0
    gm = gm.replace(pos=pos, mask=torch.ones(6, dtype=torch.bool),
                    src=torch.arange(6))
    idx = torch.tensor([2, 0, 2, -1, 0, 1])
    dist = torch.tensor([9.0, 4.0, 5.0, 0.0, 4.0, 7.0])
    monkeypatch.setattr(tgm.match_mod, "match", lambda *a, **k: (idx, dist))
    cam = tcam.make_pinhole(200.0, 200.0, 160.0, 120.0, 320, 240, device="cpu")
    lmk, hit, src = tgm.resurrect(gm, cam, torch.eye(3), torch.zeros(3), torch.eye(3),
                                  torch.zeros(3), torch.zeros((4, 2)),
                                  torch.zeros((4, 256), dtype=torch.bool),
                                  torch.ones(4, dtype=torch.bool))
    assert hit.tolist() == [True, True, True, False]
    assert src.tolist() == [1, 5, 2, -1]  # det 0: rows 1 and 4 tie at 4 -> row 1; det 2: row 2
    np.testing.assert_array_equal(lmk[:3].numpy(), pos[[1, 5, 2]].numpy())
    assert float(lmk[3].abs().max()) == 0.0


def test_from_numpy_carries_the_map(rng):
    pts, words = _scene(rng, 10)
    gj = jgm.archive(jgm.GlobalMap.create(16), jnp.asarray(pts), jnp.asarray(words),
                     jnp.ones(10, bool), src_idx=jnp.int32(7))
    gt = from_numpy(jax.tree.map(np.asarray, gj), "cpu")
    assert isinstance(gt, tgm.GlobalMap)
    assert gt.head.dtype == torch.int64 and gt.src.dtype == torch.int64
    assert tuple(gt.desc.shape) == (16, 256)
    _same_map(gt, gj)
