"""BRIEF descriptors, the window sampler's flags and the descriptor matcher
of the port against the JAX package, on the same numpy inputs.

Tolerances, with reasons:
* the sampling-pair table is drawn from the same numpy generator: equal;
* descriptors: a bit flips where its two samples are nearly equal (the JAX
  package samples through a one-hot contraction, the port through gathers),
  so parity is stated in Hamming distance: at most 2 of 256 bits apart on
  at least 98% of the features;
* ``window_sample``: flags identical, values to 1e-3 of a 0..255 image;
* ``hamming``: exact (integers below 2^24 in float32);
* ``match``: the same index wherever the row's best distance is untied;
  where it is tied, the port takes the lowest index by its stated rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.frontend import detect as jdet, match as jmatch
from sadvio_tpu_torch.data.convert import unpack_descriptors
from sadvio_tpu_torch.frontend import detect as tdet, match as tmatch

torch.set_num_threads(2)


def _image(rng, H=120, W=160):
    """Smooth random texture in 0..255."""
    img = rng.uniform(0, 255, (H // 4, W // 4)).astype(np.float32)
    img = np.kron(img, np.ones((4, 4), np.float32))
    return np.asarray(jdet.smooth3(jdet.smooth3(jnp.asarray(img))))


def _pack(bits):
    """(N,256) bool -> (N,8) uint32 as the JAX package packs them."""
    return np.packbits(bits, axis=1, bitorder="little").view("<u4").astype(np.uint32)


def test_brief_pair_table_equal():
    np.testing.assert_array_equal(np.asarray(jdet._BRIEF), tdet._BRIEF)
    assert tdet.DESC_BITS == 256


def test_unpack_descriptors_bit_order(rng):
    bits = rng.integers(0, 2, (9, 256)).astype(bool)
    weights = (1 << np.arange(32, dtype=np.uint64))
    words = (bits.reshape(9, 8, 32) * weights).sum(-1).astype(np.uint32)
    np.testing.assert_array_equal(unpack_descriptors(words).numpy(), bits)
    np.testing.assert_array_equal(_pack(bits), words)


def test_brief_descriptors_within_two_bits(rng):
    img = _image(rng)
    uv = np.stack([rng.uniform(0, 160, 300), rng.uniform(0, 120, 300)], -1).astype(np.float32)
    uv[:40] = np.round(uv[:40])  # integer detections, as the detector gives them
    dj = unpack_descriptors(np.asarray(jdet.brief_describe(jnp.asarray(img), jnp.asarray(uv))))
    dt = tdet.brief_describe(torch.as_tensor(img), torch.as_tensor(uv))
    assert dt.dtype == torch.bool and tuple(dt.shape) == (300, 256)
    apart = (dj != dt).sum(1).numpy()
    assert (apart <= 2).mean() >= 0.98, np.sort(apart)[-10:]
    assert 0.3 < dt.float().mean() < 0.7  # descriptors carry information


@pytest.mark.parametrize("ws", [18, 32, 48])
def test_window_sample_flags_and_values(rng, ws):
    img = _image(rng)
    N, S = 64, 50
    c = np.stack([rng.uniform(-10, 170, N), rng.uniform(-10, 130, N)], -1).astype(np.float32)
    pts = (c[:, None, :] + rng.uniform(-0.8 * ws, 0.8 * ws, (N, S, 2))).astype(np.float32)
    c[0] = np.nan
    pts[1, 0] = np.inf
    vj, fj = jdet.window_sample(jnp.asarray(img), jnp.asarray(c), jnp.asarray(pts), ws=ws)
    vt, ft = tdet.window_sample(torch.as_tensor(img), torch.as_tensor(c), torch.as_tensor(pts), ws)
    fj = np.asarray(fj)
    assert 0.1 < fj.mean() < 0.95  # both verdicts occur
    fin = np.isfinite(pts).all(-1)
    np.testing.assert_array_equal(ft.numpy()[fin], fj[fin])
    assert not ft.numpy()[~fin].any()
    np.testing.assert_allclose(vt.numpy()[fj], np.asarray(vj)[fj], atol=1e-3)


def test_hamming_exact(rng):
    a = rng.integers(0, 2, (40, 256)).astype(bool)
    b = rng.integers(0, 2, (70, 256)).astype(bool)
    hj = np.asarray(jmatch.hamming(jnp.asarray(_pack(a)), jnp.asarray(_pack(b))))
    ht = tmatch.hamming(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(ht, (a[:, None] != b[None]).sum(-1))


def _match_case(rng, Na=80, Nb=120, flip=20):
    """Set B holds noisy copies of A's descriptors near A's predictions."""
    a = rng.integers(0, 2, (Na, 256)).astype(bool)
    b = rng.integers(0, 2, (Nb, 256)).astype(bool)
    b[:Na] = a ^ (rng.uniform(size=(Na, 256)) < flip / 256.0)
    uv_a = np.stack([rng.uniform(0, 320, Na), rng.uniform(0, 240, Na)], -1).astype(np.float32)
    uv_b = np.stack([rng.uniform(0, 320, Nb), rng.uniform(0, 240, Nb)], -1).astype(np.float32)
    uv_b[:Na] = uv_a + rng.uniform(-8, 8, (Na, 2)).astype(np.float32)
    va = rng.uniform(size=Na) > 0.1
    vb = rng.uniform(size=Nb) > 0.1
    return a, uv_a, va, b, uv_b, vb


@pytest.mark.parametrize("radius,ratio,max_dist", [(60.0, 0.9, 80.0), (12.0, 0.9, 60.0),
                                                   (30.0, 0.7, 40.0)])
def test_match_indices_equal_where_untied(rng, radius, ratio, max_dist):
    a, uv_a, va, b, uv_b, vb = _match_case(rng)
    ij, dj = jmatch.match(jnp.asarray(_pack(a)), jnp.asarray(uv_a), jnp.asarray(va),
                          jnp.asarray(_pack(b)), jnp.asarray(uv_b), jnp.asarray(vb),
                          search_radius=radius, ratio=ratio, max_dist=max_dist)
    it, dt = tmatch.match(*[torch.as_tensor(x) for x in (a, uv_a, va, b, uv_b, vb)],
                          search_radius=radius, ratio=ratio, max_dist=max_dist)
    assert it.dtype == torch.int64
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # rows whose best distance is reached once, in their row and in the column of the match
    d = (a[:, None] != b[None]).sum(-1).astype(np.float32)
    gate = (((uv_a[:, None] - uv_b[None]) ** 2).sum(-1) < radius * radius) & va[:, None] & vb[None]
    d = np.where(gate, d, 1e9)
    untied = (d == d.min(1, keepdims=True)).sum(1) == 1
    col = d[:, d.argmin(1)]
    untied &= (col == col.min(0, keepdims=True)).sum(0) == 1
    assert untied.sum() > 40
    np.testing.assert_array_equal(it.numpy()[untied], np.asarray(ij)[untied])
    assert (np.asarray(ij) >= 0).sum() > 30  # real matches were made
    assert (it.numpy()[~va] == -1).all()


def test_match_tie_rule_lowest_index():
    """Two identical candidates: the ratio test rejects the row either way,
    and first_argmin names the lower index on any device."""
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, 5.0, 0.0]])
    idx, val = tmatch.first_argmin(x, 1)
    assert idx.tolist() == [1, 0] and val.tolist() == [1.0, 0.0]
    idx0, _ = tmatch.first_argmin(x, 0)
    assert idx0.tolist() == [1, 1, 0, 1]
    a = torch.zeros((1, 256), dtype=torch.bool)
    b = torch.zeros((2, 256), dtype=torch.bool)
    uv = torch.zeros((1, 2))
    it, _ = tmatch.match(a, uv, torch.ones(1, dtype=torch.bool), b, torch.zeros((2, 2)),
                         torch.ones(2, dtype=torch.bool))
    assert it.tolist() == [-1]


def test_match_zncc_equal(rng):
    Na, Nb, S = 40, 60, 49
    pa = rng.standard_normal((Na, S)).astype(np.float32)
    pb = rng.standard_normal((Nb, S)).astype(np.float32)
    pb[:Na] = pa + 0.2 * rng.standard_normal((Na, S)).astype(np.float32)
    nrm = lambda p: (p - p.mean(1, keepdims=True)) / np.linalg.norm(p - p.mean(1, keepdims=True),
                                                                    axis=1, keepdims=True)
    pa, pb = nrm(pa), nrm(pb)
    uv_a = rng.uniform(0, 200, (Na, 2)).astype(np.float32)
    uv_b = rng.uniform(0, 200, (Nb, 2)).astype(np.float32)
    uv_b[:Na] = uv_a + 3.0
    va, vb = np.ones(Na, bool), np.ones(Nb, bool)
    ij, sj = jmatch.match_zncc(*[jnp.asarray(x) for x in (pa, va, pb, vb, uv_a, uv_b)])
    it, st = tmatch.match_zncc(*[torch.as_tensor(x) for x in (pa, va, pb, vb, uv_a, uv_b)])
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    assert (it.numpy() >= 0).sum() > 30
