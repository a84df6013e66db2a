"""Scan Context retrieval of the port against the JAX package's, on the
fixtures of tests/test_scan_context.py: the same numpy clouds through both.
Descriptors are exact (one scatter-max); distances agree to 1e-5 (fp32 dot
products summed in another order); ``detect`` returns the same index and
the same shift."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.models import scan_context as jsc
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.models import scan_context as tsc

torch.set_num_threads(1)

ATOL = 1e-5


def _cloud(seed=0, n=20000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 10, n)
    return pts, np.ones((n,), bool)


def _desc(seed):
    pts, mask = _cloud(seed)
    return np.array(jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(mask),
                                        tiny_test_config().sc))


@pytest.fixture(scope="module")
def banks():
    """60 descriptors appended to both banks (tests/test_scan_context.py's
    detect fixture)."""
    cj, ct = tiny_test_config(), tiny_torch()
    K = cj.cap.max_keyframes
    bj, bt = jsc.init_bank(cj), tsc.init_bank(ct, "cpu")
    descs = []
    for i in range(60):
        pts, mask = _cloud(100 + i)
        dj = jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(mask), cj.sc)
        dt = tsc.make_descriptor(torch.from_numpy(pts),
                                 torch.from_numpy(mask), ct.sc)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        descs.append(np.array(dj))
        bj = jsc.append(bj, dj, K)
        bt = tsc.append(bt, dt, K, torch.tensor(True))
    return cj, ct, bj, bt, descs


def test_keys_match():
    """Means of 20 or 60 heights of up to 12 m: one fp32 ulp of the sum."""
    d = _desc(3)
    np.testing.assert_allclose(tsc.sector_key(torch.from_numpy(d)).numpy(),
                               np.asarray(jsc.sector_key(jnp.asarray(d))),
                               atol=ATOL)
    np.testing.assert_allclose(tsc.ring_key(torch.from_numpy(d)).numpy(),
                               np.asarray(jsc.ring_key(jnp.asarray(d))),
                               atol=ATOL)


@pytest.mark.parametrize("shift", [0, 13, 47])
def test_distance_all_shifts_matches(banks, shift):
    """A rolled copy of one descriptor against the whole bank: (K,S)
    distances within 1e-5, the known shift recovered by both."""
    _, _, bj, bt, descs = banks
    q = np.roll(descs[4], shift, axis=1)
    dj = np.asarray(jsc.distance_all_shifts(jnp.asarray(q), bj.desc))
    dt = tsc.distance_all_shifts(torch.from_numpy(q), bt.desc).numpy()
    assert dt.shape == dj.shape == (bt.desc.shape[0], descs[0].shape[1])
    np.testing.assert_allclose(dt, dj, atol=ATOL)
    assert int(dt[4].argmin()) == int(dj[4].argmin()) == shift
    assert abs(dt[4, shift]) < ATOL
    # Empty bank slots share no valid column with the query: the sentinel.
    assert (dt[60:] == 1e9).all() and (dj[60:] == 1e9).all()


def test_distance_skips_empty_columns():
    """Columns that are empty in either descriptor leave the mean."""
    a, b = _desc(5).copy(), _desc(6).copy()
    a[:, 7:19] = 0.0
    b[:, 30:33] = 0.0
    dj = np.asarray(jsc.distance_all_shifts(jnp.asarray(a),
                                            jnp.asarray(b)[None]))
    dt = tsc.distance_all_shifts(torch.from_numpy(a),
                                 torch.from_numpy(b)[None]).numpy()
    np.testing.assert_allclose(dt, dj, atol=ATOL)


@pytest.mark.parametrize("which,shift", [(2, 0), (2, 21), (7, 5), (55, 0)])
def test_detect_matches(banks, which, shift):
    """Same index, same shift (yaw), distance within 1e-5.  Keyframe 55 is
    inside the excluded recent window: both must return something else."""
    cj, ct, bj, bt, descs = banks
    q = np.roll(descs[which], shift, axis=1)
    ij, dj, yj = jsc.detect(cj, bj, jnp.asarray(q))
    it, dt, yt = tsc.detect(ct, bt, torch.from_numpy(q))
    assert it.dtype == torch.int64 and it.shape == ()
    assert int(it) == int(ij)
    assert abs(float(dt) - float(dj)) < ATOL
    assert float(yt) == pytest.approx(float(yj), abs=1e-6)
    if which < 10:
        assert int(it) == which
        assert round(float(yt) / (2 * np.pi / ct.sc.num_sector)) == shift
    else:
        assert int(it) != which


def test_detect_sentinel_when_nothing_eligible(banks):
    """Fewer keyframes than ``exclude_recent``: -1 from both, as a tensor
    that never indexes a bank."""
    cj, ct, _, _, descs = banks
    bj, bt = jsc.init_bank(cj), tsc.init_bank(ct, "cpu")
    for d in descs[:5]:
        bj = jsc.append(bj, jnp.asarray(d), cj.cap.max_keyframes)
        bt = tsc.append(bt, torch.from_numpy(d), ct.cap.max_keyframes,
                        torch.tensor(True))
    ij, _, _ = jsc.detect(cj, bj, jnp.asarray(descs[2]))
    it, _, _ = tsc.detect(ct, bt, torch.from_numpy(descs[2]))
    assert int(it) == int(ij) == -1
