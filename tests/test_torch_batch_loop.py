"""One batched loop tick of the port's ``BatchEngine`` against the JAX
``BatchEngine._batch_loop`` from one hand-made state of two sequences:
sequence 0 has a loop candidate that its ICP accepts, sequence 1 has none.
The port runs the detectors and the verification under ``torch.func.vmap``
(the ICP's kNN through its custom op), reads the verdicts once, and
re-solves with ``posegraph.solve_batched``; the sequence without a
candidate must come out bit-identical, as under the JAX select."""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import mapping as jmapping, posegraph as jpg
from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.models import scan_context as jsc
from sc_lego_loam_tpu.parallel import batch as jb
from sc_lego_loam_tpu.utils import synthetic
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.parallel import batch as tb
from sc_lego_loam_tpu_torch.utils import convert

from torch_keyframes import circle, loop_cfg, sequence, twist

torch.set_num_threads(1)


def _state(cfg):
    """Sequence 0: eight keyframes round a 4 m circle, the last standing
    where the first stood with its stored pose drifted.  Sequence 1: three
    keyframes 0.1 s apart, too few and too recent for either detector."""
    world = synthetic.default_world(seed=3)
    rng = np.random.default_rng(4)
    gt0 = circle(8)
    est0 = gt0.copy()
    est0[-1] = est0[-1] @ twist([0, 0, 0.02, 0.15, -0.1, 0])
    gt1 = np.stack([np.eye(4, dtype=np.float32)] * 3)
    gt1[:, 0, 3], gt1[:, 2, 3] = [20.0, 20.4, 20.8], 2.0
    kf0, bank0 = sequence(cfg, world, gt0, est0,
                          np.arange(8, dtype=np.float32), rng)
    kf1, bank1 = sequence(cfg, world, gt1, gt1, np.float32([0, 0.1, 0.2]),
                          rng)
    L = cfg.posegraph.max_loops
    last = np.stack([est0[-1], gt1[-1]])
    eye = np.eye(4, dtype=np.float32)
    return types.SimpleNamespace(
        kf={k: np.stack([kf0[k], kf1[k]]) for k in kf0},
        bank={k: np.stack([bank0[k], bank1[k]]) for k in bank0},
        loops=dict(i=np.zeros((2, L), np.int32), j=np.zeros((2, L), np.int32),
                   z=np.broadcast_to(eye, (2, L, 4, 4)).copy(),
                   count=np.zeros(2, np.int32)),
        pose=last, correction=np.stack([eye] * 2), last_kf_pose=last,
        last_kf_odom=last.copy())


@pytest.fixture(scope="module")
def ticks():
    cfg_j, cfg_t = loop_cfg(tiny_test_config), loop_cfg(tiny_torch)
    st = _state(cfg_j)
    jeng = jb.BatchEngine(cfg_j, n_seq=2)
    jmap = jmapping.MapState(
        kf=jmapping.KeyframeStore(**{k: jnp.asarray(v)
                                     for k, v in st.kf.items()}),
        correction=jnp.asarray(st.correction), pose=jnp.asarray(st.pose),
        last_kf_pose=jnp.asarray(st.last_kf_pose))
    out = jeng._batch_loop(
        jmap, jsc.DescriptorBank(**{k: jnp.asarray(v)
                                    for k, v in st.bank.items()}),
        jpg.LoopFactors(**{k: jnp.asarray(v) for k, v in st.loops.items()}),
        jnp.asarray(st.last_kf_odom), jnp.zeros(2, jnp.int32))
    jmap, jloops, jclosed = jax.tree.map(np.array, out)

    eng = tb.BatchEngine(cfg_t, n_seq=2, device="cpu")
    odo = eng.odo
    convert.load_batch_state(eng, types.SimpleNamespace(
        odo=type(odo)(*(x.numpy() if isinstance(x, torch.Tensor) else
                        type(x)(*(y.numpy() for y in x)) for x in odo)),
        map=types.SimpleNamespace(
            kf=types.SimpleNamespace(**st.kf), correction=st.correction,
            pose=st.pose, last_kf_pose=st.last_kf_pose),
        bank=types.SimpleNamespace(**st.bank),
        loops=types.SimpleNamespace(**st.loops),
        last_kf_odom=st.last_kf_odom, loops_closed=np.zeros(2, np.int32),
        traj=eng.traj.numpy(), _scan_i=0, _map_ticks=0, last_map_time=-1e9))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng._loop_tick()
    return st, (jmap, jloops, jclosed), eng, caught


def test_the_fixture_closes_sequence_zero_only(ticks):
    _, (_, _, jclosed), eng, _ = ticks
    assert jclosed.tolist() == [1, 0]
    assert eng.loops_closed.tolist() == [1, 0]


def test_closed_sequence_matches_jax(ticks):
    """The same factor (indices, count; Z to 5e-3), the same re-solved
    poses and correction to 5e-3 (tests/test_torch_loop.py's tolerance for
    loop closure from one shared state)."""
    _, (jmap, jloops, _), eng, _ = ticks
    for name in ("i", "j", "count"):
        np.testing.assert_array_equal(getattr(eng.loops, name).numpy()[0],
                                      getattr(jloops, name)[0])
    np.testing.assert_allclose(eng.loops.z.numpy()[0], jloops.z[0],
                               atol=5e-3)
    np.testing.assert_allclose(eng.map.kf.poses6.numpy()[0, :8],
                               jmap.kf.poses6[0, :8], atol=5e-3)
    for name in ("correction", "pose", "last_kf_pose"):
        np.testing.assert_allclose(getattr(eng.map, name).numpy()[0],
                                   getattr(jmap, name)[0], atol=5e-3)


def test_sequence_without_candidate_is_bit_identical(ticks):
    st, _, eng, _ = ticks
    np.testing.assert_array_equal(eng.map.kf.poses6.numpy()[1],
                                  st.kf["poses6"][1])
    for name in ("i", "j", "z", "count"):
        np.testing.assert_array_equal(getattr(eng.loops, name).numpy()[1],
                                      st.loops[name][1])
    for name in ("correction", "pose", "last_kf_pose"):
        np.testing.assert_array_equal(getattr(eng.map, name).numpy()[1],
                                      getattr(st, name)[1])


def test_loop_tick_fallbacks_are_listed(ticks):
    """The functorch per-sample fallbacks of the loop tick, if any, are
    the ones PERF.md lists: none in the detectors and the ICP."""
    *_, caught = ticks
    drops = sorted({str(w.message).split(" because")[0][:160]
                    for w in caught if "performance drop" in str(w.message)})
    assert drops == [], drops
