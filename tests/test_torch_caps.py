"""The capacity warnings of both packages' ``SlamEngine``, by the same
calls: the exact check of ``trajectory_array`` resets the warned flags,
warns at most once each and sets them, so the host-bound warnings of
``process_scan`` stay quiet after it; and the one difference, a defect of
the JAX package: with loop closure off its host-bound loop-cap check still
counts ``map_ticks // check_every_ticks`` loop ticks and warns of a loop
bank that cannot fill, where the port counts the loop ticks that ran."""

import dataclasses
import warnings

import jax.numpy as jnp
import pytest
import torch

from sc_lego_loam_tpu import pipeline as jp
from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu_torch import pipeline as tp
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch

torch.set_num_threads(1)

K, L = 4, 2          # small enough for the counters below to overflow


def _cfg(base, loop_on=True, k=K):
    cfg = base()
    return cfg.replace(
        cap=dataclasses.replace(cfg.cap, max_keyframes=k),
        posegraph=dataclasses.replace(cfg.posegraph, max_loops=L),
        loop=dataclasses.replace(cfg.loop, enabled=loop_on))


def _engines(loop_on=True, k=K):
    return (jp.SlamEngine(_cfg(tiny_test_config, loop_on, k)),
            tp.SlamEngine(_cfg(tiny_torch, loop_on, k), device="cpu"))


def _set_counters(je, te, dropped, loops):
    je.m = je.m._replace(kf_dropped=jnp.int32(dropped),
                         loops=je.m.loops._replace(count=jnp.int32(loops)))
    te.m = te.m._replace(kf_dropped=torch.tensor(dropped, dtype=torch.int32),
                         loops=te.m.loops._replace(
                             count=torch.tensor(loops, dtype=torch.int32)))


def _recorded(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn()
    return [str(w.message).split(":")[0] for w in rec
            if w.category is RuntimeWarning]


def _script(eng, ticks):
    """The same calls on either engine; returns the warnings of each."""
    def host_bound():
        eng.map_ticks = ticks
        eng.loop_ticks = ticks // eng.config.loop.check_every_ticks
        eng._check_caps_host_bound()

    out = [_recorded(lambda: (eng.trajectory_array(),
                              eng.trajectory_array())),
           _recorded(host_bound)]
    return out


def test_exact_check_warns_once_each_and_sets_the_flags():
    je, te = _engines()
    _set_counters(je, te, dropped=3, loops=L + 1)
    want = [["keyframe bank full (4)", "loop-factor bank full (2)"] * 2, []]
    assert _script(je, 30) == _script(te, 30) == want
    assert (je._warned_kf_cap, je._warned_loop_cap) == \
        (te._warned_kf_cap, te._warned_loop_cap) == (True, True)

    # No overflow: the exact check resets the flags and says nothing; the
    # host-bound check then warns from the tick counters, once each.
    _set_counters(je, te, dropped=0, loops=0)
    want = [[], ["keyframe bank may be full (4)",
                 "loop-factor bank may be full (2)"]]
    assert _script(je, 30) == _script(te, 30) == want
    assert _recorded(te._check_caps_host_bound) == \
        _recorded(je._check_caps_host_bound) == []


@pytest.mark.parametrize("loop_on", [False, True])
def test_loop_cap_count_with_loop_closure_off(loop_on):
    """Nine mapping ticks, 64 keyframes of room.  Loop closure on: both
    count 3 loop ticks (6 possible factors > 2) and warn.  Off: no loop
    tick runs; the JAX package warns all the same, the port does not."""
    je, te = _engines(loop_on, k=64)
    je.map_ticks = te.map_ticks = 3 * te.config.loop.check_every_ticks
    te.loop_ticks = 3 if loop_on else 0
    got_j = _recorded(je._check_caps_host_bound)
    got_t = _recorded(te._check_caps_host_bound)
    assert got_j == ["loop-factor bank may be full (2)"]
    assert got_t == (got_j if loop_on else [])
