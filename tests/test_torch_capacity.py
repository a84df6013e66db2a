"""The capacity runway (``sc_lego_loam_tpu_torch/tools/run_capacity.py``) on
the CPU at ``max_keyframes=64``: part 1's route (prefill through
``mapping.insert_keyframe``, then ``process_scan`` past the cap), the
prefilled rows against the JAX package's ``mapping.insert_keyframe`` on the
same inputs, and part 2's full bank with the loop bank past its slots.
(The loop bank's eviction against the JAX ``posegraph.add_loop`` is held
by ``test_add_loop_past_capacity_evicts_same_slot`` in
``tests/test_torch_posegraph.py``.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from sc_lego_loam_tpu import mapping as jmapping
from sc_lego_loam_tpu.config import tiny_test_config as jax_tiny
from sc_lego_loam_tpu.utils import se3 as jse3
from sc_lego_loam_tpu_torch import mapping
from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.tools import run_capacity
from sc_lego_loam_tpu_torch.utils import convert

torch.set_num_threads(1)

K, EXTRA = 64, 8


def _one_iteration(cfg):
    """One LM iteration in odometry and scan-to-map, two in the ICP: the
    runway checks counts and slots, not accuracy, and the CPU pays ~4 s a
    scan at the default iterations when every scan is a mapping tick."""
    return cfg.replace(
        mapping=dataclasses.replace(cfg.mapping, max_iterations=1),
        odom=dataclasses.replace(cfg.odom, max_iterations=1),
        loop=dataclasses.replace(cfg.loop, icp_max_iterations=2))


def test_runway_prefill_then_drive():
    got = run_capacity.part1("cpu", "cpu", _one_iteration(tiny_test_config()),
                             k=K, extra=EXTRA, tail=2, n_src=2)
    assert (got["count"], got["dropped"], got["prefilled"]) == (K, EXTRA, 60)


def test_prefill_rows_equal_jax_insert_keyframe():
    jcfg, tcfg = jax_tiny(), tiny_test_config()
    n_src, stop, step = 3, 11, 0.3
    rng = np.random.default_rng(2)
    jkf = jmapping.init_state(jcfg).kf
    fields = {}
    for f in jmapping.KeyframeStore._fields[:-1]:
        a = np.array(getattr(jkf, f))
        if a.dtype == bool:
            a[:n_src] = rng.random(a[:n_src].shape) < 0.5
        elif f in ("corner", "surf", "outlier", "poses6"):
            a[:n_src] = rng.normal(0, 2.0, a[:n_src].shape)
        elif f == "times":
            a[:n_src] = 0.1 * np.arange(n_src)
        fields[f] = a
    jkf = jkf._replace(count=jnp.int32(n_src),
                       **{f: jnp.asarray(a) for f, a in fields.items()})

    tkf = convert.to_torch(mapping.KeyframeStore,
                           jkf._replace(**{f: np.asarray(getattr(jkf, f))
                                           for f in jkf._fields}), "cpu")
    tkf = run_capacity.prefill(tcfg, tkf, stop, n_src, step)

    for i in range(n_src, stop):
        j = i % n_src
        pose = np.array(jse3.pose6_to_mat(jkf.poses6[j]))
        pose[0, 3] += (i // n_src) * n_src * step
        jkf, _ = jmapping.insert_keyframe(
            jcfg, jkf, jnp.bool_(True), jnp.asarray(pose),
            jnp.float32(0.1) * jnp.float32(i),
            *(jkf.__getattribute__(f)[j] for f in mapping.SHARDED_FIELDS))
    assert int(tkf.count) == int(jkf.count) == stop
    for f in jmapping.KeyframeStore._fields[:-1]:
        want, got = np.asarray(getattr(jkf, f)), getattr(tkf, f).numpy()
        if want.dtype == bool or f in ("corner", "surf", "outlier"):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5,
                                       err_msg=f)


def test_full_bank_and_loop_bank_past_its_slots():
    cfg = _one_iteration(tiny_test_config())
    src, scans, valids = run_capacity.source_drive("cpu", cfg, n=4)
    got = run_capacity.part2("cpu", "cpu", src, scans, valids, cfg,
                             loops_over=4)
    assert got["loops"] == cfg.posegraph.max_loops + 4
    assert got["state_bytes"] > got["mapper_bytes"] > 0
