"""How far the JAX package's jitted and eager runs of one batched step lie
apart, beside the port's run of the same step: the step CARRY of
tests/test_torch_batch.py (perception + a mapping tick, both sequences),
from the same carried state.  The scan-to-map plane fits are fp32 normal
equations, so XLA's fusions move the mapped pose; the tolerance of
``test_batched_steps_from_carried_state`` on that pose rests on what this
prints.  About 4 min on one CPU thread (the eager step is ~170 s):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_jit_spread.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import test_torch_batch as tt
from sc_lego_loam_tpu.parallel import batch as jb
from sc_lego_loam_tpu_torch.parallel import batch as tb
from sc_lego_loam_tpu_torch.utils import convert


def _apart(a, b):
    """(translation m, rotation deg) between two (S,4,4) pose stacks."""
    return (np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1),
            tt._rot_deg(a, b))


def main():
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg_t, pts, msk, jit_eng, snaps = tt.jax_drive()
    before, after = snaps["before"], snaps["after"]
    i = tt.CARRY

    eager = jb.BatchEngine(jit_eng.config, n_seq=2)
    for name in ("odo", "map", "bank", "loops"):
        setattr(eager, name, jax.tree.map(jnp.asarray, getattr(before, name)))
    for name in ("last_kf_odom", "loops_closed", "traj"):
        setattr(eager, name, jnp.asarray(getattr(before, name)))
    eager._scan_i, eager._map_ticks = before._scan_i, before._map_ticks
    eager.last_map_time = before.last_map_time
    with jax.disable_jit():
        eager.process_scans(pts[i], msk[i], t=i * 0.1)

    port = tb.BatchEngine(cfg_t, n_seq=2, device="cpu")
    convert.load_batch_state(port, before)
    port.process_scans(pts[i], msk[i], t=i * 0.1)

    p_jit, p_eager = after.map.pose, np.array(eager.map.pose)
    p_port = port.map.pose.numpy()
    print(f"keyframes {before.map.kf.count.tolist()} -> "
          f"{after.map.kf.count.tolist()}")
    for label, a, b in (("JAX jit vs JAX eager", p_jit, p_eager),
                        ("port vs JAX jit", p_port, p_jit),
                        ("port vs JAX eager", p_port, p_eager)):
        m, deg = _apart(a, b)
        print(f"mapped pose, {label}: {m.tolist()} m, {deg.tolist()} deg")
    odo = np.abs(np.array(eager.odo.pose) - after.odo.pose).max()
    print(f"odometry pose, JAX jit vs JAX eager: {odo} (max abs)")


if __name__ == "__main__":
    main()
