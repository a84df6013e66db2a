"""``python -m sc_lego_loam_tpu_torch.tools.dryrun_multichip``, the port's
counterpart of ``__graft_entry__.dryrun_multichip``: the sharded engine
(against an unsharded one), sharded retrieval, the sharded solve and the
multi-chain merge, in 2 gloo processes on a (1, 2) mesh and in 4 on a
(2, 2) mesh."""

import pytest
import torch

from sc_lego_loam_tpu_torch.tools import dryrun_multichip

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    line = dryrun_multichip.dryrun(n, "cpu")
    shape = dryrun_multichip.mesh_shape(n)
    assert line.startswith(f"dryrun_multichip({n}): ok — mesh="
                           f"({shape[0]}x{shape[1]})"), line
