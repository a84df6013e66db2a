"""The import guard compares whole top-level names."""

import sys
import types

from slambench import run


def test_forbidden_top_level_names(monkeypatch):
    base = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sc_lego_loam_tpu_torch.x",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("j"))
    assert run.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "sc_lego_loam_tpu.pipeline",
                        types.ModuleType("p"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("n"))
    assert {"jax", "sc_lego_loam_tpu"} <= set(run.forbidden_modules())
