"""The JAX package's package-level names on the port's twins.

Every public name of `eincm_tpu`, `eincm_tpu.models`, `eincm_tpu.ops` and
`eincm_tpu.edge` (the three lazy names of `eincm_tpu.__getattr__`
included) resolves on `eincm_tpu_torch` and its subpackages, to the port's
own object of the same kind; importing the port's packages stays as light
as before and builds or loads no CUDA library.
"""

import importlib
import inspect
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
LAZY = ("ExperimentConfig", "load_config", "EINCMExperiment")
PACKAGES = ["", ".models", ".ops", ".edge"]


def _public(mod):
    """The names a package binds itself: not private, not a submodule."""
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not isinstance(v, types.ModuleType))


def _kind(obj):
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "function"
    return type(obj).__name__


@pytest.mark.parametrize("sub", PACKAGES, ids=["root", "models", "ops", "edge"])
def test_every_public_name_resolves_on_the_port(sub):
    jmod = importlib.import_module("eincm_tpu" + sub)
    tmod = importlib.import_module("eincm_tpu_torch" + sub)
    names = _public(jmod) + (list(LAZY) if sub == "" else [])
    assert len(names) >= {"": 11, ".models": 20, ".ops": 15, ".edge": 6}[sub]
    for name in names:
        jobj, tobj = getattr(jmod, name), getattr(tmod, name)
        assert _kind(tobj) == _kind(jobj), name
        if callable(tobj):
            assert tobj.__module__.startswith("eincm_tpu_torch."), (name, tobj.__module__)
            assert tobj.__name__ == jobj.__name__


def test_lazy_names_are_the_experiment_layers():
    import eincm_tpu_torch
    from eincm_tpu_torch.experiments import config, manager

    assert eincm_tpu_torch.ExperimentConfig is config.ExperimentConfig
    assert eincm_tpu_torch.load_config is config.load_config
    assert eincm_tpu_torch.EINCMExperiment is manager.EINCMExperiment
    with pytest.raises(AttributeError):
        eincm_tpu_torch.NoSuchName  # noqa: B018


IMPORT_CHECK = r"""
import ctypes, subprocess, sys
import torch
opened = []
_cdll, _run = ctypes.CDLL, subprocess.run
ctypes.CDLL = lambda *a, **k: opened.append(a[0]) or _cdll(*a, **k)
subprocess.run = lambda *a, **k: opened.append(a[0]) or _run(*a, **k)
import eincm_tpu_torch
light = sorted(m for m in sys.modules if m.startswith("eincm_tpu_torch"))
import eincm_tpu_torch.ops, eincm_tpu_torch.models, eincm_tpu_torch.edge
from eincm_tpu_torch.ops import _build
assert not _build._LIBS, _build._LIBS
assert all(k._fn is None for k in _build.KERNELS.values())
assert not [p for p in opened if "eincm" in str(p) or "nvcc" in str(p)], opened
print(" ".join(light))
"""


def test_imports_are_light_and_build_nothing():
    """In a fresh process: `import eincm_tpu_torch` loads the solve's
    modules only (no experiment, data or edge layer), and importing the
    ops, models and edge packages opens no kernel library and runs no
    compiler."""
    out = subprocess.run([sys.executable, "-c", IMPORT_CHECK], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    light = out.stdout.split()
    assert "eincm_tpu_torch.models.pyramid" in light
    for layer in ("experiments", "data", "edge", "native", "models.compat"):
        assert not [m for m in light if m.startswith(f"eincm_tpu_torch.{layer}")], layer
