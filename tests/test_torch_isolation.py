"""PyTorch port, isolation: importing every module of the port loads no
``jax``, no ``flax`` and no module of the JAX package.

Checked by module name, not by substring: the JAX package's name
(``two_stage_object_detection_tpu``) is a prefix of the port's own.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import two_stage_object_detection_tpu_torch as port

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "two_stage_object_detection_tpu")

_PROBE = """
import importlib, pkgutil, sys
for name in {forbidden!r}:
    sys.modules[name] = None          # any import of them now raises
import two_stage_object_detection_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
bad = sorted(n for n in sys.modules if sys.modules[n] is not None
             and any(n == f or n.startswith(f + ".") for f in {forbidden!r}))
print(len(mods), bad)
"""


def _import_all(forbidden):
    """Import every module of the port in a fresh interpreter where the
    ``forbidden`` packages cannot be imported."""
    root = Path(port.__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _PROBE.format(forbidden=forbidden)],
                         capture_output=True, text=True, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]"
    expected = {m.name for m in pkgutil.walk_packages(port.__path__,
                                                      port.__name__ + ".")}
    assert int(n_mods) == len(expected) >= 15
    return expected


def test_port_imports_no_jax_or_jax_package():
    mods = _import_all(FORBIDDEN)
    assert {port.__name__ + m for m in (".data.device_transforms",
                                        ".data.device_cache",
                                        ".parallel.spatial")} <= mods


def test_port_imports_without_pil_matplotlib_or_tqdm():
    """The card's machine may lack PIL, matplotlib and tqdm: every module,
    the drivers included, imports without them (each is imported inside
    the function that uses it)."""
    mods = _import_all(FORBIDDEN + ("PIL", "matplotlib", "tqdm"))
    assert {port.__name__ + m for m in (".train", ".evaluate", ".infer",
                                        ".__main__", ".utils.draw",
                                        ".data.pipeline")} <= mods


def test_chip_smoke_imports_no_jax():
    root = Path(port.__file__).resolve().parent.parent
    tree = ast.parse((root / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert "two_stage_object_detection_tpu_torch.serving" in names
    bad = [n for n in names
           if any(n == f or n.startswith(f + ".") for f in FORBIDDEN)]
    assert bad == []
