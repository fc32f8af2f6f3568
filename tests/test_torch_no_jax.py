"""The port imports neither JAX nor the JAX package, and no port module
imports pygame at import (the viewer imports it at its first
`ViewerClass()`; the card's machine has no pygame).

Checked in a subprocess: conftest.py imports JAX into the test process,
so `sys.modules` there says nothing."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import madrona_basketball_tpu_torch as port

ROOT = Path(port.__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import madrona_basketball_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "madrona_basketball_tpu", "pygame"))
print(len(names))
print(",".join(bad))
"""


def test_port_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().split("\n") + [""] * (
        2 - len(out.stdout.strip().split("\n")))
    assert int(n_modules) >= 57
    assert bad == "", f"port pulled in: {bad}"


def test_port_sources_do_not_name_jax():
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        path = Path(m.module_finder.path) / (m.name.rsplit(".", 1)[-1] + ".py")
        if not path.exists():
            continue
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax",
                                      "import flax", "import optax")) or
                        "import madrona_basketball_tpu." in s or
                        s.startswith("from madrona_basketball_tpu ") or
                        s.startswith("from madrona_basketball_tpu.")), \
                f"{path}: {line}"
