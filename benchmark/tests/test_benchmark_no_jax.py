"""Nothing the benchmark runs imports JAX or the JAX package, and no
benchmark source reads a file of the JAX era's benchmarks."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "madrona_basketball_tpu")


def test_no_jax_module_is_loaded():
    """A subprocess imports every module under benchmark/ (the drivers
    import the port's entry points they call); the top-level names of
    sys.modules, compared whole, hold none of FORBIDDEN."""
    files = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
    dotted = [".".join(p.relative_to(ROOT).with_suffix("").parts)
              for p in files if "." not in p.stem]
    by_path = [str(p) for p in files if "." in p.stem]
    code = f"""
import importlib, importlib.util, json, sys
sys.path.insert(0, {str(ROOT)!r})
for name in {dotted!r}:
    importlib.import_module(name)
for i, path in enumerate({by_path!r}):
    spec = importlib.util.spec_from_file_location(f"metric{{i}}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "madrona_basketball_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))
    assert len(files) >= 15


JAX_ERA = re.compile(r"BENCH_r0|MULTICHIP_r0|BASELINE\.json|BASELINE\.md|"
                     r"BENCHMARKS\.md|bench_logs|(?<![\w/])bench(_\w+)?\.py")


def test_no_source_reads_a_jax_era_bench_file():
    for path in BENCH.rglob("*"):
        if path.suffix not in (".py", ".json") or path.name == \
                Path(__file__).name:
            continue
        text = path.read_text()
        assert not JAX_ERA.search(text), (path, JAX_ERA.search(text)[0])
