"""Build and load the package's CUDA kernels at first use.

Each `csrc/<name>.cu` is compiled by its own `nvcc` process into a shared
library with a plain C interface, and loaded with ctypes; tensors pass as
`data_ptr()` integers and the launch goes on PyTorch's current stream.
The ctypes argument types are read from each source's `extern "C"`
signature, and `SimParams` from its struct in csrc/sim_world.cuh, so the
sources are the one table of the interface.
The sources include no PyTorch header: build_ab.py timed kernel C at
2.9 s with plain nvcc against 307 s through `torch.utils.cpp_extension.load`
with `torch/extension.h`.  All builds start together.

Flags: `-O3 -gencode=arch=compute_90a,code=sm_90a`, no `--use_fast_math`.
nvcc's default contraction into fused multiply-adds stays on: kernel B
is ~19 % slower with `--fmad=false`, and with FMAs the kernels still
agree with the plain torch versions to ~2e-6 (build_ab.py measures both).
Libraries land in `_build/` beside this file
(git-ignored), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  A failed build or load
raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
KERNELS = ("fused_step", "fused_rollout", "fused_gae", "meter_scan",
           "fused_update", "fused_multistep", "fused_rollout_tiled",
           "obs_moments", "fused_rollout_bf16", "fused_rollout_probe",
           "fused_rollout_probe_bf16", "fused_rollout_probe_pbf",
           "trace_stamp", "eval_policy", "fused_update_probe")
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-lineinfo", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_SCALARS = {"int": ctypes.c_int, "uint32_t": ctypes.c_uint32,
            "float": ctypes.c_float}


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)


def c_struct(name: str):
    """A ctypes.Structure built from `struct <name> {...};` in
    csrc/sim_world.cuh (scalar fields only), so the host and the kernels
    share one layout."""
    src = _strip_comments((CSRC / "sim_world.cuh").read_text())
    m = re.search(rf"struct {name} {{(.*?)}};", src, re.S)
    if m is None:
        raise RuntimeError(f"struct {name} not found in sim_world.cuh")
    fields = []
    for decl in filter(None, (d.strip() for d in m.group(1).split(";"))):
        typ, names = decl.split(None, 1)
        fields += [(n.strip(), _SCALARS[typ]) for n in names.split(",")]
    return type(name, (ctypes.Structure,), {"_fields_": fields})


# the config and its derived constants, passed by value to kernels A and B
SimParams = c_struct("SimParams")


def c_signature(path: Path, fn: str):
    """ctypes argtypes of `extern "C" ... fn(...)` read from the source:
    pointers and cudaStream_t pass as c_void_p, scalars by type and
    SimParams by value."""
    src = _strip_comments(Path(path).read_text())
    m = re.search(rf'extern "C" [\w\s]+?\b{fn}\((.*?)\)\s*{{', src, re.S)
    if m is None:
        raise RuntimeError(f"extern \"C\" {fn} not found in {path}")
    types = []
    for param in (p.strip() for p in m.group(1).split(",")):
        typ = param.rsplit(None, 1)[0].replace("const ", "").split("::")[-1]
        if "*" in param or typ == "cudaStream_t":
            types.append(ctypes.c_void_p)
        elif typ == "SimParams":
            types.append(SimParams)
        else:
            types.append(_SCALARS[typ])
    return types


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every missing library, one nvcc per source, all at once.
    Returns {"seconds": wall time, "built": [...], "library_seconds":
    {name: seconds from the start to its nvcc's exit}, "ptxas": {name:
    ptxas_kernels(name)}}.  A host span of the tracer, "build"."""
    from .utils.profiling import annotate
    with annotate("build"):
        return _build(names)


def _build(names) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")], stdout=log, stderr=subprocess.STDOUT),
            tmp, out, log)
    failed, done = [], {}
    while len(done) < len(procs):
        for name, (proc, tmp, out, log) in procs.items():
            if name in done or proc.poll() is None:
                continue
            done[name] = round(time.perf_counter() - t0, 2)
            log.close()
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(name)
        time.sleep(0.05)
    if failed:
        msgs = [f"--- {n}\n{lib_path(n).with_suffix('.log').read_text()[:4000]}"
                for n in failed]
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n" +
                           "\n".join(msgs))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "library_seconds": done,
            "ptxas": {n: ptxas_kernels(n) for n in names}}


def ptxas_kernels(name: str, path: Path | None = None) -> dict:
    """Per kernel of csrc/<name>.cu (keyed by its mangled name), what
    ptxas printed: registers, stack frame and spill bytes (from the build
    log beside the built library, or beside the library at `path`)."""
    log = (lib_path(name) if path is None else path).with_suffix(".log")
    out, cur = {}, None
    for ln in (log.read_text().splitlines() if log.exists() else ()):
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers")):
            m = re.search(pat, ln)
            if m:
                cur[key] = int(m.group(1))
    return out


def sass_loop_counts(name: str, ops=("STS", "STG", "LDS", "LDL", "STL"),
                     path: Path | None = None):
    """Per kernel of csrc/<name>.cu (keyed by its mangled name), how many
    SASS instructions of each opcode family in `ops` lie inside its
    longest backward branch that contains a CTA barrier (a kernel's tick
    loop; without a barrier, its longest backward branch) and in the whole
    kernel, from `cuobjdump -sass` of the built library (or of the
    library at `path`)."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    lib = lib_path(name) if path is None else path
    sass = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        fn = body.split("\n", 1)[0].strip()
        code = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
            r"([^;]*);", body)]
        bars = [a for a, op, _ in code if op == "BAR"]
        back = [(int(m.group(1), 16), a) for a, op, rest in code
                if op == "BRA" for m in [re.search(r"0x([0-9a-f]+)", rest)]
                if m and int(m.group(1), 16) < a]
        with_bar = [(lo, hi) for lo, hi in back
                    if any(lo <= b <= hi for b in bars)]
        loop = max(with_bar or back or [(0, -1)], key=lambda x: x[1] - x[0])
        out[fn] = {"loop_bytes": loop[1] - loop[0] + 1}
        for o in ops:
            out[fn][f"{o}_in_loop"] = sum(
                1 for a, op, _ in code if op == o and loop[0] <= a <= loop[1])
            out[fn][f"{o}_total"] = sum(1 for _, op, _ in code if op == o)
    return out


_LIBS: dict = {}


def load(name: str):
    """The ctypes library of one kernel, built first if it is missing."""
    if name not in _LIBS:
        if not lib_path(name).exists():
            build([name])
        _LIBS[name] = open_lib(lib_path(name), name)
    return _LIBS[name]


def entries(name: str) -> list[str]:
    """The `extern "C" int mbb_*` entries of csrc/<name>.cu."""
    src = _strip_comments((CSRC / f"{name}.cu").read_text())
    return re.findall(r'extern "C" int (mbb_\w+)\(', src)


def open_lib(path: Path, name: str):
    """Load one kernel library and type each of its `extern "C" int
    mbb_*` entries from its signature in csrc/<name>.cu."""
    lib = ctypes.CDLL(str(path))
    for entry in entries(name):
        fn = getattr(lib, entry)
        fn.argtypes = c_signature(CSRC / f"{name}.cu", entry)
        fn.restype = ctypes.c_int
    lib.mbb_error_string.argtypes = [ctypes.c_int]
    lib.mbb_error_string.restype = ctypes.c_char_p
    return lib


def ptr(t):
    return None if t is None else t.data_ptr()


def check_device(device, **tensors):
    """Raise unless every given tensor lies on `device` (a kernel handed a
    host pointer would fault)."""
    for name, t in tensors.items():
        if t is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, the kernel's inputs "
                             f"on {device}")


def stream(device):
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def device_int(value, device):
    """A scalar kernel argument that the kernel reads from device memory,
    so that a CUDA graph replaying the launch sees each replay's value:
    `value` as a 0-d int32 tensor on `device`.  An int is written there
    by a fill launch (no host synchronization); a 0-d int32 tensor on
    `device` passes as it is."""
    import torch
    if isinstance(value, torch.Tensor):
        if value.shape != () or value.dtype != torch.int32 or \
                value.device != device:
            raise ValueError(f"a device scalar must be a 0-d int32 tensor "
                             f"on {device}, got {tuple(value.shape)} "
                             f"{value.dtype} on {value.device}")
        return value
    return torch.full((), int(value), dtype=torch.int32, device=device)


def check(err: int, name: str):
    if err != 0:
        msg = _LIBS[name].mbb_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({msg})")
