"""The native host executor (port of `madrona_basketball_tpu.native`,
native/__init__.py:62-132).

`NativeEngine` steps a fleet of worlds on the host's CPU cores: numpy row
matrices (sf (72, W) float32, si (59, W) int32, obs (256, W) float32) in
the kernels' layout, stepped in place by csrc/host_step.cpp's
`mbb_host_step_threaded`, which runs `sim_world.cuh::step_world` - the
per-world body that kernel A runs on the card - over contiguous ranges of
worlds, one `std::thread` each.  It is a host executor by design, like
the JAX package's (the counterpart of the reference's CPU
TaskGraphExecutor path, src/mgr.cpp:49-81): the rows stay on the CPU.
The JAX package's executor builds its own C++ transcription
(native/mbb_sim.cpp); this one builds no copy of that file.

`build_host_step` compiles csrc/host_step.cpp with g++ at first use into
`_build/host/`, named by a hash of the sources and flags (as `_build.py`
names the CUDA libraries), with contraction off, so the host body rounds
each operation as the plain torch tick does; the CPU tests build it
through this function too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import _build
from .. import constants as C
from ..engine import init_rows
from ..ops import layout
from ..ops.fused_step import sim_params

SOURCE = _build.CSRC / "host_step.cpp"
GXX_FLAGS = ["-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
             "-pthread"]
ENTRIES = ("mbb_host_step", "mbb_host_step_threaded", "mbb_host_multistep")


def host_lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    for hdr in sorted(_build.CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return _build.BUILD_DIR / "host" / f"libhost_step-{h.hexdigest()[:16]}.so"


def build_host_step() -> Path:
    """The library of csrc/host_step.cpp, built with g++ if missing
    (written under a temporary name and renamed, so processes building at
    once do not load a half-written file)."""
    out = host_lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host executor is "
                           "built from csrc/host_step.cpp at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True)
    os.replace(tmp, out)
    return out


_lib = None


def load_host_step():
    """The built library, every entry typed from its signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_host_step()))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = _build.c_signature(SOURCE, entry)
            fn.restype = None
        _lib = lib
    return _lib


class NativeEngine:
    """Multi-world executor on the host over numpy row matrices; `step`
    updates `sf`, `si` and `obs` in place.  `n_threads` 0 takes every
    core this process may run on; every thread count gives the same
    bits."""

    def __init__(self, cfg, num_worlds: int, seed: int = 0,
                 n_threads: int = 0, init_state=None):
        self.cfg = cfg
        self.num_worlds = num_worlds
        self.lib = load_host_step()
        self.params = sim_params(cfg)
        if init_state is None:
            sf, si = init_rows(cfg, num_worlds,
                               torch.Generator().manual_seed(seed), "cpu")
        else:
            sf, si = layout.pack(init_state)
        # writable copies owned by the engine
        self.sf = np.array(sf.cpu().numpy(), np.float32, order="C")
        self.si = np.array(si.cpu().numpy(), np.int32, order="C")
        self.obs = np.zeros((layout.N_OBS_ROWS, num_worlds), np.float32)
        self.n_threads = n_threads or len(os.sched_getaffinity(0))
        self.rng = np.random.RandomState(seed)

    def draw_noise(self) -> np.ndarray:
        """(9, W) float32: rows 0-7 U(-1, 1), row 8 U(0, 1)."""
        W = self.num_worlds
        n = np.empty((layout.N_NOISE_ROWS, W), np.float32)
        n[:6] = self.rng.uniform(-1, 1, (6, W))
        n[6] = self.rng.uniform(-1, 1, W)
        n[7] = self.rng.uniform(-1, 1, W)
        n[8] = self.rng.uniform(0, 1, W)
        return n

    def step(self, noise: np.ndarray | None = None):
        """One tick of every world, in place; `noise` (9, W) replaces the
        engine's draw."""
        if noise is None:
            noise = self.draw_noise()
        noise = np.ascontiguousarray(noise, np.float32)
        self.lib.mbb_host_step_threaded(
            self.params, noise.ctypes.data, self.sf.ctypes.data,
            self.si.ctypes.data, self.sf.ctypes.data, self.si.ctypes.data,
            self.obs.ctypes.data, self.num_worlds, self.n_threads)

    def set_actions(self, actions: np.ndarray):
        """Write a (W, A, 6) action array into the rows."""
        actions = np.asarray(actions, np.int32)
        for i in range(C.NUM_AGENTS):
            for j, r in enumerate(layout.ACTION_ROWS[i]):
                self.si[r] = actions[:, i, j]

    def state(self):
        """The structured view (`state.State`, CPU tensors) of a copy of
        the rows."""
        return layout.unpack(self.cfg, torch.from_numpy(self.sf.copy()),
                             torch.from_numpy(self.si.copy()),
                             obs=torch.from_numpy(self.obs.copy()))
