#!/usr/bin/env python3
"""Build-flag measurements of the PyTorch port's CUDA kernels, one card.

    python3 build_ab.py

1. `--fmad=false` A/B.  `_build.NVCC_FLAGS` leave nvcc's contraction of
   a * b + c into fused multiply-adds on.  This script builds kernels A,
   B and C a second time with `--fmad=false`, which makes them round like
   their plain torch versions, and at the flagship shape (8192 worlds,
   T = 32) prints for each build:
     - each kernel's own device time (torch.profiler, as chip_smoke.py
       takes it), in the order default, no_fma, no_fma, default;
     - each kernel's largest error against its plain version on the
       same inputs, integer outputs included (A: 1 reset + 3 ticks;
       B: T = 4 external noise, and over 32 Philox ticks the fraction
       of worlds whose integer state or actions diverged; C: one pass).
2. Build time with PyTorch's headers.  Times
   `torch.utils.cpp_extension.load` of kernel C's source with a pybind
   binding that includes torch/extension.h, against a plain `nvcc` of
   the same source with the package's flags, and checks that the two
   builds give identical results.

Every measurement prints one JSON line; the card's name and power limit
come last.  Exits non-zero if any step failed.
"""

import json
import os
import subprocess
import time

import chip_smoke as cs

W, T = cs.W, cs.T
AB_KERNELS = ("fused_step", "fused_rollout", "fused_gae")


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_no_fma(_build):
    """Build AB_KERNELS with --fmad=false, all at once -> {name: lib}."""
    flags = _build.NVCC_FLAGS + ["--fmad=false"]
    procs = {}
    t0 = time.perf_counter()
    for name in AB_KERNELS:
        out = _build.lib_path(name).with_name(f"lib{name}-no-fma-ab.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *flags, "-o", str(out),
             str(_build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc (--fmad=false) failed for {name}:\n"
                               f"{log[:4000]}")
        libs[name] = _build.open_lib(out, name)
    return libs, time.perf_counter() - t0


def fmad_ab():
    import torch
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.config import SimConfig
    from madrona_basketball_tpu_torch.engine import init_rows
    from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
    from madrona_basketball_tpu_torch.models.agent import init_agent
    from madrona_basketball_tpu_torch.models.normalize import rms_update
    from madrona_basketball_tpu_torch.ops import fused_gae as FG
    from madrona_basketball_tpu_torch.ops import fused_rollout as FR
    from madrona_basketball_tpu_torch.ops import fused_step as FS
    from madrona_basketball_tpu_torch.ops.layout import RESET_ROWS

    t0 = time.perf_counter()
    _build.build()
    default_s = time.perf_counter() - t0
    no_fma_libs, no_fma_s = build_no_fma(_build)
    default_libs = {n: _build.load(n) for n in AB_KERNELS}
    emit({"phase": "build", "default_s": default_s, "no_fma_s": no_fma_s})

    dev = torch.device("cuda:0")
    cfg = SimConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    sf, si = init_rows(cfg, W, gen, dev)
    for r in RESET_ROWS:
        si[r] = 1
    noises = [draw_noise_rows(W, gen, dev) for _ in range(4)]
    agent = init_agent(torch.Generator().manual_seed(0), dev)
    u = torch.rand((4 * FR.EXT_NOISE_CHUNK, W), generator=gen, device=dev)
    row = torch.arange(4 * FR.EXT_NOISE_CHUNK, device=dev) % \
        FR.EXT_NOISE_CHUNK
    ext = torch.where((row < 8)[:, None], 2.0 * u - 1.0, u)
    carry = torch.stack([
        -50.0 * torch.rand((W,), generator=gen, device=dev),
        torch.randint(0, 300, (W,), generator=gen, device=dev).float()])
    nv = torch.randn((1, W), generator=gen, device=dev)
    vstats = torch.tensor([[-2.0, 3.0, 0, 0, 0, 0, 0, 0]], device=dev)
    gae_kw = dict(gamma=0.998, lam=0.95, r_value=FR.R_VALUE,
                  r_rew=FR.R_REW, r_done=FR.R_DONE)

    def ticks(step):
        s, i = sf, si.clone()
        for t, n in enumerate(noises):
            s, i, o = step(cfg, s, i, n)
            if t == 0:
                i = i.clone()
                for r in RESET_ROWS:
                    i[r] = 0
        return s, i, o

    def maxerr(got, want):
        return max(float((g.float() - w.float()).abs().max())
                   for g, w in zip(got, want))

    # plain references, once
    p_state = ticks(FS.step_rows_plain)
    s4, i4, o4 = p_state
    agent.obs_rms = rms_update(agent.obs_rms, o4[128:256].T)
    mats = FR.pack_policy(agent)
    p_roll4 = FR.rollout_plain(cfg, s4, i4, o4, mats, n_steps=4,
                               trainee_idx=1, noise=ext)
    p_roll32 = FR.rollout_plain(cfg, s4, i4, o4, mats, n_steps=T,
                                trainee_idx=1,
                                noise=FR.philox_noise(7, 0, T, W, dev))
    traj = p_roll32[3]
    p_gae = FG.gae_plain(traj, carry, nv, vstats, **gae_kw)

    pulse_si = i4.clone()
    for r in RESET_ROWS:
        pulse_si[r] = 1
    calls = {
        "fused_step": (lambda: FS.fused_step(cfg, s4, pulse_si, noises[0]),
                       20),
        "fused_rollout": (lambda: FR.fused_rollout(
            cfg, s4, i4, o4, mats, n_steps=T, trainee_idx=1, seed=7), 5),
        "fused_gae": (lambda: FG.fused_gae(traj, carry, nv, vstats,
                                           **gae_kw), 20),
    }
    acts = slice(FR.R_ACT, FR.R_ACT + 6)
    results = {}
    for label in ("default", "no_fma", "no_fma", "default"):
        libs = default_libs if label == "default" else no_fma_libs
        _build._LIBS.update(libs)
        row = {"build": label}
        row["ms"] = {n: cs.kernel_ms(fn, reps, n + "_kernel")
                     for n, (fn, reps) in calls.items()}
        k_state = ticks(FS.fused_step)
        k_roll4 = FR.fused_rollout(cfg, s4, i4, o4, mats, n_steps=4,
                                   trainee_idx=1, noise=ext)
        k_roll32 = FR.fused_rollout(cfg, s4, i4, o4, mats, n_steps=T,
                                    trainee_idx=1, seed=7)
        torch.cuda.synchronize()
        div = (k_roll32[1] != p_roll32[1]).any(dim=0) | \
            (k_roll32[3][:, acts] != p_roll32[3][:, acts]).any(dim=0) \
            .any(dim=0)
        row["err"] = {
            "fused_step": maxerr(k_state, p_state),
            "fused_rollout_T4": maxerr(k_roll4[:4], p_roll4[:4]),
            "fused_rollout_T32_diverged_worlds": float(div.float().mean()),
            "fused_gae": maxerr(FG.fused_gae(traj, carry, nv, vstats,
                                             **gae_kw), p_gae),
        }
        emit({"phase": "fmad_ab", **row})
        results.setdefault(label, []).append(row["ms"])
    _build._LIBS.update(default_libs)
    emit({"phase": "fmad_ab_summary", "ms_mean": {
        label: {n: sum(r[n] for r in rows) / len(rows) for n in AB_KERNELS}
        for label, rows in results.items()}})
    return traj, carry, nv, vstats, gae_kw


BINDING = r"""
#include <torch/extension.h>
#include <c10/cuda/CUDAStream.h>
#include "@SRC@"

std::vector<torch::Tensor> gae(torch::Tensor traj, torch::Tensor carry,
                               torch::Tensor nv, torch::Tensor vstats,
                               int64_t gb, int64_t r_value, int64_t r_rew,
                               int64_t r_done, double gamma,
                               double gamma_lam) {
    const int T = traj.size(0), rows = traj.size(1), W = traj.size(2);
    auto opt = traj.options();
    auto side = torch::empty({T, 8, W}, opt);
    auto moments = torch::empty({W / gb, 8}, opt);
    auto carry_out = torch::empty({2, W}, opt);
    auto ticks = torch::empty({W / gb, T, 8}, opt);
    const int err = mbb_fused_gae(
        traj.data_ptr<float>(), carry.data_ptr<float>(),
        nv.data_ptr<float>(), vstats.data_ptr<float>(),
        side.data_ptr<float>(), moments.data_ptr<float>(),
        carry_out.data_ptr<float>(), ticks.data_ptr<float>(), T, rows, W,
        (int)gb, (int)r_value, (int)r_rew, (int)r_done, (float)gamma,
        (float)gamma_lam, c10::cuda::getCurrentCUDAStream().stream());
    TORCH_CHECK(err == 0, "fused_gae launch failed: ", err);
    return {side, moments, carry_out, ticks};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) { m.def("gae", &gae); }
"""


def header_build_time(traj, carry, nv, vstats, gae_kw):
    import torch
    from torch.utils import cpp_extension
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.ops import fused_gae as FG

    out_dir = _build.BUILD_DIR / "ext_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    plain_so = out_dir / "libfused_gae_plain.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(plain_so), str(_build.CSRC / "fused_gae.cu")],
                   check=True, capture_output=True)
    nvcc_s = time.perf_counter() - t0

    src = out_dir / "gae_ext.cu"
    src.write_text(BINDING.replace("@SRC@",
                                   str(_build.CSRC / "fused_gae.cu")))
    os.environ["TORCH_CUDA_ARCH_LIST"] = "9.0"
    t0 = time.perf_counter()
    ext = cpp_extension.load(
        name="mbb_gae_ext_ab", sources=[str(src)],
        build_directory=str(out_dir),
        extra_cuda_cflags=[f for f in _build.NVCC_FLAGS
                           if f not in ("-shared", "-Xcompiler", "-fPIC",
                                        "-Xptxas=-v", "-std=c++17")],
        verbose=False)
    ext_s = time.perf_counter() - t0
    gb = FG.pick_gae_block(W)
    got = ext.gae(traj, carry, nv, vstats, gb, gae_kw["r_value"],
                  gae_kw["r_rew"], gae_kw["r_done"], gae_kw["gamma"],
                  gae_kw["gamma"] * gae_kw["lam"])
    want = FG.fused_gae(traj, carry, nv, vstats, **gae_kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    emit({"phase": "header_build_time", "source": "csrc/fused_gae.cu",
          "nvcc_plain_c_s": nvcc_s, "cpp_extension_load_s": ext_s,
          "torch_arch_list": "9.0 (+ the package's sm_90a gencode)",
          "identical_results": same})
    if not same:
        raise RuntimeError("the cpp_extension build of kernel C disagrees "
                           "with the ctypes build")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("build_ab: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    inputs = fmad_ab()
    try:
        header_build_time(*inputs)
    except Exception as e:  # reported, and the exit code says so
        emit({"phase": "header_build_time", "error": repr(e)[:2000]})
        ok = False
    print(cs.nvidia_smi_line(), flush=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
