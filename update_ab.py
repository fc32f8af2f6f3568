#!/usr/bin/env python3
"""Kernels D, G and H of this checkout against another tree's, on one card:
bit identity on the same inputs, then D's time in turns.

    python3 update_ab.py --other DIR [--turns other,this,this,other]
                         [--reps N] [--seed N]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive`).  Its csrc/fused_update.cu is built
with this checkout's nvcc flags into this checkout's `_build/other/` and
loaded beside this checkout's library; both are driven through this
checkout's wrappers (`ops/fused_update.py`) on inputs made from `--seed`
at the flagship shape (8192 worlds x 32 ticks, 4 epochs x 4 minibatches
of 65536 samples, the 4096-wide blocks; obs ~ N(0, 3), valid actions,
log-probs, raw side rows, an obs normalizer with non-trivial statistics,
Adam moments ~ N(0, 1e-3) and their squares).  Cases:

  * D: the whole phase (16 Adam steps) with raw side rows (ustats), with
    normalized ones (ustats None), on the trajectory rounded to bf16, on
    32-wide blocks (32-sample tiles), and one minibatch on 2-wide blocks
    (the unaligned loads), float32 and bf16;
  * G: one minibatch's gradient, float32 and bf16;
  * H: one minibatch as a row-major feat matrix, 24 rows short (a ragged
    last tile).

Each case's outputs (params, mu, nu; or the gradient) are compared bit
for bit.  Then D's phase in turns: the mean of `--reps` back-to-back
calls between CUDA events, and the gradient and reduce launches' device
time from torch.profiler; then, in the same turns, the device time a call
of D on the bf16 trajectory, G (float32, bf16) and H.  ptxas's registers
and spills of both builds' instances come first.  One JSON line per case
and per turn, each with the card's name and power limit; exits non-zero
if any case differs.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_other(other: Path):
    """The other tree's fused_update.cu as a library, built with this
    checkout's nvcc flags and typed by this checkout's entries (the
    wrappers pass the same arguments to both), and what ptxas printed."""
    from madrona_basketball_tpu_torch import _build
    src = other / "madrona_basketball_tpu_torch" / "csrc" / "fused_update.cu"
    out = _build.BUILD_DIR / "other" / "libfused_update.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".log"), "w") as log:
        done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                               str(out), str(src)], stdout=log,
                              stderr=subprocess.STDOUT)
    if done.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n"
                         f"{out.with_suffix('.log').read_text()}")
    return (_build.open_lib(out, "fused_update"),
            _build.ptxas_kernels("fused_update", path=out))


def registers(ptx: dict) -> dict:
    """Registers and spill stores per kernel instance, by its template
    arguments."""
    return {instance(k): {f: v[f] for f in ("registers", "spill_store_bytes")
                          if f in v} for k, v in ptx.items()}


def instance(mangled: str) -> str:
    for key, name in (("update_grad_kernelILi0EfE", "grad<0, float>"),
                      ("update_grad_kernelILi0EtE", "grad<0, bf16>"),
                      ("update_grad_kernelILi1EfE", "grad<1, float>"),
                      ("update_reduce_kernel", "reduce")):
        if key in mangled:
            return name
    return mangled


def inputs(seed: int, dev, num_envs: int = 8192,
           num_rollout_steps: int = 32):
    import torch
    from madrona_basketball_tpu_torch.models.agent import init_agent
    from madrona_basketball_tpu_torch.models.normalize import rms_update
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
    hp = PPOParams(num_envs=num_envs, num_rollout_steps=num_rollout_steps)
    T, W = hp.num_rollout_steps, hp.num_envs
    wb = FU.pick_update_block(W, hp.minibatch_size)
    g = torch.Generator().manual_seed(seed)
    agent = init_agent(torch.Generator().manual_seed(seed), "cpu")
    agent.obs_rms = rms_update(agent.obs_rms,
                               torch.randn((256, 128), generator=g) * 2 + 1)
    traj = torch.randn((T, 128, W), generator=g) * 3
    for j, n in enumerate(FU.BUCKETS):
        traj[:, FU.R_ACT + j] = torch.randint(0, n, (T, W), generator=g)
    traj[:, FU.R_LOGP] = torch.randn((T, W), generator=g) * 0.3
    side = torch.randn((T, FU.SIDE_ROWS, W), generator=g)
    u = torch.rand(2, generator=g)
    ustats = torch.tensor([[float(torch.randn(1, generator=g)),
                            0.5 + float(u[0]),
                            0.1 * float(torch.randn(1, generator=g)),
                            0.5 + float(u[1]), 0, 0, 0, 0]])
    params = FU.pack_weights(agent.net)
    mu = tuple(torch.randn(x.shape, generator=g) * 1e-3 for x in params)
    nu = tuple(m * m for m in mu)
    nrm = FU.pack_norm(agent.obs_rms)

    def perms(wb):
        n = T * W // wb
        return torch.cat([torch.randperm(n, generator=g)
                          for _ in range(hp.update_epochs)]).to(torch.int32)
    to = (lambda x: x.to(dev))
    return {"hp": hp, "traj": to(traj), "side": to(side),
            "ustats": to(ustats), "nrm": to(nrm),
            "params": tuple(map(to, params)), "mu": tuple(map(to, mu)),
            "nu": tuple(map(to, nu)),
            "wb": wb, "idx": {b: to(perms(b)) for b in (wb, 32, 2)}}


def cases(x):
    """name: a call of this checkout's wrappers, returning its tensors."""
    import torch
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    hp, BF = x["hp"], torch.bfloat16
    side_n = FU.normalize_side(x["side"], x["ustats"])

    def d(wb, traj, side, ustats, n_mb=None):
        idx = x["idx"][wb]
        if n_mb is not None:
            idx = idx[:n_mb * hp.minibatch_size // wb]
        return lambda: sum(FU.fused_update_phase(
            hp, idx, 0, traj, side, x["nrm"], ustats, x["params"], x["mu"],
            x["nu"], wb=wb), ())

    wb = x["wb"]
    bpm = hp.minibatch_size // wb
    tb, sb = FU.gather_blocks(x["idx"][wb][:bpm], x["traj"], side_n, wb)
    feat = torch.cat([tb.T, sb[:3].T], dim=1)[:hp.minibatch_size - 24]
    feat = feat.contiguous()
    tr, tr16 = x["traj"], x["traj"].to(BF)
    return {
        "D": d(wb, tr, x["side"], x["ustats"]),
        "D_normalized_side": d(wb, tr, side_n, None),
        "D_bf16": d(wb, tr16, x["side"], x["ustats"]),
        "D_wb32": d(32, tr, x["side"], x["ustats"]),
        "D_wb2_one_minibatch": d(2, tr, x["side"], x["ustats"], 1),
        "D_bf16_wb2_one_minibatch": d(2, tr16, x["side"], x["ustats"], 1),
        "G": lambda: FU.fused_minibatch_grad_prefetch(
            hp, x["idx"][wb][:bpm], tr, side_n, x["nrm"], *x["params"],
            wb=wb),
        "G_bf16": lambda: FU.fused_minibatch_grad_prefetch(
            hp, x["idx"][wb][:bpm], tr16, side_n, x["nrm"], *x["params"],
            wb=wb),
        "H_ragged": lambda: FU.fused_minibatch_grad(hp, feat, x["nrm"],
                                                    *x["params"]),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--turns", default="other,this,this,other")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=20)
    a = ap.parse_args()
    import torch
    from chip_smoke import cuda_ms, kernel_ms
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    if not torch.cuda.is_available():
        raise SystemExit("update_ab: needs one CUDA card")
    name = card()
    dev = torch.device("cuda:0")
    _build.build(["fused_update"])
    other_lib, other_ptx = build_other(a.other.resolve())
    libs = {"this": _build.load("fused_update"), "other": other_lib}
    print(json.dumps({"ptxas": {
        "this": registers(_build.ptxas_kernels("fused_update")),
        "other": registers(other_ptx)}, "card": name}), flush=True)
    own_lib = FU._lib

    def use(which):
        """The wrappers, while the context lasts, on one tree's library."""
        return mock.patch.object(
            FU, "_lib", lambda t, **kw: (own_lib(t, **kw)[0], libs[which]))
    x = inputs(a.seed, dev)
    calls = cases(x)
    bad = 0
    for case, fn in calls.items():
        out = {}
        for which in ("other", "this"):
            with use(which):
                out[which] = [t.detach().clone() for t in fn()]
        torch.cuda.synchronize()
        diff = [int((o.view(torch.int32) != t.view(torch.int32)).sum())
                for o, t in zip(out["other"], out["this"])]
        bad += sum(diff) > 0
        print(json.dumps({"case": case, "tensors": len(diff),
                          "entries": sum(t.numel() for t in out["this"]),
                          "entries_differing": sum(diff),
                          "bit_identical": sum(diff) == 0, "card": name}),
              flush=True)
    n_mb = x["hp"].update_epochs * x["hp"].num_minibatches
    turns = {}
    for which in a.turns.split(","):
        with use(which):
            ms = cuda_ms(calls["D"], a.reps, 3)
            grad = kernel_ms(calls["D"], a.reps,
                             {"update_grad_kernel<0, float>": n_mb})
            red = kernel_ms(calls["D"], a.reps,
                            {"update_reduce_kernel": n_mb})
        turns.setdefault(which, []).append(ms)
        print(json.dumps({"turn": which, "phase_ms_events": ms,
                          "grad_ms_profiler": grad,
                          "reduce_ms_profiler": red,
                          "grad_us_a_launch": grad / n_mb * 1e3,
                          "card": name}), flush=True)
    # every instance's device ms a call (gradient and reduce launches) in
    # the same turns
    timed = {"D_bf16": ("update_grad_kernel<0, unsigned short>", n_mb),
             "G": ("update_grad_kernel<0, float>", 1),
             "G_bf16": ("update_grad_kernel<0, unsigned short>", 1),
             "H_ragged": ("update_grad_kernel<1, float>", 1)}
    for which in a.turns.split(","):
        row = {}
        with use(which):
            for case, (kern, k) in timed.items():
                row[case] = {
                    "ms": kernel_ms(calls[case], a.reps,
                                    {kern: k, "update_reduce_kernel": k}),
                    "grad_ms": kernel_ms(calls[case], a.reps, {kern: k})}
        print(json.dumps({"turn": which, "cases": row, "card": name}),
              flush=True)
    print(json.dumps({"turns": turns, "cases_differing": bad,
                      "card": name}), flush=True)
    if bad:
        raise SystemExit(f"{bad} cases differ")


if __name__ == "__main__":
    main()
