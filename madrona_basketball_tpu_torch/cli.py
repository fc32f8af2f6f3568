"""PPO training CLI of the port —
`python -m madrona_basketball_tpu_torch.cli [...]`.

Port of `madrona_basketball_tpu/cli.py:28-149,281-500` for the flagship
trainer (rollout kernel + fused gradients + fused GAE) and its
`--rollout-tiled` variant (kernel I, then kernel E for the obs moments;
the world count a multiple of 1024): the same flags and defaults, plus
`--device` (default "cuda"; "cpu" runs the plain torch versions of the
kernels, for small runs).  Each iteration is
`ppo/train_fused.py::make_train_iteration`; the log line and the
checkpoint cadence are the JAX CLI's.  `--iters-per-dispatch` has the
JAX CLI's meaning (cli.py:421-436): N iterations per host dispatch
(`ppo/train.py::make_train_chunk`, on the card one iteration captured as
a CUDA graph and replayed N times), 0 = auto (the largest divisor of the
log and save cadences up to 50), 1 = one eager iteration per dispatch;
a chunk that does not divide both cadences falls back to the auto value,
and the tail of `--num-iterations` runs one iteration per dispatch, so
logs and checkpoints land on the same iterations for every N.
Checkpoints are reference-layout `.pth` files under
`checkpoints/{model}/{model}_{iteration}.pth`, which the JAX CLI's
`--trainee-checkpoint` also reads.  `--tensorboard` writes every metric
of each log iteration as a scalar to `runs/{model}` (tensorboardX,
through `utils/wandb_logger.py::WandbLogger`).

Multi-GPU (cli.py:93-109,286-296,343-397 of the JAX CLI): one process a
GPU over torch.distributed (NCCL on the card, gloo with `--device cpu`).
`--data-parallel` splits the worlds over every visible GPU (each rank
W / size, ppo/train_fused.py's data mesh): started plainly it spawns one
worker per visible GPU (on one GPU, or the CPU, it runs as the one rank
of an in-process group); under torchrun (RANK and WORLD_SIZE in the
environment) or `--distributed` it joins that group.  `--dp-update` (with
`--data-parallel`, untiled) shards the GAE and the update too: kernel G
a minibatch on each rank, the gradient summed over the ranks.
`--distributed` joins the group first (`parallel/distributed.py::
init_distributed`: torchrun's variables, or a warning and one process).
Only rank 0 prints, saves checkpoints and writes TensorBoard.

The alternate trainer paths (cli.py:337-403 of the JAX CLI) take the JAX
flags, defaults and refusals (`resolve_paths`, with
ppo/train_fused.py::check_paths): `--no-rollout-kernel` and `--backend
xla-rows` run the per-tick rollout (T launches of kernel A, the policy in
torch, then the autodiff update); `--no-fused-gae` runs GAE in torch and
kernel D on the normalized side rows; `--no-fused-grads` the autodiff
update over the feat matrix, shuffled in `--shuffle-block` super-rows;
`--backend structured` the structured-state trainer (ppo/train.py over
systems.py); `--viewer` records world 0 on the per-tick rollout, drops
episode npz files under logs/{model} (`EpisodeRecorder`, the JAX CLI's)
and spawns `python -m madrona_basketball_tpu_torch.viewer
--live-log-folder logs/{model}` to play them (not on a headless host: no
DISPLAY, WAYLAND_DISPLAY or SDL_VIDEODRIVER), torn down at exit.
`--bf16-traj` (the untiled fused-GAE paths: the flagship,
`--data-parallel`, `--dp-update`) stores kernel B's trajectory in
bfloat16, which kernels C, E, D and G upcast on load; `--bf16-policy`
(wherever the untiled rollout kernel runs, also with `--no-fused-gae`
and `--no-fused-grads`) rounds kernel B's Dense operands to bf16; other
combinations exit with the JAX trainer's messages, and the structured
backend ignores both, as the JAX CLI does.  `--rollout-block` (a TPU
kernel's VMEM tile) is refused for good (`UNPORTED`).

The loop body (dispatch, metric unstack, log readback, save) is
`ppo/train.py::TrainLoop`, shared with the league.  `--trace-out PATH`
turns the tracer on for the training run (utils/profiling.py; rank 0
under a group) and writes one Chrome trace at its end: the loop's host
spans and the device phases of every iteration on the device's clock,
the clock's calibration, the graphs' kernel-node counts, the dropped
records.

`--interactive` (cli.py:248-277 of the JAX CLI) trains through
`ppo/train_interactive.py::InteractiveTrainer` with the embedded viewer
(viewer/app.py, pygame): per tick the policy, the controller manager's
check and one kernel-A step, then the autodiff update; H hands world 0's
selected agent to the keyboard, Ctrl+P pauses, 1-0 switch worlds.  It
takes the training flags above and ignores the path flags, as the JAX
CLI does; `SDL_VIDEODRIVER=dummy` runs it without a display.
"""

from __future__ import annotations

import argparse
import atexit
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import SimConfig
from .ops.fused_rollout import check_tiled_worlds
from .ppo.hparams import PPOParams
from .parallel.distributed import init_distributed, init_single_process
from .parallel.mesh import make_mesh, shard_train_state
from .ppo.train import TrainLoop, auto_chunk
from .ops.fused_step import _hoop_geometry
from .ppo.train import init_train_state as init_structured
from .ppo.train import make_train_iteration as make_structured
from .ppo.train_fused import (check_paths, init_train_state,
                              make_train_iteration)
from .utils.checkpoint import checkpoint_path, load_agent, save_agent
from .utils.profiling import trace
from .utils.timers import PPOTimer
from .utils.wandb_logger import WandbLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PPO trainer (PyTorch + CUDA)")
    p.add_argument("--seed", type=int, default=321)
    p.add_argument("--model-name", type=str, default="Model")
    p.add_argument("--trainee-idx", type=int, default=1)
    p.add_argument("--trainee-checkpoint", type=str, default=None)
    p.add_argument("--frozen-checkpoint", type=str, default=None)
    p.add_argument("--num-iterations", type=int, default=100_000)
    p.add_argument("--num-envs", type=int, default=8192)
    p.add_argument("--num-rollout-steps", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--gamma", type=float, default=0.998)
    p.add_argument("--gae-lambda", type=float, default=0.95)
    p.add_argument("--num-minibatches", type=int, default=4)
    p.add_argument("--update-epochs", type=int, default=4)
    p.add_argument("--clip-coef", type=float, default=0.2)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--vf-coef", type=float, default=1.0)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--log-every-n-iterations", type=int, default=100)
    p.add_argument("--save-model-every-n-iterations", type=int, default=100)
    p.add_argument("--no-tag-mode", action="store_true", default=False)
    p.add_argument("--full-game", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--shuffle-block", type=int,
                   default=PPOParams.shuffle_block,
                   help="the autodiff update's epoch shuffle permutes "
                        "blocks of N consecutive samples; 1 = the "
                        "reference's exact sample-granularity shuffle")
    p.add_argument("--viewer", action="store_true", default=False,
                   help="record world-0 episode npz logs for the viewer "
                        "(logs/{model-name}; the per-tick rollout)")
    p.add_argument("--tensorboard", action="store_true", default=False,
                   help="log every metric of each log iteration to "
                        "runs/{model-name} (tensorboardX; rank 0)")
    p.add_argument("--backend", choices=("fused", "structured", "xla-rows"),
                   default="fused",
                   help="fused = the rows trainer over the CUDA kernels; "
                        "structured = the structured-state engine "
                        "(systems.py) in torch; xla-rows = the rows "
                        "trainer without the rollout kernel: the per-tick "
                        "rollout, whose tick is kernel A (the rows tick's "
                        "only card implementation; in JAX xla-rows differs "
                        "from fused only in how the tick is computed)")
    p.add_argument("--interactive", action="store_true", default=False)
    p.add_argument("--rollout-kernel", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="run the T-tick rollout as one launch of kernel B "
                        "(default: on for the fused backend unless "
                        "--viewer); --no-rollout-kernel runs T launches of "
                        "kernel A with the policy in torch")
    p.add_argument("--fused-grads", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="rollout-kernel trainer only: the update phase as "
                        "kernel D; --no-fused-grads runs the autodiff "
                        "update over the feat matrix (--shuffle-block)")
    p.add_argument("--fused-gae", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="rollout-kernel trainer only: GAE and the side "
                        "array as kernel C, normalized inside kernel D; "
                        "requires --fused-grads.  Default: on whenever the "
                        "rollout kernel and fused gradients are; "
                        "--no-fused-gae runs GAE in torch and kernel D on "
                        "the normalized side rows")
    p.add_argument("--data-parallel", action="store_true", default=False,
                   help="split the worlds over every visible GPU, one "
                        "process each (spawned, or torchrun's); the "
                        "learner replicates, the trajectory is gathered")
    p.add_argument("--dp-update", action="store_true", default=False,
                   help="with --data-parallel (untiled): shard the GAE and "
                        "the update too; the 5216-float gradient is summed "
                        "over the ranks each minibatch")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="join the torch.distributed group first "
                        "(torchrun's MASTER_ADDR / MASTER_PORT / RANK / "
                        "WORLD_SIZE)")
    p.add_argument("--rollout-tiled", action="store_true", default=False)
    p.add_argument("--bf16-traj", action="store_true", default=False,
                   help="flagship trainer only (rollout kernel + fused "
                        "grads + fused GAE, untiled): store the rollout "
                        "trajectory in bfloat16 (kernel math stays "
                        "float32); kernels C, E, D and G upcast it on load")
    p.add_argument("--bf16-policy", action="store_true", default=False,
                   help="rollout-kernel trainer only (untiled): bf16 "
                        "operands for kernel B's policy Dense layers "
                        "(float32 sums)")
    p.add_argument("--rollout-block", type=int, default=0)
    p.add_argument("--iters-per-dispatch", type=int, default=0,
                   help="run N training iterations per host dispatch (on "
                        "the card one iteration captured as a CUDA graph "
                        "and replayed N times); 0 = auto (largest divisor "
                        "of the log/save cadences <= 50), 1 = one eager "
                        "iteration per dispatch")
    p.add_argument("--trace-out", type=str, default=None,
                   help="trace the training run (host spans, device "
                        "phase stamps, kernel-node counts) and write a "
                        "Chrome trace to PATH at its end")
    return p


# flag, test of a non-default value, the reason it is refused
UNPORTED = (
    ("--rollout-block", lambda a: a.rollout_block != 0,
     "refused for good: it sets the TPU rollout kernel's VMEM block "
     "(cli.py:138-143 of the JAX package), and kernel B's CTA geometry on "
     "the card is fixed by its design (ROADMAP.md queue 1, item 16)"),
)


def check_ported(args):
    for flag, given, reason in UNPORTED:
        if given(args):
            raise SystemExit(f"{flag}: {reason}")


def resolve_paths(args) -> dict:
    """The rows trainer's path flags as the JAX CLI resolves them
    (cli.py:679-735), checked with its messages: {} for the structured
    backend, else make_train_iteration's backend / rollout_kernel /
    fused_grads / fused_gae / bf16_traj / bf16_policy."""
    if args.backend == "structured":
        return {}
    rollout_kernel = args.rollout_kernel
    if rollout_kernel is None:
        rollout_kernel = args.backend == "fused" and not args.viewer
    fused_gae = args.fused_gae
    if fused_gae is None:
        fused_gae = rollout_kernel and args.fused_grads
    if fused_gae and not (rollout_kernel and args.fused_grads):
        raise SystemExit(
            "--fused-gae requires the rollout kernel and fused gradients "
            "(drop --no-rollout-kernel/--no-fused-grads/--viewer, or drop "
            "--fused-gae)")
    if args.dp_update and not (args.data_parallel and fused_gae):
        raise SystemExit("--dp-update requires --data-parallel and the "
                         "fused-GAE flagship path")
    paths = dict(backend="pallas" if args.backend == "fused" else "xla",
                 rollout_kernel=rollout_kernel, fused_grads=args.fused_grads,
                 fused_gae=fused_gae, bf16_traj=args.bf16_traj,
                 bf16_policy=args.bf16_policy)
    try:
        check_paths(PPOParams(record_world0=args.viewer),
                    rollout_tiled=args.rollout_tiled,
                    mesh=True if args.data_parallel else None,
                    dp_update=args.dp_update, **paths)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return paths


class EpisodeRecorder:
    """Host-side assembly of world-0 per-tick rows into episode npz files,
    the file drops the viewer plays (the JAX CLI's recorder,
    cli.py:152-199; scripts/ppo.py:93-122): armed every `every_n`
    iterations, it waits for world 0's episode to end, records the next
    episode tick by tick and saves it when that one ends."""

    def __init__(self, log_folder: str, hoop_pos: np.ndarray,
                 every_n: int = 100):
        self.log_folder = log_folder
        self.hoop_pos = hoop_pos
        self.every_n = every_n
        self.waiting = False
        self.recording = False
        self.steps: list[dict] = []
        self.saved: list[str] = []
        os.makedirs(log_folder, exist_ok=True)

    def maybe_arm(self, iteration: int):
        if iteration % self.every_n == 0:
            self.waiting = True

    def feed(self, w0: dict, iteration: int):
        """w0: dict of (T, 1, ...) numpy arrays for one rollout."""
        if not (self.waiting or self.recording):
            return
        for t in range(w0["done"].shape[0]):
            done = float(w0["done"][t, 0]) > 0.5
            if self.recording:
                self.steps.append({k: np.asarray(v[t])
                                   for k, v in w0.items()})
                if done:
                    self._save(iteration)
                    self.recording = False
                    return
            elif self.waiting and done:
                self.waiting = False
                self.recording = True
                self.steps = []

    def _save(self, iteration: int):
        if not self.steps:
            return
        out = {k: np.stack([s[k] for s in self.steps])
               for k in self.steps[0]}
        out["hoop_pos"] = self.hoop_pos
        path = os.path.join(self.log_folder,
                            f"iter_{iteration}_episode.npz")
        np.savez_compressed(path, **out)
        self.saved.append(path)
        print(f"Episode trajectory saved to {path}")
        self.steps = []


def _recorder(cfg: SimConfig, model_name: str, every_n: int):
    """The world-0 recorder of `--viewer` (cli.py:745-760)."""
    (h0x, h0y), (h1x, h1y) = _hoop_geometry(cfg)
    hoop_pos = np.array([[[h0x, h0y, 0.0], [h1x, h1y, 0.0]]], np.float32)
    return EpisodeRecorder(f"logs/{model_name}", hoop_pos, every_n=every_n)


def _spawn_viewer(log_folder: str):
    """Launch the live-log watcher viewer as a subprocess
    (scripts/ppo.py:261-276; the JAX CLI's cli.py:202-229).  Skipped on a
    headless host (no display and no SDL video driver override): the
    recorder still drops npz logs that a later `python -m
    madrona_basketball_tpu_torch.viewer` can play."""
    import subprocess
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
            or os.environ.get("SDL_VIDEODRIVER")):
        print("Headless host (no DISPLAY): not spawning the live viewer; "
              f"npz drops still land in {log_folder}")
        return None
    os.makedirs(log_folder, exist_ok=True)
    print("Setting up viewer process...")
    command = [sys.executable, "-m", "madrona_basketball_tpu_torch.viewer",
               "--live-log-folder", log_folder]
    try:
        proc = subprocess.Popen(command)
    except OSError as e:
        print(f"Failed to start viewer process: {e}")
        return None
    print(f"Viewer process started with PID: {proc.pid}")
    print(f"Viewer is now watching: {log_folder}")
    return proc


def _teardown_viewer(proc) -> None:
    """Terminate the spawned viewer on trainer exit
    (scripts/ppo.py:352-368; the JAX CLI's cli.py:232-245)."""
    import subprocess
    if proc is None:
        return
    print(f"Terminating viewer process (PID: {proc.pid})...")
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=5)
            print("Viewer process terminated successfully")
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            print("Viewer process killed")
    else:
        print(f"Viewer process already exited with code: {proc.returncode}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, argv, port: int, n: int):
    """One spawned `--data-parallel` rank: torchrun's variables, then
    `main`."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
    main(argv)


def _join_group(args, argv) -> tuple:
    """(owns, spawned): join or make the process group the flags ask for.
    owns: this call initialized it (and `main` destroys it); spawned: the
    ranks ran in workers, this process has nothing left to do."""
    was = dist.is_initialized()
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.distributed or (args.data_parallel and torchrun):
        n = init_distributed(device=args.device)
        if dist.is_initialized() and dist.get_rank() == 0:
            print(f"torch.distributed: {dist.get_world_size()} process(es), "
                  f"{n} global GPU(s), {dist.get_backend()}")
    if args.data_parallel and not dist.is_initialized():
        n = torch.cuda.device_count() \
            if torch.device(args.device).type == "cuda" else 1
        if n > 1:
            import torch.multiprocessing as mp
            argv = sys.argv[1:] if argv is None else list(argv)
            mp.spawn(_worker, args=(argv, _free_port(), n), nprocs=n)
            return False, True
        init_single_process(args.device)
    return dist.is_initialized() and not was, False


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    if args.interactive:
        return _run_interactive(args)
    paths = resolve_paths(args)
    if args.rollout_tiled and args.backend != "structured" and \
            not args.data_parallel:
        try:
            check_tiled_worlds(args.num_envs)
        except ValueError as e:
            raise SystemExit(f"--rollout-tiled: {e}") from None
    owns, spawned = _join_group(args, argv)
    if spawned:
        return None
    try:
        main_rank = not dist.is_initialized() or dist.get_rank() == 0
        with trace(args.trace_out if main_rank else None, args.device):
            return _train(args, paths)
    finally:
        if owns:
            dist.destroy_process_group()


def _config(args):
    """(model name, SimConfig, PPOParams) of the training flags."""
    model_name = args.model_name or \
        f"MadronaBasketball__{args.seed}__{int(time.time())}"
    cfg = SimConfig(one_on_one=not args.full_game,
                    tag_mode=not args.no_tag_mode and not args.full_game)
    hp = PPOParams(
        num_envs=args.num_envs,
        num_rollout_steps=args.num_rollout_steps,
        learning_rate=args.learning_rate,
        gamma=args.gamma, gae_lambda=args.gae_lambda,
        num_minibatches=args.num_minibatches,
        update_epochs=args.update_epochs,
        clip_coef=args.clip_coef, ent_coef=args.ent_coef,
        vf_coef=args.vf_coef, max_grad_norm=args.max_grad_norm,
        trainee_idx=args.trainee_idx,
        use_frozen=args.frozen_checkpoint is not None,
        record_world0=args.viewer, shuffle_block=args.shuffle_block)
    return model_name, cfg, hp


def _print_config(args, model_name, hp, dev):
    print("🎯 TRAINING CONFIGURATION:")
    print(f"   Trainee Agent Index: {hp.trainee_idx}")
    print(f"   Frozen Checkpoint: {args.frozen_checkpoint}")
    print(f"   Model: {model_name}  Envs: {hp.num_envs}  "
          f"Iters: {args.num_iterations}")
    print(f"   Device: {dev}")


def _run_interactive(args):
    """Interactive training session: the embedded live viewer and the
    human override (scripts/ppo.py:257-276; the JAX CLI's cli.py:248-277,
    ppo/train_interactive.py's loop).  Returns the trainer."""
    from .ppo.train_interactive import InteractiveTrainer
    from .viewer.app import ViewerClass
    model_name, cfg, hp = _config(args)
    dev = args.device
    agent = load_agent(args.trainee_checkpoint, dev) \
        if args.trainee_checkpoint else None
    frozen = load_agent(args.frozen_checkpoint, dev) \
        if args.frozen_checkpoint else None
    _print_config(args, model_name, hp, dev)
    viewer = ViewerClass(training_mode=True)
    timer = PPOTimer(dev)
    trainer = InteractiveTrainer(cfg, hp, agent=agent, frozen=frozen,
                                 viewer=viewer, seed=args.seed, timer=timer,
                                 device=dev)
    viewer.env = trainer.env
    print("Interactive training: H = human control of selected agent "
          "(click to select), Ctrl+P = pause, 1-0 = world switch")
    for iteration in range(1, args.num_iterations + 1):
        timer.start("iter")
        timer.add_steps(hp.num_envs * hp.num_rollout_steps)
        metrics = trainer.train_iteration()
        timer.end("iter")
        if iteration % args.log_every_n_iterations == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"\nUpdate: {iteration}", end=" ")
            timer.print()
            print(f"Mean reward: {m['mean_reward']:.2f}. "
                  f"Mean episode length: {m['mean_episode_length']:.2f}")
            timer.reset()
        if iteration % args.save_model_every_n_iterations == 0:
            save_agent(trainer.agent, checkpoint_path(model_name, iteration))
            print(f"Model {model_name} saved at iteration {iteration}")
    return trainer


def _train(args, paths: dict):
    is_main = not dist.is_initialized() or dist.get_rank() == 0
    mesh = None
    dev = args.device
    if args.data_parallel:
        mesh = make_mesh(dev)
        dev = mesh.device
        if args.num_envs % mesh.size:
            raise SystemExit(f"--num-envs {args.num_envs} must divide evenly "
                             f"over {mesh.size} devices")
        if args.rollout_tiled and args.backend != "structured":
            try:
                check_tiled_worlds(args.num_envs // mesh.size)
            except ValueError as e:
                raise SystemExit(f"--rollout-tiled: {e}") from None
    elif torch.device(dev).type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    model_name, cfg, hp = _config(args)
    dev = args.device
    agent = load_agent(args.trainee_checkpoint, dev) \
        if args.trainee_checkpoint else None
    frozen = load_agent(args.frozen_checkpoint, dev) \
        if args.frozen_checkpoint else None

    if is_main:
        _print_config(args, model_name, hp, dev)
        if mesh is not None:
            print(f"Data-parallel over {mesh.size} devices "
                  f"({hp.num_envs // mesh.size} worlds each"
                  f"{', sharded update' if args.dp_update else ''})")

    log_every = args.log_every_n_iterations
    save_every = args.save_model_every_n_iterations
    chunk_n = args.iters_per_dispatch or auto_chunk(log_every, save_every)
    if chunk_n > 1 and (log_every % chunk_n or save_every % chunk_n):
        # a chunk that straddles a save/log boundary would checkpoint
        # end-of-chunk params under a mid-chunk iteration label
        safe = auto_chunk(log_every, save_every)
        if is_main:
            print(f"--iters-per-dispatch {chunk_n} does not divide the "
                  f"log/save cadence; using {safe} instead")
        chunk_n = safe
    chunk_n = max(1, min(chunk_n, args.num_iterations))
    if is_main:
        print(f"   Iterations per dispatch: {chunk_n}")

    if args.backend == "structured":
        state = init_structured(cfg, hp, args.seed, dev, agent=agent,
                                frozen=frozen)
        if mesh is not None:
            state = shard_train_state(state, mesh)
        train_iteration = make_structured(cfg, hp, dev, mesh=mesh)
    else:
        state = init_train_state(cfg, hp, args.seed, dev, agent=agent,
                                 frozen=frozen)
        if mesh is not None:
            state = shard_train_state(state, mesh, args.dp_update)
        train_iteration = make_train_iteration(
            cfg, hp, dev, rollout_tiled=args.rollout_tiled, mesh=mesh,
            dp_update=args.dp_update, **paths)
    recorder, viewer_process = None, None
    if args.viewer and is_main:
        recorder = _recorder(cfg, model_name, log_every)
        # scripts/ppo.py:261-276: --viewer also spawns the watcher viewer;
        # the atexit hook tears it down on an exception or Ctrl-C too
        viewer_process = _spawn_viewer(recorder.log_folder)
        if viewer_process is not None:
            atexit.register(_teardown_viewer, viewer_process)
    # a missing tensorboardX raises ImportError here, as in the JAX CLI
    logger = WandbLogger("madrona_basketball", model_name,
                         tensorboard_dir=f"runs/{model_name}",
                         use_wandb=False) \
        if args.tensorboard and is_main else None
    timer = PPOTimer(dev)

    def row(iteration, w0):
        timer.add_steps(hp.num_envs * hp.num_rollout_steps)
        if recorder is not None:
            recorder.maybe_arm(iteration)
            recorder.feed({k: v.cpu().numpy() for k, v in w0.items()},
                          iteration)

    def log(m, iteration):
        timer.end("iter")
        if is_main:
            print(f"\nUpdate: {iteration}", end=" ")
            timer.print()
            print(f"Mean reward: {m['mean_reward']:.2f}. "
                  f"Mean episode length: {m['mean_episode_length']:.2f}")
        if logger is not None:
            logger.log(m, iteration)
        timer.reset()
        timer.start("iter")

    def save(state, iteration):
        save_agent(state.agent, checkpoint_path(model_name, iteration))
        print(f"Model {model_name} saved at iteration {iteration}")

    # whole chunks, then the exact tail one iteration per dispatch
    loop = TrainLoop(train_iteration, chunk_n, log_every, save_every,
                     row=row, log=log, save=save if is_main else None)
    timer.start("iter")
    state = loop.run(state, args.num_iterations)
    if viewer_process is not None:
        # the clean exit tears down once and drops the crash-path hook
        atexit.unregister(_teardown_viewer)
        _teardown_viewer(viewer_process)
    if logger is not None:
        logger.close()
    if recorder is not None:
        state.recorded = recorder.saved
    return state


if __name__ == "__main__":
    main()
