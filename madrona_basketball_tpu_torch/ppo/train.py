"""Episode statistics of the trainer (port of the stats part of
`madrona_basketball_tpu.ppo.train`, train.py:51-96): the reference's
PPOStats + AverageMeter(window=100) (scripts/ppo_stats.py:8-50,153-172),
and the fused path's windowed-meter scan with its CUDA kernel
(csrc/meter_scan.cu)."""

from __future__ import annotations

import dataclasses

import torch

F32 = torch.float32


@dataclasses.dataclass
class EpisodeStats:
    curr_rewards: torch.Tensor     # (N,)
    episode_lengths: torch.Tensor  # (N,)
    mean_reward: torch.Tensor      # ()
    reward_size: torch.Tensor      # ()
    mean_length: torch.Tensor      # ()
    length_size: torch.Tensor      # ()


def init_stats(num_envs: int, device="cuda") -> EpisodeStats:
    def z():
        return torch.zeros((), dtype=F32, device=device)
    return EpisodeStats(
        curr_rewards=torch.zeros((num_envs,), dtype=F32, device=device),
        episode_lengths=torch.zeros((num_envs,), dtype=F32, device=device),
        mean_reward=z(), reward_size=z(), mean_length=z(), length_size=z())


def _meter_update(mean, cur_size, values_sum, count, max_size=100.0):
    """AverageMeter.update with a masked batch
    (scripts/ppo_stats.py:160-167)."""
    has = count > 0
    new_mean = torch.where(has, values_sum / torch.clamp(count, min=1.0),
                           0.0)
    size = torch.clamp(count, max=max_size)
    old_size = torch.minimum(max_size - size, cur_size)
    total = old_size + size
    merged = torch.where(has, (mean * old_size + new_mean * size) /
                         torch.clamp(total, min=1.0), mean)
    return merged, torch.where(has, total, cur_size)


METERS = 4  # [reward mean, reward window, length mean, length window]


def meter_scan_plain(ticks, meters):
    """Plain version of the meter kernel: `ticks` (nb, T, 8) per-(block,
    tick) sums [done count, sum(curr * done), sum(lens * done), 0...] from
    kernel C, summed over blocks, then T updates of the reward and length
    meters `meters` (4,) -> (4,)."""
    per_t = ticks.sum(dim=0)
    r_mean, r_size, l_mean, l_size = meters.unbind()
    for t in range(per_t.shape[0]):
        r_mean, r_size = _meter_update(r_mean, r_size, per_t[t, 1],
                                       per_t[t, 0])
        l_mean, l_size = _meter_update(l_mean, l_size, per_t[t, 2],
                                       per_t[t, 0])
    return torch.stack([r_mean, r_size, l_mean, l_size])


launches = 0  # meter kernel launches (the wrapper counts, the caller resets)


def meter_scan(ticks, meters):
    """The windowed-meter scan of train_fused.py:602-615 (JAX package):
    csrc/meter_scan.cu on CUDA tensors, `meter_scan_plain` on CPU tensors.
    One block; a thread per tick sums the blocks' partials, then one
    thread runs the T-step recursion, so the scan stays on the device
    (no host copy, no T x 2 x ~12 launches of 0-d tensors)."""
    global launches
    nb, T, cols = ticks.shape
    if cols != 8 or meters.shape != (METERS,) or \
            ticks.dtype != F32 or meters.dtype != F32:
        raise ValueError("ticks must be (nb, T, 8) and meters (4,) float32")
    if ticks.device.type == "cpu":
        return meter_scan_plain(ticks, meters)
    if ticks.device.type != "cuda":
        raise ValueError(f"unsupported device {ticks.device}")
    from .. import _build
    _build.check_device(ticks.device, meters=meters)
    lib = _build.load("meter_scan")
    ticks, meters = ticks.contiguous(), meters.contiguous()
    out = torch.empty((METERS,), dtype=F32, device=ticks.device)
    err = lib.mbb_meter_scan(_build.ptr(ticks), _build.ptr(meters),
                             _build.ptr(out), nb, T,
                             _build.stream(ticks.device))
    _build.check(err, "meter_scan")
    launches += 1
    return out


def _stats_step(st: EpisodeStats, rew, done) -> EpisodeStats:
    curr = st.curr_rewards + rew
    lens = st.episode_lengths + 1.0
    count = done.sum()
    r_mean, r_size = _meter_update(st.mean_reward, st.reward_size,
                                   (curr * done).sum(), count)
    l_mean, l_size = _meter_update(st.mean_length, st.length_size,
                                   (lens * done).sum(), count)
    return EpisodeStats(curr_rewards=curr * (1.0 - done),
                        episode_lengths=lens * (1.0 - done),
                        mean_reward=r_mean, reward_size=r_size,
                        mean_length=l_mean, length_size=l_size)
