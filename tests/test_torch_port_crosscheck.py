"""The port's cross-check trainer (crosscheck/torch_ppo.py) against the
JAX package's (crosscheck/torch_ppo.py, torch as well), both on the CPU:
the same weights (the JAX agent's, loaded into both) and the same
trajectories must give the same forward (actions, log-probs, values),
advantages, normalizer states and post-update parameters, bit for bit,
with the port's explicit generators in the state of the global generator
the JAX module draws from.  `TorchAgent.from_agent_params` takes the
port's `Agent` (the reference-layout state_dict).  Then `train` runs 2
iterations at 32 worlds on the port's native host executor with
device="cpu"."""

import numpy as np
import torch

from madrona_basketball_tpu.crosscheck import torch_ppo as J

from madrona_basketball_tpu_torch import constants as C
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.crosscheck import torch_ppo as P
from madrona_basketball_tpu_torch.models.agent import init_agent
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.utils.checkpoint import state_dict


def _pair(seed):
    torch.manual_seed(seed)
    ja = J.TorchAgent()
    pa = P.TorchAgent()
    pa.load_state_dict(ja.state_dict())
    return ja, pa


def _buffer(rng, T, N):
    obs = rng.normal(scale=3.0, size=(T, N, C.OBS_SIZE)).astype(np.float32)
    obs[:, :, C.OBS_USED:] = 0.0
    acts = np.stack([rng.randint(0, n, (T, N)) for n in C.ACTION_BUCKETS],
                    axis=-1)
    buf = dict(obs=obs,
               log_probs=rng.normal(-6.0, 0.3, (T, N)).astype(np.float32),
               values=rng.normal(size=(T, N)).astype(np.float32),
               rewards=rng.normal(size=(T, N)).astype(np.float32),
               not_dones=(rng.uniform(size=(T, N)) > 0.1).astype(np.float32),
               next_value=rng.normal(size=(N,)).astype(np.float32))
    out = {k: torch.from_numpy(v) for k, v in buf.items()}
    out["actions"] = torch.from_numpy(acts).long()
    return out


def _same_params(a, b):
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def test_from_agent_params_takes_the_port_agent():
    agent = init_agent(torch.Generator().manual_seed(3), "cpu")
    ta = P.TorchAgent.from_agent_params(agent)
    for k, v in state_dict(agent).items():
        assert torch.equal(ta.state_dict()[k], v.to(ta.state_dict()[k].dtype)), k


def test_forward_matches_jax_module_bit_for_bit():
    ja, pa = _pair(1)
    obs = torch.from_numpy(np.random.RandomState(0).normal(
        scale=4.0, size=(64, C.OBS_SIZE)).astype(np.float32))
    for stochastic in (True, False):
        torch.manual_seed(5)
        want = ja(obs, stochastic=stochastic)
        got = pa(obs, stochastic=stochastic,
                 gen=torch.Generator().manual_seed(5))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert torch.equal(pa.evaluate(obs), ja.evaluate(obs))
    a = torch.randint(0, 2, (64, 6))
    for g, w in zip(pa.get_stats(obs, a), ja.get_stats(obs, a)):
        assert torch.equal(g, w)


def test_update_matches_jax_module_bit_for_bit():
    T, N = 8, 32
    hp = PPOParams(num_envs=N, num_rollout_steps=T, num_minibatches=4,
                   update_epochs=2)
    ja, pa = _pair(2)
    buf = _buffer(np.random.RandomState(7), T, N)
    out_j = J.compute_advantages_torch(ja, buf, hp.gamma, hp.gae_lambda)
    out_p = P.compute_advantages_torch(pa, buf, hp.gamma, hp.gae_lambda)
    for g, w in zip(out_p, out_j):
        assert torch.equal(g, w)
    _same_params(pa, ja)                 # the normalizers' buffers too
    opt_j = torch.optim.Adam(ja.parameters(), lr=hp.learning_rate, eps=1e-8)
    opt_p = torch.optim.Adam(pa.parameters(), lr=hp.learning_rate, eps=1e-8)
    torch.manual_seed(9)
    J.update_policy_torch(ja, opt_j, buf, *out_j, hp)
    P.update_policy_torch(pa, opt_p, buf, *out_p, hp,
                          torch.Generator().manual_seed(9))
    _same_params(pa, ja)


def test_train_two_iterations_on_the_host_engine():
    hp = PPOParams(num_envs=32, num_rollout_steps=16, num_minibatches=2,
                   update_epochs=1)
    agent = P.TorchAgent(gen=torch.Generator().manual_seed(0))
    w0 = agent.actor.weight.detach().clone()
    agent, history = P.train(num_envs=32, num_iterations=2, seed=1,
                             cfg=SimConfig(time_per_period=0.5), agent=agent,
                             log_every=1, hp=hp, device="cpu")
    assert [h["iteration"] for h in history] == [1, 2]
    assert all(np.isfinite(h["mean_reward"]) for h in history)
    assert history[-1]["episodes"] > 0, "no episodes completed"
    assert not torch.equal(agent.actor.weight, w0), "no learning step"
    for p in agent.parameters():
        assert torch.isfinite(p).all()
