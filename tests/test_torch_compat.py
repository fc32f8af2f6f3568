"""Reference-PyTorch-checkpoint import: forward-pass equivalence.

Builds a torch network with the reference Agent's exact architecture and
state_dict key structure (scripts/agent.py:107-137), computes its
deterministic outputs (normalized obs -> backbone -> actor logits,
critic value) in torch, imports the state_dict via torch_compat, and
checks the JAX forward produces the same logits/values."""

import numpy as np
import pytest
from tests import torch_threads  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from madrona_basketball_tpu.models import action as action_dist  # noqa: E402
from madrona_basketball_tpu.models import agent as agent_lib  # noqa: E402
from madrona_basketball_tpu.models.agent import init_agent  # noqa: E402
from madrona_basketball_tpu.models.normalize import rms_normalize  # noqa: E402
from madrona_basketball_tpu.utils.torch_compat import (  # noqa: E402
    agent_params_from_torch_state_dict, load_torch_agent)
from madrona_basketball_tpu import constants as C  # noqa: E402


def _make_torch_agent(input_dim=128, num_channels=32, num_layers=2,
                      action_dim=19, seed=3):
    torch.manual_seed(seed)
    nn = torch.nn
    layers = [nn.Linear(input_dim, num_channels), nn.LayerNorm(num_channels),
              nn.ReLU()]
    for _ in range(num_layers - 1):
        layers += [nn.Linear(num_channels, num_channels),
                   nn.LayerNorm(num_channels), nn.ReLU()]

    class RefAgent(nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = nn.Sequential(*layers)
            self.actor = nn.Linear(num_channels, action_dim)
            self.critic = nn.Linear(num_channels, 1)
            # RunningMeanStd buffers (float64, scripts/agent.py:24-26)
            g = torch.Generator().manual_seed(seed + 1)
            self.register_buffer("obs_mean",
                                 torch.randn(input_dim, generator=g,
                                             dtype=torch.float64) * 0.3)
            self.register_buffer("obs_var", torch.rand(
                input_dim, generator=g, dtype=torch.float64) + 0.5)
            self.register_buffer("obs_count",
                                 torch.tensor(12345.0, dtype=torch.float64))
            self.register_buffer("val_mean",
                                 torch.randn(1, generator=g,
                                             dtype=torch.float64))
            self.register_buffer("val_var", torch.rand(
                1, generator=g, dtype=torch.float64) + 0.5)
            self.register_buffer("val_count",
                                 torch.tensor(678.0, dtype=torch.float64))

        def state_dict_reference_keys(self):
            sd = {}
            for k, v in self.backbone.state_dict().items():
                sd[f"backbone.{k}"] = v
            for k, v in self.actor.state_dict().items():
                sd[f"actor.{k}"] = v
            for k, v in self.critic.state_dict().items():
                sd[f"critic.{k}"] = v
            sd["obs_norm.mean"] = self.obs_mean
            sd["obs_norm.var"] = self.obs_var
            sd["obs_norm.count"] = self.obs_count
            sd["value_norm.mean"] = self.val_mean
            sd["value_norm.var"] = self.val_var
            sd["value_norm.count"] = self.val_count
            return sd

        def forward(self, obs):
            # RunningMeanStd.forward (scripts/agent.py:31-39) then net
            mean = self.obs_mean.to(torch.float32)
            var = self.obs_var.to(torch.float32) + 1e-5
            x = (obs - mean) * torch.rsqrt(var)
            x = torch.clamp(x, -5.0, 5.0)
            h = self.backbone(x)
            return self.actor(h), self.critic(h)[..., 0]

    return RefAgent()


def test_torch_import_forward_equivalence(tmp_path):
    ref = _make_torch_agent()
    sd = ref.state_dict_reference_keys()
    path = tmp_path / "ref_agent_100.pth"
    torch.save(sd, str(path))

    ap = load_torch_agent(str(path))
    net, _template = init_agent(jax.random.PRNGKey(0))

    obs = np.random.RandomState(0).randn(64, 128).astype(np.float32)
    with torch.no_grad():
        t_logits, t_value = ref(torch.from_numpy(obs))

    x = rms_normalize(ap.obs_rms, jnp.asarray(obs), clamp=5.0)
    j_logits, j_value = net.apply(ap.params, x)

    np.testing.assert_allclose(np.asarray(j_logits), t_logits.numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(j_value), t_value.numpy(),
                               atol=2e-4)

    # argmax policy decisions identical
    j_act = action_dist.best(j_logits, C.ACTION_BUCKETS)
    a_imported, _, _ = agent_lib.forward(net, ap, jnp.asarray(obs),
                                         jax.random.PRNGKey(1),
                                         stochastic=False)
    np.testing.assert_array_equal(np.asarray(j_act), np.asarray(a_imported))


def test_torch_import_from_arrays():
    """The converter also accepts plain numpy arrays (no torch needed)."""
    ref = _make_torch_agent(seed=9)
    sd = {k: v.numpy() for k, v in ref.state_dict_reference_keys().items()}
    ap = agent_params_from_torch_state_dict(sd)
    assert ap.params["params"]["Dense_0"]["kernel"].shape == (128, 32)
    assert ap.params["params"]["Dense_2"]["kernel"].shape == (32, 19)
    assert ap.params["params"]["Dense_3"]["kernel"].shape == (32, 1)
    assert float(ap.obs_rms.count) == 12345.0


def test_torch_import_architecture_mismatch_rejected(tmp_path):
    """A .pth with a different architecture fails at load time with both
    shape trees named (not as an opaque downstream shape error)."""
    from madrona_basketball_tpu.utils.checkpoint import load_agent
    ref = _make_torch_agent(num_channels=64, seed=4)
    path = tmp_path / "wide_5000.pth"
    torch.save(ref.state_dict_reference_keys(), str(path))
    with pytest.raises(ValueError, match="does not match"):
        load_agent(str(path))
