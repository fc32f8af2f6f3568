"""The port's `--dp-update` iteration (`make_train_iteration(...,
mesh=..., dp_update=True)`) on the CPU over gloo.

  * one rank equals the flagship iteration within 1e-6, with injected and
    with drawn permutations (JAX's pin: tests/test_parallel.py:205-224);
  * two ranks of 128 worlds against the one-process flagship of 256: the
    statistics that do not depend on the shuffle (value normalizer and
    episode stats exact, the obs normalizer through the cross-shard Chan
    combine within JAX's tolerances) and the weights within JAX's 5e-3
    envelope of the stratified shuffle (:226-261);
  * two ranks equal, bit for bit, the one-process composition of the two
    shards' kernel-G gradients (summed, halved, clip + Adam);
  * two ranks against the JAX `_dp_body` composed by hand on the same
    trajectory and permutations: per shard the interpret-mode Pallas
    `make_fused_minibatch_grad_prefetch`, the mean, `grads_to_tree` and
    `make_optimizer(hp)`'s optax update, and the obs moments through
    `train_fused.py:641-650`'s Chan combine; weights within 1e-5."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.models.normalize import RMSState as JRMS
from madrona_basketball_tpu.models.normalize import \
    rms_update_padded_moments as j_rms_moments
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train import make_optimizer

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.parallel.mesh import DataMesh
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train import clip_adam_step
from madrona_basketball_tpu_torch.ppo.train_fused import make_train_iteration
from tests import torch_dist_workers as DW

D = FR.ROLL_OBS
ONE = {"W": 64, "T": 4, "iters": 2, "dp": True}
# two ranks of 128 worlds: kernel C's 128-world blocks stay whole
TWO = {"W": 256, "T": 4, "M": 2, "E": 2, "iters": 1, "dp": True,
       "perm_shape": (2, 2, 4)}
FLAGSHIP = {**TWO, "dp": False, "perm_shape": (2, 4)}


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.parametrize("perms", ["injected", "drawn"])
def test_one_rank_matches_the_flagship(perms):
    torch.set_num_threads(1)
    spec = dict(ONE, perm_shape=(1, 4, 4)) if perms == "injected" else ONE
    flag = dict(spec, dp=False)
    if perms == "injected":
        flag["perm_shape"] = (4, 4)
    ref = DW.run_iterations(None, flag)
    with DW.single_group() as mesh:
        got = DW.run_iterations(mesh, spec)
    for key in ("params", "mu", "nu"):
        assert _max_err(got[key], ref[key]) <= 1e-6, key
    for k, v in ref["rms"].items():
        np.testing.assert_allclose(got["rms"][k], v, rtol=1e-6, atol=0)
    for it in range(2):
        for k, v in ref["metrics"][it].items():
            np.testing.assert_allclose(float(got["metrics"][it][k]), float(v),
                                       rtol=1e-6, atol=1e-6)
    assert got["count"] == ref["count"] == 2 * 16


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    torch.set_num_threads(1)
    ranks = DW.spawn("iterations", TWO, tmp_path_factory.mktemp("dp"))
    return ranks, DW.run_iterations(None, FLAGSHIP)


def test_two_ranks_stats_exact_params_close(two):
    ranks, ref = two
    for r in ranks:
        for f in ("mean", "var", "count"):
            assert torch.equal(r["rms"][f"value_rms.{f}"],
                               ref["rms"][f"value_rms.{f}"]), f
        assert torch.equal(r["rms"]["obs_rms.count"],
                           ref["rms"]["obs_rms.count"])
        np.testing.assert_allclose(r["rms"]["obs_rms.mean"],
                                   ref["rms"]["obs_rms.mean"], atol=1e-5)
        np.testing.assert_allclose(r["rms"]["obs_rms.var"],
                                   ref["rms"]["obs_rms.var"], rtol=1e-4,
                                   atol=1e-4)
        for k in ("mean_reward", "reward_size", "mean_length",
                  "length_size"):
            assert torch.equal(r["stats"][k], ref["stats"][k]), k
        for k in ("mean_reward", "mean_episode_length", "reward_window"):
            assert torch.equal(r["metrics"][0][k], ref["metrics"][0][k]), k
        for k in ("adv_abs_mean", "value_mean"):
            np.testing.assert_allclose(float(r["metrics"][0][k]),
                                       float(ref["metrics"][0][k]),
                                       rtol=1e-4, atol=1e-4)
        assert torch.equal(r["first"]["ustats"], ref["first"]["ustats"])
        assert _max_err(r["params"], ref["params"]) <= 5e-3
        assert all(torch.isfinite(p).all() for p in r["params"])
    # the sharded stats carry: each rank's columns of the fleet's
    for rank, r in enumerate(ranks):
        cols = slice(128 * rank, 128 * (rank + 1))
        for k in ("curr_rewards", "episode_lengths"):
            assert torch.equal(r["stats"][k], ref["stats"][k][cols]), k
        assert torch.equal(r["first"]["traj"],
                           ref["first"]["traj"][..., cols])
    for key in ("params", "mu", "nu"):
        for a, b in zip(ranks[0][key], ranks[1][key]):
            assert torch.equal(a, b), key


def _hp_local():
    hp = DW.hparams(TWO)
    return dataclasses.replace(hp, num_envs=TWO["W"] // 2)


def test_two_ranks_equal_the_composition_of_the_shards_gradients(two):
    ranks, _ = two
    hp_l = _hp_local()
    wb, bpm = 128, hp_l.minibatch_size // 128
    pre = ranks[0]["first"]["pre"]
    params, mu, nu, count = pre[0], pre[1], pre[2], pre[3]
    per = []
    for rank, r in enumerate(ranks):
        f = r["first"]
        nrm = FU.pack_norm(SimpleNamespace(**f["obs_rms"]))
        per.append((f["perms"][rank].reshape(-1), f["traj"],
                    FU.normalize_side(f["side"], f["ustats"]), nrm))
    for k in range(hp_l.update_epochs * hp_l.num_minibatches):
        flats = []
        for idx, traj, side_n, nrm in per:
            g = FU.minibatch_grad_prefetch_plain(
                hp_l, idx[k * bpm:(k + 1) * bpm], traj, side_n, nrm,
                *params, wb=wb)
            flats.append(torch.cat([x.reshape(-1) for x in g]))
        flat = (flats[0] + flats[1]).mul_(1.0 / 2)
        g = [x.view_as(p) for x, p in
             zip(flat.split([p.numel() for p in params]), params)]
        params, mu, nu = clip_adam_step(params, mu, nu, g, count + k + 1,
                                        lr=hp_l.learning_rate,
                                        max_norm=hp_l.max_grad_norm)
    for r in ranks:
        for a, b in zip(r["params"], params):
            assert torch.equal(a, b)
        for a, b in zip(r["nu"], nu):
            assert torch.equal(a, b)


def test_two_ranks_match_the_composed_jax_dp_body(two):
    ranks, _ = two
    hp_l = _hp_local()
    jhp_l = JPPOParams(**{f.name: getattr(hp_l, f.name)
                          for f in dataclasses.fields(hp_l)})
    T, W_l, wb = TWO["T"], TWO["W"] // 2, 128
    bpm = hp_l.minibatch_size // wb
    pre = ranks[0]["first"]["pre"]
    j = jnp.asarray

    # obs moments: each shard's fold, then the cross-shard Chan combine
    oms = []
    for r in ranks:
        traj = r["first"]["traj"]
        parts = torch.stack([FR.obs_moment_partials(traj[t, :D])
                             for t in range(T)])
        oms.append(FR.combine_obs_moments(parts).numpy())
    m = j(np.stack(oms))
    means, m2s, ns = m[:, :, 0], m[:, :, 1], m[:, :, 2]
    gmean = means.mean(axis=0)
    gm2 = m2s.sum(axis=0) + (ns * (means - gmean[None]) ** 2).sum(axis=0)
    obs_rms = j_rms_moments(
        JRMS(mean=j(pre[4].numpy()), var=j(pre[5].numpy()),
             count=j(pre[6].numpy())), gmean, gm2, ns.sum(axis=0)[0])
    got = ranks[0]["first"]["obs_rms"]
    np.testing.assert_allclose(got["mean"], np.asarray(obs_rms.mean),
                               atol=1e-5)
    np.testing.assert_allclose(got["var"], np.asarray(obs_rms.var),
                               rtol=1e-5, atol=1e-5)
    nrm = JFU.pack_norm(obs_rms, D)

    # the update: per shard kernel G (interpret mode), the mean, optax
    _, template = jagent.init_agent(jax.random.PRNGKey(0))
    params = JFU.unpack_weights(template.params,
                                *[j(x.numpy()) for x in pre[0]], D)
    tx = make_optimizer(jhp_l)
    opt = tx.init(params)
    mbg = jax.jit(JFU.make_fused_minibatch_grad_prefetch(
        jhp_l, D, T, W_l, wb, interpret=True))
    shards = []
    for rank, r in enumerate(ranks):
        f = r["first"]
        us = f["ustats"].numpy()[0]
        side = f["side"].numpy()
        v_n = np.clip((side[:, FU.SIDE_VALUE] - us[0]) * us[1], -5.0, 5.0)
        a_n = (side[:, FU.SIDE_ADV] - us[2]) * us[3]
        r_n = np.clip((side[:, FU.SIDE_RET] - us[0]) * us[1], -5.0, 5.0)
        side_n = np.zeros_like(side)
        side_n[:, 0], side_n[:, 1], side_n[:, 2] = v_n, a_n, r_n
        shards.append((f["perms"][rank].numpy().reshape(-1),
                       j(f["traj"].numpy()), j(side_n)))
    for k in range(hp_l.update_epochs * hp_l.num_minibatches):
        g4 = [mbg(j(idx[k * bpm:(k + 1) * bpm]), traj, side_n, nrm,
                  *JFU.pack_weights(params, D))
              for idx, traj, side_n in shards]
        g4 = [(a + b) * 0.5 for a, b in zip(*g4)]
        grads = JFU.grads_to_tree(params, *g4, D)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    want = JFU.pack_weights(params, D)
    for a, b in zip(ranks[0]["params"], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_dp_update_refuses_what_it_cannot_shard():
    hp = PPOParams(num_envs=128, num_rollout_steps=4)
    mesh2 = DataMesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="untiled"):
        make_train_iteration(SimConfig(), PPOParams(num_envs=2048), "cpu",
                             rollout_tiled=True, mesh=mesh2, dp_update=True)
    with pytest.raises(ValueError, match="kernel C's 128-world block"):
        make_train_iteration(SimConfig(), PPOParams(num_envs=384), "cpu",
                             mesh=mesh2, dp_update=True)
    # 64 worlds a rank: C's block of the fleet is 128
    with pytest.raises(ValueError, match="block"):
        make_train_iteration(SimConfig(), hp, "cpu", mesh=mesh2,
                             dp_update=True)
