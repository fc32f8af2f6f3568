"""`.ckpt` agent files and train-state resume.

`.ckpt` is the JAX package's agent file, `flax.serialization.to_bytes` of
`AgentParams` (utils/checkpoint.py:25-29), written and read by the port's
own msgpack codec (utils/flax_msgpack.py), held against the `msgpack`
package and `flax.serialization` here: the port's file is the JAX
`save_agent`'s byte for byte, flax reads it to equal arrays, the port reads
the JAX file to equal tensors, a nonzero obs-normalizer tail warns and is
zeroed, another architecture raises.  Train-state resume mirrors
tests/test_checkpoint_resume.py: 2 iterations (32 worlds x 4 ticks, the
CPU plain path), save, restore, then one more iteration from each, bit
for bit on every state tensor and metric."""

import copy
import dataclasses
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from madrona_basketball_tpu import constants as JC
from madrona_basketball_tpu.models.agent import init_agent as jinit
from madrona_basketball_tpu.utils import checkpoint as jckpt

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (
    init_train_state, make_train_iteration, restore_train_state,
    save_train_state, state_tensors)
from madrona_basketball_tpu_torch.utils import checkpoint as ckpt
from madrona_basketball_tpu_torch.utils import flax_msgpack as FM
from madrona_basketball_tpu_torch.utils.jax_params import (agent_from_numpy,
                                                           agent_to_numpy)
from tests import torch_threads  # noqa: F401
from tests.test_torch_infer_chunk import _one_thread  # noqa: F401

VALUES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
          -1, -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 40,
          1.5, -0.0, "", "x" * 31, "x" * 40, "y" * 300, "z" * 70000,
          b"", b"abc" * 100, b"q" * 70000, [], [1] * 15, [1] * 20,
          list(range(70000)), {}, {str(i): i for i in range(20)},
          {"a": {"b": [None, True, False]}}, np.float32(2.5), np.int64(7),
          np.zeros((3,), np.int32), np.arange(6, dtype=np.float32)
          .reshape(2, 3), np.ones((), np.float32), np.zeros((1,), np.uint8)]


def _flax_packb(x):
    return msgpack.packb(x, default=serialization._msgpack_ext_pack,
                         use_bin_type=True)


def _flax_unpackb(b):
    return msgpack.unpackb(b, ext_hook=serialization._msgpack_ext_unpack,
                           raw=False)


def _equal(a, b):
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        return type(a) is type(b) and a.dtype == b.dtype and \
            np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_codec_matches_msgpack(i):
    x = VALUES[i]
    b = FM.packb(x)
    assert b == _flax_packb(x)
    assert _equal(FM.unpackb(b), _flax_unpackb(b))


def test_codec_refusals():
    with pytest.raises(TypeError):
        FM.packb(object())
    with pytest.raises(ValueError, match="truncated"):
        FM.unpackb(FM.packb("abc")[:-1])
    with pytest.raises(ValueError, match="after"):
        FM.unpackb(FM.packb(1) + b"\x00")
    chunked = {"__msgpack_chunked_array__": True, "shape": [1]}
    with pytest.raises(ValueError, match="chunked"):
        FM.unpackb(FM.packb(chunked))


def _jax_agent(seed, tail=0.0):
    _, ap = jinit(jax.random.PRNGKey(seed))
    if tail:
        mean = ap.obs_rms.mean.at[JC.OBS_USED:].set(tail)
        ap = ap.replace(obs_rms=ap.obs_rms.replace(mean=mean))
    return ap


def test_port_ckpt_is_the_jax_file(tmp_path):
    ap = _jax_agent(3)
    agent = agent_from_numpy(jax.tree.map(np.asarray, ap), "cpu")
    ckpt.save_agent(agent, str(tmp_path / "port.ckpt"))
    jckpt.save_agent(ap, str(tmp_path / "jax.ckpt"))
    port_bytes = (tmp_path / "port.ckpt").read_bytes()
    assert port_bytes == (tmp_path / "jax.ckpt").read_bytes()
    back = serialization.from_bytes(_jax_agent(0), port_bytes)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ap)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    loaded = jckpt.load_agent(str(tmp_path / "port.ckpt"))
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(ap)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_ckpt_loads_into_the_port(tmp_path):
    ap = _jax_agent(4)
    path = jckpt.save_agent(ap, str(tmp_path / "a.ckpt"))
    agent = ckpt.load_agent(path, "cpu")
    want = agent_from_numpy(jax.tree.map(np.asarray, ap), "cpu")
    sd, sd_want = ckpt.state_dict(agent), ckpt.state_dict(want)
    assert sorted(sd) == sorted(sd_want)
    for k in sd:
        assert torch.equal(sd[k], sd_want[k]), k
    tree = agent_to_numpy(agent)
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(serialization.to_state_dict(ap))):
        np.testing.assert_array_equal(a, np.asarray(b))
    # .pth and .ckpt of one agent load equal
    ckpt.save_agent(agent, str(tmp_path / "a.pth"))
    sd_pth = ckpt.state_dict(ckpt.load_agent(str(tmp_path / "a.pth"), "cpu"))
    assert all(torch.equal(sd_pth[k], sd[k]) for k in sd)


def test_ckpt_obs_tail_warns_and_is_zeroed(tmp_path):
    ap = _jax_agent(5, tail=0.5)
    path = jckpt.save_agent(ap, str(tmp_path / "t.ckpt"))
    with pytest.warns(UserWarning, match="structurally zero"):
        agent = ckpt.load_agent(path, "cpu")
    assert not agent.obs_rms.mean[JC.OBS_USED:].any()
    np.testing.assert_array_equal(agent.obs_rms.mean[:JC.OBS_USED].numpy(),
                                  np.asarray(ap.obs_rms.mean)[:JC.OBS_USED])


def test_ckpt_refusals(tmp_path):
    tree = agent_to_numpy(agent_from_numpy(
        jax.tree.map(np.asarray, _jax_agent(6)), "cpu"))
    tree["params"]["params"]["Dense_1"]["kernel"] = np.zeros((32, 64),
                                                             np.float32)
    (tmp_path / "w.ckpt").write_bytes(FM.packb(tree))
    with pytest.raises(ValueError, match="architecture"):
        ckpt.load_agent(str(tmp_path / "w.ckpt"), "cpu")
    with pytest.raises(ValueError, match="ends in"):
        ckpt.load_agent(str(tmp_path / "w.npz"), "cpu")


@pytest.mark.parametrize("use_frozen", [False, True],
                         ids=["flagship", "frozen"])
def test_train_state_resume(tmp_path, use_frozen):
    cfg = SimConfig()
    hp = PPOParams(num_envs=32, num_rollout_steps=4, use_frozen=use_frozen)
    it = make_train_iteration(cfg, hp, "cpu")
    state = init_train_state(cfg, hp, seed=7, device="cpu")
    for _ in range(2):
        state, _ = it(state)
    path = save_train_state(state, str(tmp_path / "state.pt"))
    restored = restore_train_state(path, "cpu")
    for x, y in zip(state_tensors(state), state_tensors(restored)):
        assert torch.equal(x, y)
    cont_a, out_a = it(copy.deepcopy(state))
    cont_b, out_b = it(restored)
    ta, tb = state_tensors(cont_a), state_tensors(cont_b)
    assert len(ta) == len(tb) == 53
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    for k in out_a["metrics"]:
        assert torch.equal(out_a["metrics"][k], out_b["metrics"][k]), k
    for f in ("seed", "counter", "iteration"):
        assert getattr(cont_a, f) == getattr(cont_b, f)
    assert cont_b.iteration == 3 and cont_b.opt.count == cont_a.opt.count
    assert dataclasses.fields(cont_a) == dataclasses.fields(cont_b)


def test_codec_needs_no_msgpack_package():
    """The card's machine has no `msgpack`: the port's checkpoint code
    imports neither it nor flax (checked in a subprocess, since this test
    process has both)."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(ckpt.__file__).resolve().parents[2]
    probe = ("import sys, madrona_basketball_tpu_torch.utils.checkpoint, "
             "madrona_basketball_tpu_torch.infer, "
             "madrona_basketball_tpu_torch.selfplay; "
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('msgpack', 'flax', 'jax')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, timeout=30,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
