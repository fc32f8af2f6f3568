"""The port's tables equal the JAX package's: constants, row layout,
trajectory / noise / side constants, and the CUDA device body's field
lists and parameter struct."""

import re
from pathlib import Path

import numpy as np
import pytest

from madrona_basketball_tpu import constants as JC
from madrona_basketball_tpu.ops import fused_gae as JFG
from madrona_basketball_tpu.ops import fused_rollout as JFR
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPO
from madrona_basketball_tpu.config import SimConfig as JSimConfig

from madrona_basketball_tpu_torch import constants as TC
from madrona_basketball_tpu_torch.config import GAME_MODES, SimConfig
from madrona_basketball_tpu_torch.ops import fused_gae as TFG
from madrona_basketball_tpu_torch.ops import fused_rollout as TFR
from madrona_basketball_tpu_torch.ops import fused_step as TFS
from madrona_basketball_tpu_torch.ops import layout as TL
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams

CSRC = Path(TFS.__file__).resolve().parent.parent / "csrc"


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")}


def test_constants_equal_jax():
    j, t = _public(JC), _public(TC)
    assert set(j) == set(t)
    for k in j:
        assert j[k] == t[k], k


def test_row_layout_equals_jax():
    assert TL.F_IDX == JL.F_IDX
    assert TL.I_IDX == JL.I_IDX
    for n in ("N_F32_ROWS", "N_I32_ROWS", "N_OBS_ROWS", "N_NOISE_ROWS",
              "AGENT_F32", "AGENT_I32", "BALL_F32", "BALL_I32", "GAME_F32",
              "GAME_I32", "HOOP_F32", "HOOP_I32"):
        assert getattr(TL, n) == getattr(JL, n), n
    assert (TL.N_F32_ROWS, TL.N_I32_ROWS, TL.N_OBS_ROWS,
            TL.N_NOISE_ROWS) == (72, 59, 256, 9)


def test_trajectory_and_side_constants_equal_jax():
    for n in ("ROLL_OBS", "R_ACT", "R_LOGP", "R_VALUE", "R_REW", "R_DONE",
              "ROLL_ROWS", "EXT_TRAINEE_U", "EXT_FROZEN_U", "EXT_NOISE_CHUNK",
              "N_LOGITS", "RMS_EPS", "LN_EPS"):
        assert getattr(TFR, n) == getattr(JFR, n), n
    assert (TFR.ROLL_OBS, TFR.R_LOGP, TFR.R_VALUE, TFR.ROLL_ROWS,
            TFR.EXT_NOISE_CHUNK) == (103, 109, 112, 128, 56)
    for n in ("SIDE_VALUE", "SIDE_ADV", "SIDE_RET", "SIDE_ROWS"):
        assert getattr(TFG, n) == getattr(JFU, n), n
    assert TFG.VSTAT_COLS == JFG.VSTAT_COLS
    for W in (1, 96, 256, 8192, 24576):
        assert TFG.pick_gae_block(W) == JFG.pick_gae_block(
            W, TFG.GAE_BLOCK_CAP)


@pytest.mark.parametrize("mode", sorted(GAME_MODES))
def test_configs_equal_jax(mode):
    kw = {"tag": {}, "1v1": {"tag_mode": False},
          "full": {"one_on_one": False, "tag_mode": False}}[mode]
    assert vars(GAME_MODES[mode]) == vars(JSimConfig(**kw))
    assert vars(PPOParams()) == vars(JPPO())


def _xmacro(text, name):
    m = re.search(rf"#define {name}\(X\)(.*?)(?<!\\)\n", text, re.S)
    return tuple(re.findall(r"X\((\w+)\)", m.group(1)))


def test_device_body_field_lists_match_layout():
    text = (CSRC / "sim_world.cuh").read_text()
    for macro, tup in (("MBB_AGENT_F32", TL.AGENT_F32),
                       ("MBB_AGENT_I32", TL.AGENT_I32),
                       ("MBB_BALL_F32", TL.BALL_F32),
                       ("MBB_BALL_I32", TL.BALL_I32),
                       ("MBB_GAME_F32", TL.GAME_F32),
                       ("MBB_GAME_I32", TL.GAME_I32),
                       ("MBB_HOOP_F32", TL.HOOP_F32),
                       ("MBB_HOOP_I32", TL.HOOP_I32)):
        assert _xmacro(text, macro) == tup, macro


def test_sim_params_struct_matches_device_struct():
    text = (CSRC / "sim_world.cuh").read_text()
    body = re.search(r"struct SimParams \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"(\w+)\s*[,;]", body)
    assert names == [n for n, _ in TFS.SimParams._fields_]
    p = TFS.sim_params(SimConfig())
    (h0x, h0y), (h1x, h1y) = TFS._hoop_geometry(SimConfig())
    assert p.h0x == np.float32(h0x) and p.h1x == np.float32(h1x)
    assert p.spot_y == np.float32(h0y + JC.PIXELS_PER_METER / 60.0)
    assert p.tag_mode == 1


def test_policy_buffer_layout_matches_kernel():
    # the packed-policy layout of kernels B and I, in their shared header
    text = (CSRC / "rollout_common.cuh").read_text()
    assert "constexpr int POL = P_B + H * 8;  // 6272" in text
    for src in ("fused_rollout.cu", "fused_rollout_tiled.cu"):
        assert '#include "rollout_common.cuh"' in (CSRC / src).read_text()
    assert TFR.POLICY_FLOATS == 6272
