"""`engine.init_rows` vs `layout.pack(engine.init_batch(...))`.

With the per-world spawn uniforms reproduced through JAX's own key
splits (engine.py:171-172,299), every row must match: integer rows
exactly, float rows exactly except the spawn coordinates, which go
through cos/sin (numpy vs XLA, 1-ulp tier).  Without injected uniforms
the port draws its own; those are checked for range and spread."""

import jax
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import engine
from madrona_basketball_tpu import systems as S
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.ops import layout as JL

from madrona_basketball_tpu_torch.config import GAME_MODES
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.ops.layout import F_IDX

_KW = {"tag": {}, "1v1": {"tag_mode": False},
       "full": {"one_on_one": False, "tag_mode": False}}
W = 256


def _jax_reset_u(jcfg, key, n):
    keys = jax.random.split(key, n)
    nks = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    return np.asarray(jax.vmap(lambda k: S.draw_noise(jcfg, k).reset_u)(nks))


@pytest.mark.parametrize("mode", sorted(_KW))
def test_init_rows_matches_init_batch(mode):
    jcfg = JSimConfig(**_KW[mode])
    key = jax.random.PRNGKey(11)
    sf_j, si_j = (np.asarray(x) for x in
                  JL.pack(engine.init_batch(jcfg, key, W)))
    ru = torch.tensor(_jax_reset_u(jcfg, key, W).T.copy())
    sf, si = init_rows(GAME_MODES[mode], W, None, "cpu", reset_u=ru)
    np.testing.assert_array_equal(si.numpy(), si_j)
    spawn = [F_IDX[f"a{i}.{n}"] for i in range(2)
             for n in ("pos_x", "pos_y", "target_x", "target_y")]
    other = [r for r in range(sf.shape[0]) if r not in spawn]
    np.testing.assert_array_equal(sf.numpy()[other], sf_j[other])
    np.testing.assert_allclose(sf.numpy()[spawn], sf_j[spawn], atol=2e-6)


def test_init_rows_own_draws():
    cfg = GAME_MODES["tag"]
    gen = torch.Generator().manual_seed(0)
    sf, si = init_rows(cfg, 4096, gen, "cpu")
    x0 = sf[F_IDX["a0.pos_x"]].numpy()
    assert x0.min() >= cfg.start_x - 5.0 and x0.max() <= cfg.start_x + 5.0
    assert 2.5 < x0.std() < 3.3          # U(-5, 5): std 2.89
    d = np.hypot(sf[F_IDX["a1.pos_x"]] - sf[F_IDX["a0.pos_x"]],
                 sf[F_IDX["a1.pos_y"]] - sf[F_IDX["a0.pos_y"]])
    assert float(d.max()) <= 8.0 + 1e-4  # defender on the radius-8 circle
    sf2, _ = init_rows(cfg, 4096, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(sf, sf2)
