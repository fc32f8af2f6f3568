"""The port's viewer (viewer/app.py, viewer/__main__.py) and the CLI's
viewer process on the CPU, headless (SDL's dummy drivers): the ten cases
of tests/test_viewer_infer.py on the port, with the rules controller's
case in tests/test_torch_controllers.py and, in its place, the parse held
against the JAX viewer's.

An npz that the port's `infer` writes must carry the reference's keys and
shapes, parse into episodes and events, and render; `load_and_parse_log`
must give the JAX viewer's episodes and events on it, edited so that
every event family fires (every event field equal, for each
--track-event choice); `mgi_playlist` must order a
folder as the JAX one does; the CLI's `_spawn_viewer` starts `python -m
madrona_basketball_tpu_torch.viewer --live-log-folder` and
`_teardown_viewer` ends it, and a host without a display spawns nothing;
the embedded viewer ticks over a CPU env (the one host copy of what it
draws equal to the export's world); fading trails render; the chunked and
per-step eval write the same schema."""

import os

import numpy as np
import pytest
import torch

from madrona_basketball_tpu.viewer.__main__ import mgi_playlist as j_playlist
from madrona_basketball_tpu.viewer.app import ViewerClass as JViewer

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.env import BasketballEnv
from madrona_basketball_tpu_torch.infer import infer
from madrona_basketball_tpu_torch.models.agent import init_agent
from tests import torch_threads  # noqa: F401

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
os.environ.setdefault("SDL_AUDIODRIVER", "dummy")


def _agent(seed):
    return init_agent(torch.Generator().manual_seed(seed), "cpu")


@pytest.fixture(scope="module")
def trajectory_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("logs") / "traj.npz")
    env = BasketballEnv(4, SimConfig(), seed=0, device="cpu")
    infer(env, _agent(1), log_path=path, num_episodes=1, max_steps=25,
          stochastic=True, seed=0, trainee_idx=1, chunk_size=1)
    return path


def _frame(viewer, raw, t, trails=None):
    hp = np.asarray(raw["hoop_pos"]).reshape(-1, 3)
    viewer._draw_frame(raw["agent_pos"][t, 0], raw["orientation"][t, 0],
                       raw["ball_pos"][t, 0, 0], hp,
                       raw["game_state"][t, 0],
                       possession=raw["agent_possession"][t, 0],
                       trails=trails)
    viewer.pg.display.flip()


def test_npz_schema(trajectory_npz):
    raw = dict(np.load(trajectory_npz, allow_pickle=True))
    for key in ("agent_pos", "ball_pos", "ball_vel", "orientation",
                "ball_physics", "agent_possession", "game_state", "rewards",
                "actions", "done", "hoop_pos"):
        assert key in raw, key
    T = raw["done"].shape[0]
    assert raw["agent_pos"].shape == (T, 4, 2, 3)
    assert raw["ball_physics"].shape == (T, 4, 1, 7)
    assert raw["game_state"].shape == (T, 4, 14)


def test_viewer_parse_and_render(trajectory_npz):
    from madrona_basketball_tpu_torch.viewer.app import ViewerClass
    raw, episodes, _ = ViewerClass.load_and_parse_log(trajectory_npz)
    assert len(episodes) >= 1
    _frame(ViewerClass(headless=True), raw, 0)


def test_track_event_filter(trajectory_npz):
    """--track-event (scripts/viewer.py:1060): a single key parses only
    that family, 'none' nothing, 'all' the union of the single ones."""
    from madrona_basketball_tpu_torch.viewer.app import ViewerClass
    parse = ViewerClass.load_and_parse_log
    _, _, all_events = parse(trajectory_npz, track_event="all")
    assert parse(trajectory_npz, track_event="none")[2] == []
    singles = []
    for name in ("shoot", "pass", "grab"):
        ev = parse(trajectory_npz, track_event=name)[2]
        assert all(e["name"] == name for e in ev)
        singles.extend(ev)
    key = lambda e: (e["step"], e["name"], e["agent"])  # noqa: E731
    assert sorted(map(key, singles)) == sorted(map(key, all_events))


@pytest.fixture(scope="module")
def events_npz(trajectory_npz, tmp_path_factory):
    """The infer log with world 0's rows edited so that every event family
    fires (a random policy's 25 ticks hold none): shots made and missed,
    a pass, grabs; and a done mid-log, for two episodes."""
    raw = dict(np.load(trajectory_npz, allow_pickle=True))
    bp, pos, act = raw["ball_physics"], raw["agent_possession"], \
        raw["actions"]
    vel = raw["ball_vel"]
    bp[:, 0, 0, 0] = 0
    act[:, 0] = 0
    for t, made in ((4, 1), (9, 0)):            # shoot: in flight 0 -> 1
        bp[t, 0, 0, 0], bp[t, 0, 0, 6] = 1, made
        act[t, 0, 1, 5] = 1
    pos[:, 0, :, 0] = 0                         # pass at 14 by agent 0
    pos[13, 0, 0, 0] = 1
    act[14, 0, 0, 4] = 1
    vel[15, 0, 0, :2] = (2.0, -1.0)
    for t, agent in ((18, 1), (20, 0)):         # grabs: possession flips
        pos[t:, 0, agent, 0] = 1
        act[t, 0, agent, 3] = 1
    raw["done"][:, 0] = 0
    raw["done"][11, 0] = 1
    path = str(tmp_path_factory.mktemp("logs") / "events.npz")
    np.savez_compressed(path, **raw)
    return path


@pytest.mark.parametrize("track", ["all", "shoot", "pass", "grab", "none"])
def test_parse_matches_jax_viewer(events_npz, track):
    from madrona_basketball_tpu_torch.viewer.app import ViewerClass
    raw, episodes, events = ViewerClass.load_and_parse_log(
        events_npz, track_event=track)
    j_raw, j_episodes, j_events = JViewer.load_and_parse_log(
        events_npz, track_event=track)
    assert episodes == j_episodes and len(episodes) == 2
    assert events == j_events
    assert sorted(raw) == sorted(j_raw)
    want = {"all": 5, "shoot": 2, "pass": 1, "grab": 2, "none": 0}[track]
    assert len(events) == want, events


def test_mgi_playlist_sorting(tmp_path):
    from madrona_basketball_tpu_torch.viewer.__main__ import mgi_playlist
    d = tmp_path / "Model_"
    d.mkdir()
    names = ["Model_gen_2_1000.npz", "Model_gen_0_500.npz",
             "Model_initial.npz", "Model_gen_0_1000.npz",
             "Model_gen_10_500.npz", "Model_7.npz"]
    for n in names:
        (d / n).write_bytes(b"")
    (d / "notes.txt").write_bytes(b"")  # not an npz: ignored
    got = mgi_playlist("Model", root=str(tmp_path))
    assert got == j_playlist("Model", root=str(tmp_path))
    assert [os.path.basename(p) for p in got][:5] == [
        "Model_initial.npz", "Model_7.npz", "Model_gen_0_500.npz",
        "Model_gen_0_1000.npz", "Model_gen_2_1000.npz"]
    assert mgi_playlist("NoSuchModel", root=str(tmp_path)) == []


def test_viewer_spawn_teardown(tmp_path):
    """--viewer spawns the watcher viewer and tears it down
    (scripts/ppo.py:261-276, 352-368), here on the dummy SDL driver."""
    from madrona_basketball_tpu_torch.cli import (_spawn_viewer,
                                                  _teardown_viewer)
    proc = _spawn_viewer(str(tmp_path / "logs"))
    assert proc is not None, "the dummy SDL driver should allow spawning"
    try:
        assert proc.poll() is None  # alive, polling the empty folder
        assert proc.args[1:4] == ["-m", "madrona_basketball_tpu_torch.viewer",
                                  "--live-log-folder"]
    finally:
        _teardown_viewer(proc)
    assert proc.poll() is not None


def test_viewer_spawn_headless_guard(tmp_path, monkeypatch, capsys):
    from madrona_basketball_tpu_torch.cli import _spawn_viewer
    for var in ("DISPLAY", "WAYLAND_DISPLAY", "SDL_VIDEODRIVER"):
        monkeypatch.delenv(var, raising=False)
    assert _spawn_viewer(str(tmp_path / "logs")) is None
    assert "not spawning the live viewer" in capsys.readouterr().out


def test_viewer_embedded_tick():
    from madrona_basketball_tpu_torch.viewer import app
    env = BasketballEnv(4, SimConfig(), seed=3, device="cpu")
    viewer = app.ViewerClass(sim_instance=env, training_mode=True,
                             headless=True)
    env.viewer = viewer
    env.reset()
    for _ in range(3):
        env.step(torch.zeros((4, 6), dtype=torch.int32))
    viewer.world_idx = 2
    viewer.tick()
    t = env.tensors()
    drawn = app._world_to_host(t, 2)
    for key, _ in app._DRAWN:
        np.testing.assert_array_equal(
            drawn[key], t[key][2].to(torch.float32).numpy().reshape(
                drawn[key].shape), err_msg=key)


def test_infer_chunked_matches_perstep_schema(tmp_path):
    """The eval chunk and the per-step loop write the same npz schema, and
    with a short clock both finish episodes."""
    cfg = SimConfig(time_per_period=0.5)
    paths = {}
    for name, chunk in (("perstep", 1), ("chunked", 16)):
        path = str(tmp_path / f"{name}.npz")
        env = BasketballEnv(4, cfg, seed=3, device="cpu")
        counts = infer(env, _agent(2), log_path=path, num_episodes=1,
                       max_steps=64, stochastic=True, seed=0, trainee_idx=1,
                       chunk_size=chunk)
        assert (counts >= 1).all(), f"{name}: episodes not completed"
        paths[name] = dict(np.load(path, allow_pickle=True))
    a, b = paths["perstep"], paths["chunked"]
    assert set(a.keys()) == set(b.keys())
    for k in ("agent_pos", "game_state", "actions"):
        assert a[k].shape[1:] == b[k].shape[1:], k


def test_viewer_fading_trails_render(trajectory_npz):
    """Trail points render in faded colours (scripts/viewer.py:962,
    1388-1390: older points darker by up to 50 %)."""
    from madrona_basketball_tpu_torch.viewer import constants as V
    from madrona_basketball_tpu_torch.viewer.app import ViewerClass
    raw, episodes, _ = ViewerClass.load_and_parse_log(trajectory_npz)
    s0, s1 = episodes[0]
    t = s1 - 1
    ep_len = max(s1 - s0, 1)
    trails = []
    for a in range(raw["agent_pos"].shape[2]):
        base = V.TEAM0_COLOR if a % 2 == 0 else V.TEAM1_COLOR
        pts = raw["agent_pos"][s0:t + 1, 0, a, :2][::4]
        ages = (t - np.arange(s0, t + 1)[::4]) / ep_len
        cols = [tuple(int((1.0 - 0.5 * x) * c) for c in base) for x in ages]
        assert all(0 <= v <= 255 for c in cols for v in c)
        if len(cols) > 1:
            assert sum(cols[0]) < sum(cols[-1])
        trails.append((pts, cols))
    _frame(ViewerClass(headless=True), raw, t, trails)
