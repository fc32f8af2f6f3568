"""pygame viewer: embedded live view, trajectory playback, live-log watch
(port of `madrona_basketball_tpu.viewer.app`, app.py:1-496).

Re-implementation of the reference viewer's three modes
(scripts/viewer.py:67-1531) against the port's tensor export:

  * embedded:  constructed with a `BasketballEnv`; `tick()` exports the
    state each frame (`env.tensors()`, torch tensors on the env's
    device), takes what it draws of the selected world to the host in
    one copy, draws it, and handles interaction
    (world switching 1-0, R reset, H human-control toggle, Ctrl+P pause,
    click agent selection, WASD/QE/Space/Shift/Enter action input).
  * playback:  `run_trajectory_playback(path)` loads an npz trajectory log
    (the scripts/ppo.py:94-105 schema), segments episodes on done flags,
    extracts shoot/pass/grab event glyphs (EVENT_DEFINITIONS), and plays
    with pause/frame-step/trails/episode navigation.
  * watch:     `watch_training(folder)` polls a folder for new npz drops
    from a live training run and plays each (the file-drop IPC of
    scripts/ppo.py:266-276).

Audio cues (swish on score, whistle on out-of-bounds) are synthesized tones
rather than checked-in wav assets.  pygame is imported at the first
`ViewerClass()`, never at import: the port's modules import without it.
"""

from __future__ import annotations

import math
import os
import time
import numpy as np

from .. import constants as C
from . import constants as V

# what tick() draws of one world: export key, shape, in the order of the
# one host copy
_DRAWN = (("agent_pos", (C.NUM_AGENTS, 3)), ("orientation", (C.NUM_AGENTS, 4)),
          ("basketball_pos", (1, 3)), ("hoop_pos", (2, 3)),
          ("game_state", (14,)), ("agent_possession", (C.NUM_AGENTS, 3)))


def _world_to_host(t: dict, w: int, keys=_DRAWN) -> dict:
    """World w of the export's `keys` as numpy arrays, through ONE device
    to host copy (the fields cast to float32 and concatenated; the
    integer fields are small and exact in float32)."""
    import torch
    flat = torch.cat([t[k][w].reshape(-1).to(torch.float32)
                      for k, _ in keys]).cpu().numpy()
    out, off = {}, 0
    for k, shape in keys:
        n = int(np.prod(shape))
        out[k] = flat[off:off + n].reshape(shape)
        off += n
    return out


def _require_pygame():
    import pygame
    if not pygame.get_init():
        pygame.init()
    return pygame


class ViewerClass:
    def __init__(self, sim_instance=None, training_mode: bool = False,
                 headless: bool = False):
        if headless or not os.environ.get("DISPLAY"):
            os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
            os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
        self.pg = _require_pygame()
        self.screen = self.pg.display.set_mode(
            (V.WINDOW_WIDTH, V.WINDOW_HEIGHT))
        self.pg.display.set_caption("madrona_basketball_tpu_torch viewer")
        self.font = self.pg.font.SysFont("monospace", 16)
        self.big_font = self.pg.font.SysFont("monospace", 28)
        self.clock = self.pg.time.Clock()

        self.env = sim_instance
        self.training_mode = training_mode
        self.world_idx = 0
        self.selected_agent = 0
        self.training_paused = False
        self.human_control = False
        self.controller_manager = None
        self._prev_scored = 0.0
        self._prev_oob = 0.0
        self._sounds = self._make_sounds()

    # ---------------- audio ----------------
    def _make_sounds(self):
        try:
            self.pg.mixer.init(frequency=22050, size=-16, channels=1)
            rate = 22050

            def tone(freq, dur, decay=8.0):
                t = np.linspace(0, dur, int(rate * dur), endpoint=False)
                wave = np.sin(2 * np.pi * freq * t) * np.exp(-decay * t)
                return self.pg.sndarray.make_sound(
                    (wave * 20000).astype(np.int16))

            return {"swish": tone(880, 0.3), "whistle": tone(2200, 0.4, 4.0)}
        except Exception:
            return {}

    def _play(self, name):
        snd = self._sounds.get(name)
        if snd is not None:
            try:
                snd.play()
            except Exception:
                pass

    # ---------------- coordinate transform ----------------
    def _to_screen(self, x, y):
        ppm = V.PIXELS_PER_METER
        off_x = (V.WINDOW_WIDTH - C.GRID_WIDTH_M * ppm) / 2.0
        off_y = (V.WINDOW_HEIGHT - C.GRID_HEIGHT_M * ppm) / 2.0
        return int(x * ppm + off_x), int(y * ppm + off_y)

    # ---------------- drawing ----------------
    def _draw_court(self, hoop_pos):
        pg, s = self.pg, self.screen
        s.fill(V.BACKGROUND_COLOR)
        ppm = V.PIXELS_PER_METER
        tl = self._to_screen(C.COURT_MIN_X, C.COURT_MIN_Y)
        br = self._to_screen(C.COURT_MAX_X, C.COURT_MAX_Y)
        court = pg.Rect(tl[0], tl[1], br[0] - tl[0], br[1] - tl[1])
        pg.draw.rect(s, V.COURT_COLOR, court)
        pg.draw.rect(s, V.LINE_COLOR, court, 2)
        # half-court + center circle
        mid_x = (C.COURT_MIN_X + C.COURT_MAX_X) / 2.0
        top = self._to_screen(mid_x, C.COURT_MIN_Y)
        bot = self._to_screen(mid_x, C.COURT_MAX_Y)
        pg.draw.line(s, V.LINE_COLOR, top, bot, 2)
        center = self._to_screen(mid_x, (C.COURT_MIN_Y + C.COURT_MAX_Y) / 2)
        pg.draw.circle(s, V.LINE_COLOR, center,
                       int(C.CENTER_CIRCLE_RADIUS_M * ppm), 2)
        cy = (C.COURT_MIN_Y + C.COURT_MAX_Y) / 2.0
        for hx, hy, left in ((C.COURT_MIN_X + C.HOOP_FROM_BASELINE_M, cy,
                              True),
                             (C.COURT_MAX_X - C.HOOP_FROM_BASELINE_M, cy,
                              False)):
            # key (paint)
            key_len = C.KEY_HEIGHT_M
            base_x = C.COURT_MIN_X if left else C.COURT_MAX_X
            key_x0 = min(base_x, base_x + (key_len if left else -key_len))
            kt = self._to_screen(key_x0, hy - C.KEY_WIDTH_M / 2)
            pg.draw.rect(s, V.LINE_COLOR,
                         pg.Rect(kt[0], kt[1], int(key_len * ppm),
                                 int(C.KEY_WIDTH_M * ppm)), 2)
            # free-throw circle
            ft = self._to_screen(base_x + (key_len if left else -key_len), hy)
            pg.draw.circle(s, V.LINE_COLOR, ft,
                           int(C.FREE_THROW_CIRCLE_RADIUS_M * ppm), 1)
            # 3pt arc
            cx, cyp = self._to_screen(hx, hy)
            r = int(C.ARC_RADIUS_M * ppm)
            rect = pg.Rect(cx - r, cyp - r, 2 * r, 2 * r)
            if left:
                pg.draw.arc(s, V.LINE_COLOR, rect, -math.pi / 2.4,
                            math.pi / 2.4, 2)
            else:
                pg.draw.arc(s, V.LINE_COLOR, rect,
                            math.pi - math.pi / 2.4,
                            math.pi + math.pi / 2.4, 2)
            # corner-3 lines
            for side in (-1, 1):
                y_line = hy + side * (C.COURT_WIDTH_M / 2 -
                                      C.CORNER_3_FROM_SIDELINE_M)
                x0 = base_x
                x1 = base_x + (C.CORNER_3_LENGTH_FROM_BASELINE_M if left
                               else -C.CORNER_3_LENGTH_FROM_BASELINE_M)
                pg.draw.line(s, V.LINE_COLOR, self._to_screen(x0, y_line),
                             self._to_screen(x1, y_line), 2)
            # backboard + rim
            bb_x = hx + (-C.BACKBOARD_OFFSET_FROM_HOOP_M if left
                         else C.BACKBOARD_OFFSET_FROM_HOOP_M)
            pg.draw.line(s, (200, 200, 200),
                         self._to_screen(bb_x, hy - C.BACKBOARD_WIDTH_M / 2),
                         self._to_screen(bb_x, hy + C.BACKBOARD_WIDTH_M / 2),
                         3)
        for hp in np.asarray(hoop_pos).reshape(-1, 3):
            pos = self._to_screen(hp[0], hp[1])
            pg.draw.circle(s, (255, 60, 30), pos,
                           int(C.RIM_DIAMETER_M / 2 * ppm), 2)

    def _draw_agent(self, pos, quat, color, selected=False, has_ball=False):
        pg, s = self.pg, self.screen
        ppm = V.PIXELS_PER_METER
        w, x, y, z = [float(v) for v in quat]
        # forward = rotate (0,1,0) by quat; z-rotations only
        fwd_x = 2 * (x * y - w * z)
        fwd_y = 1 - 2 * (x * x + z * z)
        fx, fy = fwd_x, fwd_y
        rx, ry = fy, -fx
        cx, cy = float(pos[0]), float(pos[1])
        hw = C.AGENT_SHOULDER_WIDTH / 2
        hd = C.AGENT_DEPTH / 2
        verts = [
            (cx - fx * hd + rx * hw, cy - fy * hd + ry * hw),
            (cx - fx * hd - rx * hw, cy - fy * hd - ry * hw),
            (cx + fx * hd - rx * hw, cy + fy * hd - ry * hw),
            (cx + fx * hd + rx * hw, cy + fy * hd + ry * hw),
        ]
        pg.draw.polygon(s, color, [self._to_screen(*v) for v in verts])
        tip = self._to_screen(cx + fx * C.AGENT_ORIENTATION_ARROW_LENGTH_M,
                              cy + fy * C.AGENT_ORIENTATION_ARROW_LENGTH_M)
        pg.draw.line(s, (255, 255, 0), self._to_screen(cx, cy), tip, 2)
        if selected:
            pg.draw.circle(s, (255, 255, 255), self._to_screen(cx, cy),
                           int(V.AGENT_DRAW_SIZE_M * ppm) + 6, 2)
        if has_ball:
            pg.draw.circle(s, V.BALL_COLOR, self._to_screen(cx, cy),
                           int(V.AGENT_DRAW_SIZE_M * ppm) + 3, 2)

    def _draw_ball(self, pos):
        self.pg.draw.circle(self.screen, V.BALL_COLOR,
                            self._to_screen(float(pos[0]), float(pos[1])),
                            int(C.BALL_RADIUS_M * V.PIXELS_PER_METER) + 2)

    def _draw_scoreboard(self, gs):
        lines = [
            f"P{int(gs[V.GS_PERIOD])}  "
            f"{gs[V.GS_GAME_CLOCK]:5.1f}s  shot {gs[V.GS_SHOT_CLOCK]:4.1f}",
            f"TEAM0 {int(gs[V.GS_TEAM0_SCORE])} : "
            f"{int(gs[V.GS_TEAM1_SCORE])} TEAM1   "
            f"poss={int(gs[V.GS_TEAM_IN_POSSESSION])}",
        ]
        if gs[V.GS_INBOUNDING] > 0.5:
            lines.append(f"INBOUND {gs[V.GS_INBOUND_CLOCK]:.1f}s")
        for i, txt in enumerate(lines):
            self.screen.blit(self.font.render(txt, True, V.TEXT_COLOR),
                             (10, 8 + 18 * i))

    def _draw_frame(self, agent_pos, orientation, ball_pos, hoop_pos, gs,
                    possession=None, events=(), trails=None):
        self._draw_court(hoop_pos)
        if trails:
            for pts, cols in trails:
                for p, c in zip(pts, cols):
                    self.pg.draw.circle(self.screen, c,
                                        self._to_screen(p[0], p[1]), 2)
        for ev in events:
            vis = ev["visual"]
            pos = self._to_screen(*ev["pos"])
            if vis["shape"] == "circle":
                self.pg.draw.circle(self.screen, vis["color"], pos,
                                    vis["size"], 2)
            else:
                sz = vis["size"]
                self.pg.draw.line(self.screen, vis["color"],
                                  (pos[0] - sz, pos[1] - sz),
                                  (pos[0] + sz, pos[1] + sz), 2)
                self.pg.draw.line(self.screen, vis["color"],
                                  (pos[0] - sz, pos[1] + sz),
                                  (pos[0] + sz, pos[1] - sz), 2)
        for i in range(agent_pos.shape[0]):
            color = V.TEAM0_COLOR if i % 2 == 0 else V.TEAM1_COLOR
            has_ball = bool(possession is not None and possession[i, 0] == 1)
            self._draw_agent(agent_pos[i], orientation[i], color,
                             selected=(self.human_control
                                       and i == self.selected_agent),
                             has_ball=has_ball)
        self._draw_ball(ball_pos)
        self._draw_scoreboard(gs)

    # ---------------- interaction ----------------
    def get_selected_agent_index(self) -> int:
        return self.selected_agent

    def set_controller_manager(self, mgr):
        self.controller_manager = mgr

    def set_training_paused(self, paused: bool):
        self.training_paused = paused

    def get_human_action(self):
        """Keyboard state -> [move, moveAngle, rotate, grab, pass, shoot]."""
        pg = self.pg
        keys = pg.key.get_pressed()
        dx = (1 if keys[pg.K_d] else 0) - (1 if keys[pg.K_a] else 0)
        dy = (1 if keys[pg.K_s] else 0) - (1 if keys[pg.K_w] else 0)
        move, angle = 0, 0
        if dx or dy:
            move = 1
            # moveAgent convention: dir = (sin(a*pi/4), -cos(a*pi/4))
            angle = int(round(math.atan2(dx, -dy) / (math.pi / 4))) % 8
        rotate = 1 if keys[pg.K_q] else (2 if keys[pg.K_e] else 0)
        grab = 1 if keys[pg.K_LSHIFT] else 0
        pas = 1 if keys[pg.K_RETURN] else 0
        shoot = 1 if keys[pg.K_SPACE] else 0
        return [move, angle, rotate, grab, pas, shoot]

    def _handle_events(self):
        pg = self.pg
        for event in pg.event.get():
            if event.type == pg.QUIT:
                raise SystemExit
            if event.type == pg.KEYDOWN:
                if pg.K_1 <= event.key <= pg.K_9:
                    self.world_idx = event.key - pg.K_1
                elif event.key == pg.K_0:
                    self.world_idx = 9
                elif event.key == pg.K_h:
                    self.human_control = not self.human_control
                    if self.controller_manager is not None:
                        self.controller_manager.set_human_control(
                            self.human_control)
                elif event.key == pg.K_p and \
                        (pg.key.get_mods() & pg.KMOD_CTRL):
                    self.training_paused = not self.training_paused
                elif event.key == pg.K_r and self.env is not None:
                    self.env.trigger_reset(self.world_idx)
            if event.type == pg.MOUSEBUTTONDOWN and self.env is not None:
                mx, my = event.pos
                t = self.env.tensors()
                w = min(self.world_idx, t["agent_pos"].shape[0] - 1)
                pos = _world_to_host(t, w, _DRAWN[:1])["agent_pos"]
                dists = [np.hypot(*(np.array(self._to_screen(p[0], p[1]))
                                    - np.array([mx, my])))
                         for p in pos]
                if min(dists) < 40:
                    self.selected_agent = int(np.argmin(dists))

    # ---------------- embedded live mode ----------------
    def tick(self):
        if self.env is None:
            return
        self._handle_events()
        t = self.env.tensors()
        w = min(self.world_idx, t["agent_pos"].shape[0] - 1)
        d = _world_to_host(t, w)
        gs = d["game_state"]
        if gs[V.GS_SCORED_BASKETS] > self._prev_scored:
            self._play("swish")
        if gs[V.GS_OOB_COUNT] > self._prev_oob:
            self._play("whistle")
        self._prev_scored = float(gs[V.GS_SCORED_BASKETS])
        self._prev_oob = float(gs[V.GS_OOB_COUNT])
        self._draw_frame(d["agent_pos"], d["orientation"],
                         d["basketball_pos"][0], d["hoop_pos"], gs,
                         possession=d["agent_possession"])
        self.pg.display.flip()

    # ---------------- trajectory playback ----------------
    @staticmethod
    def load_and_parse_log(path: str, track_event: str = "all"):
        """Load an npz trajectory; segment into episodes on done flags and
        extract event markers (scripts/viewer.py:1028-1082 equivalent).

        track_event: a single EVENT_DEFINITIONS key ("shoot" / "pass" /
        "grab") parses only that event, matching the reference's
        --track-event filter (scripts/viewer.py:1060); "all" (default)
        parses every event type, "none" parses none."""
        raw = dict(np.load(path, allow_pickle=True))
        T = raw["done"].shape[0]
        episodes, start = [], 0
        for t in range(T):
            if float(np.asarray(raw["done"][t]).reshape(-1)[0]) > 0.5:
                episodes.append((start, t + 1))
                start = t + 1
        if start < T:
            episodes.append((start, T))

        if track_event == "all":
            defs = V.EVENT_DEFINITIONS
        elif track_event in V.EVENT_DEFINITIONS:
            defs = {track_event: V.EVENT_DEFINITIONS[track_event]}
        else:
            defs = {}
        events = []
        num_agents = raw["agent_pos"].shape[2]
        for t in range(T):
            for name, spec in defs.items():
                for agent in range(num_agents):
                    try:
                        pressed = int(
                            raw["actions"][t, 0, agent,
                                           spec["action_idx"]]) == 1
                        if pressed and spec["conditions"](raw, t, 0, agent):
                            outcome = spec["outcome_func"](raw, t, 0)
                            vis = spec["visuals"].get(outcome)
                            if vis is None:
                                continue
                            pos = raw["agent_pos"][t, 0, agent]
                            events.append({"step": t, "name": name,
                                           "agent": agent,
                                           "pos": (float(pos[0]),
                                                   float(pos[1])),
                                           "visual": vis})
                    except (IndexError, KeyError):
                        continue
        return raw, episodes, events

    def run_trajectory_playback(self, paths, loop: bool = True,
                                track_event: str = "all"):
        if isinstance(paths, str):
            paths = [paths]
        pg = self.pg
        file_idx, episode_idx, frame, paused, trails_on = 0, 0, 0, False, True
        fading_on = True  # F toggles; scripts/viewer.py:962,1388-1390

        def load(fi):
            return self.load_and_parse_log(paths[fi],
                                           track_event=track_event)

        raw, episodes, events = load(file_idx)

        running = True
        while running:
            for event in pg.event.get():
                if event.type == pg.QUIT:
                    running = False
                if event.type == pg.KEYDOWN:
                    mods = pg.key.get_mods()
                    if event.key == pg.K_SPACE:
                        paused = not paused
                    elif event.key == pg.K_t:
                        trails_on = not trails_on
                    elif event.key == pg.K_f:
                        fading_on = not fading_on
                    elif event.key == pg.K_RIGHT and paused:
                        frame += 1
                    elif event.key == pg.K_LEFT and paused:
                        frame = max(0, frame - 1)
                    elif event.key == pg.K_n:
                        if mods & pg.KMOD_SHIFT and len(paths) > 1:
                            file_idx = (file_idx + 1) % len(paths)
                            raw, episodes, events = load(file_idx)
                            episode_idx, frame = 0, 0
                        else:
                            episode_idx = (episode_idx + 1) % len(episodes)
                            frame = 0
                    elif event.key == pg.K_b:
                        if mods & pg.KMOD_SHIFT and len(paths) > 1:
                            file_idx = (file_idx - 1) % len(paths)
                            raw, episodes, events = load(file_idx)
                            episode_idx, frame = 0, 0
                        else:
                            episode_idx = (episode_idx - 1) % len(episodes)
                            frame = 0
                    elif event.key in (pg.K_ESCAPE, pg.K_q):
                        running = False

            s0, s1 = episodes[episode_idx]
            t = s0 + frame
            if t >= s1:
                if paused:
                    frame = s1 - s0 - 1
                    t = s1 - 1
                elif loop:
                    frame, t = 0, s0
                else:
                    episode_idx = (episode_idx + 1) % len(episodes)
                    frame, t = 0, episodes[episode_idx][0]

            trails = None
            if trails_on:
                trails = []
                ep_len = max(s1 - s0, 1)
                for a in range(raw["agent_pos"].shape[2]):
                    base = V.TEAM0_COLOR if a % 2 == 0 else V.TEAM1_COLOR
                    pts = raw["agent_pos"][s0:t + 1, 0, a, :2][::4]
                    if fading_on:
                        # older points darker: c * (1 - 0.5 * age_frac)
                        # (scripts/viewer.py:1388-1390)
                        ages = (t - np.arange(s0, t + 1)[::4]) / ep_len
                        cols = [tuple(int((1.0 - 0.5 * x) * c)
                                      for c in base) for x in ages]
                    else:
                        cols = [base] * len(pts)
                    trails.append((pts, cols))

            frame_events = [e for e in events if s0 <= e["step"] <= t]
            hoop_pos = raw.get("hoop_pos")
            hp = np.asarray(hoop_pos).reshape(-1, 3) if hoop_pos is not None \
                else np.array([[3.25, 8.5, 0], [28.75, 8.5, 0]])
            self._draw_frame(raw["agent_pos"][t, 0],
                             raw["orientation"][t, 0],
                             raw["ball_pos"][t, 0, 0],
                             hp, raw["game_state"][t, 0],
                             possession=raw["agent_possession"][t, 0],
                             events=frame_events, trails=trails)
            info = (f"{os.path.basename(paths[file_idx])}  "
                    f"ep {episode_idx + 1}/{len(episodes)} "
                    f"frame {frame}/{s1 - s0}  "
                    f"{'PAUSED' if paused else ''}")
            self.screen.blit(self.font.render(info, True, V.TEXT_COLOR),
                             (10, V.WINDOW_HEIGHT - 24))
            self.pg.display.flip()
            if not paused:
                frame += 1
            self.clock.tick(V.FPS)

    # ---------------- live training watch ----------------
    def watch_training(self, folder: str, poll_seconds: float = 2.0,
                       track_event: str = "all"):
        """Poll `folder` for new npz drops and play each once
        (scripts/viewer.py:1475-1510 equivalent)."""
        seen = set()
        print(f"Watching {folder} for new trajectory logs... (Ctrl+C quits)")
        while True:
            try:
                files = sorted(f for f in os.listdir(folder)
                               if f.endswith(".npz"))
            except FileNotFoundError:
                files = []
            new = [f for f in files if f not in seen]
            if new:
                path = os.path.join(folder, new[0])
                seen.add(new[0])
                print(f"Playing {path}")
                try:
                    self.run_trajectory_playback(path, loop=False,
                                                 track_event=track_event)
                except SystemExit:
                    return
            else:
                for event in self.pg.event.get():
                    if event.type == self.pg.QUIT:
                        return
                time.sleep(poll_seconds)
