"""Viewer CLI — `python -m madrona_basketball_tpu_torch.viewer [...]`
(port of `madrona_basketball_tpu.viewer.__main__`, __main__.py:1-82).

Mirrors the reference CLI (scripts/viewer.py:1517-1531):
  --playback-log PATH[,PATH...]   play recorded trajectory npz file(s)
  --live-log-folder DIR           watch a training run's log drops
  --watch-model NAME              play the sorted multi-generation
                                  playlist from logs/mgi/{NAME}_/ —
                                  "watch the model evolve": npz drops
                                  sorted by (generation, iteration) with
                                  the initial checkpoint first, Shift+B/N
                                  to step across generations
                                  (scripts/viewer.py:1104-1150)
  --track-event EVENT             which event glyphs to draw: shoot /
                                  pass / grab (the reference's single-
                                  event filter, scripts/viewer.py:49-56,
                                  1060), "all" (default — richer than
                                  the reference) or
                                  "none" (the reference CLI's implicit
                                  default).
"""

import argparse
import glob
import os
import re


def mgi_playlist(model_name: str, root: str = "logs/mgi") -> list:
    """The reference's multi-generation playlist: every npz under
    logs/mgi/{model}_/ sorted by (gen, iter) extracted from the filename
    (scripts/viewer.py:1118-1136).  Files without gen_/iter markers
    (e.g. {model}_initial.npz) sort with key -1, landing first."""
    d = os.path.join(root, f"{model_name}_")
    try:
        files = [f for f in os.listdir(d) if f.endswith(".npz")]
    except FileNotFoundError:
        return []

    def sort_keys(fn):
        gen = re.search(r"gen_(\d+)", fn)
        it = re.search(r"_(\d+)\.npz$", fn)
        return (int(gen.group(1)) if gen else -1,
                int(it.group(1)) if it else -1)

    return [os.path.join(d, f) for f in sorted(files, key=sort_keys)]


def main(argv=None):
    p = argparse.ArgumentParser(description="Trajectory viewer")
    p.add_argument("--playback-log", type=str, default=None)
    p.add_argument("--live-log-folder", type=str, default=None)
    p.add_argument("--watch-model", type=str, default=None)
    p.add_argument("--track-event", type=str, default="all",
                   choices=["shoot", "pass", "grab", "all", "none"])
    args = p.parse_args(argv)

    from .app import ViewerClass
    viewer = ViewerClass()

    if args.playback_log:
        paths = []
        for part in args.playback_log.split(","):
            paths.extend(sorted(glob.glob(part)) or [part])
        viewer.run_trajectory_playback(paths, track_event=args.track_event)
    elif args.live_log_folder:
        viewer.watch_training(args.live_log_folder,
                              track_event=args.track_event)
    elif args.watch_model:
        paths = mgi_playlist(args.watch_model)
        if not paths:
            print("No model multi-gen-inference logs were found. Exiting.")
            return
        print(f"Getting all logs of {args.watch_model}: "
              f"{len(paths)} generation drops")
        viewer.run_trajectory_playback(paths, track_event=args.track_event)
    else:
        p.error("one of --playback-log / --live-log-folder / --watch-model "
                "is required")


if __name__ == "__main__":
    main()
