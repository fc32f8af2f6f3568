"""The eval step's share of the card's float32 peak: both agents' actor
forwards (counts/model_flops.py) of the ticks evaluated in the traced
run's window, over that window, over 67 TFLOP/s."""

from benchmark.counts import model_flops, peaks


def read(ctx):
    w, run = ctx["window"], ctx["run"]
    if not w.get("ticks"):
        return None
    flops = model_flops.eval_tick(ctx["plan"]["config"]["policy"],
                                  run.num_envs) * w["ticks"]
    return 100.0 * flops / w["window_s"] / peaks.FP32_FLOP_PER_S
