"""The iteration step's share of the card's float32 peak: the policy's
model FLOPs (counts/model_flops.py, at the configuration's widths) of
the iterations completed in the traced run's window, over that window,
over 67 TFLOP/s."""

from benchmark.counts import model_flops, peaks


def read(ctx):
    hp, w = ctx["run"].hp, ctx["window"]
    if not w["iterations"]:
        return None
    flops = model_flops.train_iteration(ctx["plan"]["config"]["policy"],
                                        hp.num_envs, hp.num_rollout_steps,
                                        hp.update_epochs, hp.use_frozen)
    return 100.0 * flops * w["iterations"] / w["window_s"] / \
        peaks.FP32_FLOP_PER_S
