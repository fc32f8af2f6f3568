"""The share of 32-world groups (the lanes of one warp of kernel B) whose
worlds are not all in one rule phase, at the end of each iteration: 100 x
mixed groups / all groups over the traffic's `profile_iterations`
iterations that follow the traced window, from the program's rule-phase
counter (`madrona_basketball_tpu_torch/ops/rule_phases.py`).  The run's
own captured chunk graph steps them one at a time from the state the
window and the profiled span trained (`Run._advance`, as the checked steps
take them), and the counter samples the rows after each: its torch
operations are the only work outside the graph, and its buffers (0.1 MB
at 8192 worlds) all it holds beyond the chunk's own.  None where the
program has no counter."""


def read(ctx):
    try:
        from madrona_basketball_tpu_torch.ops.rule_phases import (
            RulePhaseCounter, mixed_share)
    except ImportError:
        return None
    run = ctx["run"]
    counter = RulePhaseCounter()
    for _ in range(ctx["plan"]["traffic"]["profile_iterations"]):
        run.state, _ = run._advance(run.state)
        counter.sample(run.state.sf, run.state.si)
    return mixed_share(counter.read(run.state.sf.device))
