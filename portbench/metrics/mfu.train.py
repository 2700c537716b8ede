"""Model FLOPs of the window's steps (portbench.harness.work.
train_step_flops) over the window's seconds at the bf16 peak, in percent."""
from portbench.harness import work


def read(run):
    steps = run.work.get("train_step")
    if not steps:
        return None
    return work.share_pct(sum(work.train_step_flops(run.model, b, s) for b, s in steps),
                          run.window_s)
