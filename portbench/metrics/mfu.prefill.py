"""Model FLOPs of the window's prefills (portbench.harness.work.
prefill_flops) over the window's seconds at the bf16 peak, in percent."""
from portbench.harness import work


def read(run):
    lengths = run.work.get("prefill")
    if not lengths:
        return None
    return work.share_pct(sum(work.prefill_flops(run.model, s) for s in lengths), run.window_s)
