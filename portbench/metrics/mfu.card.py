"""Model FLOPs of the traced segment's prefills (portbench.harness.work.
prefill_flops) over the card's busy seconds in it, at the bf16 peak, in
percent: the whole step's share of the peak while the card works."""
from portbench.harness import work


def read(run):
    lengths = run.trace_work.get("prefill")
    if run.trace is None or not lengths or run.trace.busy_s <= 0:
        return None
    return work.share_pct(sum(work.prefill_flops(run.model, s) for s in lengths),
                          run.trace.busy_s)
