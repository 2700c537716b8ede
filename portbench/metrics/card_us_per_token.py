"""The card's busy time in the window (the union of every device
operation's span, from the profiler's trace of the whole window) per
prompt token of the window's requests, in microseconds: the card time a
prompt token costs, whatever the host's pace."""


def read(run):
    lengths = run.trace_work.get("prefill")
    if run.trace is None or not lengths or run.trace.busy_s <= 0:
        return None
    return 1e6 * run.trace.busy_s / sum(lengths)
