"""Tokens of every step in the window (it ends at a synchronize), over its
seconds."""


def read(run):
    if not run.counts.get("steps"):
        return None
    return run.counts["steps"] * run.counts["tokens_per_step"] / run.window_s
