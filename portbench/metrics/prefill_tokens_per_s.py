"""Prompt tokens of the requests finished in the window, over its seconds."""


def read(run):
    if not run.work.get("prefill"):
        return None
    return run.counts["prompt_tokens"] / run.window_s
