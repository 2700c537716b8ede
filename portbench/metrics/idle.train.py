"""Share of the traced segment in which no operation ran on the device, in
percent."""


def read(run):
    if run.trace is None or not run.trace_work.get("train_step") or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
