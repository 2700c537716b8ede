"""Process start to the first timed request or step: weights, inputs,
tables, index, kernel builds and loads, warm-up."""


def read(run):
    return run.setup_s
