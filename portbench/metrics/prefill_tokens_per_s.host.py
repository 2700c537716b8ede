"""prefill_tokens_per_s, in a cell whose requests the host's launch pace
sets: a reading of the host, left without a bound."""
from portbench.harness import spec


def read(run):
    return spec.reader("prefill_tokens_per_s")(run)
