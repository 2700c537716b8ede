"""topk_sim_roofline, in a cell whose end-to-end metric is the card's time a
prompt token costs (card_us_per_token)."""
from portbench.harness import spec


def read(run):
    return spec.reader("topk_sim_roofline")(run)
