"""flash_attention_roofline, in a cell whose end-to-end metric is the card's time a
prompt token costs (card_us_per_token)."""
from portbench.harness import spec


def read(run):
    return spec.reader("flash_attention_roofline")(run)
