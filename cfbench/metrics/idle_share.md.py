"""Idle share of the card in the traced window: 1 - busy / wall, the busy
time the union of the device events' intervals."""
from cfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
