"""ns_per_day: simulated ns per day over the whole window."""
from cfbench.readers import ns_per_day


def read(ctx):
    return ns_per_day(ctx)
