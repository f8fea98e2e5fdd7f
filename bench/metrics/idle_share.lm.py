"""``idle_share.lm``: percent of the traced tier rounds in which no
kernel or copy ran on the card, from the union of the device's
intervals in the profiler's trace."""
from bench.trace import idle_share


def read(t):
    return idle_share(t)
