"""Share of the traced window's wall time in which no device operation ran
(the union of their intervals)."""

from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
