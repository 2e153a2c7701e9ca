"""Median over every request of the window of (last token's time - first
token's) / (output tokens - 1), on the runtime's clock."""
from perfbench import readers


def read(run):
    return readers.pct(readers.tpot_ms(run), 50)
