"""Median over every request of the window of the time from when it was
due to its first token, on the runtime's clock."""
from perfbench import readers


def read(run):
    return readers.pct(readers.ttft_ms(run), 50)
