"""Whole step: model FLOPs of every token the profiled stretch processed
over its wall time at the card's bf16 peak.  Percent.  The reader of
every ``mfu.<part>`` metric, such as ``mfu.offline`` (the backlog
cells, moving ``output_tok_s``); a split by the end-to-end metric moved
differs only in its name."""
from perfbench import readers


def read(run):
    return readers.mfu(run)
