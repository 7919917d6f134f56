"""Median of the engine's own step times in the window: one group's launch
to its token fetch (``ServeEngine``'s step clock), ms."""
from perfbench import readers


def read(layer):
    return readers.engine_median_ms(layer, "step_s")
