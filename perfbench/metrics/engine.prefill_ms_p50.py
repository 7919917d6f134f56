"""Median over the window's requests of the wall time of the prefill chunks
each rode in (``RequestState.prefill_s``), ms."""
from perfbench import readers


def read(layer):
    return readers.engine_median_ms(layer, "prefill_s")
