"""Median host duration of the profiled segment's ``engine.launch`` spans
of kind ``decode``: the host cost of issuing one fixed-shape step, ms."""
from perfbench import span_readers


def read(layer):
    return span_readers.launch_ms_p50()
