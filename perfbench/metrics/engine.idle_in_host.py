"""Idle device time charged to ``engine.tick``, ``engine.blocks``,
``engine.swap``, ``engine.admit``, ``engine.apply`` or ``engine.fetch``
(the port's spans), over the profiled segment (%): the device waiting on
the engine's bookkeeping."""
from perfbench import span_readers


def read(layer):
    return span_readers.idle_share(layer, span_readers.in_host)
