"""Idle device time charged to ``engine.launch``, ``engine.stage`` or a
``model.*`` span (the port's spans), over the profiled segment (%): the
device waiting while the host issues a step."""
from perfbench import span_readers


def read(layer):
    return span_readers.idle_share(layer, span_readers.in_launch)
