"""Hand-written kernel launches (DAISM GEMMs, their split-K sums, flash
attention) a decode step issues: the mean over the profiled segment's
decode ``engine.launch`` spans of their kernel counters' changes."""
from perfbench import span_readers


def read(layer):
    return span_readers.launches_per_decode()
