"""1 - real prompt tokens over launched positions (B x S), summed over the
profiled segment's ``engine.launch`` spans of kind ``prefill`` (%)."""
from perfbench import span_readers


def read(layer):
    return span_readers.prefill_pad_share()
