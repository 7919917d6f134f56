"""Device time of the kernels, copies and sets that the profiled segment's
``model.lm_head`` ranges launched, over that of those its ``engine.launch``
ranges launched (the chrome trace's correlation ids; %)."""
from perfbench import span_readers


def read(layer):
    return span_readers.lm_head_share(layer)
