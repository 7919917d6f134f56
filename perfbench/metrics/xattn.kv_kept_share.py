"""The share of the decode steps' cross-attention K/V that were reused from
the encoder states rather than projected anew: 100 x kept / (kept + taken)
over the profiled segment's ``model.xattn`` span records, whose attrs carry
the port's ``cross_kv.kept`` / ``cross_kv.taken`` counts. None where no
record carries them, or the program has no span module."""
from perfbench import span_readers


def read(layer, records=None):
    recs = span_readers.port_records() if records is None else records
    xattn = [r for r in recs or () if r.name == "model.xattn"]
    kept = sum(r.attrs.get("cross_kv.kept", 0) for r in xattn)
    taken = sum(r.attrs.get("cross_kv.taken", 0) for r in xattn)
    if kept + taken == 0:
        return None
    return 100.0 * kept / (kept + taken)
