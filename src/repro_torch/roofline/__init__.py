"""The roofline of a step on one H100: FLOP, byte, memory and wire counts
from a ``meta`` trace (``flops.py``), the three terms (``analysis.py``)
and the dry-run's tables (``report.py``)."""
