"""Share of the profiled segment with no device op running (%)."""
from perfbench.readers import idle as read  # noqa: F401
