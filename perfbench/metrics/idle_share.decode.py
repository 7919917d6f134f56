"""Share of the traced decode steps with no device op running (%)."""
from perfbench.readers import idle as read  # noqa: F401
