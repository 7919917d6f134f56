"""The window's decoded tokens over its host seconds (tokens/s): the rate
the host's issue of each step sets."""
from perfbench.readers import window_rate as read  # noqa: F401
