"""The card's idle share of the window (``benchmark/readers.py``)."""
from benchmark.readers import device_idle_share as read  # noqa: F401
