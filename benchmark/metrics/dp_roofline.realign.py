"""The DP's share of its roofline over the window
(``benchmark/readers.py``)."""
from benchmark.readers import dp_roofline_share as read  # noqa: F401
