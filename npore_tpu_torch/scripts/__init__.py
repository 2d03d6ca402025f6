"""Entry points of the port's probes."""
