"""Seeded synthetic data for checks of the port (no test framework needed)."""
