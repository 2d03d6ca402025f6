"""Realignment engine: window building, batching, orchestration."""
