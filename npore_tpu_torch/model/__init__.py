"""Learned error model: confusion matrices and derived score matrices."""
