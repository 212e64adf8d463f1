"""Depth evaluation metrics (dense, boundary, temporal)."""
