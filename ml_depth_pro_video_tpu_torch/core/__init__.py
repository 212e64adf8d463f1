"""Dtype and device policy."""
