"""Depth-based 3D effects (parallax videos, anaglyphs)."""
