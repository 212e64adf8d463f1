"""Streaming video depth runner."""
