"""Param trees: npz loading, numpy bridge, random init."""
