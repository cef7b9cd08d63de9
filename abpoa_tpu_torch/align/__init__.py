"""Banded sequence-to-graph alignment: host tables, the DP kernel, the host backtrack."""
