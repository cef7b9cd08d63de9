"""Sequence input and consensus output."""
