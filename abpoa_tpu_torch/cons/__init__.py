"""Consensus calling."""
