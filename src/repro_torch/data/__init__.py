"""Synthetic data of the port (host numpy)."""
