"""Utilities of the port (run logging)."""
