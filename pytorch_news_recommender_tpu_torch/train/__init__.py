"""Training and evaluation engine (single device), impression-level metrics."""
