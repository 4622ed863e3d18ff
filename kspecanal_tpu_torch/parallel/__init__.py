"""Batched multi-iteration paths of the port (single device for now)."""
