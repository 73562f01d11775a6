"""Distributed-training pieces of the port (activation recompute)."""
