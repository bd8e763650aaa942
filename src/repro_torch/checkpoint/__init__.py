"""Fault-tolerant checkpoints."""
