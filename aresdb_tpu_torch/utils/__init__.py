"""Shared utilities: clock, hashing, metrics."""
