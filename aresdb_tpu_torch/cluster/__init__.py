"""Cluster topology: shard→host placement views."""
