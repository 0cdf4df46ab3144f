"""Datanode: distributed-mode node runtime with peer bootstrap."""
