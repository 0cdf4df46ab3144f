"""Multi-device execution: one query's batch rows over a list of devices."""
