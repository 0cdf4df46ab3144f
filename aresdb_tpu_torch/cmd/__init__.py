"""The daemon (aresd)."""
