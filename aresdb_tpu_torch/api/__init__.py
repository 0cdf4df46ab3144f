"""HTTP API layer (REST handlers + debug surface)."""
