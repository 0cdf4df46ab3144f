"""Shared data model: data types, schema, upsert batch wire format."""
