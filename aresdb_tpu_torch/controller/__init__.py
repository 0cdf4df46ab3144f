"""Cluster controller: schema, membership, placement, ingestion assignment."""
