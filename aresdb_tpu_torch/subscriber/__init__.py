"""Subscriber: streaming (Kafka) → AresDB ETL service."""
