"""Broker: distributed scatter-gather query execution."""
