"""Client SDK: schema-cached connector building upsert batches over HTTP."""

from aresdb_tpu_torch.client.connector import Connector  # noqa: F401
