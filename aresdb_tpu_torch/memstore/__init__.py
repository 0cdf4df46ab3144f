"""Memory store: live + archive columnar stores, ingestion, jobs.

Reference capabilities: memstore/ (SURVEY.md §2.1). The TPU-native design
keeps the live/archive split, upsert semantics, and watermark protocol, but
stores columns as numpy arrays (values + bool validity (+ counts)) laid out
for zero-copy staging onto TPU HBM, instead of raw C buffers.
"""

from aresdb_tpu_torch.memstore.common import RecordID, BASE_BATCH_ID  # noqa: F401
