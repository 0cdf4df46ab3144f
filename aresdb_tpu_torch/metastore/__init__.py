from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore  # noqa: F401
