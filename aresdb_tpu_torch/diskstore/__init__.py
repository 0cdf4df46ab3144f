from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore  # noqa: F401
