from aresdb_tpu_torch.redolog.file_redolog import FileRedoLogManager  # noqa: F401
