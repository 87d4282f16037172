"""Pluggable filesystems for the writer sink (local FS + in-memory HDFS
analog), with the atomic tmp→rename publish the correctness protocol needs
(reference renameAndMoveTempFile, KafkaProtoParquetWriter.java:359-378).
The port has no HDFS, object-store, failover or fault-injecting filesystem
yet."""

from .fs import FileSystem, LocalFileSystem, MemoryFileSystem  # noqa: F401
# NOTE: .verify is deliberately NOT imported here — it is a runnable module
# (`python -m kpw_tpu_torch.io.verify <file-or-dir>`), and a package-level
# import would make runpy warn about the double import.  Import it directly:
#   from kpw_tpu_torch.io.verify import verify_file, verify_dir, FileReport
