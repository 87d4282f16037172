"""Pluggable filesystems for the writer sink (local FS + in-memory HDFS
analog), with the atomic tmp→rename publish the correctness protocol needs
(reference renameAndMoveTempFile, KafkaProtoParquetWriter.java:359-378).
Beside them: the HDFS, object-store, failover and fault-injecting
filesystems."""

from .fs import FileSystem, LocalFileSystem, MemoryFileSystem  # noqa: F401
from .hdfs import HdfsFileSystem  # noqa: F401  (needs libhdfs at construction)
# lint: fault-isolation ok — the package's public opt-in seam: tests and
# benchmarks import these names from here; no production call path
# references them
from .faults import (  # noqa: F401
    FaultInjectingFileSystem,
    FaultSchedule,
    InjectedFault,
    objectstore_persona,
)
from .failover import FailoverFileSystem  # noqa: F401
from .objectstore import (  # noqa: F401
    BandwidthBudget,
    BandwidthBudgetedFileSystem,
    EmulatedObjectStore,
    ObjectStoreFileSystem,
)
# NOTE: .verify is deliberately NOT imported here — it is a runnable module
# (`python -m kpw_tpu_torch.io.verify <file-or-dir>`), and a package-level
# import would make runpy warn about the double import.  Import it directly:
#   from kpw_tpu_torch.io.verify import verify_file, verify_dir, FileReport
