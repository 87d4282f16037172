"""Writer runtime: Builder config API, orchestrator, worker pool, rotation,
retry, metrics — the reference's L3-L5 layers rebuilt (SURVEY.md §1).  The
port runs thread and process workers, compaction and multi-route writers
over local, in-memory, HDFS, object-store and failover sinks."""

from .builder import Builder  # noqa: F401
from .export import registry_to_json, registry_to_prometheus  # noqa: F401
from .metrics import Gauge, MetricRegistry  # noqa: F401
from .multiwriter import (  # noqa: F401
    MultiWriter,
    SchemaIncompatibleError,
    TenantQuotaLedger,
)
from .parquet_file import ParquetFile  # noqa: F401
from .partition import (  # noqa: F401
    CallablePartitioner,
    EventTimePartitioner,
    FieldPartitioner,
    Partitioner,
)
from .retry import (  # noqa: F401
    RetryBudgetExceeded,
    RetryInterrupted,
    RetryPolicy,
)
from .writer import (  # noqa: F401
    KafkaProtoParquetWriter,
    PublishVerificationError,
    WriterFailedError,
)
