"""Ingest layer: record sources with smart-commit at-least-once semantics.

Rebuilds the capability the reference imports as the external
``smart-commit-kafka-consumer`` library (SURVEY.md §2.2): a bounded shared
queue many workers poll, a paged per-partition offset tracker whose commit
frontier advances only over fully-acked consecutive pages, and open-page
backpressure.  The broker itself is pluggable: the in-process ``FakeBroker``
(partitioned append logs + consumer groups, the §4 test-infra analog of an
embedded Kafka broker) or any client implementing the same small interface.
"""

from .broker import FakeBroker, Record, RecordBatch  # noqa: F401
from .offsets import PagedOffsetTracker, PartitionOffset  # noqa: F401
from .consumer import SmartCommitConsumer  # noqa: F401
from .kafka_client import KafkaBrokerClient  # noqa: F401  (needs kafka-python at construction)
# lint: fault-isolation ok — the package's public opt-in seam: tests and
# benchmarks import FaultInjectingBroker from here; no production call
# path references it
from .faults import FaultInjectingBroker  # noqa: F401
