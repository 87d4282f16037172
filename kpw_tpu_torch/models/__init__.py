"""Record models: bridges from user record schemas (protobuf message classes,
flat avro-style specs) to the parquet schema + columnar batches.

Replaces parquet-protobuf's ``ProtoWriteSupport`` (the reference plugs it in
at ParquetFile.java:97-99; the user contract is "any Message subclass + its
Parser", KafkaProtoParquetWriter.java:671-684)."""

from .proto_bridge import proto_to_schema, ProtoColumnarizer  # noqa: F401
from .record_bridge import flat_schema, dicts_to_batch, arrays_to_batch  # noqa: F401
