"""Multi-shard parallelism (SURVEY.md §7).

The reference's parallelism is thread-level data parallelism over a shared
consumer queue plus scale-out via Kafka consumer groups (SURVEY.md §2.4,
KafkaProtoParquetWriter.java:40-41,72-76).  Here rows are split over the
shards of a mesh of torch devices:

- ``mesh``: the shard mesh and its collectives (one ``shard`` axis;
  partitions -> shards; ``all_gather`` / ``psum`` / ``pmax`` as copies in
  one process and through ``torch.distributed`` across processes);
- ``dict_merge``: the north-star collective — when multiple Kafka
  partitions share a row group, each shard dictionary-encodes its rows
  locally and the global dictionary is merged with ``all_gather`` /
  ``psum``;
- ``sharded``: the encode step on one card (``encode_step_single``) and
  over the mesh (``sharded_encode_step``, ``sharded_encode_step_bounded``);
- ``mesh_encoder``: ``MeshChunkEncoder``, the writer's ``"mesh"`` backend.
"""

from .mesh import make_mesh  # noqa: F401
from .dict_merge import DictionaryOverflow, global_dictionary_encode  # noqa: F401
from .sharded import sharded_encode_step, sharded_encode_step_bounded  # noqa: F401
