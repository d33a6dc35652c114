"""Device-mesh parallelism for the dedup data plane, inside one process.

The port of ``fastdfs_tpu/parallel``.  The reference runs a
single-controller ``shard_map`` over a ``jax.sharding.Mesh``; here a
``Mesh`` is an array of ``torch.device``s, every rank runs the same body
on its shard, and copies between the ranks' devices stand in for the
collectives (``parallel.collectives``):

- **sp** (sequence parallel): a long byte stream is split into contiguous
  blocks, one per rank; the gear hash needs the gear values of a 31-byte
  halo from the previous block, passed along a ring (``ppermute``).
- **dp** (data parallel): chunk batches shard across ranks; the digest
  all-gather builds the replicated exact-index view.
- **tp** (tensor parallel): the MinHash permutation axis shards across
  ranks; ``all_gather`` reassembles full signatures.
"""

from fastdfs_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    cuda_devices,
    factorize_devices,
    fingerprint_mesh,
    make_mesh,
)
from fastdfs_tpu_torch.parallel.ingest_step import (  # noqa: F401
    IngestStep,
    distributed_fingerprint,
    distributed_ingest_step,
    make_fingerprint_step,
    make_ingest_step,
)
