"""Client side of dedup-aware uploads: chunk fingerprints."""

from fastdfs_tpu_torch.client.fingerprint import (  # noqa: F401
    ChunkFingerprint,
    fingerprint_buffer,
)
