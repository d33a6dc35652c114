"""Client library: the port of ``fastdfs_tpu/client``.  Pure-Python
framing of the binary TCP protocol (the C++ daemons are the servers), and
the upload fingerprint of dedup-aware uploads, which runs on the card."""

from fastdfs_tpu_torch.client.fingerprint import (  # noqa: F401
    ChunkFingerprint,
    fingerprint_buffer,
)
from fastdfs_tpu_torch.client.storage_client import StorageClient  # noqa: F401
from fastdfs_tpu_torch.client.tracker_client import TrackerClient  # noqa: F401
from fastdfs_tpu_torch.client.client import FdfsClient  # noqa: F401
