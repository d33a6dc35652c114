"""L1 shared layer: wire protocol, file-ID codec, config parsing.

The port's copy of ``fastdfs_tpu/common``, with the same re-exports.
Reference analogue: ``common/`` (``fdfs_proto.h``, ``fdfs_global.c``,
``fdfs_shared_func.c``) in xigui2013/fastdfs.
"""

from fastdfs_tpu_torch.common.protocol import (  # noqa: F401
    Header,
    HEADER_SIZE,
    TrackerCmd,
    StorageCmd,
    Status,
    pack_header,
    unpack_header,
    long2buff,
    buff2long,
)
from fastdfs_tpu_torch.common.fileid import (  # noqa: F401
    FileId,
    FileInfo,
    encode_file_id,
    decode_file_id,
)
