"""fastdfs_tpu_torch: the accelerator half of fastdfs_tpu in PyTorch and CUDA.

A port of the JAX package ``fastdfs_tpu`` (which stays beside it as the
reference) to PyTorch on an NVIDIA Hopper card.  This package imports
neither JAX nor anything of ``fastdfs_tpu``; it keeps its own copy of what
it needs.

What it serves: the dedup sidecar's fingerprint path, the storage
daemon's accelerator half.  ``sidecar.DedupSidecar`` speaks the same
unix-socket opcodes as ``fastdfs_tpu.sidecar`` and runs
``dedup.DedupEngine``, whose two device kernels (batched SHA-1 and the
MinHash survivor sketch) are hand-written CUDA C++ under ``csrc/``, built
with ``nvcc`` on first use (``ops/_build.py``).  Beside it: the client's
upload fingerprint (``client.fingerprint_buffer``, through the same
SHA-1 kernel), Reed-Solomon coding (``ops.rs_code``) and host-to-device
streaming (``ops.streaming``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper takes its plain PyTorch twin.  Asking for
CUDA where there is none raises: nothing falls back to the CPU.
"""

__version__ = "0.1.0"

FDFS_TPU_VERSION = __version__
