#!/usr/bin/env python3
"""On-card smoke of fastdfs_tpu_torch: the dedup sidecar's fingerprint path
and everything of the port around it.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (none catches another's failure; any failed check exits non-zero
before the last line):

1. The card (``nvidia-smi`` name and power limit) and the kernel build:
   ``nvcc`` compiles ``fastdfs_tpu_torch/csrc/*.cu`` for sm_90a.
2. The ragged kernels against their plain PyTorch twins (and SHA-1 against
   hashlib) on the card, bit for bit: a seeded 64 MB segment cut by the
   host chunker, with each kernel's median time over one launch for the
   whole segment (CUDA events), the plain twin's time and the least time
   the card could take (the bound); an edge segment (lengths 0-8, 55-57,
   63-65 at every start offset mod 4, each followed by non-zero bytes,
   and a last chunk past max_size); one chunk as large as the segment;
   and the padded ``(N, L)`` adapters at 256 x 2048.  The general-width
   kernel at shingle widths 4 and 8, in both forms: fused with stage 4
   (``sketch_ragged_cuda(..., k=k)``, signatures and ``z`` from one
   launch, against ``minhash.sketch_ragged(..., 64, k)``) and stages 1-3
   alone (``survivor_ragged_cuda`` with ``k``, against
   ``minhash.survivor_ragged``): on the segment (timed: CUDA-event ms,
   device ms and the bound of each form, one launch each) and on an edge
   segment each (lengths 0, 1, k - 1, k, k + 1 and a few hundred at every
   start offset mod 4, each followed by non-zero bytes, and a chunk of
   three of the kernel's 4096-position passes), and the padded adapters
   at k = 4 (``minhash_batch_cuda(..., 64, 4)`` and
   ``survivor_segmin_cuda``), bit for bit against the plain twins.  Then the gear CDC
   kernel's compacted form (``csrc/gear_cdc.cu``) against its plain twin
   and the host scan: on the segment as the client stages it (more tiles
   than the kernel's persistent grid has blocks; timed), below a
   non-power-of-two ``n``, on a 5 KiB buffer (fewer tiles than blocks),
   on buffers planted at the kernel's thread-run and tile seams at
   avg_bits 17, 18 and 32, and on an adversarial 4 MB buffer (candidates
   planted in the first window and at the seams, from
   ``ops.cuda_gear``'s ``RUN`` and ``TILE``, and a dense run that
   overflows ``device_cuts``' k, whose recovery must relaunch the kernel
   and cut as the host does); 50 launches on the segment and on the
   adversarial buffer at each k must give the first launch's output bit
   for bit.  Every kernel's ``ms`` is the CUDA-event median of a call of
   its wrapper; the gear kernel's two forms also give ``device_ms``,
   that call's device time under torch.profiler (kernels and memsets,
   without the host's time in the wrapper, which is longer than theirs).
3. The main path through the socket: the port's DedupSidecar serves in a
   thread; a seeded 256 MB corpus (A; B = A with scattered edits; C = a
   copy of A; D unique), 64 MB per file, goes in as one
   DEDUP_FINGERPRINT_CUTS segment each for A, B and C (cut by the host
   chunker, as the daemon's chunker would) and one DEDUP_FINGERPRINT
   segment for D (chunked on the card), then DEDUP_NEARDUPS for B and a
   DEDUP_VERIFY batch with one corrupted chunk.  Every digest is checked
   against hashlib, the file signatures against the plain twins, the
   dedup / near-dup / verify verdicts, and that each 64 MB request
   launched each kernel exactly once (verify: one SHA-1 launch; the gear
   kernel for D only).
4. Where one segment's engine time goes: a torch.profiler pass over
   ``DedupEngine.fingerprint``, device time by kernel and the idle share.
   Then the engine at ``DedupConfig(shingle=4)`` on a seeded 64 MB
   segment with cuts, a counted run: one launch of the SHA-1 kernel and
   one of the general-width sketch kernel (stage 4 fused), no plain twin,
   digests equal to hashlib and signatures to the plain twins'.
5. The client's upload fingerprint: ``client.fingerprint_buffer`` on the
   card over corpus file A and a second seeded payload, both exactly
   2^26 bytes (so the device CDC's power-of-two buffer has no slack of
   its own), equal to ``chunk_stream_np`` plus hashlib, one SHA-1 and
   one gear launch (one device kernel) per call; the median wall time of
   5 calls on A, the SHA-1 kernel's share of it, and the gear kernel's
   device time beside its plain twin's (the eager pass it replaced) and
   its bound.
6. Streaming: phase 2's segment as padded ``(256, 65536)`` batches
   through ``sha1_batch_cuda`` with ``ops.streaming.stream_batches``, in
   order and equal to direct calls and hashlib, timed at depth 1 and 2.
7. Reed-Solomon on the GF(2^8) kernel (``csrc/gf_matmul.cu``): a seeded
   64 MB stripe encoded on the card at RS(4,2), RS(10,4) and RS(32,8)
   (the storage config's clamp), each parity equal to ``gf_matmul_np``,
   then rebuilt on the card from the last k of the k + m shards (a
   ``torch.cat`` of a view and the parity), each a counted main-path run
   of one launch; the kernel against its plain twin on each product, at
   shard lengths 0, 1, 3, 17 and 4097, on row and column views, rows past
   32 and a matrix of every byte value; the median ms of encode and
   rebuild beside the bound and the plain twin's, the device kernels an
   encode runs and the device time of its product, and the rebuild's
   product's event and device times.
8. ``parallel/`` with every virtual rank on the one card: the ingest step
   over a (2, 2, 2) mesh and over one rank on two seeded 64 MB streams
   (cut candidates planted at the block seam, the gear kernel's run and
   tile seams and the stream start), one
   stream's ~6,400 chunks as 64 KiB rows and a 65,536-row index, checked
   bit for bit against the whole streams' candidates, hashlib, the
   ragged sketch kernel and NumPy's dense score; the engine's fan-out
   over 2 and 4 ranks against ``fan_out=1``; the fingerprint step over 1
   and 2 ranks against the kernels; ``entry()`` and
   ``dryrun_multichip(8)``.  The gear kernel's dense form on the streams
   as the 8-rank step splits them, with their halos, on rows of 3 tiles
   and 5 bytes read from on and off a 16-byte boundary and on rows
   planted at avg_bits 17, 18 and 32 (timed on the whole streams), and
   the index kernel
   on the step's queries x 65,536 rows and on small odd shapes, and the
   stage-4 kernel (``csrc/minhash_sig.cu``) on a dp rank's real survivor
   vectors at each tp rank's 32 permutations, at 64 and at P = 1, 7, 31,
   33, 100 and 300 with all-EMPTY rows, against their plain twins, bit
   for bit.  Both steps again at shingle 4, counted, equal to the plain
   twins: the 1-rank step signs on the general-width kernel's fused form
   (it holds all 64 permutations), the 8-rank step's tp = 2 ranks run its
   ``z`` form and then stage 4 on their slices.  Times of
   both steps (the 8-rank step also with stage 4 swapped back to its
   plain twin, and at shingle 4), and of the stage-1 CDC, the index query
   and stage 4 on their kernels beside their plain twins and bounds.
9. The live system: ``fdfs_storaged`` (built with ``fdfs_trackerd`` if
   the checkout has neither, through ``tests/torch_native.py``) with
   ``dedup_mode = sidecar`` on the port's
   DedupSidecar, serving on the card in a thread.  The port's
   ``StorageClient(device="cuda")`` uploads a seeded corpus of 64 MB files:
   A, B = A with scattered edits and D unique by plain uploads (the daemon
   cuts them and sends DEDUP_FINGERPRINT_CUTS), then C = A and E = A with a
   new last 1 MB by negotiated uploads (fingerprinted on the card).  Every
   file must be a recipe (the daemon fails open to flat files when the
   sidecar does not answer), read back exactly; C ships 0 bytes and E only
   its new chunks; near_dups(B) ranks A first; a corrupted chunk is found
   by a scrub pass whose DEDUP_VERIFY goes to the sidecar.  Each served
   segment launches each kernel once and each negotiated upload one
   SHA-1.  Wall per 64 MB upload, plain and negotiated, and the stitched
   timeline of one traced plain upload.
10. The tracker-routed cluster: ``fdfs_trackerd`` and two
   ``fdfs_storaged`` of one group, each with ``dedup_mode = sidecar`` on
   its own port DedupSidecar on the card (two engines on one card, as
   two hosts would have).  ``python -m fastdfs_tpu_torch.cli upload
   --dedup`` (no ``--device``: the card by default) sends A from a
   process of its own; ``cli.main`` here sends A' = A with a new last
   1 MB, which ships only its new chunks; ``FdfsClient(device="cuda")``
   uploads D plainly, then A again under ``traced_upload``, whose spans
   ``collect_cluster_spans`` stitches from the tracker and both
   storages.  Every file downloads byte-exact from both storages and is
   a recipe on the storage that took it; each sidecar launches each
   kernel once per segment it serves, the client one SHA-1 per
   negotiated upload made here, and the replicas' own fingerprinting of
   synced files is counted, not assumed.  ``monitor.gather_top`` and
   ``cli --device cuda group status`` / ``health`` show both storages
   live.  Wall per 64 MB upload and the stitched timeline.
11. The port's benchmarks.  ``python -m fastdfs_tpu_torch.bench`` and
   ``--multichip`` at full size (8192 rows of 64 KiB a dispatch), each
   in a process of its own: one stdout line, rc 0, ``ok``, a rate above
   0 after at least ``MIN_ROUNDS`` rounds, the rows it checked equal to
   hashlib and the plain twin, and one launch of each kernel a step (a
   rank's step on the fan-out), as the bench counts them over its
   rounds; its rate, dispersion, ``vs_baseline`` and each kernel's
   device ms are printed.  Then ``bench_configs.config4`` here at scale
   1/400 (4,096 documents): the kernel's signatures equal to the plain
   twin's, every recall field present, recall@1 at the 0.98 target, one
   sketch launch a dispatch; and ``config5``: its 17 steps of the
   (2, 2, 2) mesh on the card, the artifact's shapes, each of the step's
   five kernels once a rank a step.
12. The daemons' ingest through the port's sidecar process:
   ``bench_configs`` config 2 at scale 1/128 (19 text documents, 89 MB,
   four client connections to one storage) and config 3 at 1/512 (mixed
   binaries through a tracker and two storages, until every file has its
   replica), each once with ``dedup_mode = cpu`` and once behind ``python
   -m fastdfs_tpu_torch.sidecar`` on the card.  Each sidecar leg must
   count (no restart, error, upload retry or watchdog re-exec, and
   ``fingerprint_bytes`` equal to the bytes sent); config 2's sidecar leg
   must save the bytes and hit the chunks that its cpu leg does, config
   3's legs must replay every file's recipe on the replica, and every
   upload stage table must record fingerprint time, its shares summing to
   1 +- 0.05.  Each leg's rates, stage shares and the sidecar's
   ``engine_us`` and ``lock_wait_fraction`` are printed.
13. The single-storage configs of ``bench_configs``, in this process:
   config 6 at its default scale (480 negotiated uploads of 256 KB
   blobs to one storage in three passes, cold, warm and tail-edited,
   each fingerprinted by ``FdfsClient(device="cuda")`` on the card),
   counted: the wire bytes of each pass and the daemon's ingest
   counters equal to the reference artifact's five numbers, one SHA-1
   launch an upload, one or two gear launches an upload, no plain twin;
   then the same corpus on the client's host route, which must ship
   the same bytes, both routes' pass seconds printed, and the median
   wall of one blob's fingerprint on each route.  Configs 1 (``fdfs_load``
   at 1/64), 7 (the scrubber off, paced and unpaced, at 1/2048) and 8
   (read cache 0 and 64 MB, the parallel-4 ranged download, at 1/1024),
   counted too, launch no kernel; ``errors`` 0 and half the bytes saved,
   no false corruption with chunks verified only when the scrubber
   runs, and no wrong byte with cache hits only at 64 MB.
14. Configs 9, 10 and 11 of ``bench_configs`` and the index tool
   (``tools.bench_index_scale``), in this process, on the card's host:
   config 9 at 1/2048 (200 unique 4 KB files a layout arm, slab packing
   off and on, then 80% deleted and the slabs compacted), config 10 at
   1/65536 (60 files of 64 KB under one open-loop zipfian load on one
   group and on three, then group3 drained) and config 11 at 1/65536
   (12 files of 256 KB demoted from 2x replication to RS(3, 2) stripes,
   then two shards of every stripe rebuilt, unpaced and at 2 MB/s;
   without the storages' admission ladder, which can shed a peer's
   fetch of a released chunk and cut a download), and the index tool at
   200,000 entries.  Each run, counted, launches no kernel and calls no
   plain twin on the card.  Config 9 must lose no
   byte, win 10x on inodes and reclaim 80% of its dead slab bytes with
   both arms' downloads error-free; config 10 must see no error, spread
   the three-group corpus within 10 points of a third and relocate all
   of group3; config 11 must store ~2x replicated, at most (k+m)/k + 5%
   demoted, lose no byte and rebuild from parity alone.  The timing
   verdicts (packed ingest p50 no worse, the offered rate met by three
   groups, the paced rebuild within its budget and slower than the
   unpaced) are printed beside their readings, not checked.
15. Configs 12, 13 and 14 of ``bench_configs``, the read path, in this
   process: config 12 at 1/65536 (24 files of 256 KB; one open-loop
   download load on a 1-reactor and a 4-reactor storage, 64 held
   sockets, the port's ranged downloader and a mid-load flamegraph of
   each arm by ``python -m fastdfs_tpu_torch.cli --device cuda
   profile``), config 13 at its default 1/128 (12 files of 1 MB; a
   priority-mixed load at 1.7x capacity with admission off and on, and
   at half capacity) and config 14 at 1/65536 (12 files of 8 KB; a
   90%-hot read mix on three groups with the hot-map policy off and
   on, read by the port's ``FdfsClient``).  Each run, counted, launches
   no kernel and calls no plain twin on the card.  Config 12 must see
   no error and no wrong byte, no ranged fallback on either arm, the
   connection budget honoured, more vectored-read spans than batches,
   the held sockets spread within 2x of the mean and both folded
   stack files written with samples; config 13 must see no error but
   sheds and never shed an interactive read; config 14 must publish the
   promotion, route reads through it and see no read error.  Their
   timing verdicts (config 12's p99 ratios, config 13's shed and
   collapse verdicts, config 14's spreads and hot p99s) are printed
   beside their readings, not checked.

The kernels' launch counts are those of the main-path runs in phases 3,
4, 5, 6, 7, 8, 9, 10, 11 and 13 (each counted from 0 just before its
run; the general-width kernel's two forms from the runs at shingle 4;
phase 12's sidecar launches in a process of its own and is not counted;
phase 13's are config 6's run on the card, its warm-up fingerprint
included; the runs of phases 14 and 15 are counted too and must launch
none);
launches made only to time or compare a kernel are not counted.  Those
runs must call no plain twin on a CUDA tensor (the ``cuda_calls`` of
``gear_window``, ``index_best``, ``rs_code.gf_matmul_torch``,
``minhash.survivor_ragged``, ``minhash.survivor_segmin`` and
``minhash.signature_tiles`` stay 0).
The second-to-last line is a JSON object with one entry per kernel (the
gear kernel's two forms as two entries, the sketch file's k = 5 kernel
as one and its general-width kernel's two forms, fused ``sketch_k`` and
``z`` alone ``survivor_k``, as two; the seven that replace jitted XLA,
not a Pallas kernel, say so in ``replaces_kind``); the last is ``{"ok":
true, "device": {...}}``.
Without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import importlib.util
import io
import json
import os
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from fastdfs_tpu_torch import bench as bench_mod
from fastdfs_tpu_torch import bench_configs
from fastdfs_tpu_torch import cli as cli_mod
from fastdfs_tpu_torch import monitor as monitor_mod
from fastdfs_tpu_torch import sidecar as sidecar_mod
from fastdfs_tpu_torch.client import (FdfsClient, StorageClient,
                                      TrackerClient, fingerprint_buffer)
from fastdfs_tpu_torch.client.conn import ProtocolError, StatusError
from fastdfs_tpu_torch.client import fingerprint as fingerprint_mod
from fastdfs_tpu_torch.client import storage_client as storage_client_mod
from fastdfs_tpu_torch.common import protocol
from fastdfs_tpu_torch.dedup import engine as engine_mod
from fastdfs_tpu_torch.dedup.engine import DedupConfig, DedupEngine
from fastdfs_tpu_torch.entry import dryrun_multichip, entry
from fastdfs_tpu_torch.ops import (SEGMENT_SLACK, _build, minhash, rs_code,
                                   sha1, widen)
from fastdfs_tpu_torch.ops.cuda_gear import (RUN, TILE,
                                             block_candidates_cuda,
                                             gear_candidates_cuda)
from fastdfs_tpu_torch.ops import gear_cdc as gear_cdc_mod
from fastdfs_tpu_torch.ops.cuda_gf import gf_matmul_cuda
from fastdfs_tpu_torch.ops.cuda_index import index_best, index_best_cuda
from fastdfs_tpu_torch.ops.cuda_minhash import (minhash_batch_cuda,
                                                signature_tiles_cuda,
                                                sketch_ragged_cuda,
                                                survivor_ragged_cuda,
                                                survivor_segmin_cuda)
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_batch_cuda, sha1_ragged_cuda
from fastdfs_tpu_torch.ops.gear_cdc import (candidate_mask, chunk_stream,
                                            chunk_stream_np, device_cuts,
                                            gear_candidates,
                                            gear_candidates_np, gear_hashes,
                                            gear_hashes_np, gear_values,
                                            gear_window, upload_padded)
from fastdfs_tpu_torch.ops.streaming import stream_batches
from fastdfs_tpu_torch.parallel import (fingerprint_mesh,
                                        make_fingerprint_step,
                                        make_ingest_step, make_mesh)
from fastdfs_tpu_torch.parallel import ingest_step as ingest_step_mod
from fastdfs_tpu_torch.parallel.ingest_step import HALO, block_candidates
from fastdfs_tpu_torch.sidecar import DedupSidecar
from fastdfs_tpu_torch.tools import bench_index_scale
from fastdfs_tpu_torch.tools.timing import card_line, median_ms, once_ms
from fastdfs_tpu_torch.trace import (Tracer, collect_cluster_spans,
                                     decode_dump, render_timeline,
                                     traced_upload)


def _load_native():
    """``tests/torch_native.py`` (the daemons' build and start) by its
    path: a host may have another package named ``tests`` on its path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_native.py")
    spec = importlib.util.spec_from_file_location("fdfs_torch_native", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


native = _load_native()
harness = native.harness
dense_pair, plant_candidate = native.dense_pair, native.plant_candidate
seam_plants, shingle_segment = native.seam_plants, native.shingle_segment
plant_wide, wide_seam_plants = native.plant_wide, native.wide_seam_plants

SEED = 20261016
SEGMENT = 64 << 20                     # storage.conf dedup_segment_bytes
PLAIN_ROW_TILE = 4096                  # plain twins' tiles on the card
ROW = 65536                            # DedupConfig.max_size: a chunk per row
INDEX_ROWS = 65536                     # phase 8's near-dup index, 16 MB
INDEXED = 4096                         # stream 0's chunks in that index
RANKS = 8                              # phase 8's (2, 2, 2) mesh

# H100 SXM peaks for the bound: HBM3 bandwidth (NVIDIA data sheet) and
# the 32-bit integer rate, 132 SMs x 64 results per clock (IMAD, IADD3,
# LOP3, SHF, IMNMX on compute capability 9.0) x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
# The fewest sm_90a integer instructions each function needs, one per
# IMAD, IADD3, LOP3, SHF (funnel shift) or PRMT:
# - SHA-1 per 64-byte block: 16 byte swaps (PRMT); 64 schedule words of
#   two LOP3 (four-way xor) and one SHF (rotate); 80 rounds of one SHF
#   (rotl 5), one LOP3 (choose, parity or majority), two IADD3 (the five
#   addends) and one SHF (rotl 30); 5 IADD3 into the state.
#   16 + 192 + 400 + 5 = 613.
# - Survivor sketch per byte position, the hash rolled forward
#   (h' = h*B - b[p]*B^5 + b[p+5], two IMAD): one PRMT for the new byte,
#   two IMAD, one LOP3 (sample test, predicate out), one IMNMX (min);
#   plus per 4-byte word an address add, a loop add, a compare and a
#   segment flush, one per position.  5 + 1 = 6.  The same at any
#   shingle width k: the roll's two IMAD do not depend on k.
# - Stage 4 per non-EMPTY segment minimum and permutation: one IMAD
#   (a*z + b) and one IMNMX.  2.
SHA1_OPS_PER_BLOCK = 613
SURVIVOR_OPS_PER_POSITION = 6
STAGE4_OPS_PER_SURVIVOR_PERM = 2
# SHA-1's critical path: a message's blocks are a serial chain, and each
# round depends on the last through two instructions (rotl(a,5) or f,
# then one IADD3).  A dependent 32-bit ALU instruction issues about 4
# cycles after its producer: measured at 4 cycles for IADD3, LOP3 and
# SHF-class instructions on Volta by Jia et al., "Dissecting the NVIDIA
# Volta GPU Architecture via Microbenchmarking" (arXiv:1804.06826), and
# assumed unchanged on Hopper.  So the longest chunk alone needs
# blocks x 80 x 2 x 4 cycles.
SHA1_CHAIN_INSTR_PER_ROUND = 2
ALU_LATENCY_CYCLES = 4
# Device code that is not a TPU kernel (plain PyTorch in the port), with
# the fewest sm_90a integer instructions its work needs; a lookup in a
# table in shared memory counts as one instruction (LDS):
# - Gear CDC per byte position: one PRMT to take the byte, one LDS of
#   its value in the 256-entry gear table, one LEA rolling
#   h = (h << 1) + g, one LOP3 for the candidate test (predicate out).
#   4.  (The kernel reads the table from shared memory, one copy per
#   bank, as counted here, in PRMT, IMAD (the address), LDS, IMAD (the
#   roll) and half a three-input min, which tests 16 positions at once
#   on hashes kept shifted so that a candidate is zero.)
# - GF(2^8) matmul per output byte and shard column: one table lookup
#   (LDS from a 64 KiB table in shared memory) and a quarter of a LOP3
#   (the xor works on four packed bytes).  1.25.
CDC_OPS_PER_POSITION = 4
GF_OPS_PER_PRODUCT = 1.25

_I64 = struct.Struct(">q")


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def i64(t: torch.Tensor) -> np.ndarray:
    """uint32 tensor on any device -> int64 numpy with the same values."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32).astype(np.int64)


def sha1_bound(lens: np.ndarray) -> tuple[float, str]:
    """(ms, by) of one SHA-1 launch over these chunks: the larger of its
    bytes (each chunk byte and its offset, length and order entry read
    once, 20 bytes written per chunk) over HBM, its operations over the INT32 rate, and the
    longest chunk's dependent chain."""
    lens = lens.astype(np.int64)
    blocks = (lens + 8) // 64 + 1
    t_bytes = float(lens.sum() + 36 * len(lens)) / HBM_BYTES_PER_S
    t_ops = float(blocks.sum() * SHA1_OPS_PER_BLOCK) / INT32_OPS_PER_S
    t_chain = (float(blocks.max()) * 80 * SHA1_CHAIN_INSTR_PER_ROUND
               * ALU_LATENCY_CYCLES / SM_CLOCK_HZ)
    return (max(t_bytes, t_ops, t_chain) * 1e3,
            "bytes" if t_bytes >= max(t_ops, t_chain) else "operations")


def cdc_bound(n: int, k: int) -> tuple[float, str]:
    """(ms, by) of the device CDC pass over n bytes: each byte read once
    and k int64 candidate slots written, against CDC_OPS_PER_POSITION."""
    t_bytes = float(n + 8 * k) / HBM_BYTES_PER_S
    t_ops = float(n) * CDC_OPS_PER_POSITION / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def block_cdc_bound(rows: int, length: int) -> tuple[float, str]:
    """(ms, by) of the dense CDC pass over ``rows`` rows of ``length``
    bytes: each byte and the 31 int64 halo values of a row read once, one
    bool written a position, against CDC_OPS_PER_POSITION."""
    t_bytes = float(rows * (2 * length + 8 * HALO)) / HBM_BYTES_PER_S
    t_ops = float(rows * length) * CDC_OPS_PER_POSITION / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def index_bound(n: int, m: int, p: int) -> tuple[float, str]:
    """(ms, by) of the index query of n queries against m rows of p
    lanes: each signature word read once and n floats written, against
    two instructions (compare, add) per (query, row, lane)."""
    t_bytes = float(4 * (n + m) * p + 4 * n) / HBM_BYTES_PER_S
    t_ops = float(2 * n * m * p) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def gf_bound(rows: int, k: int, length: int) -> tuple[float, str]:
    """(ms, by) of a (rows x k) GF(2^8) matmul over shards of ``length``
    bytes: (k + rows) * length bytes, against rows * k * length lookups."""
    t_bytes = float((k + rows) * length) / HBM_BYTES_PER_S
    t_ops = float(rows * k * length) * GF_OPS_PER_PRODUCT / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


PROFILE_TRIES = 5


def device_profile(fn, need: tuple[tuple[str, int], ...] = ()
                   ) -> tuple[float, dict[str, tuple[float, int]]]:
    """One call of ``fn`` under torch.profiler: its wall ms and, per
    device kernel or copy name, (device us, count).  The profiler at
    times drops a run's device events; with ``need`` (pairs of a name and
    the launches it must show), ``fn`` is profiled again, up to
    PROFILE_TRIES times in all, until every pair shows, and ``{}`` comes
    back for the kernels if none did."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        kernels = {ev.key: (ev.self_device_time_total, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA}
        if all(sum(c for key, (_, c) in kernels.items() if name in key)
               >= count for name, count in need):
            return wall_ms, kernels
    print(f"  (the profiler's last try showed {len(kernels)} device names: "
          + ", ".join(f"{key[:40]} x{c}" for key, (_, c) in
                      sorted(kernels.items())[:8]) + ")", file=sys.stderr)
    return wall_ms, {}


def device_ms(fn, kernel: str, n: int = 20) -> float | None:
    """Device ms of one call of ``fn``: over ``n`` calls under
    torch.profiler, after one warm-up call, the mean time of each device
    kernel, memset or copy that the calls ran (each runs once a call),
    summed.  The profiler drops one of a run's device events now and
    then; a mean leaves it out instead of reading it as zero.  None (not
    measured) where it never showed half the ``n`` kernels whose names
    hold ``kernel``.  Unlike a CUDA-event time around a call, it leaves
    out the host's time in the wrapper."""
    fn()
    _, kernels = device_profile(lambda: [fn() for _ in range(n)],
                                ((kernel, n // 2),))
    if not kernels:
        return None
    return sum(us / c for us, c in kernels.values()) / 1e3


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def time_kernel(rec, fn, kernel: str, n: int = 20) -> None:
    """A gear form's two times on one call ``fn`` of its wrapper: ``ms``,
    the CUDA-event median of ``n`` calls, as every kernel has, and
    ``device_ms``, its device time under torch.profiler (``kernel`` names
    its device kernel)."""
    rec.ms = median_ms(fn, n)
    rec.device_ms = device_ms(fn, kernel, n)


def sketch_bound(lens: np.ndarray, survivors: int, k: int = 5
                 ) -> tuple[float, str]:
    """(ms, by) of one fused sketch launch at shingle width k: each chunk
    byte and its offset, length and order entry read once and 256
    signature bytes written per chunk, against the positions p <= bound
    and stage 4 over this run's non-EMPTY segment minima."""
    lens = lens.astype(np.int64)
    bound = np.where(lens >= k, lens - k, np.maximum(lens, 1) - 1)
    t_bytes = float(lens.sum() + 272 * len(lens)) / HBM_BYTES_PER_S
    ops = ((bound + 1).sum() * SURVIVOR_OPS_PER_POSITION
           + survivors * 64 * STAGE4_OPS_PER_SURVIVOR_PERM)
    t_ops = float(ops) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


class KernelRecord:
    """One kernel's entry of the ``kernels`` line.  ``xla`` marks a
    kernel whose reference is a jitted XLA function, not a Pallas
    kernel."""

    def __init__(self, name, source, replaces, xla=False):
        self.name, self.source, self.replaces = name, source, replaces
        self.xla = xla
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.device_ms = None
        self.bound_by = ""
        self.max_abs_err = 0
        self.launches = 0

    def json(self):
        out = {"name": self.name, "route": "cuda", "source": self.source,
               "replaces": self.replaces, "launches": self.launches,
               "max_abs_err": self.max_abs_err, "ms": self.ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": self.bound_by, "library_ms": None}
        if self.device_ms is not None:
            out["device_ms"] = self.device_ms
        if self.xla:
            out["replaces_kind"] = "jax.jit (XLA) in the reference, not a " \
                                   "Pallas kernel"
        return out


# The plain twins' calls on a CUDA tensor: every eager gear pass goes
# through gear_window, the plain index query is index_best, the plain
# GF(2^8) product gf_matmul_torch, the plain stages 1-3 survivor_ragged
# and survivor_segmin (at any shingle width) and the plain stage 4
# signature_tiles.  The card's paths make none.
PLAIN_TWINS = (gear_window, index_best, rs_code.gf_matmul_torch,
               minhash.survivor_ragged, minhash.survivor_segmin,
               minhash.signature_tiles)


def reset_plain() -> None:
    for f in PLAIN_TWINS:
        f.cuda_calls = 0


def check_no_plain(what: str) -> None:
    calls = {f.__name__: f.cuda_calls for f in PLAIN_TWINS if f.cuda_calls}
    check(not calls, f"{what}: plain twins ran on the card: {calls}")


def on_card(dev, seg: bytes, offsets, lens):
    """A segment with its zero slack, and its chunk table (offsets,
    lengths, longest-first order), on the card, as the engine stages it."""
    buf = torch.zeros(len(seg) + SEGMENT_SLACK, dtype=torch.uint8)
    buf.numpy()[:len(seg)] = np.frombuffer(seg, np.uint8)
    lens = np.asarray(lens, np.int32)
    order = np.argsort(-lens, kind="stable").astype(np.int32)
    return (buf.to(dev), torch.from_numpy(np.asarray(offsets, np.int64)).to(dev),
            torch.from_numpy(lens).to(dev), torch.from_numpy(order).to(dev))


def edge_segment(rng) -> tuple[bytes, list[int], list[int]]:
    """Lengths 0-8, 55-57, 63-65 and 1400 at every start offset mod 4,
    each followed by non-zero bytes, then a chunk past the 64 KiB max_size
    that ends the segment."""
    seg = bytearray()
    offsets, lens = [], []
    for align in range(4):
        for n in list(range(9)) + [55, 56, 57, 63, 64, 65, 1400]:
            seg += rng.integers(1, 256, 1 + (align - len(seg) - 1) % 4,
                                dtype=np.uint8).tobytes()
            offsets.append(len(seg))
            lens.append(n)
            seg += rng.integers(1, 256, n, dtype=np.uint8).tobytes()
    offsets.append(len(seg))
    lens.append(66000)
    seg += rng.integers(1, 256, 66000, dtype=np.uint8).tobytes()
    return bytes(seg), offsets, lens


def check_segment(dev, what, seg, offsets, lens, rec_sha1, rec_sketch,
                  timed: bool) -> None:
    """Both ragged kernels on one segment, bit for bit against their plain
    twins and hashlib; with ``timed``, the CUDA-event medians, the twins'
    times and the bounds go into the records."""
    d_seg, d_off, d_len, d_ord = on_card(dev, seg, offsets, lens)
    plain_seg = d_seg[:len(seg)]

    got = i64(sha1_ragged_cuda(d_seg, d_off, d_len, d_ord))
    plain, plain_ms = once_ms(lambda: sha1.sha1_ragged(
        plain_seg, d_off, d_len, PLAIN_ROW_TILE))
    err = int(np.abs(got - i64(plain)).max())
    check(err == 0, f"sha1 kernel != plain twin on the {what}")
    raw = sha1.digest_bytes(got.astype(np.uint32))
    for i, (o, n) in enumerate(zip(offsets, lens)):
        check(raw[i * 20:(i + 1) * 20] == hashlib.sha1(seg[o:o + n]).digest(),
              f"sha1 kernel != hashlib on the {what}, chunk {i}")
    rec_sha1.max_abs_err = max(rec_sha1.max_abs_err, err)
    if timed:
        rec_sha1.ms = median_ms(lambda: sha1_ragged_cuda(d_seg, d_off, d_len,
                                                         d_ord))
        rec_sha1.plain_ms = plain_ms
        rec_sha1.bound_ms, rec_sha1.bound_by = sha1_bound(np.asarray(lens))

    got = i64(sketch_ragged_cuda(d_seg, d_off, d_len, None, d_ord))
    (plain, z), plain_ms = once_ms(lambda: minhash.sketch_ragged(
        plain_seg, d_off, d_len, row_tile=PLAIN_ROW_TILE, with_z=True))
    err = int(np.abs(got - i64(plain)).max())
    check(err == 0, f"sketch kernel != plain twin on the {what}")
    survivors = int((i64(z) != int(minhash.EMPTY)).sum())
    check(survivors > 0, f"sketch of the {what} has no survivor")
    check(np.array_equal(i64(survivor_ragged_cuda(d_seg, d_off, d_len,
                                                  order=d_ord)), i64(z)),
          f"sketch kernel's stages 1-3 != plain twin on the {what}")
    rec_sketch.max_abs_err = max(rec_sketch.max_abs_err, err)
    if timed:
        words = minhash.perm_words(64, dev)

        def sketch():
            return sketch_ragged_cuda(d_seg, d_off, d_len, words, d_ord)
        rec_sketch.ms = median_ms(sketch)
        rec_sketch.device_ms = device_ms(sketch, "sketch_ragged_kernel")
        rec_sketch.plain_ms = plain_ms
        rec_sketch.bound_ms, rec_sketch.bound_by = sketch_bound(
            np.asarray(lens), survivors)
        print(f"  {what}: {len(lens)} chunks, longest {max(lens)} B, "
              f"{survivors} survivors; sha1 {rec_sha1.ms:.4f} ms (plain "
              f"{rec_sha1.plain_ms:.1f}, bound {rec_sha1.bound_ms:.4f} by "
              f"{rec_sha1.bound_by}); sketch {rec_sketch.ms:.4f} ms, "
              f"{fmt_ms(rec_sketch.device_ms)} ms on the device (plain "
              f"{rec_sketch.plain_ms:.1f}, bound {rec_sketch.bound_ms:.4f} "
              f"by {rec_sketch.bound_by}); bit-exact")
    else:
        print(f"  {what}: {len(lens)} chunks, both kernels bit-exact")


def check_whole_segment_chunk(dev, rng) -> None:
    """One chunk as large as the segment: a single serial SHA-1 chain of
    1M blocks, correct and slow."""
    seg = rng.integers(0, 256, SEGMENT, dtype=np.uint8).tobytes()
    d_seg, d_off, d_len, d_ord = on_card(dev, seg, [0], [SEGMENT])
    digest, sha1_ms = once_ms(lambda: sha1_ragged_cuda(d_seg, d_off, d_len,
                                                       d_ord))
    check(sha1.digest_bytes(digest) == hashlib.sha1(seg).digest(),
          "sha1 kernel != hashlib on the whole-segment chunk")
    sig, sketch_ms = once_ms(lambda: sketch_ragged_cuda(d_seg, d_off, d_len,
                                                        None, d_ord))
    plain = minhash.sketch_ragged(d_seg[:SEGMENT], d_off, d_len)
    check(np.array_equal(i64(sig), i64(plain)),
          "sketch kernel != plain twin on the whole-segment chunk")
    print(f"  one {SEGMENT >> 20} MB chunk: sha1 {sha1_ms:.1f} ms, sketch "
          f"{sketch_ms:.1f} ms (one launch each, first call); bit-exact")


def check_padded_adapters(dev, rng) -> None:
    """The (N, L) entries over the same kernels: 256 rows of 2048 bytes
    with the edge lengths, and a verify-shaped batch with a length 0."""
    data = rng.integers(0, 256, (256, 2048), dtype=np.uint8)
    lens = rng.integers(1, 2049, 256).astype(np.int32)
    lens[:12] = [2048, 0, 1, 3, 4, 5, 55, 56, 57, 63, 64, 65]
    data[np.arange(2048)[None, :] >= lens[:, None]] = 0
    d = torch.from_numpy(data).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    check(np.array_equal(i64(sha1_batch_cuda(d, ln)), i64(sha1.sha1_batch(d, ln))),
          "padded sha1 adapter != plain twin")
    check(np.array_equal(i64(survivor_segmin_cuda(d, ln)),
                         i64(minhash.survivor_segmin(d, ln))),
          "padded survivor adapter != plain twin")
    check(np.array_equal(i64(minhash_batch_cuda(d, ln)),
                         i64(minhash.minhash_batch(d, ln))),
          "padded sketch adapter != plain twin")
    print("  padded (256, 2048) adapters of both kernels: bit-exact")


SHINGLES = (4, 8)                  # phase 2's widths other than 5


def survivor_k_bound(lens: np.ndarray, k: int) -> tuple[float, str]:
    """(ms, by) of one launch of stages 1-3 at width k: each chunk byte
    and its offset, length and order entry read once and its 4 KiB of
    ``z`` written, against SURVIVOR_OPS_PER_POSITION at every position
    p <= bound."""
    lens = lens.astype(np.int64)
    bound = np.where(lens >= k, lens - k, np.maximum(lens, 1) - 1)
    t_bytes = float(lens.sum() + (16 + 4 * minhash.NUM_SEGMENTS)
                    * len(lens)) / HBM_BYTES_PER_S
    t_ops = float((bound + 1).sum() * SURVIVOR_OPS_PER_POSITION) \
        / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_survivor_k(dev, what: str, seg: bytes, offsets, lens, k: int,
                     rec, timed: bool) -> None:
    """Stages 1-3 at width ``k`` (the general-width kernel's ``z`` form)
    on one segment, one launch, bit for bit against the plain twin; with
    ``timed``, the times and the bound go into the record."""
    d_seg, d_off, d_len, d_ord = on_card(dev, seg, offsets, lens)
    before = survivor_ragged_cuda.launches
    got = survivor_ragged_cuda(d_seg, d_off, d_len, k, order=d_ord)
    torch.cuda.synchronize()
    check(survivor_ragged_cuda.launches == before + 1,
          f"stages 1-3 at k = {k} on the {what}: not one launch")
    want, plain_ms = once_ms(lambda: minhash.survivor_ragged(
        d_seg[:len(seg)], d_off, d_len, k, PLAIN_ROW_TILE))
    err = int(np.abs(i64(got) - i64(want)).max())
    rec.max_abs_err = max(rec.max_abs_err, err)
    check(err == 0, f"general-width kernel's z form != plain twin at k = "
          f"{k} on the {what}")
    survivors = int((i64(got) != int(minhash.EMPTY)).sum())
    if not timed:
        print(f"  general-width kernel, z form, k = {k}, {what} "
              f"({len(lens)} chunks): one launch, bit-exact")
        return

    def fn():
        return survivor_ragged_cuda(d_seg, d_off, d_len, k, order=d_ord)
    ms, dev_ms = median_ms(fn), device_ms(fn, "sketch_k_kernel")
    bound, by = survivor_k_bound(np.asarray(lens), k)
    if k == SHINGLES[0]:
        rec.ms, rec.device_ms, rec.plain_ms = ms, dev_ms, plain_ms
        rec.bound_ms, rec.bound_by = bound, by
    print(f"  general-width kernel, z form, k = {k}, {what}: {survivors} "
          f"survivors, one launch, {ms:.4f} ms a call (CUDA events), "
          f"{fmt_ms(dev_ms)} ms on the device (plain twin {plain_ms:.1f}, "
          f"bound {bound:.4f} by {by}); bit-exact")


def check_sketch_k(dev, what: str, seg: bytes, offsets, lens, k: int, rec,
                   timed: bool) -> None:
    """The general-width kernel's fused form at width ``k`` on one
    segment: signatures and ``z`` from one launch, bit for bit against
    ``minhash.sketch_ragged(..., 64, k)``; with ``timed``, the signature
    call's times and bound go into the record."""
    d_seg, d_off, d_len, d_ord = on_card(dev, seg, offsets, lens)
    words = minhash.perm_words(64, dev)
    before = sketch_ragged_cuda.launches
    sig, z = sketch_ragged_cuda(d_seg, d_off, d_len, words, d_ord, k=k,
                                with_z=True)
    torch.cuda.synchronize()
    check(sketch_ragged_cuda.launches == before + 1,
          f"fused sketch at k = {k} on the {what}: not one launch")
    (want, want_z), plain_ms = once_ms(lambda: minhash.sketch_ragged(
        d_seg[:len(seg)], d_off, d_len, 64, k, row_tile=PLAIN_ROW_TILE,
        with_z=True))
    err = max(int(np.abs(i64(sig) - i64(want)).max()),
              int(np.abs(i64(z) - i64(want_z)).max()))
    rec.max_abs_err = max(rec.max_abs_err, err)
    check(err == 0, f"general-width kernel's fused form != plain twin at "
          f"k = {k} on the {what}")
    survivors = int((i64(want_z) != int(minhash.EMPTY)).sum())
    check(survivors > 0, f"fused sketch at k = {k}: the {what} has no "
          f"survivor")
    if not timed:
        print(f"  general-width kernel, fused, k = {k}, {what} "
              f"({len(lens)} chunks): signatures and z from one launch, "
              f"bit-exact")
        return

    def fn():
        return sketch_ragged_cuda(d_seg, d_off, d_len, words, d_ord, k=k)
    ms, dev_ms = median_ms(fn), device_ms(fn, "sketch_k_kernel")
    bound, by = sketch_bound(np.asarray(lens), survivors, k)
    if k == SHINGLES[0]:
        rec.ms, rec.device_ms, rec.plain_ms = ms, dev_ms, plain_ms
        rec.bound_ms, rec.bound_by = bound, by
    print(f"  general-width kernel, fused, k = {k}, {what}: {survivors} "
          f"survivors, one launch, {ms:.4f} ms a call (CUDA events), "
          f"{fmt_ms(dev_ms)} ms on the device (plain twin {plain_ms:.1f}, "
          f"bound {bound:.4f} by {by}); signatures and z bit-exact")


def check_shingles(dev, rng, seg: bytes, offsets, lens, rec_fused,
                   rec_z) -> None:
    """The general-width kernel at k = 4 and 8, fused and z alone, on the
    64 MB segment (timed) and on an edge segment each, and the padded
    adapters at k = 4."""
    for k in SHINGLES:
        big = f"{SEGMENT >> 20} MB segment"
        check_sketch_k(dev, big, seg, offsets, lens, k, rec_fused, timed=True)
        check_survivor_k(dev, big, seg, offsets, lens, k, rec_z, timed=True)
        edge, e_off, e_len = shingle_segment(rng, k)
        check_sketch_k(dev, "edge segment", edge, e_off, e_len, k, rec_fused,
                       timed=False)
        check_survivor_k(dev, "edge segment", edge, e_off, e_len, k, rec_z,
                         timed=False)
    data = rng.integers(0, 256, (256, 2048), dtype=np.uint8)
    ln = rng.integers(1, 2049, 256).astype(np.int32)
    ln[:6] = [0, 1, 3, 4, 5, 2048]
    data[np.arange(2048)[None, :] >= ln[:, None]] = 0
    d, d_ln = torch.from_numpy(data).to(dev), torch.from_numpy(ln).to(dev)
    check(np.array_equal(i64(survivor_segmin_cuda(d, d_ln, 4)),
                         i64(minhash.survivor_segmin(d, d_ln, 4))),
          "padded survivor adapter at k = 4 != plain twin")
    check(np.array_equal(i64(minhash_batch_cuda(d, d_ln, 64, 4)),
                         i64(minhash.minhash_batch(d, d_ln, 64, 4))),
          "padded sketch adapter at k = 4 != plain twin")
    print("  padded (256, 2048) adapters at k = 4 (fused and z alone): "
          "bit-exact")


def check_gear(rec, what: str, buf: torch.Tensor, n: int, bits: int, k: int
               ) -> int:
    """The gear kernel's compacted form on one card buffer against its
    plain twin and the host scan, bit for bit; returns the count."""
    out = gear_candidates_cuda(buf, n, bits, k)
    plain = gear_candidates(buf, n, bits, k)
    pos, count, plain, plain_count = out[:k], out[k], plain[:k], plain[k]
    err = int((pos - plain).abs().max()) if k else 0
    rec.max_abs_err = max(rec.max_abs_err, err,
                          abs(int(count) - int(plain_count)))
    check(err == 0 and int(count) == int(plain_count),
          f"gear kernel != plain twin on the {what}")
    host = gear_candidates_np(buf[:n].cpu().numpy(), bits)
    got = pos.cpu().numpy()
    check(int(count) == len(host) and np.array_equal(got[:len(host)],
                                                     host[:k])
          and (got[len(host):] == buf.shape[0]).all(),
          f"gear kernel != the host scan on the {what}")
    return int(count)


# At most two blocks of either form fit on an SM (each takes over 100 KiB
# of shared memory, csrc/gear_cdc.cu): the most blocks a persistent grid
# can have is twice the SM count.
BLOCKS_PER_SM = 2
WIDE_BITS = (17, 18, 32)           # a thread rolls 32 bytes before its run


def check_repeats(what: str, buf: torch.Tensor, n: int, bits: int, k: int
                  ) -> None:
    """50 launches of the compacted form give the first launch's output
    bit for bit: the look-back has no race."""
    first = gear_candidates_cuda(buf, n, bits, k)
    same = sum(torch.equal(gear_candidates_cuda(buf, n, bits, k), first)
               for _ in range(50))
    check(same == 50, f"{50 - same} of 50 repeat launches on the {what} "
          f"(k = {k}) differ from the first")


def wide_buffer(rng, size: int, bits: int) -> np.ndarray:
    """Seeded bytes with candidates planted at ``bits`` where their
    windows cross the kernel's run and tile seams."""
    data = rng.integers(0, 256, size, dtype=np.uint8)
    planted = wide_seam_plants(size, bits)
    for p in planted:
        plant_wide(data, p, bits)
    check(set(planted) <= set(gear_candidates_np(data, bits).tolist()),
          f"a position planted at {bits} bits is not a candidate")
    return data


def check_gear_kernel(dev, seg: bytes, rec) -> None:
    """The gear kernel's compacted form on phase 2's segment as the
    client stages it (timed; more tiles than the persistent grid has
    blocks), below a non-power-of-two n, on a buffer of fewer tiles than
    blocks, on buffers planted at the run and tile seams at avg_bits 17,
    18 and 32, and on an adversarial buffer: candidates planted in the
    first window and at the seams, and a run dense enough to overflow
    ``device_cuts``' k, recovered through the kernel.  50 launches on the
    segment and on the adversarial buffer must agree bit for bit."""
    bits = DedupConfig().avg_bits
    blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count
    _, staged = upload_padded(seg, dev, slack=SEGMENT_SLACK)
    buf = staged[:SEGMENT]
    k = max(SEGMENT >> (bits - 2), 256)                # chunk_stream's k
    check(SEGMENT // TILE > blocks, f"{SEGMENT // TILE} tiles, not more "
          f"than {blocks} blocks")
    count = check_gear(rec, f"{SEGMENT >> 20} MB segment", buf, SEGMENT,
                       bits, k)
    time_kernel(rec, lambda: gear_candidates_cuda(buf, SEGMENT, bits, k),
                "gear_compact_kernel")
    # A yardstick, not the function: PyTorch reading the same bytes.
    sum_ms = device_ms(lambda: buf.view(torch.int64).sum(), "")
    rec.plain_ms = median_ms(lambda: gear_candidates(buf, SEGMENT, bits, k),
                             3)
    rec.bound_ms, rec.bound_by = cdc_bound(SEGMENT, k)
    check_repeats(f"{SEGMENT >> 20} MB segment", buf, SEGMENT, bits, k)
    odd = SEGMENT - 12345
    odd_count = check_gear(rec, "segment below a non-power-of-two n", buf,
                           odd, bits, k)

    rng = np.random.default_rng(SEED + 10)
    small = 5 * 1024 + 3
    few = rng.integers(0, 256, small, dtype=np.uint8)
    for p in seam_plants(small):
        plant_candidate(few, p, bits)
    check(small < TILE, "the small buffer is more than one tile")
    d_few = torch.from_numpy(few).to(dev)
    few_count = check_gear(rec, "buffer of fewer tiles than blocks", d_few,
                           small, bits, 256)
    check_gear(rec, "buffer of fewer tiles than blocks, k short", d_few,
               small, bits, few_count // 2)

    wide_counts = []
    for wide in WIDE_BITS:
        size = 5 * TILE + 77
        d_wide = torch.from_numpy(wide_buffer(rng, size, wide)).to(dev)
        wide_counts.append(check_gear(rec, f"buffer planted at {wide} bits",
                                      d_wide, size, wide, 64))
        check_gear(rec, f"buffer planted at {wide} bits, k short", d_wide,
                   size, wide, wide_counts[-1] // 2)

    size = 4 << 20
    adv = rng.integers(0, 256, size, dtype=np.uint8)
    run = (1 << 20, (1 << 20) + (64 << 10))           # the dense run
    x, y = dense_pair(bits)
    adv[run[0]:run[1]] = np.tile(np.array([x, y], np.uint8), 32 << 10)
    planted = [p for p in seam_plants(size)
               if not run[0] - 1 <= p < run[1] + HALO]
    for p in planted:
        plant_candidate(adv, p, bits)
    host = gear_candidates_np(adv, bits)
    check(set(planted) <= set(host.tolist()), "a planted position is not a "
          "candidate of the adversarial buffer")
    d_adv = torch.from_numpy(adv).to(dev)
    kk = max(size >> (bits - 2), 256)
    full = check_gear(rec, "adversarial buffer, k short", d_adv, size, bits,
                      kk)
    check(full > kk, f"the dense run left {full} candidates, not past {kk}")
    check_gear(rec, "adversarial buffer, k = count", d_adv, size, bits, full)
    for kr in (kk, full):
        check_repeats("adversarial buffer", d_adv, size, bits, kr)
    before = gear_candidates_cuda.launches
    reset_plain()
    cuts = chunk_stream(adv.tobytes(), device=dev)
    check(cuts == chunk_stream_np(adv.tobytes()),
          "device CDC != chunk_stream_np on the adversarial buffer")
    check(gear_candidates_cuda.launches == before + 2,
          f"overflow recovery made {gear_candidates_cuda.launches - before} "
          "gear launches, not 2")
    check_no_plain("overflow recovery")
    print(f"  gear kernel (compacted) on the {SEGMENT >> 20} MB segment "
          f"({SEGMENT // TILE} tiles of {TILE} B, runs of {RUN}, on at "
          f"most {blocks} persistent blocks): {count} candidates, "
          f"{rec.ms:.4f} ms a call (CUDA events), {fmt_ms(rec.device_ms)} "
          f"ms on the device (plain {rec.plain_ms:.2f}, bound "
          f"{rec.bound_ms:.4f} by {rec.bound_by}; a PyTorch int64 sum of "
          f"the same bytes {fmt_ms(sum_ms)} on the device), 50 repeat "
          f"launches bit-identical; below n = {odd}: {odd_count}; {small} B "
          f"(1 tile): {few_count}; {5 * TILE + 77} B planted at avg_bits "
          f"{', '.join(map(str, WIDE_BITS))}: "
          f"{', '.join(map(str, wide_counts))}; adversarial {size >> 20} MB "
          f"buffer ({len(planted)} planted at the first window and the run "
          f"and tile seams, a 64 KiB dense run): {full} candidates past "
          f"k = {kk}, recovered by a second launch with k = {full}, 50 "
          f"repeat launches at each k bit-identical; cuts == "
          f"chunk_stream_np; bit-exact")


def phase_kernels(dev, rec_sha1, rec_sketch, rec_gear, rec_sketch_k,
                  rec_shingle) -> tuple[bytes, list[int]]:
    rng = np.random.default_rng(SEED)
    print("phase 2: kernels vs plain twins on the card (ms = one launch "
          "over the whole segment; bound = least time for its work)")
    seg = rng.integers(0, 256, SEGMENT, dtype=np.uint8).tobytes()
    cuts = chunk_stream_np(seg)
    offsets = [0] + cuts[:-1]
    lens = [b - a for a, b in zip(offsets, cuts)]
    check_segment(dev, f"{SEGMENT >> 20} MB segment", seg, offsets, lens,
                  rec_sha1, rec_sketch, timed=True)
    edge, offsets, lens = edge_segment(rng)
    check_segment(dev, "edge segment", edge, offsets, lens, rec_sha1,
                  rec_sketch, timed=False)
    check_whole_segment_chunk(dev, rng)
    check_padded_adapters(dev, rng)
    offsets = [0] + cuts[:-1]
    check_shingles(dev, rng, seg, offsets,
                   [b - a for a, b in zip(offsets, cuts)], rec_sketch_k,
                   rec_shingle)
    check_gear_kernel(dev, seg, rec_gear)
    return seg, cuts


class Client:
    def __init__(self, path: str) -> None:
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(600)
        self.sock.connect(path)

    def call(self, cmd: int, body: bytes) -> tuple[int, bytes]:
        self.sock.sendall(protocol.pack_header(len(body), cmd))
        self.sock.sendall(body)
        h = protocol.unpack_header(self._recv(protocol.HEADER_SIZE))
        check(h.cmd == protocol.StorageCmd.RESP, f"bad response cmd {h.cmd}")
        return h.status, self._recv(h.pkg_len)

    def _recv(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            got = self.sock.recv(min(n - len(buf), 1 << 22))
            check(bool(got), "sidecar closed the connection")
            buf.extend(got)
        return bytes(buf)

    def close(self) -> None:
        self.sock.close()


def engine_us(client: Client) -> int:
    """The sidecar's cumulative time inside engine.fingerprint."""
    status, body = client.call(protocol.StorageCmd.DEDUP_COMMIT, b"stats")
    check(status == 0, f"stats: status {status}")
    return json.loads(body)["engine_us"]


def parse_fingerprint(resp: bytes) -> tuple[list[tuple[int, int]], list[bytes]]:
    n = _I64.unpack_from(resp)[0]
    check(len(resp) == 8 + 36 * n, "malformed fingerprint response")
    spans, digests = [], []
    for i in range(n):
        off = 8 + 36 * i
        spans.append((_I64.unpack_from(resp, off)[0],
                      _I64.unpack_from(resp, off + 8)[0]))
        digests.append(resp[off + 16:off + 36])
    return spans, digests


def spans_of(cuts: list[int]) -> list[tuple[int, int]]:
    return [(a, b - a) for a, b in zip([0] + cuts[:-1], cuts)]


def plain_file_signature(dev, data: np.ndarray, spans) -> np.ndarray:
    """Min over every chunk's plain-twin signature, on the card."""
    seg = torch.from_numpy(data).to(dev)
    offsets = torch.tensor([o for o, _ in spans], dtype=torch.int64, device=dev)
    lens = torch.tensor([n for _, n in spans], dtype=torch.int32, device=dev)
    sig = minhash.sketch_ragged(seg, offsets, lens, row_tile=PLAIN_ROW_TILE)
    return i64(sig).min(axis=0)


def phase_socket(dev, card: str) -> tuple[int, int, int]:
    C = protocol.StorageCmd
    rng = np.random.default_rng(SEED + 1)
    a = rng.integers(0, 256, SEGMENT, dtype=np.uint8)
    b = a.copy()
    for pos in rng.integers(0, SEGMENT - 64, 256):
        b[pos:pos + 64] = rng.integers(0, 256, 64, dtype=np.uint8)
    c = a.copy()
    d = rng.integers(0, 256, SEGMENT, dtype=np.uint8)
    files = {"A": a.tobytes(), "B": b.tobytes(), "C": c.tobytes(),
             "D": d.tobytes()}
    cuts = {k: chunk_stream_np(files[k]) for k in "ABC"}
    print(f"phase 3: corpus 4 x {SEGMENT >> 20} MB (seed {SEED + 1}); host "
          f"chunker cut A/B/C into {len(cuts['A'])}/{len(cuts['B'])}/"
          f"{len(cuts['C'])} chunks")

    sock_dir = tempfile.mkdtemp(prefix="fdfs")
    sidecar = DedupSidecar(os.path.join(sock_dir, "dedup.sock"),
                           config=DedupConfig(), device=dev)
    t0 = time.monotonic()
    sidecar.engine.warmup()
    print(f"  sidecar warmed up in {time.monotonic() - t0:.2f} s")
    ready = threading.Event()
    server = threading.Thread(target=sidecar.serve_forever,
                              kwargs={"ready_event": ready}, daemon=True)
    server.start()
    check(ready.wait(timeout=60), "sidecar did not bind")
    client = Client(sidecar.socket_path)
    try:
        wrappers = (sha1_ragged_cuda, sketch_ragged_cuda,
                    gear_candidates_cuda)
        for f in wrappers:
            f.launches = 0
        reset_plain()
        latency = {}
        engine_ms = {}
        per_request = {}
        answers = {}
        for session, name in enumerate("ABCD", start=1):
            data = files[name]
            if name == "D":
                cmd = C.DEDUP_FINGERPRINT
                body = _I64.pack(session) + _I64.pack(0) + data
            else:
                cmd = C.DEDUP_FINGERPRINT_CUTS
                body = (_I64.pack(session) + _I64.pack(0)
                        + _I64.pack(len(cuts[name]))
                        + b"".join(_I64.pack(x) for x in cuts[name]) + data)
            before = engine_us(client)
            counts = [f.launches for f in wrappers]
            t0 = time.monotonic()
            status, resp = client.call(cmd, body)
            latency[name] = time.monotonic() - t0
            engine_ms[name] = (engine_us(client) - before) / 1e3
            per_request[name] = tuple(f.launches - c
                                      for f, c in zip(wrappers, counts))
            check(status == 0, f"fingerprint {name}: status {status}")
            answers[name] = parse_fingerprint(resp)
            if name == "C":
                # Before C commits: every chunk is already in the exact
                # index, attributed to A.
                refs = sidecar.engine.exact.lookup_batch(answers["C"][1])
                check(all(r is not None and r[0] == "group1/A" for r in refs),
                      "C's chunks are not all duplicates of A")
            status, _ = client.call(C.DEDUP_COMMIT,
                                    f"commitchunks {session} group1/{name}".encode())
            check(status == 0, f"commitchunks {name}: status {status}")

        status, near = client.call(C.DEDUP_NEARDUPS, b"group1/B")
        check(status == 0, f"neardups B: status {status}")
        near_refs = [line.split()[0] for line in near.decode().splitlines()]
        check("group1/A" in near_refs, f"A not among B's near-dups: {near!r}")

        # DEDUP_VERIFY: the first 32 chunks of A, chunk 5 corrupted.
        spans, digests = answers["A"]
        payloads = [files["A"][off:off + ln] for off, ln in spans[:32]]
        payloads[5] = bytes([payloads[5][0] ^ 0xFF]) + payloads[5][1:]
        body = _I64.pack(32) + b"".join(
            _I64.pack(len(p)) + dg for p, dg in zip(payloads, digests[:32]))
        counts = [f.launches for f in wrappers]
        status, mask = client.call(C.DEDUP_VERIFY, body + b"".join(payloads))
        check(status == 0 and mask == bytes(5) + b"\x01" + bytes(26),
              f"verify flagged {mask!r} (status {status})")
        per_request["verify"] = tuple(f.launches - c
                                      for f, c in zip(wrappers, counts))
        launches = tuple(f.launches for f in wrappers)
        check_no_plain("the socket phase")
    finally:
        client.close()
        sidecar.stop()
        server.join(timeout=60)
        shutil.rmtree(sock_dir, ignore_errors=True)
    check(not server.is_alive(), "sidecar thread did not stop")

    # Every digest equals hashlib; spans are the cuts asked for (A/B/C)
    # or the host chunker's (D, chunked on the card).
    for name in "ABCD":
        spans, digests = answers[name]
        want = spans_of(cuts[name] if name != "D"
                        else chunk_stream_np(files["D"]))
        check(spans == want, f"{name}: spans differ from the chunker's")
        data = files[name]
        for (off, ln), dg in zip(spans, digests):
            check(dg == hashlib.sha1(data[off:off + ln]).digest(),
                  f"{name}: digest at {off} != hashlib")
    check(answers["C"][1] == answers["A"][1], "C's digests differ from A's")

    # The committed file signatures equal the plain twins' on the card.
    arrays = {"A": a, "D": d}
    for name in "AD":
        got = sidecar.engine.near.signature_of(f"group1/{name}")
        check(got is not None, f"{name} has no signature")
        want = plain_file_signature(dev, arrays[name], answers[name][0])
        check(np.array_equal(got.astype(np.int64), want),
              f"{name}: file signature != plain twins'")
    print("  digests == hashlib for all 4 files; C all duplicates of A; A "
          "among B's near-dups; verify flagged exactly chunk 5; file "
          "signatures == plain twins")

    cut_mb = SEGMENT / 1e9
    rate = 3 * cut_mb / sum(latency[k] for k in "ABC")
    print(f"  DEDUP_FINGERPRINT_CUTS (125) per {SEGMENT >> 20} MB request "
          "(of which in the engine): "
          + ", ".join(f"{k} {latency[k] * 1e3:.1f} ms ({engine_ms[k]:.1f})"
                      for k in "ABC")
          + f"; fingerprint rate {rate:.3f} GB/s  [{card}]")
    print(f"  DEDUP_FINGERPRINT (120, chunked on the card) {SEGMENT >> 20} MB: "
          f"{latency['D'] * 1e3:.1f} ms (engine {engine_ms['D']:.1f}), "
          f"{cut_mb / latency['D']:.3f} GB/s  "
          f"[{card}]")
    print(f"  kernel launches during the socket phase: sha1 {launches[0]}, "
          f"sketch {launches[1]}, gear {launches[2]}; per request "
          "(sha1/sketch/gear): "
          + ", ".join(f"{k} {v[0]}/{v[1]}/{v[2]}"
                      for k, v in per_request.items())
          + "; no plain twin on the card")
    for name in "ABCD":
        want = (1, 1, 1 if name == "D" else 0)
        check(per_request[name] == want,
              f"{name}: {per_request[name]} launches, not {want}")
    check(per_request["verify"] == (1, 0, 0), "verify: not one sha1 launch")
    return launches


def phase_profile(dev) -> None:
    """Where one 64 MB 125 segment's engine time goes: a torch.profiler
    pass over DedupEngine.fingerprint (after the counters were read, so
    these launches are not counted), device time summed by kernel."""
    from fastdfs_tpu_torch.dedup.engine import DedupEngine

    rng = np.random.default_rng(SEED + 2)
    data = rng.integers(0, 256, SEGMENT, dtype=np.uint8).tobytes()
    cuts = chunk_stream_np(data)
    engine = DedupEngine(DedupConfig(), device=dev)
    engine.fingerprint(data, cuts=cuts)              # staging allocated
    wall_ms, kernels = device_profile(
        lambda: engine.fingerprint(data, cuts=cuts),
        (("sha1_ragged_kernel", 1), ("sketch_ragged_kernel", 1)))
    groups = {"sha1 kernel": 0.0, "sketch kernel": 0.0, "copies": 0.0,
              "other device ops": 0.0}
    for key, (us, _) in kernels.items():
        if "sha1_ragged_kernel" in key:
            groups["sha1 kernel"] += us
        elif "sketch_ragged_kernel" in key:
            groups["sketch kernel"] += us
        elif is_copy(key):
            groups["copies"] += us
        else:
            groups["other device ops"] += us
    busy_ms = sum(groups.values()) / 1e3
    print(f"phase 4: engine.fingerprint on one {SEGMENT >> 20} MB segment "
          f"with cuts, under torch.profiler: wall {wall_ms:.1f} ms")
    if not kernels:
        print(f"  device time: not measured (the profiler missed the "
              f"kernels in {PROFILE_TRIES} tries)")
        return
    for name, us in groups.items():
        print(f"  device {name}: {us / 1e3:.3f} ms")
    print(f"  device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} of the call's wall time")


def check_engine_shingle(dev, card: str) -> dict[str, int]:
    """The engine at ``DedupConfig(shingle=4)`` on a seeded 64 MB segment
    with cuts, a counted main-path run: one launch of the SHA-1 kernel
    and one of the general-width sketch kernel (stage 4 fused), and no
    plain twin; digests equal hashlib and signatures the plain twins'.
    Returns the run's launches by wrapper."""
    rng = np.random.default_rng(SEED + 12)
    data = rng.integers(0, 256, SEGMENT, dtype=np.uint8).tobytes()
    cuts = chunk_stream_np(data)
    engine = DedupEngine(DedupConfig(shingle=4), device=dev)
    (spans, digests, sigs), launches = counted(
        lambda: engine.fingerprint(data, cuts=cuts))
    want = {"sha1_ragged_cuda": 1, "sketch_ragged_cuda": 1}
    check(launches == want, f"engine at shingle 4 launched {launches}")
    check(spans == spans_of(cuts), "engine at shingle 4: spans != cuts")
    raw = sha1.digest_bytes(digests)
    for i, (o, n) in enumerate(spans):
        check(raw[i * 20:(i + 1) * 20] == hashlib.sha1(data[o:o + n]).digest(),
              f"engine at shingle 4: digest {i} != hashlib")
    seg = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    offsets = torch.tensor([o for o, _ in spans], dtype=torch.int64,
                           device=dev)
    lens = torch.tensor([n for _, n in spans], dtype=torch.int32, device=dev)
    plain = minhash.sketch_ragged(seg, offsets, lens, 64, 4,
                                  row_tile=PLAIN_ROW_TILE)
    check(np.array_equal(sigs.astype(np.int64), i64(plain)),
          "engine at shingle 4: signatures != plain twins'")
    times = []
    for _ in range(3):
        t0 = time.monotonic()
        engine.fingerprint(data, cuts=cuts)
        times.append((time.monotonic() - t0) * 1e3)
    print(f"  engine at shingle 4 on one {SEGMENT >> 20} MB segment with "
          f"cuts ({len(spans)} chunks): launches {launches}, no plain twin; "
          f"digests == hashlib, signatures == plain twins; wall "
          f"{statistics.median(times):.1f} ms (median of 3)  [{card}]")
    return launches


def is_copy(key: str) -> bool:
    return "Memcpy" in key or "Memset" in key


def fingerprint_pairs(data: bytes, cuts: list[int]) -> list[tuple[int, bytes]]:
    """(length, raw SHA-1) of each chunk, by hashlib."""
    return [(b - a, hashlib.sha1(data[a:b]).digest())
            for a, b in zip([0] + cuts[:-1], cuts)]


def phase_client(dev, card: str) -> tuple[int, int]:
    """The client's upload fingerprint on the card; returns the SHA-1 and
    gear launches of its main-path calls."""
    # Corpus file A of phase 3 (the first draw of its generator), and a
    # second payload of the same 2^26 bytes: seeded random bytes with a
    # 1 MB run of one repeated 4 KiB block every 8 MB, so chunks cut at
    # max_size and repeated digests occur.
    a = np.random.default_rng(SEED + 1).integers(0, 256, SEGMENT,
                                                 dtype=np.uint8).tobytes()
    rng = np.random.default_rng(SEED + 3)
    r = rng.integers(0, 256, SEGMENT, dtype=np.uint8)
    run = np.resize(rng.integers(0, 256, 4096, dtype=np.uint8), SEGMENT // 64)
    for start in range(0, SEGMENT, SEGMENT // 8):
        r[start:start + len(run)] = run
    payloads = {"A": a, "R": r.tobytes()}
    print(f"phase 5: client fingerprint_buffer on the card, two payloads "
          f"of exactly 2^{SEGMENT.bit_length() - 1} bytes (no slack of the "
          f"CDC buffer's own)")
    wrappers = (sha1_ragged_cuda, gear_candidates_cuda)
    for f in wrappers:
        f.launches = 0
    reset_plain()
    got = {}
    for name, data in payloads.items():
        before = [f.launches for f in wrappers]
        got[name] = fingerprint_buffer(data, device=dev)
        check([f.launches - b for f, b in zip(wrappers, before)] == [1, 1],
              f"{name}: fingerprint_buffer did not launch SHA-1 and the "
              "gear kernel once each")
    walls = []
    for _ in range(5):
        before = [f.launches for f in wrappers]
        t0 = time.monotonic()
        fps = fingerprint_buffer(payloads["A"], device=dev)
        walls.append((time.monotonic() - t0) * 1e3)
        check([f.launches - b for f, b in zip(wrappers, before)] == [1, 1],
              "A: fingerprint_buffer did not launch SHA-1 and the gear "
              "kernel once each")
        check(fps == got["A"], "A: fingerprints differ between calls")
    launches = tuple(f.launches for f in wrappers)
    check_no_plain("the client's fingerprint")

    for name, data in payloads.items():
        cuts = chunk_stream_np(data)
        want = fingerprint_pairs(data, cuts)
        check([(f.length, f.digest) for f in got[name]] == want,
              f"{name}: fingerprint_buffer != chunk_stream_np + hashlib")
        print(f"  {name}: {len(cuts)} chunks, "
              f"{len(set(d for _, d in want))} distinct digests, longest "
              f"{max(n for n, _ in want)} B; == chunk_stream_np + hashlib, "
              f"one SHA-1 and one gear launch per call, no plain twin on "
              f"the card")

    # The SHA-1 kernel alone on A's chunk table, and the device CDC pass
    # alone on A's staged buffer, the gear kernel beside its plain twin
    # (CUDA-event medians, and the gear kernel's device time; not
    # counted).
    data = payloads["A"]
    cuts = chunk_stream_np(data)
    offsets = [0] + cuts[:-1]
    lens = [b - o for o, b in zip(offsets, cuts)]
    d_seg, d_off, d_len, d_ord = on_card(dev, data, offsets, lens)
    sha1_ms = median_ms(lambda: sha1_ragged_cuda(d_seg, d_off, d_len, d_ord))
    host, staged = upload_padded(data, dev, slack=SEGMENT_SLACK)
    check(device_cuts(host, staged, len(data)) == cuts,
          "device CDC != chunk_stream_np on A")
    bits = DedupConfig().avg_bits
    k = max(SEGMENT >> (bits - 2), 256)              # chunk_stream's k
    cdc_ms = median_ms(lambda: gear_candidates_cuda(staged[:SEGMENT],
                                                    SEGMENT, bits, k))
    cdc_device_ms = device_ms(lambda: gear_candidates_cuda(staged[:SEGMENT],
                                                           SEGMENT, bits, k),
                              "gear_compact_kernel")
    plain_ms = median_ms(lambda: gear_candidates(staged[:SEGMENT], SEGMENT,
                                                 bits, k), 3)
    cdc_bound_ms, cdc_by = cdc_bound(SEGMENT, k)
    wall_ms, kernels = device_profile(
        lambda: fingerprint_buffer(data, device=dev),
        (("sha1_ragged_kernel", 1), ("gear_", 1)))
    cdc = [(us, c) for key, (us, c) in kernels.items() if "gear_" in key]
    other = [(us, c) for key, (us, c) in kernels.items()
             if "sha1_ragged_kernel" not in key and "gear_" not in key
             and not is_copy(key)]
    cdc_launches = sum(c for _, c in cdc)
    check(not kernels or cdc_launches == 1, f"{cdc_launches} gear device "
          "kernels in one fingerprint_buffer call, not 1")
    busy = {"sha1 kernel": sum(us for key, (us, _) in kernels.items()
                               if "sha1_ragged_kernel" in key),
            "gear kernel": sum(us for us, _ in cdc),
            "other ops": sum(us for us, _ in other),
            "copies": sum(us for key, (us, _) in kernels.items()
                          if is_copy(key))}
    wall = statistics.median(walls)
    print(f"  fingerprint_buffer(A) wall, median of 5: {wall:.1f} ms "
          f"(all: {', '.join(f'{w:.1f}' for w in walls)}); SHA-1 kernel "
          f"{sha1_ms:.4f} ms, {sha1_ms / wall:.4f} of it  [{card}]")
    kernels_seen = (f"{cdc_launches} gear device kernel, one pass, after "
                    f"a memset of its span counter and status words; "
                    f"{sum(c for _, c in other)} other device kernels "
                    f"besides SHA-1 and copies" if kernels else
                    "device kernels not measured: the profiler missed them "
                    f"in {PROFILE_TRIES} tries")
    print(f"  device CDC on A: gear kernel {cdc_ms:.4f} ms a call (CUDA "
          f"events), {fmt_ms(cdc_device_ms)} ms on the device, its plain "
          f"twin (the eager pass before) {plain_ms:.4f} ms; one gear launch "
          f"per fingerprint_buffer call ({kernels_seen}); bound "
          f"{cdc_bound_ms:.4f} ms by {cdc_by}  [{card}]")
    busy_ms = sum(busy.values()) / 1e3
    if kernels:
        print(f"  one call under torch.profiler: wall {wall_ms:.1f} ms; "
              "device " + ", ".join(f"{name} {us / 1e3:.3f} ms"
                                    for name, us in busy.items())
              + f"; busy {busy_ms:.3f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
    # The same padded payload copied from pageable memory, as the client
    # staged it before it kept a pinned buffer.
    pageable = np.array(host, copy=True)
    _, copies = device_profile(lambda: torch.from_numpy(pageable).to(dev))
    pageable_ms = sum(us for key, (us, _) in copies.items()
                      if is_copy(key)) / 1e3
    print(f"  device copy time of the {len(host)}-byte staged payload: "
          f"from the pinned staging {busy['copies'] / 1e3:.3f} ms (all copies "
          f"of the profiled call); from pageable memory, as before, "
          f"{pageable_ms:.3f} ms  [{card}]")
    return launches


def phase_streaming(dev, card: str, seg: bytes, cuts: list[int]) -> int:
    """Phase 2's segment through ``stream_batches``; returns the SHA-1
    launches of the streamed runs."""
    rows, width = 256, 65536
    offsets = [0] + cuts[:-1]
    n = len(cuts)
    nb = -(-n // rows)
    host = np.zeros((nb, rows, width), dtype=np.uint8)
    lens = np.zeros((nb, rows), dtype=np.int32)
    buf = np.frombuffer(seg, dtype=np.uint8)
    for i, (o, e) in enumerate(zip(offsets, cuts)):
        host[i // rows, i % rows, :e - o] = buf[o:e]
        lens[i // rows, i % rows] = e - o
    batches = [(host[b], lens[b]) for b in range(nb)]
    print(f"phase 6: stream_batches over phase 2's segment: {n} chunks in "
          f"{nb} padded ({rows}, {width}) batches through sha1_batch_cuda")
    direct = [sha1_batch_cuda(torch.from_numpy(x).to(dev),
                              torch.from_numpy(ln).to(dev)).cpu().numpy()
              for x, ln in batches]
    raw = sha1.digest_bytes(np.concatenate(direct)[:n])
    check(all(raw[i * 20:(i + 1) * 20] == hashlib.sha1(seg[o:e]).digest()
              for i, (o, e) in enumerate(zip(offsets, cuts))),
          "direct sha1_batch_cuda != hashlib")
    sha1_batch_cuda.launches = 0
    reset_plain()
    times = []
    for depth in (1, 2, 2, 1):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = list(stream_batches(iter(batches), sha1_batch_cuda,
                                  depth=depth, device=dev))
        times.append((depth, (time.monotonic() - t0) * 1e3))
        check(len(out) == nb and all(np.array_equal(o, d)
                                     for o, d in zip(out, direct)),
              f"stream_batches at depth {depth} != direct calls")
    launches = sha1_batch_cuda.launches
    check(launches == 4 * nb, f"{launches} SHA-1 launches, not {4 * nb}")
    check_no_plain("streaming")
    print(f"  in order and == direct calls == hashlib; wall ms (depth): "
          + ", ".join(f"{t:.1f} ({d})" for d, t in times)
          + f"; {host.nbytes >> 20} MB of padded batches each  [{card}]")
    return launches


GF_EDGE_LENGTHS = (0, 1, 3, 17, 4097)


def check_gf(rec, mat: np.ndarray, shards: torch.Tensor, what: str
             ) -> None:
    """The GF kernel against its plain twin on the same inputs, bit for
    bit."""
    got = gf_matmul_cuda(mat, shards)
    want = rs_code.gf_matmul_torch(mat, shards)
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) \
        if got.numel() else 0
    rec.max_abs_err = max(rec.max_abs_err, err)
    check(err == 0 and got.shape == want.shape,
          f"GF kernel != plain twin on {what}")


def check_gf_edges(dev, rng, rec) -> None:
    """The GF kernel at shard lengths 0, 1, 3, 17 and 4097, on a
    non-contiguous survivor view and on columns off a 4-byte boundary,
    with a matrix that holds every byte value (0 and 1 included), rows
    past 32 and rows and k at the field's 255."""
    every = (np.arange(40 * 7) % 256).astype(np.uint8).reshape(40, 7)
    for length in GF_EDGE_LENGTHS:
        for rows, k in ((2, 4), (8, 32), (32, 32), (40, 7)):
            mat = (every if (rows, k) == (40, 7) else
                   rng.integers(0, 256, (rows, k), dtype=np.uint8))
            shards = torch.from_numpy(rng.integers(
                0, 256, (k, length), dtype=np.uint8)).to(dev)
            check_gf(rec, mat, shards, f"({rows} x {k}) x {length} B")
    d = torch.from_numpy(rng.integers(0, 256, (20, 4099),
                                      dtype=np.uint8)).to(dev)
    pm = rs_code.parity_matrix(10, 4)
    for view, what in ((d[::2], "every other row"),
                       (d[4:14, 3:4000], "rows 4-13 from column 3")):
        check_gf(rec, pm, view, what)
    for rows, k in ((255, 1), (1, 255), (64, 4)):
        mat = (np.arange(rows * k) % 256).astype(np.uint8).reshape(rows, k)
        shards = torch.from_numpy(rng.integers(0, 256, (k, 1031),
                                               dtype=np.uint8)).to(dev)
        check_gf(rec, mat, shards, f"({rows} x {k}), every byte value")


def phase_rs(dev, card: str, rec) -> int:
    """Phase 7; returns the GF kernel's launches in its main-path runs
    (encode, then rebuild from the last k shards, through ``rs_code``,
    each geometry counted from 0 just before it)."""
    rng = np.random.default_rng(SEED + 4)
    stripe = rng.integers(0, 256, SEGMENT, dtype=np.uint8).tobytes()
    print(f"phase 7: Reed-Solomon on the card, a seeded {SEGMENT >> 20} MB "
          f"stripe, on the GF kernel (ms: CUDA-event median of 10 calls of "
          f"rs_encode or rs_reconstruct; plain twin: median of 3 calls of "
          f"gf_matmul_torch on the same product)")
    launches = 0
    for k, m in ((4, 2), (10, 4), (32, 8)):
        shards = rs_code.split_stripe(stripe, k)
        length = shards.shape[1]
        d = torch.from_numpy(shards).to(dev)
        present = list(range(m, k + m))                  # first m lost

        def encode_and_rebuild():
            parity = rs_code.rs_encode(d, m)
            survivors = torch.cat([d[m:], parity])
            return parity, survivors, rs_code.rs_reconstruct(
                survivors, present, k, m)

        (parity, survivors, back), n = counted(encode_and_rebuild)
        check(n == {"gf_matmul_cuda": 2},
              f"RS({k},{m}) encode and rebuild launched {n}")
        launches += n["gf_matmul_cuda"]
        check(parity.device == d.device, "parity left the card")
        pm = rs_code.parity_matrix(k, m)
        dm = rs_code.decode_matrix(k, m, present)
        check(np.array_equal(parity.cpu().numpy(),
                             rs_code.gf_matmul_np(pm, shards)),
              f"RS({k},{m}) parity != gf_matmul_np")
        check(torch.equal(back, d), f"RS({k},{m}) rebuild != data")
        check_gf(rec, pm, d, f"RS({k},{m}) encode")
        check_gf(rec, dm, survivors, f"RS({k},{m}) rebuild")
        enc_ms = median_ms(lambda: rs_code.rs_encode(d, m), 10)
        enc_dev = device_ms(lambda: gf_matmul_cuda(pm, d), "gf_matmul_kernel")
        dec_ms = median_ms(lambda: rs_code.rs_reconstruct(
            survivors, present, k, m), n=10)
        enc_plain = median_ms(lambda: rs_code.gf_matmul_torch(pm, d), 3)
        dec_plain = median_ms(
            lambda: rs_code.gf_matmul_torch(dm, survivors), 3)
        _, kernels = device_profile(lambda: rs_code.rs_encode(d, m),
                                    (("gf_matmul_kernel", 1),))
        kernel_n = sum(c for key, (_, c) in kernels.items()
                       if not is_copy(key))
        enc_bound, enc_by = gf_bound(m, k, length)
        dec_bound, dec_by = gf_bound(k, k, length)
        print(f"  RS({k},{m}), shards of {length} B: parity == gf_matmul_np "
              f"and the plain twin, rebuilt from the last {k} shards == "
              f"data; one GF launch each; encode {enc_ms:.4f} ms "
              f"({kernel_n if kernels else 'not measured'} device kernels "
              f"a call; its product {fmt_ms(enc_dev)} ms on the device; "
              f"bound {enc_bound:.4f} by {enc_by}; plain twin "
              f"{enc_plain:.4f}), rebuild {dec_ms:.4f} ms (bound "
              f"{dec_bound:.4f} by {dec_by}; plain twin {dec_plain:.4f})  "
              f"[{card}]")
        if (k, m) == (32, 8):
            # The record times the kernel's wrapper on the rebuild's
            # product; rs_reconstruct also inverts the surviving rows on
            # the host (Gauss-Jordan, decode_matrix).
            def fn():
                return gf_matmul_cuda(dm, survivors)
            rec.ms, rec.plain_ms = median_ms(fn, 10), dec_plain
            rec.bound_ms, rec.bound_by = dec_bound, dec_by
            rec.device_ms = device_ms(fn, "gf_matmul_kernel")
            t0 = time.monotonic()
            for _ in range(10):
                rs_code.decode_matrix(k, m, present)
            inv_ms = (time.monotonic() - t0) * 1e2
            print(f"  RS(32,8) rebuild's product on the GF kernel: "
                  f"{rec.ms:.4f} ms a call (CUDA events), "
                  f"{fmt_ms(rec.device_ms)} ms on the device; the host's "
                  f"decode_matrix in rs_reconstruct {inv_ms:.3f} ms "
                  f"(host clock, mean of 10)  [{card}]")
    check_gf_edges(dev, rng, rec)
    print(f"  GF kernel == plain twin at lengths "
          f"{', '.join(map(str, GF_EDGE_LENGTHS))}, on row and column "
          f"views, rows past 32 and on a matrix of every byte value")
    return launches


# Every kernel wrapper's launch counter, and which kernel each launches.
SHA1_WRAPPERS = (sha1_ragged_cuda, sha1_batch_cuda)
SKETCH_WRAPPERS = (sketch_ragged_cuda, survivor_ragged_cuda,
                   survivor_segmin_cuda, minhash_batch_cuda)
WRAPPERS = SHA1_WRAPPERS + SKETCH_WRAPPERS + (
    gear_candidates_cuda, block_candidates_cuda, index_best_cuda,
    gf_matmul_cuda, signature_tiles_cuda)


def counted(fn):
    """``(fn(), launches)``: every counter set to 0 just before the call
    and read just after it, as ``{wrapper name: launches}``; the call
    must run no plain twin on the card."""
    for f in WRAPPERS:
        f.launches = 0
    reset_plain()
    out = fn()
    torch.cuda.synchronize()
    check_no_plain("a counted main-path run")
    return out, {f.__name__: f.launches for f in WRAPPERS if f.launches}


def padded_rows(stream: np.ndarray, cuts: list[int], dp: int):
    """Each chunk of ``stream`` in its own zero-padded ``ROW``-byte row,
    and zero-length rows up to a multiple of ``dp``."""
    n = len(cuts) + (-len(cuts)) % dp
    rows = np.zeros((n, ROW), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, (o, e) in enumerate(zip([0] + cuts[:-1], cuts)):
        rows[i, :e - o] = stream[o:e]
        lens[i] = e - o
    return rows, lens


def plain_signatures(dev, stream: torch.Tensor, cuts: list[int]) -> np.ndarray:
    """The plain twin's signatures of a stream's chunks, on the card."""
    ends = torch.tensor(cuts, dtype=torch.int64, device=dev)
    lens = torch.diff(ends, prepend=ends.new_zeros(1))
    sig = minhash.sketch_ragged(stream, ends - lens, lens.to(torch.int32),
                                row_tile=PLAIN_ROW_TILE)
    return sig.view(torch.int32).cpu().numpy().view(np.uint32)


def check_ingest_step(dev, card: str, total: dict, rec_block, rec_index,
                      rec_sig) -> None:
    """The ingest step over a (2, 2, 2) mesh of virtual ranks and over one
    rank, at full width: two 64 MB streams, one stream's chunks as padded
    rows, a 65,536-row index."""
    rng = np.random.default_rng(SEED + 5)
    bits = DedupConfig().avg_bits
    mesh8 = make_mesh(RANKS, devices=[dev] * RANKS)
    mesh1 = make_mesh(1, devices=[dev])
    dp, sp = mesh8.shape["dp"], mesh8.shape["sp"]
    streams = rng.integers(0, 256, (2, SEGMENT), dtype=np.uint8)
    # Candidates where the window straddles a block seam or one of the
    # gear kernel's thread-run and tile seams, and within the first
    # window of each stream (zero halo values, not zero bytes).
    seam = SEGMENT // sp
    planted = [5, 30, RUN - 1, RUN + 1, TILE - 3, TILE + 1, seam - TILE + 1,
               seam + 1, seam + 5, seam + 30, seam + RUN + 1, seam + TILE - 1]
    for stream in streams:
        for p in planted:
            plant_candidate(stream, p, bits)
    cuts = [chunk_stream_np(stream) for stream in streams]
    rows, lens = padded_rows(streams[0], cuts[0], dp)
    n_real, n = len(cuts[0]), len(lens)

    d_streams = torch.from_numpy(streams).to(dev)
    sigs0 = plain_signatures(dev, d_streams[0], cuts[0])
    chosen = rng.choice(n_real, INDEXED, replace=False)
    index = np.concatenate([
        sigs0[chosen], plain_signatures(dev, d_streams[1], cuts[1]),
        rng.integers(0, 2**32, (INDEX_ROWS - INDEXED - len(cuts[1]), 64),
                     dtype=np.uint32)])
    index = index[rng.permutation(INDEX_ROWS)]
    d_rows = torch.from_numpy(rows).to(dev)
    d_lens = torch.from_numpy(lens).to(dev)
    d_index = torch.from_numpy(index.view(np.int32)).to(dev)
    print(f"  ingest step inputs: 2 seeded streams of {SEGMENT >> 20} MB "
          f"(candidates planted at {planted}); {n_real} chunks of stream 0 "
          f"in {n} rows of {ROW} B; an index of {INDEX_ROWS} signatures "
          f"({INDEXED} of stream 0's chunks, {len(cuts[1])} of stream 1's)")

    step8, step1 = make_ingest_step(mesh8), make_ingest_step(mesh1)
    in8 = (d_streams.view(2, sp, seam), d_rows, d_lens, d_index)
    in1 = (d_streams.view(2, 1, SEGMENT), d_rows, d_lens, d_index)
    ranks, n8 = counted(lambda: step8.per_rank(*in8))
    (cand1, dig1, sig1, best1), n1 = counted(lambda: step1(*in1))
    for launches in (n8, n1):
        for name, k in launches.items():
            total[name] = total.get(name, 0) + k
    check(n8 == {"sha1_batch_cuda": RANKS, "survivor_segmin_cuda": RANKS,
                 "signature_tiles_cuda": RANKS,
                 "block_candidates_cuda": RANKS, "index_best_cuda": RANKS},
          f"8-rank step launched {n8}")
    check(n1 == {"sha1_batch_cuda": 1, "minhash_batch_cuda": 1,
                 "block_candidates_cuda": 1, "index_best_cuda": 1},
          f"1-rank step launched {n1}")
    for r, out in enumerate(ranks):
        for name, a, b in zip(("digests", "sigs", "best"), out[1:],
                              ranks[0][1:]):
            check(torch.equal(a, b), f"rank {r}'s {name} != rank 0's")
    cand8, dig8, sig8, best8 = step8.assemble(ranks)

    for b in range(2):
        want = candidate_mask(widen(gear_hashes(d_streams[b])), bits)
        check(bool(want[planted].all()), f"stream {b}: a planted position "
              "is not a candidate")
        for got, what in ((cand8, "8-rank"), (cand1, "1-rank")):
            check(torch.equal(got[b].reshape(-1), want),
                  f"stream {b}: {what} candidates != the whole stream's")
    raw = sha1.digest_bytes(dig8)
    spans = list(zip([0] + cuts[0][:-1], cuts[0])) + [(0, 0)] * (n - n_real)
    for i, (o, e) in enumerate(spans):
        check(raw[i * 20:(i + 1) * 20] == hashlib.sha1(
            streams[0][o:e].tobytes()).digest(), f"row {i}: digest != hashlib")
    check(np.array_equal(i64(dig1), i64(dig8)),
          "1-rank digests != 8-rank digests")
    offsets = [0] + cuts[0][:-1]
    d_seg, d_off, d_len, d_ord = on_card(dev, streams[0].tobytes(), offsets,
                                         np.diff(cuts[0], prepend=0))
    ragged = sketch_ragged_cuda(d_seg, d_off, d_len, None, d_ord)
    check(np.array_equal(i64(sig8)[:n_real], i64(ragged)),
          "8-rank signatures != the ragged sketch kernel's")
    check(np.array_equal(i64(sig1), i64(sig8)),
          "1-rank signatures != 8-rank signatures")
    best = best8.cpu().numpy()
    check(bool((best[chosen] == 1.0).all()), "an indexed chunk scored below 1")
    check(torch.equal(best1, best8), "1-rank best != 8-rank best")
    sample = rng.choice(n, min(n, 256), replace=False)
    q = i64(sig8)[sample]
    idx = index.astype(np.int64)
    dense = np.concatenate([
        (q[j:j + 16, None, :] == idx[None]).mean(axis=2, dtype=np.float32)
        .max(axis=1) for j in range(0, len(q), 16)])
    check(np.array_equal(dense, best[sample]),
          "best != NumPy's dense score on 256 sampled rows")
    print(f"  8-rank (2, 2, 2) and 1-rank steps: candidates == the whole "
          f"streams' (seams and planted positions included), digests == "
          f"hashlib, signatures == the ragged kernel, best == 1.0 on the "
          f"{INDEXED} indexed chunks and == NumPy on 256 rows; every rank's "
          f"replicated outputs equal; launches {n8} and {n1} (every rank "
          f"runs the body: each row is hashed sp x tp = "
          f"{sp * mesh8.shape['tp']} times on the 8-rank mesh)")

    # The same steps at shingle 4, on the general-width kernel: the
    # 1-rank step holds all 64 permutations and takes its fused form; the
    # 8-rank step's tp = 2 ranks take its z form, then stage 4 on their
    # slices of the permutations.
    step48 = make_ingest_step(mesh8, shingle=4)
    step41 = make_ingest_step(mesh1, shingle=4)
    (_, dig48, sig48, _), n48 = counted(lambda: step48(*in8))
    (_, _, sig41, _), n41 = counted(lambda: step41(*in1))
    general = {"survivor_segmin_cuda": "survivor_k",
               "minhash_batch_cuda": "sketch_k"}
    for launches in (n48, n41):
        for name, k in launches.items():
            key = general.get(name, name)
            total[key] = total.get(key, 0) + k
    check(n48 == {"sha1_batch_cuda": RANKS, "survivor_segmin_cuda": RANKS,
                  "signature_tiles_cuda": RANKS,
                  "block_candidates_cuda": RANKS, "index_best_cuda": RANKS},
          f"8-rank step at shingle 4 launched {n48}")
    check(n41 == {"sha1_batch_cuda": 1, "minhash_batch_cuda": 1,
                  "block_candidates_cuda": 1, "index_best_cuda": 1},
          f"1-rank step at shingle 4 launched {n41}")
    plain4 = minhash.sketch_ragged(d_seg, d_off, d_len, 64, 4,
                                   row_tile=PLAIN_ROW_TILE)
    check(np.array_equal(i64(sig48)[:n_real], i64(plain4))
          and np.array_equal(i64(sig41), i64(sig48))
          and np.array_equal(i64(dig48), i64(dig8)),
          "the steps at shingle 4 != the plain twins")
    ms48 = median_ms(lambda: step48(*in8), 3)
    print(f"  8-rank and 1-rank steps at shingle 4: launches {n48} and "
          f"{n41}, no plain twin; signatures == the plain twins at k = 4; "
          f"8 ranks {ms48:.2f} ms (CUDA-event median of 3)  [{card}]")

    check_block_kernel(d_streams, sp, bits, rec_block)
    check_index_kernel(dev, rng, sig8.view(torch.int32), d_index, rec_index)
    check_sig_kernel(dev, rng, d_rows[:n // dp], d_lens[:n // dp],
                     mesh8.shape["tp"], rec_sig)
    ms8 = median_ms(lambda: step8(*in8), 3)
    ms1 = median_ms(lambda: step1(*in1), 3)
    # The 8-rank step with stage 4 on its plain twin, as it ran before
    # the stage-4 kernel: the same call, the same inputs.
    kernel = ingest_step_mod.signature_tiles_cuda
    ingest_step_mod.signature_tiles_cuda = lambda z, words: \
        minhash.signature_tiles(z, words.shape[1],
                                minhash.perms_from_words(words))
    try:
        ms8_plain = median_ms(lambda: step8(*in8), 3)
    finally:
        ingest_step_mod.signature_tiles_cuda = kernel
    print(f"  ingest step, CUDA-event median of 3: 8 ranks on one card "
          f"{ms8:.2f} ms ({ms8_plain:.2f} with stage 4 on its plain twin), "
          f"1 rank {ms1:.2f} ms  [{card}]")
    print(f"  stage-1 CDC of 2 x {SEGMENT >> 20} MB: gear kernel (dense) "
          f"{rec_block.ms:.4f} ms a call (CUDA events), "
          f"{fmt_ms(rec_block.device_ms)} ms on the device, its plain twin "
          f"(the eager pass before) {rec_block.plain_ms:.3f} ms, bound "
          f"{rec_block.bound_ms:.4f} ms "
          f"by {rec_block.bound_by}; index query ({n} x {INDEX_ROWS} x 64): "
          f"index kernel {rec_index.ms:.3f} ms a call (CUDA events), "
          f"{fmt_ms(rec_index.device_ms)} ms on the device, its plain twin "
          f"{rec_index.plain_ms:.3f} ms, bound {rec_index.bound_ms:.3f} ms "
          f"by {rec_index.bound_by}  [{card}]")


def check_block_kernel(d_streams: torch.Tensor, sp: int, bits: int,
                       rec) -> None:
    """The gear kernel's dense form on the two streams as the 8-rank step
    splits them (each block after the gear values of its predecessor's
    last 31 bytes, the first after zeros), on rows of 3 tiles and 5
    bytes, and on rows planted at avg_bits 17, 18 and 32, against its
    plain twin, bit for bit; timed on the whole streams."""
    blocks = d_streams.view(2, sp, -1)
    zeros = torch.zeros((2, HALO), dtype=torch.int64, device=d_streams.device)
    for s in range(sp):
        rows = blocks[:, s, :]
        halo = gear_values(blocks[:, s - 1, -HALO:]) if s else zeros
        got = block_candidates_cuda(rows, halo, bits)
        want = block_candidates(gear_values(rows), halo, bits)
        err = int((got != want).sum())
        rec.max_abs_err = max(rec.max_abs_err, min(err, 1))
        check(err == 0, f"dense gear kernel != plain twin on block {s}")
    # Rows of 3 tiles and 5 bytes (fewer tiles than blocks; the second
    # row's mask starts off a 16-byte boundary), read from a 16-byte
    # boundary and from off one.
    length = 3 * TILE + 5
    for start in (32, 41):
        rows = d_streams[:, start:start + length]
        halo = gear_values(d_streams[:, start - HALO:start])
        got = block_candidates_cuda(rows, halo, bits)
        err = int((got != block_candidates(gear_values(rows), halo,
                                           bits)).sum())
        rec.max_abs_err = max(rec.max_abs_err, min(err, 1))
        check(err == 0, f"dense gear kernel != plain twin on rows of "
              f"{length} B from byte {start}")
    # Rows of one stream planted at wide avg_bits, the second after the
    # first's last 31 gear values: the whole stream's candidates.
    rng = np.random.default_rng(SEED + 11)
    length = 2 * TILE + 16
    for wide in WIDE_BITS:
        data = wide_buffer(rng, 2 * length, wide)
        rows = torch.from_numpy(data).to(d_streams.device).view(2, length)
        halo = torch.cat([zeros[:1], gear_values(rows[:1, -HALO:])])
        got = block_candidates_cuda(rows, halo, wide)
        err = int((got != block_candidates(gear_values(rows), halo,
                                           wide)).sum())
        rec.max_abs_err = max(rec.max_abs_err, min(err, 1))
        check(err == 0 and np.array_equal(
                  np.flatnonzero(got.reshape(-1).cpu().numpy()),
                  gear_candidates_np(data, wide)),
              f"dense gear kernel != plain twin or the host scan at "
              f"{wide} bits")
    time_kernel(rec, lambda: block_candidates_cuda(d_streams, zeros, bits),
                "gear_block_kernel")
    rec.plain_ms = median_ms(lambda: block_candidates(gear_values(d_streams),
                                                      zeros, bits), 3)
    rec.bound_ms, rec.bound_by = block_cdc_bound(*d_streams.shape)
    # A yardstick, not the function: PyTorch copying the same bytes.
    dst = torch.empty_like(d_streams)
    copy_ms = device_ms(lambda: dst.copy_(d_streams), "")
    print(f"  gear kernel (dense) on 2 x {SEGMENT >> 20} MB: "
          f"{rec.ms:.4f} ms a call (CUDA events), {fmt_ms(rec.device_ms)} "
          f"ms on the device; a PyTorch copy of the same bytes "
          f"{fmt_ms(copy_ms)} ms on the device; rows of 2 x {length} B "
          f"planted at avg_bits "
          f"{', '.join(map(str, WIDE_BITS))}: bit-exact")


def check_index_kernel(dev, rng, sigs: torch.Tensor, index: torch.Tensor,
                       rec) -> None:
    """The index kernel on the step's queries against the whole index and
    on small odd shapes (N and M not multiples of 64, P = 33, an empty
    index), against its plain twin, bit for bit; timed on the first."""
    cases = [(sigs, index)]
    for n, m, p in ((257, 70, 33), (100, 0, 64)):
        small = rng.integers(0, 3, (n + m, p)).astype(np.int32)
        cases.append((torch.from_numpy(small[:n]).to(dev),
                      torch.from_numpy(small[n:]).to(dev)))
    for q, ix in cases:
        got = index_best_cuda(q, ix)
        want = index_best(q, ix)
        err = float((got - want).abs().max()) if len(got) else 0.0
        rec.max_abs_err = max(rec.max_abs_err, err)
        check(torch.equal(got, want), f"index kernel != plain twin at "
              f"{tuple(q.shape)} x {tuple(ix.shape)}")
    rec.ms = median_ms(lambda: index_best_cuda(sigs, index), 5)
    rec.device_ms = device_ms(lambda: index_best_cuda(sigs, index),
                              "index_count_kernel", 10)
    rec.plain_ms = median_ms(lambda: index_best(sigs, index), 3)
    rec.bound_ms, rec.bound_by = index_bound(sigs.shape[0], index.shape[0],
                                             sigs.shape[1])


def stage4_bound(n: int, p: int, survivors: int) -> tuple[float, str]:
    """(ms, by) of stage 4 over n survivor vectors and p permutations:
    each z word and permutation word read once and 4 p bytes written a
    row, against STAGE4_OPS_PER_SURVIVOR_PERM per non-EMPTY entry and
    permutation."""
    t_bytes = float(4 * minhash.NUM_SEGMENTS * n + 8 * p + 4 * n * p) \
        / HBM_BYTES_PER_S
    t_ops = float(survivors * p * STAGE4_OPS_PER_SURVIVOR_PERM) \
        / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_sig_kernel(dev, rng, rows: torch.Tensor, lens: torch.Tensor,
                     tp: int, rec) -> None:
    """The stage-4 kernel on one dp rank's real survivor vectors (the
    step's rows, through the sketch kernel) at each tp rank's slice of
    the 64 permutations and at all 64 (where it must equal the fused
    kernel's signatures), and at P = 1, 7, 33 and 100 with all-EMPTY
    rows, against its plain twin, bit for bit; timed at a tp rank's
    slice, the call each rank of the 8-rank step makes."""
    z = survivor_segmin_cuda(rows, lens).view(torch.int32)
    n = z.shape[0]
    words = minhash.perm_words(64, dev)
    p_local = 64 // tp
    slices = [words[:, t * p_local:(t + 1) * p_local].contiguous()
              for t in range(tp)]
    z_odd = z.clone()
    z_odd[torch.from_numpy(rng.choice(n, 64, replace=False)).to(dev)] = -1
    cases = [(z, w, f"tp rank {t}'s {p_local} permutations")
             for t, w in enumerate(slices)]
    cases.append((z, words, "all 64 permutations"))
    cases += [(z_odd, minhash.perm_words(p, dev), f"P = {p}, 64 rows EMPTY")
              for p in (1, 7, 31, 33, 100, 300)]
    for zz, w, what in cases:
        got = signature_tiles_cuda(zz, w).view(torch.int32)
        want = minhash.signature_tiles(zz, w.shape[1],
                                       minhash.perms_from_words(w),
                                       PLAIN_ROW_TILE).view(torch.int32)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        rec.max_abs_err = max(rec.max_abs_err, err)
        check(err == 0, f"stage-4 kernel != plain twin at {what}")
    fused = minhash_batch_cuda(rows, lens).view(torch.int32)
    check(torch.equal(signature_tiles_cuda(z, words).view(torch.int32), fused),
          "stage-4 kernel at 64 permutations != the fused sketch kernel")
    def fn():
        return signature_tiles_cuda(z, slices[0])
    rec.ms = median_ms(fn, 20)
    rec.device_ms = device_ms(fn, "minhash_sig_kernel")
    rec.plain_ms = median_ms(lambda: minhash.signature_tiles(
        z, p_local, minhash.perms_from_words(slices[0]), PLAIN_ROW_TILE), 3)
    survivors = int((z != -1).sum())
    rec.bound_ms, rec.bound_by = stage4_bound(n, p_local, survivors)
    print(f"  stage-4 kernel on {n} rows' survivor vectors ({survivors} "
          f"non-EMPTY) x {p_local} permutations: {rec.ms:.4f} ms a call "
          f"(CUDA events), {fmt_ms(rec.device_ms)} ms on the device, its "
          f"plain twin {rec.plain_ms:.3f} ms, bound {rec.bound_ms:.4f} ms "
          f"by {rec.bound_by}; == plain twin at each tp slice, at 64 (and "
          f"== the fused kernel) and at P = 1, 7, 31, 33, 100, 300 with "
          f"EMPTY rows")


def check_fan_outs(dev, card: str, seg: bytes, cuts: list[int],
                   total: dict) -> None:
    """The engine's fan-out over 2 and 4 virtual ranks on phase 2's
    segment, the fingerprint step over 1 and 2 ranks, ``entry()`` and
    ``dryrun_multichip``."""
    want = DedupEngine(DedupConfig(), device=dev).fingerprint(seg, cuts=cuts)
    walls = {}
    for k in (1, 2, 4):
        eng = DedupEngine(DedupConfig(fan_out=k), device=dev,
                          devices=[dev] * k)
        got, launches = counted(lambda: eng.fingerprint(seg, cuts=cuts))
        check(got[0] == want[0] and np.array_equal(got[1], want[1])
              and np.array_equal(got[2], want[2]),
              f"fan_out={k}: spans, digests or signatures != fan_out=1")
        check(launches == {"sha1_ragged_cuda": k, "sketch_ragged_cuda": k},
              f"fan_out={k} launched {launches}")
        if k > 1:
            for name, c in launches.items():
                total[name] = total.get(name, 0) + c
        times = []
        for _ in range(3):
            t0 = time.monotonic()
            eng.fingerprint(seg, cuts=cuts)
            times.append((time.monotonic() - t0) * 1e3)
        walls[k] = statistics.median(times)
    print(f"  engine fan_out 2 and 4 on one card == fan_out 1, k launches of "
          f"each kernel; fingerprint wall, median of 3 (ms): "
          + ", ".join(f"fan_out {k} {w:.1f}" for k, w in walls.items())
          + f"  [{card}]")

    rows, lens = padded_rows(np.frombuffer(seg, np.uint8), cuts[:256], 2)
    d_rows = torch.from_numpy(rows).to(dev)
    d_lens = torch.from_numpy(lens).to(dev)
    want_d = i64(sha1_batch_cuda(d_rows, d_lens))
    want_s = i64(minhash_batch_cuda(d_rows, d_lens))
    for k in (1, 2):
        step = make_fingerprint_step(fingerprint_mesh(k, devices=[dev] * k))
        (d, s), launches = counted(lambda: step(d_rows, d_lens))
        check(np.array_equal(i64(d), want_d) and np.array_equal(i64(s), want_s),
              f"{k}-rank fingerprint step != the kernels called directly")
        check(launches == {"sha1_batch_cuda": k, "minhash_batch_cuda": k},
              f"{k}-rank fingerprint step launched {launches}")
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c
    print(f"  fingerprint step over 1 and 2 ranks on {len(lens)} x {ROW} "
          f"rows == the kernels called directly; one launch of each per rank")

    fn, (chunks, lengths) = entry(dev)
    out, launches = counted(lambda: fn(chunks, lengths))
    check(launches == {"sha1_batch_cuda": 1, "minhash_batch_cuda": 1,
                       "block_candidates_cuda": 1},
          f"entry() launched {launches}")
    raw = sha1.digest_bytes(out["sha1"])
    check(all(raw[i * 20:(i + 1) * 20] == hashlib.sha1(row.tobytes()).digest()
              for i, row in enumerate(chunks)), "entry() digests != hashlib")
    plain = minhash.minhash_batch(torch.from_numpy(chunks).to(dev),
                                  torch.from_numpy(lengths).to(dev))
    check(np.array_equal(i64(out["minhash"]), i64(plain)),
          "entry() signatures != the plain twin")
    mask = (1 << DedupConfig().avg_bits) - 1
    want_c = (gear_hashes_np(chunks.reshape(-1)) & mask) == 0
    check(np.array_equal(out["cut_candidates"].cpu().numpy(), want_c)
          and int(out["n_candidates"]) == int(want_c.sum()),
          "entry() candidates != the host referee")
    (_, launches2) = counted(lambda: dryrun_multichip(RANKS,
                                                      devices=[dev] * RANKS))
    check(launches2 == {"sha1_batch_cuda": RANKS,
                        "survivor_segmin_cuda": RANKS,
                        "signature_tiles_cuda": RANKS,
                        "block_candidates_cuda": RANKS,
                        "index_best_cuda": RANKS},
          f"dryrun_multichip launched {launches2}")
    for name, c in list(launches.items()) + list(launches2.items()):
        total[name] = total.get(name, 0) + c
    print(f"  entry() on the card: digests == hashlib, signatures == plain "
          f"twin, {int(out['n_candidates'])} candidates == host referee; "
          f"dryrun_multichip({RANKS}, devices=[{dev}] * {RANKS}) passed")


def phase_parallel(dev, card: str, seg: bytes, cuts: list[int], rec_block,
                   rec_index, rec_sig
                   ) -> tuple[int, int, int, int, int, int, int]:
    """Phase 8; returns the SHA-1, sketch (k = 5), dense gear, index,
    stage-4 and general-width (fused, then z alone) launches of its
    main-path runs (each counted from 0 just before it)."""
    print(f"phase 8: parallel/, the engine's fan-out and the entry on the "
          f"card; every virtual rank sits on {dev}, so no time below says "
          f"anything about scaling across cards")
    total: dict[str, int] = {}
    check_ingest_step(dev, card, total, rec_block, rec_index, rec_sig)
    check_fan_outs(dev, card, seg, cuts, total)
    print(f"  phase 8 launches by wrapper: {total}; no plain twin on the "
          f"card in any of these runs")
    return (sum(total.get(f.__name__, 0) for f in SHA1_WRAPPERS),
            sum(total.get(f.__name__, 0) for f in SKETCH_WRAPPERS),
            total.get("block_candidates_cuda", 0),
            total.get("index_best_cuda", 0),
            total.get("signature_tiles_cuda", 0), total.get("sketch_k", 0),
            total.get("survivor_k", 0))


# Phase 9: the live system.
LIVE_FILES = 5                         # A, B, D plain; C, E negotiated
LIVE_TAIL = SEGMENT >> 6               # E's replaced tail, 1 MB
SCRUB_CONF = "scrub_interval_s = 0\nchunk_gc_grace_s = 1"


class LaunchCounts:
    """Launches of the kernel wrappers as each module of the live path
    calls them: the sidecar's engine, the sidecar's verify and the
    client's fingerprint.  A wrapper's own count goes up where it
    launches; the difference across each call is attributed to the
    calling module under a lock, so concurrent calls cannot blur it.

    ``tags`` pairs sidecars with names: a tagged sidecar's connection
    threads carry its name, and its launches count under
    ``"<name> <site>"`` (two sidecars share the engine's module).  Enter
    before any daemon connects to a tagged sidecar."""

    SITES = (("sidecar sha1", engine_mod, "sha1_ragged_cuda"),
             ("sidecar sketch", engine_mod, "sketch_ragged_cuda"),
             ("verify sha1", sidecar_mod, "sha1_ragged_cuda"),
             ("client sha1", fingerprint_mod, "sha1_ragged_cuda"),
             ("client gear", gear_cdc_mod, "gear_candidates_cuda"))

    def __init__(self, tags=()):
        self.tags = list(tags)
        names = [name for name, _, _ in self.SITES]
        if self.tags:
            names = [f"{tag} {name}" for _, tag in self.tags
                     for name in names if not name.startswith("client")]
            names += ["client sha1", "client gear"]
        self.n = dict.fromkeys(names, 0)
        self._lock = threading.Lock()
        self._where = threading.local()
        self._saved = []

    def _wrap(self, name, fn):
        def counted_call(*args, **kw):
            with self._lock:
                before = fn.launches
                out = fn(*args, **kw)
                tag = getattr(self._where, "tag", "")
                key = f"{tag} {name}" if tag else name
                self.n[key] = self.n.get(key, 0) + fn.launches - before
            return out
        return counted_call

    def _tagged(self, tag, serve_conn):
        def tagged_conn(conn):
            self._where.tag = tag
            return serve_conn(conn)
        return tagged_conn

    def __enter__(self):
        for name, mod, attr in self.SITES:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn))
        for sidecar, tag in self.tags:
            sidecar._serve_conn = self._tagged(tag, sidecar._serve_conn)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        for sidecar, _ in self.tags:
            del sidecar._serve_conn

    def reset(self):
        """Every count to 0, the plain twins' calls on the card too."""
        with self._lock:
            self.n = dict.fromkeys(self.n, 0)
            reset_plain()


def start_sidecar(dev, path: str):
    """The port's DedupSidecar on ``dev`` at ``path``, warmed up and
    serving in a thread: ``(sidecar, thread, segments, warm-up s)``, with
    ``segments`` the size of each segment its engine fingerprints."""
    sidecar = DedupSidecar(path, config=DedupConfig(), device=dev)
    t0 = time.monotonic()
    sidecar.engine.warmup()
    warm_s = time.monotonic() - t0
    segments = []
    fingerprint = sidecar.engine.fingerprint

    def serve_segment(data, *args, **kw):       # one call per segment
        segments.append(len(data))
        return fingerprint(data, *args, **kw)

    sidecar.engine.fingerprint = serve_segment
    ready = threading.Event()
    server = threading.Thread(target=sidecar.serve_forever,
                              kwargs={"ready_event": ready}, daemon=True)
    server.start()
    check(ready.wait(timeout=60), "sidecar did not bind")
    return sidecar, server, segments, warm_s


def live_corpus() -> dict[str, bytes]:
    """A; B = A with 256 scattered 64-byte edits; D unique; C = A; E = A
    with its last 1 MB replaced: 64 MB each (one daemon segment), seeded
    (edits and tail scale with ``SEGMENT``)."""
    rng = np.random.default_rng(SEED + 9)
    a = rng.integers(0, 256, SEGMENT, dtype=np.uint8)
    b = a.copy()
    for pos in rng.integers(0, SEGMENT - 64, SEGMENT >> 18):
        b[pos:pos + 64] = rng.integers(0, 256, 64, dtype=np.uint8)
    d = rng.integers(0, 256, SEGMENT, dtype=np.uint8)
    e = a.copy()
    e[-LIVE_TAIL:] = rng.integers(0, 256, LIVE_TAIL, dtype=np.uint8)
    return {"A": a.tobytes(), "B": b.tobytes(), "C": a.tobytes(),
            "D": d.tobytes(), "E": e.tobytes()}


def is_recipe(base: str, fid: str) -> bool:
    return os.path.basename(fid) + ".rcp" in harness.recipe_keys(base)


def is_flat(base: str, fid: str) -> bool:
    return any(os.path.isfile(p) for p in glob.glob(os.path.join(
        base, "data", "**", os.path.basename(fid)), recursive=True))


def wait_for(pred, timeout: float):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.25)
    return pred()


def phase_live(dev, card: str, files: dict[str, bytes], storaged: str
               ) -> tuple[int, int, int]:
    """Phase 9; returns the SHA-1, sketch and gear launches of the live
    run."""
    print(f"phase 9: the live system on the card: {storaged}")
    work = tempfile.mkdtemp(prefix="fdfs9")
    base = os.path.join(work, "st")
    sidecar, server, segments, warm_s = start_sidecar(
        dev, os.path.join(work, "dedup.sock"))
    print(f"  the port's sidecar on {dev} warmed up in {warm_s:.2f} s")
    daemon = None
    try:
        daemon = native.start_storage(storaged, base, dedup_mode="sidecar",
                                      dedup_sidecar=sidecar.socket_path,
                                      extra=SCRUB_CONF)
        with LaunchCounts() as counts:
            out = drive_live(dev, card, files, base, daemon, sidecar,
                             counts, segments)
    finally:
        if daemon is not None:
            daemon.stop()
        sidecar.stop()
        server.join(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    check(not server.is_alive(), "sidecar thread did not stop")
    return out


def drive_live(dev, card, files, base, daemon, sidecar, counts, segments
               ) -> tuple[int, int, int]:
    sc = StorageClient("127.0.0.1", daemon.port, timeout=600.0, device=dev)
    fp_ms = []
    fp = storage_client_mod.fingerprint_buffer

    def timed_fingerprint(*args, **kw):
        t0 = time.monotonic()
        out = fp(*args, **kw)
        fp_ms.append((time.monotonic() - t0) * 1e3)
        return out

    storage_client_mod.fingerprint_buffer = timed_fingerprint
    fids, wall, engine, up_stats, tracers = {}, {}, {}, {}, {}

    def upload(name, send):
        """``send()`` timed on the client clock; D's and C's traced, by
        hand (``traced_upload`` goes through a tracker)."""
        t0 = time.monotonic()
        if name not in "DC":
            fids[name] = send()
        else:
            tracer = tracers[name] = Tracer()
            with tracer.span("client.upload"):
                sc.conn.trace_ctx = tracer.wire_ctx()
                fids[name] = send()
            sc.conn.trace_ctx = None
        wall[name] = (time.monotonic() - t0) * 1e3

    try:
        counts.reset()
        segments.clear()
        for name in "ABD":                         # plain: the daemon cuts
            before = sidecar.stats["engine_us"]
            upload(name, lambda: sc.upload_buffer(files[name], ext="bin"))
            engine[name] = (sidecar.stats["engine_us"] - before) / 1e3
        near = sc.near_dups(fids["B"])
        check(bool(near) and near[0][0] == fids["A"],
              f"near_dups(B) does not rank A first: {near}")
        stored = set(harness.chunk_digests(base))
        for name in "CE":                          # negotiated
            want = fingerprint_pairs(files[name], chunk_stream_np(files[name]))
            missing = sum(n for n, d in want if d.hex() not in stored)
            before = sidecar.stats["engine_us"]
            st = up_stats[name] = {}
            upload(name, lambda: sc.upload_buffer_dedup(
                files[name], ext="bin", chunks=None, stats=st))
            engine[name] = (sidecar.stats["engine_us"] - before) / 1e3
            check(st["fallback"] == "", f"{name}: fell back ({st})")
            check(st["chunks_total"] == len(want)
                  and st["bytes_sent"] == missing,
                  f"{name}: shipped {st}, expected {missing} bytes of the "
                  f"{len(want)} chunks")
            stored = set(harness.chunk_digests(base))
        check(up_stats["C"]["chunks_missing"] == 0
              and up_stats["C"]["bytes_sent"] == 0,
              f"C (a copy of A) shipped {up_stats['C']}")
        check(0 < up_stats["E"]["bytes_sent"] <= LIVE_TAIL + (2 << 16),
              f"E shipped more than its changed tail: {up_stats['E']}")
        fingerprint_launches = dict(counts.n)
        served = list(segments)

        # Stored as recipes, read back exactly, deduplicated.
        for name, fid in fids.items():
            check(is_recipe(base, fid) and not is_flat(base, fid),
                  f"{name} ({fid}) was not stored as a recipe: the daemon "
                  f"failed open")
            check(sc.download_to_buffer(fid) == files[name],
                  f"{name}: download != upload")
        off, ln = SEGMENT // 2 + 7, LIVE_TAIL + 13
        check(sc.download_to_buffer(fids["B"], off, ln)
              == files["B"][off:off + ln], "ranged download of B differs")
        unique = sum(harness.chunk_digests(base).values())
        logical = sum(len(v) for v in files.values())
        check(unique < 0.5 * logical,
              f"chunk store holds {unique} of {logical} logical bytes")

        # The scrubber's DEDUP_VERIFY through the port's sidecar.
        before = dict(counts.n)
        harness.corrupt_chunk(base)
        t0 = time.monotonic()
        sc.scrub_kick()
        scrub = wait_for(lambda: (lambda s: s if s["passes"] >= 1 else None)(
            sc.scrub_status()), timeout=300)
        scrub_s = time.monotonic() - t0
        check(bool(scrub), f"scrub pass never finished: {sc.scrub_status()}")
        check(scrub["chunks_corrupt"] >= 1,
              f"scrub did not report the corrupt chunk: {scrub}")
        verify = counts.n["verify sha1"] - before["verify sha1"]
        check(verify >= 1, "the scrub sent no DEDUP_VERIFY to the sidecar")
        spans = decode_dump(sc.trace_dump(),
                            f"storage 127.0.0.1:{daemon.port}")
        check_no_plain("the live system")
    finally:
        storage_client_mod.fingerprint_buffer = fp
        sc.close()

    # The kernels did the work: one launch of each per served segment,
    # one SHA-1 and one gear launch per negotiated upload.
    n = fingerprint_launches
    check(len(served) == LIVE_FILES and all(x == SEGMENT for x in served),
          f"the sidecar served {len(served)} segments {served}, not "
          f"{LIVE_FILES} of {SEGMENT} bytes")
    check(n["sidecar sha1"] == len(served) and n["sidecar sketch"]
          == len(served), f"{n} for {len(served)} segments")
    check(n["client sha1"] == 2, f"{n['client sha1']} client SHA-1 launches "
                                 f"for 2 negotiated uploads")
    check(n["client gear"] == 2, f"{n['client gear']} client gear launches "
                                 f"for 2 negotiated uploads")
    check(sidecar.stats["fingerprint_bytes"] == LIVE_FILES * SEGMENT,
          f"sidecar fingerprinted {sidecar.stats['fingerprint_bytes']} bytes")
    print(f"  A, B, D (plain) and C, E (negotiated) stored as recipes and "
          f"read back exactly; near_dups(B) ranks A first ({near[0][1]:.4f}); "
          f"chunk store {unique / 1e6:.1f} MB of {logical / 1e6:.1f} MB "
          f"logical; C shipped 0 bytes, E {up_stats['E']['bytes_sent']} B "
          f"in {up_stats['E']['chunks_missing']} chunks")
    print(f"  launches: {len(served)} segments served, sidecar SHA-1 "
          f"{n['sidecar sha1']}, sketch {n['sidecar sketch']}; client "
          f"SHA-1 {n['client sha1']}, gear {n['client gear']}; no plain "
          f"twin on the card; scrub: {verify} verify launches, "
          f"{scrub['chunks_verified']} chunks verified, "
          f"{scrub['chunks_corrupt']} corrupt, pass {scrub_s:.1f} s")
    print(f"  plain upload of {SEGMENT >> 20} MB through the daemon, client "
          "clock ms (of which in the sidecar's engine): "
          + ", ".join(f"{k} {wall[k]:.1f} ({engine[k]:.1f})" for k in "ABD")
          + f"  [{card}]")
    print(f"  negotiated upload of {SEGMENT >> 20} MB, client clock ms "
          "(fingerprint on the card; the daemon's reindex in the sidecar's "
          "engine): "
          + ", ".join(f"{k} {wall[k]:.1f} (fingerprint {f:.1f}, share "
                      f"{f / wall[k]:.3f}; engine {engine[k]:.1f})"
                      for k, f in zip("CE", fp_ms))
          + f"  [{card}]")
    for name, what in (("D", "plain"), ("C", "negotiated")):
        tracer = tracers[name]
        print(f"  traced {what} upload of {name} (Tracer on a StorageClient; "
              f"traced_upload needs a tracker):")
        for line in render_timeline(spans + tracer.spans,
                                    tracer.trace_id).splitlines():
            print("    " + line)
    return (n["sidecar sha1"] + n["client sha1"] + verify,
            n["sidecar sketch"], n["client gear"])


# Phase 10: the tracker-routed cluster.  Two storages of one group on
# their own loopback addresses (the tracker keys storages by address).
CLUSTER_IPS = ("127.0.0.61", "127.0.0.62")
# Beats every second; no admission ladder: under the pressure of a
# 64 MB upload it sheds the peer's replication (background class) with
# EBUSY, and the daemon's sync sender then skips that file for good
# (native/storage/sync.cc, "rejected by peer ... skipping").
CLUSTER_CONF = ("heart_beat_interval = 1\nstat_report_interval = 1\n"
                "admission_control = 0")
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def cli_subprocess(args: list[str]) -> subprocess.CompletedProcess:
    """``python -m fastdfs_tpu_torch.cli`` with ``args`` in a process of
    its own: no ``--device``, so it fingerprints on the card."""
    return subprocess.run([sys.executable, "-m", "fastdfs_tpu_torch.cli",
                           *args], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=600)


def cli_in_process(args: list[str]) -> tuple[int, str, str]:
    """``cli.main(args)`` here, so that its launches count: (exit code,
    stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_mod.main(args)
    return rc, out.getvalue(), err.getvalue()


def missing_bytes(data: bytes, stored: set[str]) -> tuple[int, int]:
    """(bytes, chunks) of ``data``'s chunks whose digest is not in
    ``stored``: what a negotiated upload must ship."""
    pairs = fingerprint_pairs(data, chunk_stream_np(data))
    missing = [n for n, d in pairs if d.hex() not in stored]
    return sum(missing), len(pairs)


def phase_cluster(dev, card: str, files: dict[str, bytes], storaged: str,
                  trackerd: str) -> tuple[int, int, int]:
    """Phase 10; returns the SHA-1, sketch and gear launches of the
    cluster run."""
    print(f"phase 10: the tracker-routed cluster on the card: "
          f"{os.path.basename(trackerd)} and two {os.path.basename(storaged)}"
          f" in one group, each on its own port sidecar")
    work = tempfile.mkdtemp(prefix="fdfs10")
    paths = {}
    for name, key in (("A", "A"), ("A2", "E"), ("D", "D")):
        paths[name] = os.path.join(work, f"{name}.bin")
        with open(paths[name], "wb") as fh:
            fh.write(files[key])
    data = {"A": files["A"], "A2": files["E"], "D": files["D"]}
    sidecars, tracker, storages = [], None, []
    try:
        for i in range(2):
            sidecars.append(start_sidecar(
                dev, os.path.join(work, f"dedup{i + 1}.sock")))
        print("  sidecars warmed up in "
              + ", ".join(f"{w:.2f}" for _, _, _, w in sidecars) + " s")
        tags = [(sc, f"sidecar {i + 1}")
                for i, (sc, _, _, _) in enumerate(sidecars)]
        with LaunchCounts(tags) as counts:
            tracker = native.start_tracker(trackerd,
                                           os.path.join(work, "tr"))
            taddr = f"127.0.0.1:{tracker.port}"
            for i, ip in enumerate(CLUSTER_IPS):
                storages.append(native.start_storage(
                    storaged, os.path.join(work, f"st{i + 1}"), ip=ip,
                    trackers=[taddr], dedup_mode="sidecar",
                    dedup_sidecar=sidecars[i][0].socket_path,
                    extra=CLUSTER_CONF + "\n" + SCRUB_CONF))
            bases = [os.path.join(work, f"st{i + 1}") for i in range(2)]
            out = drive_cluster(dev, card, data, paths, taddr, tracker,
                                storages, bases,
                                [seg for _, _, seg, _ in sidecars], counts)
    finally:
        for daemon in storages:
            daemon.stop()
        if tracker is not None:
            tracker.stop()
        for sc, server, _, _ in sidecars:
            sc.stop()
            server.join(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    check(not any(server.is_alive() for _, server, _, _ in sidecars),
          "a sidecar thread did not stop")
    return out


def drive_cluster(dev, card, data, paths, taddr, tracker, storages, bases,
                  segments, counts) -> tuple[int, int, int]:
    t = TrackerClient("127.0.0.1", tracker.port, 60.0)
    check(bool(wait_for(lambda: (lambda g: bool(g) and g[0]["active"] == 2)(
        t.list_groups()), timeout=60)), f"storages never ACTIVE: "
          f"{t.list_groups()}")
    cli = FdfsClient([taddr], timeout=600.0, device=dev)
    addrs = [f"{ip}:{d.port}" for ip, d in zip(CLUSTER_IPS, storages)]

    def warmed():
        try:
            return cli.upload_buffer(b"warmup " * 64, ext="txt")
        except (OSError, ProtocolError, StatusError):
            return None
    check(bool(wait_for(warmed, timeout=30)), "the tracker routes no upload")

    def stored() -> set[str]:
        return set().union(*(harness.chunk_digests(b) for b in bases))

    def replicated(fid):
        """Both storages hold ``fid`` (the tracker's fetch list can name a
        replica before its sync has written the file)."""
        for ip, daemon in zip(CLUSTER_IPS, storages):
            try:
                with StorageClient(ip, daemon.port, timeout=60.0,
                                   device=dev) as sc:
                    sc.query_file_info(fid)
            except StatusError as e:
                if e.status != 2:
                    raise
                return False
        return True

    counts.reset()
    for seg in segments:
        seg.clear()
    fids, wall, served = {}, {}, {}

    def timed(name, fn):
        before = [len(seg) for seg in segments]
        t0 = time.monotonic()
        out = fn()
        wall[name] = (time.monotonic() - t0) * 1e3
        served[name] = [len(seg) - b for seg, b in zip(segments, before)]
        return out

    # 1. The CLI, tracker-routed: a process of its own on the default
    # device, then in this process (its launches count here).
    want_a = missing_bytes(data["A"], stored())
    proc = timed("A", lambda: cli_subprocess(["upload", taddr, "--dedup",
                                              paths["A"]]))
    check(proc.returncode == 0, f"cli upload --dedup A failed: "
                                f"{proc.stderr[-2000:]}")
    fids["A"] = proc.stdout.strip()
    check(proc.stderr.strip() == f"wire: {want_a[0]}/{len(data['A'])} bytes "
          "shipped", f"A: {proc.stderr.strip()!r}, expected {want_a[0]} "
          "bytes shipped")
    check(bool(wait_for(lambda: replicated(fids["A"]), timeout=120)),
          "A never replicated")
    want_a2 = missing_bytes(data["A2"], stored())
    rc, out, wire_a2 = timed("A2", lambda: cli_in_process(
        ["upload", taddr, "--dedup", paths["A2"]]))
    check(rc == 0, f"cli upload --dedup A' failed: {wire_a2[-2000:]}")
    fids["A2"] = out.strip()
    wire_a2 = wire_a2.strip()
    check(wire_a2 == f"wire: {want_a2[0]}/{len(data['A2'])} bytes shipped",
          f"A': {wire_a2!r}, expected {want_a2[0]} bytes")
    check(0 < want_a2[0] <= LIVE_TAIL + (2 << 16),
          f"A' ships {want_a2[0]} bytes, more than its new tail")
    client_sha1 = counts.n["client sha1"]
    check(bool(wait_for(lambda: replicated(fids["A2"]), timeout=120)),
          "A' never replicated")

    # 2. A plain upload through the client on the card, then a traced
    # one, and the stitched trace across the cluster.  Each upload is
    # replicated before the next starts, so that a sidecar's segments
    # during an upload are that upload's.
    fids["D"] = timed("D", lambda: cli.upload_buffer(data["D"], ext="bin"))
    check(bool(wait_for(lambda: replicated(fids["D"]), timeout=120)),
          "D never replicated")
    fids["At"], tracer = timed("At", lambda: traced_upload(
        cli, data["A"], ext="bin"))
    data["At"] = data["A"]
    check(bool(wait_for(lambda: replicated(fids["At"]), timeout=120)),
          "the traced upload of A never replicated")

    def stitched():
        spans, errors = collect_cluster_spans(cli)
        check(errors == {}, f"collect_cluster_spans: {errors}")
        mine = [s for s in spans + tracer.spans
                if s.trace_id == tracer.trace_id]
        nodes = {s.node.rsplit(":", 1)[0] for s in mine}
        return mine if {"client", "tracker 127.0.0.1"} | {
            f"storage {ip}" for ip in CLUSTER_IPS} <= nodes else None
    spans = wait_for(stitched, timeout=30)
    check(bool(spans), "the traced upload has no spans from the tracker and "
                       "both storages")
    roots = [s for s in spans if s.name == "client.upload"]
    check(len(roots) == 1 and all(
        s is roots[0] or s.parent_id for s in spans),
        "the stitched trace is not one tree under client.upload")

    # 3. Replication: every file byte-exact from both storages; a recipe
    # on the storage that took it.
    time.sleep(1.0)              # late sync work would show by now
    final = [len(seg) for seg in segments]
    recipes = {}
    for name, fid in fids.items():
        for i, (ip, daemon) in enumerate(zip(CLUSTER_IPS, storages)):
            with StorageClient(ip, daemon.port, timeout=600.0,
                               device=dev) as sc:
                check(sc.download_to_buffer(fid) == data[name],
                      f"{name}: the download from {ip} differs")
        source = [i for i, n in enumerate(served[name]) if n]
        check(sorted(served[name]) == [0, 1],
              f"{name}: segments served per sidecar {served[name]}")
        recipes[name] = [is_recipe(b, fid) for b in bases]
        check(recipes[name][source[0]] and not is_flat(bases[source[0]],
                                                       fid),
              f"{name} ({fid}) is not a recipe on its source: the daemon "
              f"failed open")
    replica = [f - sum(served[n][i] for n in served)
               for i, f in enumerate(final)]

    # The kernels did the work: each sidecar one launch of each kernel
    # per segment it served, the client one SHA-1 per negotiated upload
    # made in this process.
    n = dict(counts.n)
    for i in range(2):
        tag = f"sidecar {i + 1}"
        check(all(x == SEGMENT for x in segments[i]),
              f"{tag} served segments of {set(segments[i])} bytes")
        check(n[f"{tag} sidecar sha1"] == final[i]
              and n[f"{tag} sidecar sketch"] == final[i],
              f"{tag}: {n} for {final[i]} segments")
        check(n[f"{tag} verify sha1"] == 0, f"{tag} verified chunks: {n}")
    check(client_sha1 == 1 and n["client sha1"] == 1,
          f"{n['client sha1']} client SHA-1 launches for one negotiated "
          f"upload in this process")
    check(n["client gear"] == 1 and not any(
        n.get(f"sidecar {i + 1} client gear") for i in range(2)),
        f"gear launches {n}: not one, for the negotiated upload in this "
        f"process")
    check_no_plain("the tracker-routed cluster")
    untagged = {k: v for k, v in n.items() if v and k.startswith(
        ("sidecar sha1", "sidecar sketch", "verify sha1"))}
    check(not untagged, f"launches outside both sidecars: {untagged}")
    reindex = sum(sum(served[k]) for k in ("A", "A2"))

    # 4. The monitor and the CLI's consoles on the card.
    top = monitor_mod.gather_top(cli)
    for addr in addrs:
        node = top.nodes.get(f"storage {addr}")
        check(node is not None and node.error == ""
              and node.registry is not None, f"top: {addr} is not live: "
              f"{node}")
    check(not [k for k, v in top.nodes.items() if v.error],
          f"top has error rows: {top.nodes}")
    frame = monitor_mod.render_top(top, monitor_mod.top_rates(None, top), [])
    consoles = {}
    for args in (["group", taddr, "status"], ["health", taddr]):
        rc, out, err = cli_in_process(["--device", "cuda", *args])
        check(rc == 0 and "error" not in out + err,
              f"cli {args[0]}: rc {rc}\n{out}\n{err}")
        consoles[args[0]] = out
    check(all(a in consoles["health"] for a in addrs),
          f"cli health lacks a storage:\n{consoles['health']}")
    cli.close()

    print(f"  A by `python -m fastdfs_tpu_torch.cli upload --dedup` in its "
          f"own process (the card by default): {proc.stderr.strip()}; A' by "
          f"cli.main in this process: {wire_a2} ({want_a2[1]} chunks)")
    label = {"A": "A", "A2": "A'", "D": "D", "At": "A traced"}
    print(f"  every file downloads byte-exact from both storages; a recipe "
          f"on its source; recipes on (storage 1, storage 2): "
          + ", ".join(f"{label[k]} {v}" for k, v in recipes.items()))
    print(f"  launches: client SHA-1 {n['client sha1']}, gear "
          f"{n['client gear']} (no plain twin on the card); "
          + "; ".join(f"sidecar {i + 1} SHA-1 "
                      f"{n[f'sidecar {i + 1} sidecar sha1']}, sketch "
                      f"{n[f'sidecar {i + 1} sidecar sketch']} for "
                      f"{final[i]} segments" for i in range(2))
          + f"; of these, reindex of the 2 negotiated uploads {reindex}, "
          f"replicas fingerprinting synced files {replica} (sidecar 1, 2)")
    print(f"  segments served per upload (sidecar 1, 2): "
          + ", ".join(f"{label[k]} {v}" for k, v in served.items()))
    print(f"  wall per {SEGMENT >> 20} MB upload, client clock ms: A (cli "
          f"subprocess, with its start) {wall['A']:.1f}, A' (cli.main) "
          f"{wall['A2']:.1f}, D (plain) {wall['D']:.1f}, A (traced plain) "
          f"{wall['At']:.1f}  [{card}]")
    print("  traced plain upload of A through the tracker (stitched "
          "across the cluster):")
    for line in render_timeline(spans, tracer.trace_id).splitlines():
        print("    " + line)
    print("  top, one frame:")
    for line in frame.splitlines()[1:]:
        print("    " + line)
    for name in ("group", "health"):
        print(f"  cli --device cuda {name}:")
        for line in consoles[name].splitlines():
            print("    " + line)
    return (n["client sha1"] + sum(n[f"sidecar {i + 1} sidecar sha1"]
                                   for i in range(2)),
            sum(n[f"sidecar {i + 1} sidecar sketch"] for i in range(2)),
            n["client gear"])


# Phase 11: the port's benchmarks.

C4_SCALE = 1 / 400                     # config 4 here: 4,096 documents, 256 MB
# Config 5's 8-rank step at shingle 5 launches each of these once a rank.
C5_WRAPPERS = ("sha1_batch_cuda", "survivor_segmin_cuda",
               "signature_tiles_cuda", "block_candidates_cuda",
               "index_best_cuda")


def run_bench(*args: str) -> dict:
    """``python -m fastdfs_tpu_torch.bench`` with ``args`` at full size in
    a process of its own: its one stdout line, which must say ok."""
    env = {k: v for k, v in os.environ.items() if k != "_FDFS_BENCH_SMOKE"}
    proc = subprocess.run([sys.executable, "-m", "fastdfs_tpu_torch.bench",
                           *args], cwd=REPO_ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    check(proc.returncode == 0 and len(lines) == 1,
          f"bench {list(args)}: rc {proc.returncode}, {len(lines)} stdout "
          f"lines; stderr: {proc.stderr[-2000:]}")
    out = json.loads(lines[0])
    check(out.get("ok") is True and (out.get("value") or 0) > 0,
          f"bench {list(args)}: {out.get('error')} {out.get('checked')}")
    return out


def add_launches(total: dict, launches: dict) -> None:
    for name, k in launches.items():
        total[name] = total.get(name, 0) + k


def check_flagship(card: str, total: dict) -> None:
    """The flagship leg: both kernels once a step, rows checked."""
    out = run_bench()
    check(out["metric"] == bench_mod.METRIC, f"flagship metric {out['metric']}")
    check(out["rounds"] >= bench_mod.MIN_ROUNDS
          and (out["measured_seconds"] >= bench_mod.MIN_SECONDS
               or out["rounds"] == bench_mod.MAX_ROUNDS),
          f"flagship rounds {out['rounds']} in {out['measured_seconds']} s")
    check(out["warmup"]["in_measure"] is False, "warm-up inside the rounds")
    checked = out["checked"]
    check(checked["digests_equal"] and checked["sigs_equal"]
          and checked["digest_rows"] > 0 and checked["sig_rows"] > 0,
          f"flagship rows checked: {checked}")
    steps = out["steps"]
    check(steps == out["rounds"] * bench_mod.PIPELINE
          and out["launches"] == {"sha1_batch_cuda": steps,
                                  "minhash_batch_cuda": steps},
          f"flagship launches {out['launches']} over {steps} steps")
    add_launches(total, out["launches"])
    dev_ms = out["kernel_device_ms"] or {}
    print(f"  bench: {out['value']} GB/s ({out['rounds']} rounds of "
          f"{bench_mod.PIPELINE} x {out['rows']} rows of {out['row_bytes']} "
          f"B, {out['measured_seconds']} s), dispersion {out['dispersion']}, "
          f"contended {out['contended']}, vs_baseline {out['vs_baseline']} "
          f"(hashlib {out['cpu_baseline_GBps']} GB/s on one core); device "
          f"ms a dispatch: SHA-1 {fmt_ms(dev_ms.get('sha1'))}, sketch "
          f"{fmt_ms(dev_ms.get('sketch'))}, all {fmt_ms(dev_ms.get('all'))} "
          f"(busy share {out.get('device_busy_share')}); a round's median "
          f"ms split {out['round_split_ms']}; rows checked "
          f"{checked['digest_rows']} digests, {checked['sig_rows']} "
          f"signatures; launches {out['launches']}  [{out['card']}]")


def check_multichip(card: str, total: dict) -> None:
    """The fan-out leg: each rank launches both kernels once a step."""
    out = run_bench("--multichip")
    check(out["metric"] == bench_mod.METRIC_MULTICHIP,
          f"multichip metric {out['metric']}")
    for k, leg in out["legs"].items():
        steps = leg["rounds"] * int(k)
        check(leg["launches"] == {"sha1_batch_cuda": steps,
                                  "minhash_batch_cuda": steps},
              f"multichip leg {k}: launches {leg['launches']}")
        add_launches(total, leg["launches"])
    if out["n_devices"] == 1:
        check(out["scaling_1_to_n"] == 1.0 and "note" in out,
              f"one card, scaling {out['scaling_1_to_n']}")
    print(f"  bench --multichip: {out['value']} GB/s aggregate, "
          f"{out['per_chip_GBps']} per card, scaling 1 -> "
          f"{out['n_devices']}: {out['scaling_1_to_n']}; legs "
          f"{out['legs']}; {out.get('note', '')}  [{out['card']}]")


def phase_benches(dev, card: str) -> dict[str, int]:
    """Phase 11; returns the launches of its main-path runs by wrapper
    (each counted from 0 just before it; the benches count their own
    rounds in their processes)."""
    print("phase 11: the port's benchmarks: python -m fastdfs_tpu_torch.bench "
          "and --multichip at full size, each in a process of its own; "
          f"bench_configs config 4 at scale {C4_SCALE} and config 5 here")
    total: dict[str, int] = {}
    check_flagship(card, total)
    check_multichip(card, total)
    with tempfile.TemporaryDirectory(prefix="fdfs11") as out_dir:
        art4, n4 = counted(lambda: bench_configs.config4(out_dir, C4_SCALE))
        art5, n5 = counted(lambda: bench_configs.config5(
            out_dir, bench_configs.DEFAULT_SCALE[5]))
    check(art4["kernel_bitexact_cuda_vs_plain"] is True,
          "config 4: the kernel's signatures != the plain twin's")
    recall = ("recall_at_1_vs_truth", "recall_at_5_vs_truth",
              "recall_per_class", "referee_top1_agreement_acc_vs_textbook",
              "referee_textbook_recall_at_1")
    check(all(art4.get(key) is not None for key in recall)
          and set(art4["recall_per_class"]) == {"span_edit", "scattered_edit"}
          and art4["recall_pass"] is True,
          f"config 4 recall fields: {[art4.get(key) for key in recall]}")
    dispatches = art4["batches"] + 1 + bench_configs.RESIDENT_DISPATCHES
    check(n4 == {"minhash_batch_cuda": dispatches},
          f"config 4 launched {n4}, expected {dispatches} sketch launches")
    print(f"  config 4 ({art4['docs']} documents, {art4['queries']} "
          f"queries): recall@1 {art4['recall_at_1_vs_truth']}, recall@5 "
          f"{art4['recall_at_5_vs_truth']}, by class "
          f"{art4['recall_per_class']}, top-1 agreement with the textbook "
          f"MinHash {art4['referee_top1_agreement_acc_vs_textbook']} over "
          f"{art4['referee_queries']}; kernel == plain twin; streamed "
          f"{art4['accelerated_sig_GBps_streamed']} GB/s, resident "
          f"{art4['accelerated_sig_GBps_resident']} GB/s; launches {n4}  "
          f"[{card}]")
    steps = art5["iterations"] + 1
    check(art5["digests_shape"] == [32, 5] and art5["sigs_shape"] == [32, 64]
          and art5["best_shape"] == [32] and art5["best_sim_finite"]
          and art5["mesh"] == {"dp": 2, "sp": 2, "tp": 2}
          and art5["iterations"] == bench_configs.C5_ITERATIONS,
          f"config 5 artifact: {art5}")
    check(n5 == {name: RANKS * steps for name in C5_WRAPPERS},
          f"config 5 launched {n5} in {steps} steps")
    print(f"  config 5: {art5['iterations']} steps of the (2, 2, 2) mesh on "
          f"one card in {art5['seconds']} s ({art5['steps_per_sec']} steps "
          f"a second, {art5['aggregate_GBps']} GB/s); shapes digests "
          f"{art5['digests_shape']}, sigs {art5['sigs_shape']}, best finite; "
          f"launches {n5}  [{card}]")
    add_launches(total, n4)
    add_launches(total, n5)
    print(f"  phase 11 launches by wrapper: {total}; no plain twin on the "
          f"card in config 4 or 5")
    return total


# Phase 12: configs 2 and 3, the daemons' ingest through the port's
# sidecar process on the card.

C2_SCALE = 1 / 128                     # config 2 here: 19 documents, 89 MB
C3_SCALE = 1 / 512                     # config 3 here: ~105 MB of files
# Cuts of config 2's first document (the same at every scale) by the
# reference's serial chunker; tests/test_torch_bench_daemon.py holds the
# port's chunker to it.
C2_FIRST_DOC_CUTS = 645


def check_stage_table(what: str, st: dict | None) -> str:
    """A leg's upload stage table: fingerprint time recorded, shares
    summing to 1 +- 0.05; returns its shares as text."""
    check(st is not None and st["count"] >= 1
          and st["stages_s"]["fp_us"] > 0
          and abs(sum(st["stage_share"].values()) - 1.0) <= 0.05,
          f"{what}: upload stage table {st}")
    return ", ".join(f"{k} {v}" for k, v in st["stage_share"].items() if v)


def check_sidecar_leg(what: str, leg: dict, scaled_bytes: int,
                      device: str) -> dict:
    """The leg counts (no restart, error, retry or re-exec, every byte
    fingerprinted) and ran on ``device``; returns its sidecar stats."""
    faults = bench_configs.leg_faults(leg, scaled_bytes)
    check(not faults, f"{what}: the sidecar leg does not count: {faults}")
    check(leg["sidecar_platform"] == device,
          f"{what}: the sidecar ran on {leg['sidecar_platform']}")
    return leg["sidecar_stats"]


def dedup_hits(leg: dict) -> list[int]:
    """Each storage's ``store.dedup_hits`` after the leg's ingest."""
    return [node.get("store.dedup_hits", 0)
            for node in leg["daemon_stats"]["after"].values()]


def phase_daemon_configs(dev, card: str, scale2: float = C2_SCALE,
                         scale3: float = C3_SCALE) -> None:
    """Phase 12: ``bench_configs`` configs 2 and 3 here, each leg held to
    the daemon's own CPU dedup."""
    print("phase 12: bench_configs config 2 at scale "
          f"{scale2} and config 3 at scale {scale3}: the daemons' ingest "
          "in dedup_mode cpu, then sidecar behind python -m "
          f"fastdfs_tpu_torch.sidecar --platform {dev.type}; the sidecar "
          "is a process of its own, so its kernel launches are not in the "
          "kernels line (phases 3 and 9 hold the same engine to one launch "
          "of each kernel per segment)")
    with tempfile.TemporaryDirectory(prefix="fdfs12") as out_dir:
        t0 = time.monotonic()
        art2 = bench_configs.config2(out_dir, scale2, dev.type)
        t2 = time.monotonic() - t0
        art3 = bench_configs.config3(out_dir, scale3, dev.type)
        t3 = time.monotonic() - t0 - t2
    cpu, sc = art2["cpu_mode"], art2["sidecar_mode"]
    stats = check_sidecar_leg("config 2", sc, art2["scaled_bytes"], dev.type)
    check(art2["chunks_sample"] == C2_FIRST_DOC_CUTS,
          f"config 2: {art2['chunks_sample']} cuts on the first document, "
          f"the reference's chunker makes {C2_FIRST_DOC_CUTS}")
    check(cpu["upload_retries"] == 0, "config 2: the cpu leg retried")
    # The daemon's own CPU dedup is the referee: two runs of the cpu leg
    # on one corpus save the same bytes, so the sidecar leg must too.
    check(sc["dedup_bytes_saved"] == cpu["dedup_bytes_saved"]
          and dedup_hits(sc) == dedup_hits(cpu),
          f"config 2: saved {sc['dedup_bytes_saved']} bytes and hit "
          f"{dedup_hits(sc)} chunks on the sidecar, {cpu['dedup_bytes_saved']}"
          f" and {dedup_hits(cpu)} on the cpu")
    print(f"  config 2 ({art2['docs']} documents, {art2['scaled_bytes']} "
          f"bytes, {t2:.1f} s): chunks_sample {art2['chunks_sample']}, "
          f"saved {cpu['dedup_bytes_saved']} bytes in both legs, chunk hits "
          f"{dedup_hits(cpu)}; serial chunker "
          f"{art2['chunker_py_serial_GBps']} GB/s, fdfs_codec "
          f"{art2['chunker_cpp_GBps']} GB/s  [{card}]")
    for name, leg in (("cpu", cpu), ("sidecar", sc)):
        shares = check_stage_table(f"config 2 {name} leg",
                                   leg["upload_stages"])
        print(f"    {name} leg: daemon_ingest_GBps "
              f"{leg['daemon_ingest_GBps']} ({leg['seconds']} s, "
              f"{leg['client_conns']} connections, {leg['upload_retries']} "
              f"retries); stage shares {shares}  [{card}]")
    print(f"    sidecar: {stats['requests']} requests, {stats['chunks']} "
          f"chunks, fingerprint_bytes {stats['fingerprint_bytes']}, "
          f"engine_us {stats['engine_us']}, lock_wait_fraction "
          f"{stats['lock_wait_fraction']}, restarts {sc['sidecar_restarts']}"
          f"  [{card}]")

    cpu, sc = art3["cpu_mode"], art3["sidecar_mode"]
    stats = check_sidecar_leg("config 3", sc, art3["scaled_bytes"], dev.type)
    print(f"  config 3 ({art3['files']} files, {art3['scaled_bytes']} bytes, "
          f"{t3:.1f} s)  [{card}]")
    for name, leg in (("cpu", cpu), ("sidecar", sc)):
        check(leg["sync_recipe_replays"] == leg["files"] == art3["files"],
              f"config 3 {name} leg: {leg['sync_recipe_replays']} recipe "
              f"replays for {leg['files']} files")
        shares = "; ".join(
            f"node {i}: " + check_stage_table(f"config 3 {name} leg node {i}",
                                              st)
            for i, st in enumerate(leg["upload_stages_per_node"])
            if st is not None)
        print(f"    {name} leg: ingest_GBps {leg['ingest_GBps']} "
              f"({leg['ingest_seconds']} s), replicated_GBps "
              f"{leg['replicated_GBps']} ({leg['replicated_seconds']} s), "
              f"sync_wire_bytes {leg['sync_wire_bytes']}, recipe replays "
              f"{leg['sync_recipe_replays']}, saved per node "
              f"{leg['dedup_bytes_saved_per_node']}; stage shares {shares}"
              f"  [{card}]")
    print(f"    sidecar: {stats['requests']} requests, {stats['chunks']} "
          f"chunks, fingerprint_bytes {stats['fingerprint_bytes']}, "
          f"engine_us {stats['engine_us']}, lock_wait_fraction "
          f"{stats['lock_wait_fraction']}, restarts {sc['sidecar_restarts']}"
          f"  [{card}]")


# Phase 13: the single-storage configs of bench_configs.py, config 6's
# negotiated uploads fingerprinted on the card, and configs 1, 7 and 8.

# Config 6 at its default scale (160 blobs of 256 KB, three passes): the
# wire bytes each pass ships and the daemon's ingest counters, as
# bench_artifacts/config6.json has them and the client's host route
# gives them (tests/test_torch_bench_host.py).
C6_WIRE = {"cold": 41943040, "warm": 0, "edited": 6542419}
C6_SAVED_WIRE = 77343661
C6_UPLOADS = 480
C1_SCALE = 1 / 64                      # config 1 here: 64 pieces, 16 MB
C7_SCALE = 1 / 2048                    # config 7 here: 20 blobs preloaded
C8_SCALE = 1 / 1024                    # config 8 here: 40 blobs, 10 MB file


def check_config6(what: str, art: dict) -> None:
    """Config 6's five exact numbers and a clean warm pass."""
    wire = {name: art[name]["wire_bytes_sent"] for name in C6_WIRE}
    ingest = art["ingest_counters"]
    check(wire == C6_WIRE
          and ingest.get("ingest.bytes_saved_wire") == C6_SAVED_WIRE
          and ingest.get("ingest.recipe_uploads") == C6_UPLOADS
          and ingest.get("ingest.recipe_fallbacks") == 0
          and art["warm_pass_ok"] is True,
          f"config 6 {what}: wire bytes {wire}, ingest {ingest}, warm ok "
          f"{art['warm_pass_ok']}")


def phase_host_configs(dev, card: str) -> dict[str, int]:
    """Phase 13; returns the launches of config 6's run on the card by
    wrapper (counted from 0 just before it)."""
    print("phase 13: bench_configs config 6 at its default scale on the "
          "card, then on the client's host route; configs 1 at "
          f"{C1_SCALE}, 7 at {C7_SCALE} and 8 at {C8_SCALE} (no kernel)")
    scale6 = bench_configs.DEFAULT_SCALE[6]
    with tempfile.TemporaryDirectory(prefix="fdfs13") as out_dir:
        art6, n6 = counted(lambda: bench_configs.config6(out_dir, scale6,
                                                         dev.type))
        art6c = bench_configs.config6(out_dir, scale6, "cpu")
        art1, n1 = counted(lambda: bench_configs.config1(out_dir, C1_SCALE,
                                                         dev.type))
        art7, n7 = counted(lambda: bench_configs.config7(out_dir, C7_SCALE,
                                                         dev.type))
        art8, n8 = counted(lambda: bench_configs.config8(out_dir, C8_SCALE,
                                                         dev.type))
    check_config6("on the card", art6)
    check_config6("on the host", art6c)
    launches = art6["kernel_launches"]
    check(not bench_configs.launch_faults(launches, C6_UPLOADS)
          and launches["uploads"] == C6_UPLOADS,
          f"config 6 launches {launches}")
    # The config's one warm-up fingerprint, before the passes, adds one
    # launch of each kernel to the counted run.
    check(n6 == {"sha1_ragged_cuda":
                 launches["sha1_ragged_cuda.launches"] + 1,
                 "gear_candidates_cuda":
                 launches["gear_candidates_cuda.launches"] + 1},
          f"config 6 run launched {n6}, the passes {launches}")
    check(art6["card"] == card and "on the card" in art6["description"],
          f"config 6 card {art6['card']}: {art6['description']}")
    for name in C6_WIRE:
        print(f"  config 6 {name}: {art6[name]['wire_bytes_sent']} wire "
              f"bytes of {art6[name]['logical_bytes']}; seconds on the card "
              f"{art6[name]['seconds']}, on the host route "
              f"{art6c[name]['seconds']}  [{card}]")
    print(f"  config 6 ingest counters {art6['ingest_counters']}; launches "
          f"over the {C6_UPLOADS} uploads {launches}, the run {n6}  "
          f"[{card}]")

    check(n1 == n7 == n8 == {},
          f"configs 1, 7, 8 launched kernels: {n1}, {n7}, {n8}")
    check(art1["errors"] == 0 and art1["uploads"] == 64
          and art1["dedup_bytes_saved"] == art1["scaled_bytes"] // 2,
          f"config 1: errors {art1['errors']}, uploads {art1['uploads']}, "
          f"saved {art1['dedup_bytes_saved']} of {art1['scaled_bytes']}")
    print(f"  config 1 ({art1['uploads']} pieces of 256 KB, "
          f"{art1['client_threads']} fdfs_load threads): ingest "
          f"{art1['daemon_ingest_GBps']} GB/s, upload latency us "
          f"{art1['upload_lat_us']}; download {art1['download_GBps']} GB/s, "
          f"latency us {art1['download_lat_us']}; saved "
          f"{art1['dedup_bytes_saved']} bytes; one core's crc32 "
          f"{art1['cpu_crc32_GBps']}, sha1 {art1['cpu_sha1_GBps']} GB/s  "
          f"[{card}]")
    modes = art7["modes"]
    verified = {m: (v["chunks_verified"], v["chunks_corrupt"])
                for m, v in modes.items()}
    check(art7["no_false_corruption"] is True
          and modes["off"]["chunks_verified"] == 0
          and modes["bw16"]["chunks_verified"] > 0
          and modes["unlimited"]["chunks_verified"] > 0,
          f"config 7: chunks verified and corrupt by mode {verified}")
    for name, m in modes.items():
        print(f"  config 7 {name}: {m['ops']} ops, upload p50/p99 "
              f"{m['upload_p50_ms']}/{m['upload_p99_ms']} ms, download "
              f"p50/p99 {m['download_p50_ms']}/{m['download_p99_ms']} ms; "
              f"scrub passes {m['scrub_passes']}, chunks verified "
              f"{m['chunks_verified']}  [{card}]")
    modes = art8["modes"]
    check(art8["wrong_bytes"] == 0 and modes["cache0"]["cache_hits"] == 0
          and modes["cache64"]["cache_hits"] > 0,
          f"config 8: wrong_bytes {art8['wrong_bytes']}, cache hits "
          f"{[m['cache_hits'] for m in modes.values()]}")
    for name, m in modes.items():
        print(f"  config 8 {name}: cold p50/p99 {m['cold']['p50_ms']}/"
              f"{m['cold']['p99_ms']} ms, warm {m['warm']['p50_ms']}/"
              f"{m['warm']['p99_ms']} ms, cache hits {m['cache_hits']}  "
              f"[{card}]")
    # The client's fingerprint of one 256 KB upload on each route, over
    # config 6's blobs (not counted: the counted run is above).
    corpus, _ = bench_configs._config6_corpus(
        int(bench_configs.NOMINAL[6] * scale6))
    for route in (dev.type, "cpu"):
        wall = []
        for blob in corpus:
            t0 = time.perf_counter()
            fingerprint_buffer(blob, device=route)
            wall.append((time.perf_counter() - t0) * 1e3)
        print(f"  client fingerprint of a 256 KB blob on {route}: median "
              f"{statistics.median(wall):.4f} ms, min {min(wall):.4f}, max "
              f"{max(wall):.4f} over {len(wall)} blobs  [{card}]")
    par = art8["parallel"]
    print(f"  config 8 ranged download of {par['file_bytes']} bytes on "
          f"{par['host_cpus']} host CPUs: single stream "
          f"{par['single_stream_s']} s, parallel 4 {par['parallel4_s']} s "
          f"(speedup {par['speedup']}); wrong bytes {art8['wrong_bytes']}  "
          f"[{card}]")
    return n6


# Phase 14: configs 9, 10 and 11 of bench_configs.py and the index tool,
# at their smallest corpora; none launches a kernel.
C9_SCALE = 1 / 2048                    # config 9 here: 200 files of 4 KB
C10_SCALE = 1 / 65536                  # config 10 here: 60 files of 64 KB
C11_SCALE = 1 / 65536                  # config 11 here: 12 files of 256 KB
INDEX_N = 200_000                      # the index tool's entries here
# Config 11 here runs without the storages' admission ladder: under its
# EC downloads a member's ladder can tighten and shed the peer's
# FETCH_CHUNK of a released chunk (background class), and the peer then
# cuts the client's download mid-body (native/storage/server.cc,
# "missing chunk ... mid-download").  ``--config 11`` keeps the
# reference's settings.
NO_SHED = "\nadmission_control = 0"


def phase_group_configs(dev, card: str) -> None:
    """Phase 14: each run counted, none may launch a kernel."""
    print(f"phase 14: bench_configs configs 9 at {C9_SCALE}, 10 at "
          f"{C10_SCALE} and 11 at {C11_SCALE}, and the index tool at "
          f"{INDEX_N} entries (no kernel)")
    with tempfile.TemporaryDirectory(prefix="fdfs14") as out_dir:
        art9, n9 = counted(lambda: bench_configs.config9(out_dir, C9_SCALE,
                                                         dev.type))
        art10, n10 = counted(lambda: bench_configs.config10(
            out_dir, C10_SCALE, dev.type))
        beats = bench_configs.HB
        bench_configs.HB = beats + NO_SHED
        try:
            art11, n11 = counted(lambda: bench_configs.config11(
                out_dir, C11_SCALE, dev.type))
        finally:
            bench_configs.HB = beats
        index_path = os.path.join(out_dir, "index_scale.json")
        _, n_index = counted(lambda: bench_index_scale.main(
            ["--n", str(INDEX_N), "--out", index_path]))
        with open(index_path) as fh:
            index = json.load(fh)
    check(n9 == n10 == n11 == n_index == {},
          f"configs 9, 10, 11 and the index tool launched kernels: {n9}, "
          f"{n10}, {n11}, {n_index}")
    check(art9["card"] == art10["card"] == art11["card"] == index["card"]
          == card, f"card lines {art9['card']}, {art10['card']}, "
          f"{art11['card']}, {index['card']}")

    modes = art9["modes"]
    errors9 = {m: v["download"]["errors"] for m, v in modes.items()}
    check(art9["files"] == 200 and art9["wrong_bytes"] == 0
          and art9["inode_win_10x"] is True
          and art9["compaction_reclaims_80pct"] is True
          and errors9 == {"flat": 0, "packed": 0},
          f"config 9: files {art9['files']}, wrong bytes "
          f"{art9['wrong_bytes']}, inodes flat / packed "
          f"{art9['inode_delta_flat']} / {art9['inode_delta_packed']}, "
          f"reclaim {(art9['delete_heavy'] or {}).get('reclaim_pct')}%, "
          f"download errors {errors9}")
    for name, m in modes.items():
        print(f"  config 9 {name}: ingest {m['ingest']['qps']} files/s, "
              f"p50/p99 {m['ingest']['lat_p50_us']}/"
              f"{m['ingest']['lat_p99_us']} us; download "
              f"{m['download']['qps']} files/s, p50 "
              f"{m['download']['lat_p50_us']} us; open fds "
              f"{m['daemon_open_fds_after_ingest']}  [{card}]")
    heavy = art9["delete_heavy"]
    print(f"  config 9: inodes flat / packed {art9['inode_delta_flat']} / "
          f"{art9['inode_delta_packed']}, files on disk "
          f"{art9['files_on_disk_delta_flat']} / "
          f"{art9['files_on_disk_delta_packed']}; reclaim "
          f"{heavy['reclaim_pct']}% in {heavy['compactions']} compactions, "
          f"{heavy['byte_checks_during_compaction']} byte checks during "
          f"it; ingest_p50_no_worse {art9['ingest_p50_no_worse']} (packed "
          f"/ flat p50 {art9['ingest_p50_packed_vs_flat']})  [{card}]")

    arms = art10["arms"]
    check(art10["files"] == 60 and art10["zero_errors"] is True
          and art10["three_group_spread_within_10pct"] is True
          and art10["drain_relocated_all"] is True,
          f"config 10: files {art10['files']}, zero errors "
          f"{art10['zero_errors']}, spread "
          f"{arms['three_groups']['group_spread']}, drain "
          f"{arms['three_groups'].get('drain')}")
    for name, arm in arms.items():
        dl = arm["open_download"]
        print(f"  config 10 {name}: open-loop {dl['qps']} of "
              f"{art10['offered_rate_qps']} offered qps, p50/p99 "
              f"{dl['lat_p50_us']}/{dl['lat_p99_us']} us; preload "
              f"{arm['preload']['qps']} qps  [{card}]")
    drain = arms["three_groups"]["drain"]
    print(f"  config 10: open_loop_rate_met_3g "
          f"{art10['open_loop_rate_met_3g']}, p99 three / one "
          f"{art10['p99_three_vs_one']}; drain moved "
          f"{drain['files_moved']} files in {drain['wall_s']} s, "
          f"{drain['pace_mb_s']} MB/s  [{card}]")

    group = art11["group"]
    check(art11["scaled_bytes"] == 12 * 256 * 1024
          and art11["replication_near_2x"] is True
          and art11["efficiency_pass"] is True
          and art11["zero_wrong_bytes"] is True
          and art11["reconstruct_from_parity_only"] is True,
          f"config 11: physical / logical replicated "
          f"{group['replicated_physical_over_logical']}, EC "
          f"{group['ec_physical_over_logical']}, zero wrong bytes "
          f"{art11['zero_wrong_bytes']}, from parity only "
          f"{art11['reconstruct_from_parity_only']}")
    for name in ("replicated_download", "ec_download"):
        dl = group[name]
        print(f"  config 11 {name}: {dl['qps']} qps, p50/p99 "
              f"{dl['lat_p50_us']}/{dl['lat_p99_us']} us  [{card}]")
    for name, r in art11["reconstruction"].items():
        print(f"  config 11 {name} rebuild: {r['shards_rebuilt']} shards "
              f"of {r['stripes']} stripes, {r['rebuilt_bytes']} bytes in "
              f"{r['wall_s']} s, {r['rebuild_mb_s']} MB/s (budget "
              f"{r['bandwidth_budget_mb_s']})  [{card}]")
    print(f"  config 11: physical / logical "
          f"{group['ec_physical_over_logical']} EC against "
          f"{group['replicated_physical_over_logical']} "
          f"replicated; paced_within_budget {art11['paced_within_budget']}, "
          f"pacing_effective {art11['pacing_effective']}  [{card}]")

    keys = ("inserts_per_sec", "max_100k_batch_pause_s",
            "index_bytes_per_entry", "lookup_batch_per_sec",
            "lookup_scalar_per_sec", "remove_per_sec", "final_merge_seconds",
            "snapshot_mb", "snapshot_save_seconds", "snapshot_load_seconds")
    check(index["entries"] == INDEX_N,
          f"index tool entries {index['entries']}")
    print(f"  index tool at {INDEX_N}: "
          + ", ".join(f"{k} {index[k]}" for k in keys) + f"  [{card}]")


# Phase 15: configs 12, 13 and 14 of bench_configs.py, the read path;
# none launches a kernel.
C12_SCALE = 1 / 65536                  # config 12 here: 24 files of 256 KB
C13_SCALE = 1 / 128                    # config 13's default: 12 files of 1 MB
C14_SCALE = 1 / 65536                  # config 14 here: 12 files of 8 KB


def phase_serving_configs(dev, card: str) -> None:
    """Phase 15: each run counted, none may launch a kernel."""
    print(f"phase 15: bench_configs configs 12 at {C12_SCALE}, 13 at "
          f"{C13_SCALE} and 14 at {C14_SCALE} (no kernel)")
    with tempfile.TemporaryDirectory(prefix="fdfs15") as out_dir:
        art12, n12 = counted(lambda: bench_configs.config12(
            out_dir, C12_SCALE, dev.type))
        folded = {name: os.path.isfile(os.path.join(
            out_dir, arm["flamegraph"]["folded_file"]))
            for name, arm in art12["arms"].items()}
        art13, n13 = counted(lambda: bench_configs.config13(
            out_dir, C13_SCALE, dev.type))
        art14, n14 = counted(lambda: bench_configs.config14(
            out_dir, C14_SCALE, dev.type))
    check(n12 == n13 == n14 == {},
          f"configs 12, 13 and 14 launched kernels: {n12}, {n13}, {n14}")
    check(art12["card"] == art13["card"] == art14["card"] == card,
          f"card lines {art12['card']}, {art13['card']}, {art14['card']}")

    arms = art12["arms"]
    fallbacks = {n: a["ranged_verify"]["ranged_fallbacks"]
                 for n, a in arms.items()}
    samples = {n: a["flamegraph"]["samples"] for n, a in arms.items()}
    check(art12["files"] == 24 and art12["zero_errors"] is True
          and art12["wrong_bytes"] == 0
          and fallbacks == {"reactors1": 0, "reactors4": 0}
          and art12["conn_budget_honored"] is True
          and art12["preadv_spans_exceed_batches"] is True
          and art12["accept_spread_within_2x"] is True
          and all(folded.values()) and len(folded) == 2
          and all(v > 0 for v in samples.values()),
          f"config 12: files {art12['files']}, zero errors "
          f"{art12['zero_errors']}, wrong bytes {art12['wrong_bytes']}, "
          f"ranged fallbacks {fallbacks}, budget "
          f"{art12['conn_budget_honored']}, preadv "
          f"{art12['preadv_spans_exceed_batches']}, spread "
          f"{art12['accept_spread_within_2x']}, folded files {folded}, "
          f"samples {samples}")
    for name, arm in arms.items():
        for client, sweep in arm["clients"].items():
            cells = "; ".join(
                f"{c['offered_rate_qps']} offered, {c['qps']} qps, p50/p99 "
                f"{c['lat_p50_us']}/{c['lat_p99_us']} us" for c in sweep)
            print(f"  config 12 {name} {client}: {cells}  [{card}]")
        flame = arm["flamegraph"]
        print(f"  config 12 {name}: {flame['samples']} samples in "
              f"{flame['stacks']} stacks; {flame['capture_note']}; "
              f"conns per reactor "
              f"{arm['accept_burst']['conns_per_reactor']}; preadv "
              f"{arm['preadv']['spans_per_batch']} spans a batch  [{card}]")
    print(f"  config 12: p99 multiplexed / single at 4 reactors "
          f"{art12['p99_multiplexed_vs_single_4r']}, p99 4 / 1 reactors "
          f"multiplexed {art12['p99_4r_vs_1r_multiplexed']}  [{card}]")

    adm = art13["arms"]["admission"]
    check(art13["files"] == 12 and art13["zero_non_shed_errors"] is True
          and art13["interactive_never_shed"] is True,
          f"config 13: files {art13['files']}, zero non-shed errors "
          f"{art13['zero_non_shed_errors']}, interactive never shed "
          f"{art13['interactive_never_shed']}")
    cal = art13["arms"]["baseline"]["calibration"]
    print(f"  config 13: capacity {art13['capacity_qps']} qps (p50/p99 "
          f"{cal['lat_p50_us']}/{cal['lat_p99_us']} us), SLO thresholds "
          f"{art13['slo_request_p99_threshold_ms']} ms request p99, "
          f"{art13['slo_loop_lag_threshold_ms']} ms loop lag; offered "
          f"{art13['offered_rates_qps']}  [{card}]")
    for name, c in (("baseline overload",
                     art13["arms"]["baseline"]["overload"]),
                    ("admission half", adm["half"]),
                    ("admission overload", adm["overload"])):
        print(f"  config 13 {name}: {c['qps']} qps, goodput "
              f"{c['goodput_qps']}, shed {c['shed']}, p50/p99 "
              f"{c['lat_p50_us']}/{c['lat_p99_us']} us  [{card}]")
    print("  config 13: " + ", ".join(
        f"{k} {art13[k]}" for k in (
            "zero_sheds_at_half_capacity", "sheds_under_overload",
            "ladder_engaged", "shed_prefers_background",
            "p99_collapse_ratio", "admitted_p99_bounded_vs_baseline"))
        + f"  [{card}]")

    check(art14["files"] == 12 and art14["hot_promotion_published"] is True
          and art14["routed_reads_flowed"] is True
          and art14["zero_read_errors"] is True,
          f"config 14: files {art14['files']}, published "
          f"{art14['hot_promotion_published']}, routed "
          f"{art14['routed_reads_flowed']}, zero read errors "
          f"{art14['zero_read_errors']}")
    for name, arm in art14["arms"].items():
        m = arm["measured"]
        print(f"  config 14 {name}: capacity "
              f"{arm['closed_loop_capacity_qps']} qps, open-loop {m['qps']} "
              f"of {arm['offered_rate_qps']} offered, p50/p99 "
              f"{m['lat_p50_us']}/{m['lat_p99_us']} us; group shares "
              f"{arm['group_read_shares']}; routed reads "
              f"{arm['hot_route_reads']}  [{card}]")
    print("  config 14: " + ", ".join(
        f"{k} {art14[k]}" for k in (
            "off_group_spread_pp", "on_group_spread_pp",
            "post_promotion_spread_within_10pp", "hot_p99_off_us",
            "hot_p99_on_us", "hot_p99_flatter_with_promotion"))
        + f"  [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke runs only "
              "on a GPU", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    so, build_s, log = _build.build()
    print(f"phase 1: kernels built in {build_s:.2f} s -> {so.name}")
    source = ""
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:]
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {source}: {line.replace('ptxas info    :', '').strip()}")

    rec_sha1 = KernelRecord("sha1", "fastdfs_tpu_torch/csrc/sha1.cu",
                            "fastdfs_tpu/ops/pallas_sha1.py:93")
    rec_sketch = KernelRecord("sketch",
                              "fastdfs_tpu_torch/csrc/minhash_survivor.cu",
                              "fastdfs_tpu/ops/pallas_minhash.py:121")
    rec_gear = KernelRecord("gear_cdc", "fastdfs_tpu_torch/csrc/gear_cdc.cu",
                            "fastdfs_tpu/ops/gear_cdc.py:225", xla=True)
    rec_block = KernelRecord("gear_cdc_block",
                             "fastdfs_tpu_torch/csrc/gear_cdc.cu",
                             "fastdfs_tpu/parallel/ingest_step.py:92-105",
                             xla=True)
    rec_index = KernelRecord("index_query",
                             "fastdfs_tpu_torch/csrc/index_query.cu",
                             "fastdfs_tpu/parallel/ingest_step.py:128-133",
                             xla=True)
    rec_gf = KernelRecord("gf_matmul", "fastdfs_tpu_torch/csrc/gf_matmul.cu",
                          "fastdfs_tpu/ops/rs_code.py:170", xla=True)
    rec_sig = KernelRecord("minhash_sig",
                           "fastdfs_tpu_torch/csrc/minhash_sig.cu",
                           "fastdfs_tpu/ops/minhash.py:127", xla=True)
    rec_sketch_k = KernelRecord("sketch_k",
                                "fastdfs_tpu_torch/csrc/minhash_survivor.cu",
                                "fastdfs_tpu/ops/minhash.py:98", xla=True)
    rec_shingle = KernelRecord("survivor_k",
                               "fastdfs_tpu_torch/csrc/minhash_survivor.cu",
                               "fastdfs_tpu/ops/minhash.py:98", xla=True)
    records = (rec_sha1, rec_sketch, rec_gear, rec_block, rec_index, rec_gf,
               rec_sig, rec_sketch_k, rec_shingle)
    marks = [time.monotonic()]
    seg, cuts = phase_kernels(dev, rec_sha1, rec_sketch, rec_gear,
                              rec_sketch_k, rec_shingle)
    marks.append(time.monotonic())
    (rec_sha1.launches, rec_sketch.launches,
     rec_gear.launches) = phase_socket(dev, card)
    marks.append(time.monotonic())
    phase_profile(dev)
    shingle_n = check_engine_shingle(dev, card)
    rec_sha1.launches += shingle_n["sha1_ragged_cuda"]
    rec_sketch_k.launches += shingle_n["sketch_ragged_cuda"]
    marks.append(time.monotonic())
    sha1_n, gear_n = phase_client(dev, card)
    rec_sha1.launches += sha1_n
    rec_gear.launches += gear_n
    marks.append(time.monotonic())
    rec_sha1.launches += phase_streaming(dev, card, seg, cuts)
    marks.append(time.monotonic())
    rec_gf.launches = phase_rs(dev, card, rec_gf)
    marks.append(time.monotonic())
    (sha1_n, sketch_n, rec_block.launches, rec_index.launches, sig_n,
     sketch_k_n, shingle_n) = phase_parallel(dev, card, seg, cuts, rec_block,
                                             rec_index, rec_sig)
    rec_sha1.launches += sha1_n
    rec_sketch.launches += sketch_n
    rec_sig.launches += sig_n
    rec_sketch_k.launches += sketch_k_n
    rec_shingle.launches += shingle_n
    marks.append(time.monotonic())
    storaged, trackerd, native_s = native.native_binaries()
    print(f"native daemons: {storaged}, {trackerd} ready in {native_s:.1f} s")
    files = live_corpus()
    marks.append(time.monotonic())
    for phase in (lambda: phase_live(dev, card, files, storaged),
                  lambda: phase_cluster(dev, card, files, storaged,
                                        trackerd)):
        sha1_n, sketch_n, gear_n = phase()
        rec_sha1.launches += sha1_n
        rec_sketch.launches += sketch_n
        rec_gear.launches += gear_n
        marks.append(time.monotonic())
    n = phase_benches(dev, card)
    rec_sha1.launches += n.get("sha1_batch_cuda", 0)
    rec_sketch.launches += (n.get("minhash_batch_cuda", 0)
                            + n.get("survivor_segmin_cuda", 0))
    rec_sig.launches += n.get("signature_tiles_cuda", 0)
    rec_block.launches += n.get("block_candidates_cuda", 0)
    rec_index.launches += n.get("index_best_cuda", 0)
    marks.append(time.monotonic())
    phase_daemon_configs(dev, card)
    marks.append(time.monotonic())
    n = phase_host_configs(dev, card)
    rec_sha1.launches += n["sha1_ragged_cuda"]
    rec_gear.launches += n["gear_candidates_cuda"]
    marks.append(time.monotonic())
    phase_group_configs(dev, card)
    marks.append(time.monotonic())
    phase_serving_configs(dev, card)
    marks.append(time.monotonic())
    idle = [r.name for r in records if not r.launches]
    check(not idle, f"kernels never launched on the main path: {idle}")

    print(f"chip_smoke finished in {time.monotonic() - t_start:.1f} s "
          f"(phases 2-8, the daemons' build and corpus, phases 9-15: "
          + ", ".join(
              f"{b - a:.1f}" for a, b in zip(marks, marks[1:])) + " s)")
    print(card)
    print(json.dumps({"kernels": [r.json() for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
