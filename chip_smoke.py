#!/usr/bin/env python3
"""On-card smoke of fastdfs_tpu_torch: the dedup sidecar's fingerprint path.

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
   and the padded ``(N, L)`` adapters at 256 x 2048.
3. The main path through the socket: the port's DedupSidecar serves in a
   thread; a seeded 256 MB corpus (A; B = A with scattered edits; C = a
   copy of A; D unique), 64 MB per file, goes in as one
   DEDUP_FINGERPRINT_CUTS segment each for A, B and C (cut by the host
   chunker, as the daemon's chunker would) and one DEDUP_FINGERPRINT
   segment for D (chunked on the card), then DEDUP_NEARDUPS for B and a
   DEDUP_VERIFY batch with one corrupted chunk.  Every digest is checked
   against hashlib, the file signatures against the plain twins, the
   dedup / near-dup / verify verdicts, and that each 64 MB request
   launched each kernel exactly once (verify: one SHA-1 launch).
4. Where one segment's engine time goes: a torch.profiler pass over
   ``DedupEngine.fingerprint``, device time by kernel and the idle share.

The second-to-last line is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
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

from fastdfs_tpu_torch.common import protocol
from fastdfs_tpu_torch.dedup.engine import SEGMENT_SLACK, DedupConfig
from fastdfs_tpu_torch.ops import _build, minhash, sha1
from fastdfs_tpu_torch.ops.cuda_minhash import (minhash_batch_cuda,
                                                sketch_ragged_cuda,
                                                survivor_ragged_cuda,
                                                survivor_segmin_cuda)
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_batch_cuda, sha1_ragged_cuda
from fastdfs_tpu_torch.ops.gear_cdc import chunk_stream_np
from fastdfs_tpu_torch.sidecar import DedupSidecar

SEED = 20261016
SEGMENT = 64 << 20                     # storage.conf dedup_segment_bytes
PLAIN_ROW_TILE = 4096                  # plain twins' tiles on the card
TIMED_LAUNCHES = 20

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
#   segment flush, one per position.  5 + 1 = 6.
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

_I64 = struct.Struct(">q")


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def i64(t: torch.Tensor) -> np.ndarray:
    """uint32 tensor on any device -> int64 numpy with the same values."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32).astype(np.int64)


def median_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def once_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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


def sketch_bound(lens: np.ndarray, survivors: int) -> tuple[float, str]:
    """(ms, by) of one fused sketch launch: each chunk byte and its
    offset, length and order entry read once and 256 signature bytes
    written per chunk, against
    the positions p <= bound and stage 4 over this run's non-EMPTY
    segment minima."""
    lens = lens.astype(np.int64)
    bound = np.where(lens >= 5, lens - 5, np.maximum(lens, 1) - 1)
    t_bytes = float(lens.sum() + 272 * len(lens)) / HBM_BYTES_PER_S
    ops = ((bound + 1).sum() * SURVIVOR_OPS_PER_POSITION
           + survivors * 64 * STAGE4_OPS_PER_SURVIVOR_PERM)
    t_ops = float(ops) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


class KernelRecord:
    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.bound_by = ""
        self.max_abs_err = 0
        self.launches = 0

    def json(self):
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": self.launches,
                "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": self.bound_by, "library_ms": None}


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
    check(np.array_equal(i64(survivor_ragged_cuda(d_seg, d_off, d_len, d_ord)),
                         i64(z)),
          f"sketch kernel's stages 1-3 != plain twin on the {what}")
    rec_sketch.max_abs_err = max(rec_sketch.max_abs_err, err)
    if timed:
        words = minhash.perm_words(64, dev)
        rec_sketch.ms = median_ms(lambda: sketch_ragged_cuda(
            d_seg, d_off, d_len, words, d_ord))
        rec_sketch.plain_ms = plain_ms
        rec_sketch.bound_ms, rec_sketch.bound_by = sketch_bound(
            np.asarray(lens), survivors)
        print(f"  {what}: {len(lens)} chunks, longest {max(lens)} B, "
              f"{survivors} survivors; sha1 {rec_sha1.ms:.4f} ms (plain "
              f"{rec_sha1.plain_ms:.1f}, bound {rec_sha1.bound_ms:.4f} by "
              f"{rec_sha1.bound_by}); sketch {rec_sketch.ms:.4f} ms (plain "
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


def phase_kernels(dev, rec_sha1, rec_sketch) -> None:
    rng = np.random.default_rng(SEED)
    print("phase 2: ragged kernels vs plain twins on the card (ms = one "
          "launch over the whole segment; bound = least time for its work)")
    seg = rng.integers(0, 256, SEGMENT, dtype=np.uint8).tobytes()
    cuts = chunk_stream_np(seg)
    offsets = [0] + cuts[:-1]
    lens = [b - a for a, b in zip(offsets, cuts)]
    check_segment(dev, f"{SEGMENT >> 20} MB segment", seg, offsets, lens,
                  rec_sha1, rec_sketch, timed=True)
    seg, offsets, lens = edge_segment(rng)
    check_segment(dev, "edge segment", seg, offsets, lens, rec_sha1,
                  rec_sketch, timed=False)
    check_whole_segment_chunk(dev, rng)
    check_padded_adapters(dev, rng)


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


def phase_socket(dev, card: str) -> tuple[int, int]:
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
        sha1_ragged_cuda.launches = 0
        sketch_ragged_cuda.launches = 0
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
            counts = (sha1_ragged_cuda.launches, sketch_ragged_cuda.launches)
            t0 = time.monotonic()
            status, resp = client.call(cmd, body)
            latency[name] = time.monotonic() - t0
            engine_ms[name] = (engine_us(client) - before) / 1e3
            per_request[name] = (sha1_ragged_cuda.launches - counts[0],
                                 sketch_ragged_cuda.launches - counts[1])
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
        counts = (sha1_ragged_cuda.launches, sketch_ragged_cuda.launches)
        status, mask = client.call(C.DEDUP_VERIFY, body + b"".join(payloads))
        check(status == 0 and mask == bytes(5) + b"\x01" + bytes(26),
              f"verify flagged {mask!r} (status {status})")
        per_request["verify"] = (sha1_ragged_cuda.launches - counts[0],
                                 sketch_ragged_cuda.launches - counts[1])
        launches = (sha1_ragged_cuda.launches, sketch_ragged_cuda.launches)
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
          f"sketch {launches[1]}; per request (sha1/sketch): "
          + ", ".join(f"{k} {v[0]}/{v[1]}" for k, v in per_request.items()))
    for name in "ABCD":
        check(per_request[name] == (1, 1),
              f"{name}: {per_request[name]} launches, not one of each kernel")
    check(per_request["verify"] == (1, 0), "verify: not one sha1 launch")
    return launches


def phase_profile(dev) -> None:
    """Where one 64 MB 125 segment's engine time goes: a torch.profiler
    pass over DedupEngine.fingerprint (after the counters were read, so
    these launches are not counted), device time summed by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from fastdfs_tpu_torch.dedup.engine import DedupEngine

    rng = np.random.default_rng(SEED + 2)
    data = rng.integers(0, 256, SEGMENT, dtype=np.uint8).tobytes()
    cuts = chunk_stream_np(data)
    engine = DedupEngine(DedupConfig(), device=dev)
    engine.fingerprint(data, cuts=cuts)              # staging allocated
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.fingerprint(data, cuts=cuts)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    groups = {"sha1 kernel": 0.0, "sketch kernel": 0.0, "copies": 0.0,
              "other device ops": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        if "sha1_ragged_kernel" in ev.key:
            groups["sha1 kernel"] += us
        elif "sketch_ragged_kernel" in ev.key:
            groups["sketch kernel"] += us
        elif "Memcpy" in ev.key or "Memset" in ev.key:
            groups["copies"] += us
        else:
            groups["other device ops"] += us
    busy_ms = sum(groups.values()) / 1e3
    print(f"phase 4: engine.fingerprint on one {SEGMENT >> 20} MB segment "
          f"with cuts, under torch.profiler: wall {wall_ms:.1f} ms")
    if busy_ms == 0.0:
        print("  device time: not measured (the profiler saw no device "
              "activity)")
        return
    for name, us in groups.items():
        print(f"  device {name}: {us / 1e3:.3f} ms")
    print(f"  device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} of the call's wall time")


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
    phase_kernels(dev, rec_sha1, rec_sketch)
    rec_sha1.launches, rec_sketch.launches = phase_socket(dev, card)
    phase_profile(dev)

    print(f"chip_smoke finished in {time.monotonic() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [rec_sha1.json(), rec_sketch.json()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
