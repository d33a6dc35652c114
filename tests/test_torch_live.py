"""The real storage daemon on the port's sidecar and the port's client.

One ``fdfs_storaged`` (no tracker) runs with ``dedup_mode = sidecar``
against ``fastdfs_tpu_torch.sidecar --platform cpu`` in a subprocess, and
the port's ``StorageClient(..., device="cpu")`` drives it: plain uploads
become recipes through the sidecar's DEDUP_FINGERPRINT_CUTS, a negotiated
re-upload ships 0 bytes, NEAR_DUPS and the scrubber's DEDUP_VERIFY go
through the port's sidecar, and killing the sidecar fails the daemon open
to flat storage.  These are the setups of tests/test_chunked_storage.py
and tests/test_dedup_upload.py without the tracker.

The sidecar starts through a small launcher that swaps the SHA-1 kernel
wrapper, in the engine and in the sidecar's verify path, for hashlib: on
the CPU the kernel's plain PyTorch twin takes about 10 s per MB of 64 KiB
chunks (the daemon's own chunk geometry), beyond the daemon's 60 s RPC
timeout.  The twin is held to hashlib by tests/test_torch_sha1.py and
tests/test_torch_ragged.py; the sketch still runs its plain twin here.
On the card, ``chip_smoke.py`` phase 9 runs this system with the kernels.
"""

import contextlib
import glob
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from fastdfs_tpu_torch.client import StorageClient
from tests import torch_native
from tests.harness import chunk_digests, corrupt_chunk, recipe_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/torch_native.py builds the daemons with g++ and ar unless the
# checkout's native/build/ holds both.
_HAVE_TOOLCHAIN = (shutil.which("g++") is not None
                   and shutil.which("ar") is not None)
_HAVE_BINARIES = all(os.path.exists(os.path.join(torch_native.NATIVE, "build",
                                                 name))
                     for name in ("fdfs_storaged", "fdfs_trackerd"))
needs_native = pytest.mark.skipif(
    not (_HAVE_TOOLCHAIN or _HAVE_BINARIES),
    reason="no native toolchain and no prebuilt daemons")

# No periodic scrub (kicks drive it), short GC grace.
SCRUB = "scrub_interval_s = 0\nchunk_gc_grace_s = 1"

_LAUNCHER = r"""
import hashlib, sys
import numpy as np
import torch
from fastdfs_tpu_torch import sidecar
from fastdfs_tpu_torch.dedup import engine

def sha1_hashlib(seg, offsets, lens, order=None, out=None, row_tile=256):
    buf = seg.numpy()
    raw = b"".join(hashlib.sha1(buf[o:o + n]).digest()
                   for o, n in zip(offsets.tolist(), lens.tolist()))
    words = np.frombuffer(raw, dtype=">u4").astype(np.uint32)
    if out is None:
        out = torch.empty((len(lens), 5), dtype=torch.int32)
    out.copy_(torch.from_numpy(words.view(np.int32).reshape(-1, 5)))
    return out.view(torch.uint32)

engine.sha1_ragged_cuda = sha1_hashlib
sidecar.sha1_ragged_cuda = sha1_hashlib
sys.exit(sidecar.main(sys.argv[1:]))
"""


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fail the test, instead of hanging the suite, past ``seconds``."""
    def expired(*_):
        raise TimeoutError(f"live test ran past its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _wait(pred, timeout=30.0, every=0.25):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(every)
    return pred()


class PortSidecar:
    """``fastdfs_tpu_torch.sidecar --platform cpu`` in a subprocess."""

    def __init__(self, tmp_path):
        self.sock = os.path.join(str(tmp_path), "dedup.sock")
        self.log = os.path.join(str(tmp_path), "sidecar.log")
        with open(self.log, "wb") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", _LAUNCHER, "--socket", self.sock,
                 "--platform", "cpu", "--snapshot-interval", "3600"],
                cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
        deadline = time.time() + 90
        while time.time() < deadline:
            assert self.proc.poll() is None, self.log_text()
            try:
                self.stats()
                return
            except OSError:
                time.sleep(0.2)
        self.kill()
        raise TimeoutError("the port's sidecar did not come up")

    def stats(self) -> dict:
        """The sidecar's request counters (DEDUP_COMMIT ``stats``)."""
        import json
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(30)
            s.connect(self.sock)
            s.sendall(struct.pack(">qBB", 5, 122, 0) + b"stats")
            hdr = b""
            while len(hdr) < 10:
                got = s.recv(10 - len(hdr))
                if not got:
                    raise OSError("sidecar closed the connection")
                hdr += got
            n = struct.unpack(">q", hdr[:8])[0]
            body = b""
            while len(body) < n:
                body += s.recv(n - len(body))
        return json.loads(body)

    def log_text(self) -> str:
        with open(self.log, "rb") as fh:
            return fh.read().decode(errors="replace")

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)


@contextlib.contextmanager
def live_system(tmp_path):
    # The daemon comes from tests/torch_native.py (its locked g++ build,
    # unless native/build/ holds both daemons), not from tests/harness.py,
    # whose ninja another test worker may be relinking at this moment.
    storaged, _, _ = torch_native.native_binaries()
    sidecar = PortSidecar(tmp_path)
    base = os.path.join(str(tmp_path), "st")
    daemon = None
    try:
        daemon = torch_native.start_storage(storaged, base,
                                            dedup_mode="sidecar",
                                            dedup_sidecar=sidecar.sock,
                                            extra=SCRUB)
        yield sidecar, daemon, base
    finally:
        if daemon is not None:
            daemon.stop()
        sidecar.kill()


def _payloads(seed, shared_mb=1, tail_kb=96):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, shared_mb << 20, dtype=np.uint8).tobytes()
    tails = rng.integers(0, 256, 2 * (tail_kb << 10),
                         dtype=np.uint8).tobytes()
    return shared + tails[:tail_kb << 10], shared + tails[tail_kb << 10:]


def _is_recipe(base, fid):
    return os.path.basename(fid) + ".rcp" in recipe_keys(base)


def _is_flat(base, fid):
    return any(os.path.isfile(p) for p in glob.glob(os.path.join(
        base, "data", "**", os.path.basename(fid)), recursive=True))


def _client(daemon):
    return StorageClient("127.0.0.1", daemon.port, timeout=120.0,
                         device="cpu")


@needs_native
def test_uploads_become_recipes_and_reupload_ships_nothing(tmp_path):
    with time_limit(240), live_system(tmp_path) as (sidecar, daemon, base):
        a, b = _payloads(seed=1)
        with _client(daemon) as sc:
            fa = sc.upload_buffer(a, ext="bin")
            fb = sc.upload_buffer(b, ext="bin")
            assert _is_recipe(base, fa) and _is_recipe(base, fb)
            assert not _is_flat(base, fa) and not _is_flat(base, fb)
            # The chunk store holds far less than the logical bytes.
            unique = sum(chunk_digests(base).values())
            assert unique < 0.7 * (len(a) + len(b)), unique
            assert sc.download_to_buffer(fa) == a
            assert sc.download_to_buffer(fb) == b
            off = (1 << 20) - 7
            assert sc.download_to_buffer(fb, off, 4321) == b[off:off + 4321]
            # Both went through the port's sidecar.
            stats = sidecar.stats()
            assert stats["fingerprint_bytes"] == len(a) + len(b), stats
            assert stats["chunks"] > 0

            # A negotiated re-upload, fingerprinted by the port's client,
            # finds every chunk in the store and ships 0 bytes.
            up = {}
            fc = sc.upload_buffer_dedup(a, ext="bin", stats=up)
            assert up["fallback"] == "", up
            assert up["chunks_missing"] == 0 and up["bytes_sent"] == 0, up
            assert up["chunks_total"] > 1
            assert _is_recipe(base, fc)
            assert sc.download_to_buffer(fc) == a
            # ...and the daemon fed it through the sidecar to index it.
            after = sidecar.stats()
            assert after["fingerprint_bytes"] == stats["fingerprint_bytes"] \
                + len(a), after


@needs_native
def test_near_dups_through_the_port_sidecar(tmp_path):
    with time_limit(240), live_system(tmp_path) as (sidecar, daemon, base):
        a, b = _payloads(seed=2)
        rng = np.random.default_rng(3)
        d = rng.integers(0, 256, len(a), dtype=np.uint8).tobytes()
        with _client(daemon) as sc:
            fa = sc.upload_buffer(a, ext="bin")
            fd = sc.upload_buffer(d, ext="bin")
            fb = sc.upload_buffer(b, ext="bin")
            near = _wait(lambda: sc.near_dups(fb), timeout=20)
            assert near and near[0][0] == fa, near
            assert fd not in [ref for ref, _ in near[:1]]
            assert all(0.0 <= score <= 1.0 for _, score in near)
            # A file the sidecar never indexed has no signature.
            flat = sc.upload_buffer(b"tiny", ext="txt")
            assert sc.near_dups(flat) == []


@needs_native
def test_scrub_verifies_through_the_port_sidecar(tmp_path):
    with time_limit(240), live_system(tmp_path) as (sidecar, daemon, base):
        a, _ = _payloads(seed=4)
        with _client(daemon) as sc:
            fa = sc.upload_buffer(a, ext="bin")
            assert _is_recipe(base, fa)
            before = sidecar.stats()
            corrupt_chunk(base)
            sc.scrub_kick()
            status = _wait(lambda: (lambda s: s if s["passes"] >= 1
                                    else None)(sc.scrub_status()), timeout=60)
            assert status, sc.scrub_status()
            assert status["chunks_corrupt"] >= 1, status
            assert status["chunks_verified"] >= len(chunk_digests(base)) - 1
        after = sidecar.stats()
        # The scrubber's DEDUP_VERIFY reached the sidecar, which answered
        # it (a failed verify is logged and answered EIO).
        assert after["requests"] > before["requests"] + 1, (before, after)
        assert after["fingerprint_bytes"] == before["fingerprint_bytes"]
        assert "batched verify failed" not in sidecar.log_text()


@needs_native
def test_daemon_fails_open_when_the_port_sidecar_dies(tmp_path):
    with time_limit(240), live_system(tmp_path) as (sidecar, daemon, base):
        a, b = _payloads(seed=5)
        with _client(daemon) as sc:
            fa = sc.upload_buffer(a, ext="bin")
            assert _is_recipe(base, fa)
            sidecar.kill()
            fb = sc.upload_buffer(b, ext="bin")
            assert _is_flat(base, fb) and not _is_recipe(base, fb)
            assert sc.download_to_buffer(fa) == a
            assert sc.download_to_buffer(fb) == b
