"""Anti-leech HTTP token.

The port's copy of ``fastdfs_tpu/common/http_token.py``.

Reference: ``common/fdfs_http_shared.c`` — fdfs_http_gen_token() /
fdfs_http_check_token(): ``token = md5(file_uri + secret_key + ts)`` as a
32-char lowercase hex string, carried as ``?token=...&ts=...`` by the web
edge; valid while |now - ts| is within the configured ttl.  Bit-compatible
with native/common/http_token.cc (cross-checked by golden tests).
"""

from __future__ import annotations

import hashlib
import hmac


def http_gen_token(file_uri: str, secret: str, ts: int) -> str:
    payload = file_uri.encode() + secret.encode() + str(ts).encode()
    return hashlib.md5(payload).hexdigest()


def http_check_token(token: str, file_uri: str, secret: str, ts: int,
                     now: int, ttl_seconds: int) -> bool:
    if ttl_seconds > 0 and abs(now - ts) > ttl_seconds:
        return False
    return hmac.compare_digest(token, http_gen_token(file_uri, secret, ts))
