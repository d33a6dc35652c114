"""GF(2^8) field tables and scalar arithmetic: the port of
``fastdfs_tpu/ops/gf256.py``.

The classic Reed-Solomon field: polynomial ``POLY = 0x11D``, generator 2.
The reference checks in generated tables; the port builds the same tables
at import from those two constants (``tests/test_torch_ec.py`` pins them
to the reference's).  ``GF_EXP`` is doubled (510 entries) so that
multiplication via logs needs no modular reduction; ``GF_LOG[0]`` is a
placeholder (zero has no log: ``gf_mul`` and ``gf_div`` short-circuit a
zero operand before reading it).
"""

from __future__ import annotations

POLY = 0x11D


def _tables() -> tuple[tuple[int, ...], tuple[int, ...]]:
    exp = [0] * 510
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return tuple(exp), tuple(log)


GF_EXP, GF_LOG = _tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return GF_EXP[GF_LOG[a] + GF_LOG[b]]


def gf_inv(a: int) -> int:
    """Field inverse; a must be non-zero (gf_inv(0) is a caller bug)."""
    return GF_EXP[255 - GF_LOG[a]]


def gf_div(a: int, b: int) -> int:
    """a / b in the field; b must be non-zero."""
    if a == 0:
        return 0
    return GF_EXP[GF_LOG[a] + 255 - GF_LOG[b]]


def cauchy_coeff(k: int, j: int, i: int) -> int:
    """Systematic Cauchy parity coefficient C[j][i] for RS(k, m):
    inv(x_i ^ a_j) with x_i = i, a_j = k + j — every k x k submatrix
    of [I; C] is invertible (requires k + m <= 255)."""
    return gf_inv(i ^ (k + j))
