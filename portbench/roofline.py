"""Peaks of the card and the least time each kernel's work needs.

A kernel's roofline time is the larger of its bytes over the memory
bandwidth and its operations over the 32-bit integer rate; its roofline
share is that time over the device time it took.  The counts are the
derivations of ``chip_smoke.py`` (the fewest sm_90a integer instructions
the work needs), copied here so that the yardstick does not move with the
program:

- SHA-1, per 64-byte block after padding: 16 byte swaps (PRMT); 64
  schedule words of two LOP3 and one SHF; 80 rounds of one SHF, one LOP3,
  two IADD3 and one SHF; 5 IADD3 into the state: 613.  Bytes: each chunk
  byte, and its 8-byte offset, 4-byte length and 4-byte order entry, read
  once; 20 bytes written a chunk.
- The survivor sketch at shingle width 5, per byte position that starts
  a window: one PRMT, two IMAD (the rolled hash), one LOP3 (the sample
  test), one IMNMX (the segment minimum) and one for the word's address
  and loop: 6.  Stage 4: one IMAD and one IMNMX per non-empty segment
  minimum and permutation: 2.  Bytes: each chunk byte and its table
  entries read once; 256 signature bytes written a chunk.

SHA-1's dependent chain (the longest chunk's blocks x 80 rounds x 2
dependent instructions x an assumed 4 cycles, after Jia et al.,
arXiv:1804.06826, measured on Volta) is a latency assumed for Hopper,
not a peak of this card, so it is printed beside the roofline and never
divides into it.
"""

from __future__ import annotations

import numpy as np

# Published peaks by the name ``torch.cuda.get_device_name`` gives: the
# HBM bandwidth of the data sheet, and the INT32 rate as 132 SMs x 64
# results a clock x the 1.98 GHz boost clock (SXM part, 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "int32_ops_per_s": 132 * 64 * 1.98e9,
        "sm_clock_hz": 1.98e9,
    },
}

SHA1_OPS_PER_BLOCK = 613
SHA1_TABLE_BYTES = 8 + 4 + 4 + 20
SKETCH_OPS_PER_POSITION = 6
STAGE4_OPS_PER_SURVIVOR_PERM = 2
SKETCH_TABLE_BYTES = 8 + 4 + 4 + 256
SHA1_CHAIN_INSTR_PER_ROUND = 2
ALU_LATENCY_CYCLES = 4


def sha1_blocks(lens: np.ndarray) -> np.ndarray:
    """64-byte blocks a chunk hashes, padding and length included."""
    return (np.asarray(lens, dtype=np.int64) + 8) // 64 + 1


def sha1_seconds(lens: np.ndarray, peak: dict) -> float:
    lens = np.asarray(lens, dtype=np.int64)
    t_bytes = float(lens.sum() + SHA1_TABLE_BYTES * len(lens)) \
        / peak["hbm_bytes_per_s"]
    t_ops = float(sha1_blocks(lens).sum() * SHA1_OPS_PER_BLOCK) \
        / peak["int32_ops_per_s"]
    return max(t_bytes, t_ops)


def sha1_chain_seconds(lens: np.ndarray, peak: dict) -> float:
    return (float(sha1_blocks(lens).max()) * 80 * SHA1_CHAIN_INSTR_PER_ROUND
            * ALU_LATENCY_CYCLES / peak["sm_clock_hz"])


def sketch_seconds(lens: np.ndarray, survivors: int, perms: int, k: int,
                   peak: dict) -> float:
    """``survivors`` counts the non-empty segment minima stage 4 reads."""
    lens = np.asarray(lens, dtype=np.int64)
    starts = np.where(lens >= k, lens - k + 1, np.maximum(lens, 1))
    t_bytes = float(lens.sum() + SKETCH_TABLE_BYTES * len(lens)) \
        / peak["hbm_bytes_per_s"]
    ops = (starts.sum() * SKETCH_OPS_PER_POSITION
           + survivors * perms * STAGE4_OPS_PER_SURVIVOR_PERM)
    return max(t_bytes, float(ops) / peak["int32_ops_per_s"])
