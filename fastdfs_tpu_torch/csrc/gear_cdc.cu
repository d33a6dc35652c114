// Gear CDC on the card: the windowed gear hash at every byte position and
// its cut candidates, in one of two forms.
//
// Replaces device code that the reference leaves to XLA (jitted, not a
// Pallas kernel): fastdfs_tpu/ops/gear_cdc.py:gear_candidates (jit at
// :225, over gear_hashes at :189, lane-folded at :95-96 and :203-213) and
// the ingest step's stage-1 CDC (fastdfs_tpu/parallel/ingest_step.py:
// 92-105).  Both compute, for every position i,
//
//     h[i] = sum_{k=0..31} gear[b[i-k]] << k   (mod 2^32),
//     gear[x] = fmix32(x + 1),
//
// with zero gear values before the first byte (not zero bytes: byte 0
// has the value fmix32(1)), and call i a candidate where the low
// avg_bits of h[i] are zero.
//
// - Compacted form (fdfs_gear_candidates): the first k candidate
//   positions below n, sorted, padded with the buffer's length, and the
//   total count of candidates below n.  Three launches: a count pass
//   (one int64 per tile), an exclusive scan of the tile counts in one
//   block, and a write pass that hashes the tile again and stores each
//   candidate at its rank.  Hashing twice costs one more read of the
//   buffer, far less than writing h out (4 bytes a position).  The write
//   pass also fills the unused slots with the pad value.
// - Dense form with a halo (fdfs_gear_block_mask): uint8 rows (B, L),
//   each with the gear values of the 31 bytes before it (B, 31), give a
//   bool mask (B, L); one launch.
//
// Design.  (h << 1) pushes a byte's term out of 32 bits after 32 steps,
// so h at any position is the serial rolling value after a 32-byte
// warm-up.  A block stages a tile of 16 KiB plus the 32 bytes before it
// in shared memory, as 4-byte words; each of its 256 threads rolls
// h = (h << 1) + fmix32(b + 1) over its own run of 64 positions in
// native 32-bit arithmetic, after rolling the 32 bytes before the run,
// and keeps the run's candidates as one 64-bit mask.  The staged words
// carry one spare word after every 16, so the 32 threads of a warp,
// whose runs start 16 words apart, read 32 different banks.  Positions
// before the row's first byte take the halo's values (zero in the
// compacted form); positions at or past the limit (n, or L) are never
// candidates.
//
// What bounds it on an H100: one read of the buffer (and, in the dense
// form, one byte written a position): 0.020 ms per 2^26 bytes.  With the
// gear table looked up, a position needs about 4 integer instructions
// (chip_smoke.py, CDC_OPS_PER_POSITION), under the bytes.  This kernel
// computes fmix32 inline instead, about 9 instructions more, and its
// warm-up adds half a run (32 of 64 positions) of hashing; the next
// step is the table in shared memory, one copy per bank (entry
// [byte][lane]), so that a warp's 32 lookups never conflict.
//
// Contract: data uint8 with len bytes (1-D, contiguous), 0 <= n <= len,
// 0 <= avg_bits <= 32, k >= 0; out int64 (k + 1): positions, then the
// count; scratch int64 (ceil(n / 16384) + 1).  rows uint8 with
// row_stride bytes between rows and unit stride within one; halo int64
// (B, 31), contiguous, values in [0, 2^32); out bool (B, L), contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 64;                       // positions per thread
constexpr int kTile = kThreads * kRun;         // positions per block
constexpr int kWarm = 32;                      // bytes rolled before a run
constexpr int kWords = (kWarm + kTile) / 4;    // staged words per tile
constexpr int kSlots = kWords + kWords / 16 + 1;
constexpr int kHalo = 31;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int slot(int q) { return q + (q >> 4); }

__device__ __forceinline__ uint32_t gear(uint32_t byte) {
  uint32_t x = byte + 1u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t low_mask(int avg_bits) {
  return avg_bits >= 32 ? 0xFFFFFFFFu : (1u << avg_bits) - 1u;
}

// Stage bytes [base - 32, base + kTile) of a row of `len` bytes as words;
// bytes outside the row read as 0 (their gear values are never used).
__device__ __forceinline__ void stage_tile(uint32_t* s, const uint8_t* row,
                                           long long len, long long base) {
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 3) == 0;
  for (int q = threadIdx.x; q < kWords; q += kThreads) {
    const long long p = base - kWarm + 4ll * q;
    uint32_t w = 0;
    if (aligned && p >= 0 && p + 4 <= len) {
      w = __ldg(reinterpret_cast<const uint32_t*>(row + p));
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (p + b >= 0 && p + b < len) {
          w |= static_cast<uint32_t>(__ldg(row + p + b)) << (8 * b);
        }
      }
    }
    s[slot(q)] = w;
  }
}

// This thread's 64-position run of the staged tile: bit j of the result
// is set where position base + 64 * threadIdx.x + j is a candidate below
// `limit`.  `halo` (31 gear values, or null for zeros) stands before the
// row's first byte.
__device__ __forceinline__ unsigned long long run_mask(
    const uint32_t* s, long long base, long long limit, uint32_t mask,
    const long long* halo) {
  const int t = threadIdx.x;
  const int w0 = 16 * t;  // the run's warm-up words; its own follow
  uint32_t h = 0;
  if (base == 0 && t == 0) {
    if (halo != nullptr) {
#pragma unroll
      for (int j = 0; j < kHalo; ++j) {
        h = (h << 1) + static_cast<uint32_t>(halo[j]);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kWarm / 4; ++q) {
      const uint32_t w = s[slot(w0 + q)];
#pragma unroll
      for (int b = 0; b < 4; ++b) h = (h << 1) + gear((w >> (8 * b)) & 0xFFu);
    }
  }
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int q = 0; q < kRun / 4; ++q) {
    const uint32_t w = s[slot(w0 + kWarm / 4 + q)];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      h = (h << 1) + gear((w >> (8 * b)) & 0xFFu);
      const uint32_t hit = (h & mask) == 0 ? 1u : 0u;
      const int j = 4 * q + b;
      if (j < 32) {
        lo |= hit << j;
      } else {
        hi |= hit << (j - 32);
      }
    }
  }
  unsigned long long bits =
      (static_cast<unsigned long long>(hi) << 32) | lo;
  const long long valid = limit - (base + kRun * t);
  if (valid <= 0) return 0ull;
  if (valid < kRun) bits &= (1ull << valid) - 1ull;
  return bits;
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block must call it.
template <int kN, typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sums[kN / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T up = __shfl_up_sync(0xFFFFFFFFu, inc, off);
    if (lane >= off) inc += up;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kN / 32 ? warp_sums[lane] : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T up = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += up;
    }
    if (lane < kN / 32) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const T before = warp == 0 ? T(0) : warp_sums[warp - 1];
  *total = warp_sums[kN / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + inc - v;
}

__global__ void __launch_bounds__(kThreads)
    gear_count_kernel(const uint8_t* __restrict__ data, long long len,
                      long long n, int avg_bits,
                      long long* __restrict__ tile_counts) {
  __shared__ uint32_t s[kSlots];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  stage_tile(s, data, len, base);
  __syncthreads();
  const int c = __popcll(run_mask(s, base, n, low_mask(avg_bits), nullptr));
  int total;
  block_exclusive_scan<kThreads, int>(c, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// In place: tile counts -> exclusive prefixes; [tiles] and out[k] get
// the total.  One block.
__global__ void __launch_bounds__(kScanThreads)
    gear_scan_kernel(long long* __restrict__ tile_counts, int tiles,
                     long long* __restrict__ count_out) {
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, tiles);
  const int hi = min(lo + per, tiles);
  long long sum = 0;
  for (int i = lo; i < hi; ++i) sum += tile_counts[i];
  long long total;
  long long run = block_exclusive_scan<kScanThreads, long long>(sum, &total);
  for (int i = lo; i < hi; ++i) {
    const long long c = tile_counts[i];
    tile_counts[i] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    tile_counts[tiles] = total;
    *count_out = total;
  }
}

__global__ void __launch_bounds__(kThreads)
    gear_write_kernel(const uint8_t* __restrict__ data, long long len,
                      long long n, int avg_bits,
                      const long long* __restrict__ prefix, int tiles,
                      long long k, long long* __restrict__ out) {
  __shared__ uint32_t s[kSlots];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  stage_tile(s, data, len, base);
  __syncthreads();
  unsigned long long bits =
      run_mask(s, base, n, low_mask(avg_bits), nullptr);
  int block_total;
  const int mine = block_exclusive_scan<kThreads, int>(__popcll(bits),
                                                       &block_total);
  long long idx = prefix[blockIdx.x] + mine;
  const long long p0 = base + kRun * threadIdx.x;
  while (bits != 0ull && idx < k) {
    const int j = __ffsll(static_cast<long long>(bits)) - 1;
    out[idx++] = p0 + j;
    bits &= bits - 1ull;
  }
  // Slots past the last candidate hold the pad value.
  const long long total = prefix[tiles];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = total + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < k; i += stride) {
    out[i] = len;
  }
}

__global__ void __launch_bounds__(kThreads)
    gear_block_kernel(const uint8_t* __restrict__ rows, long long row_stride,
                      long long L, const long long* __restrict__ halo,
                      int avg_bits, bool* __restrict__ out) {
  __shared__ uint32_t s[kSlots];
  __shared__ unsigned long long masks[kThreads];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const uint8_t* row = rows + blockIdx.y * row_stride;
  stage_tile(s, row, L, base);
  __syncthreads();
  masks[threadIdx.x] = run_mask(s, base, L, low_mask(avg_bits),
                                halo + static_cast<long long>(blockIdx.y) *
                                           kHalo);
  __syncthreads();
  bool* o = out + static_cast<long long>(blockIdx.y) * L + base;
  const long long span = L - base < kTile ? L - base : kTile;
  for (int j = threadIdx.x; j < span; j += kThreads) {
    o[j] = (masks[j >> 6] >> (j & 63)) & 1ull;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fdfs_gear_candidates(const void* data, long long len,
                                    long long n, int avg_bits, long long k,
                                    void* out, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  long long* prefix = static_cast<long long*>(scratch);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  if (n <= 0) return 0;
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  gear_count_kernel<<<tiles, kThreads, 0, st>>>(d, len, n, avg_bits, prefix);
  gear_scan_kernel<<<1, kScanThreads, 0, st>>>(prefix, tiles, o + k);
  gear_write_kernel<<<tiles, kThreads, 0, st>>>(d, len, n, avg_bits, prefix,
                                                tiles, k, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fdfs_gear_block_mask(const void* rows, long long row_stride,
                                    int b, long long L, const void* halo,
                                    int avg_bits, void* out, void* stream) {
  if (b <= 0 || L <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((L + kTile - 1) / kTile),
                  static_cast<unsigned>(b));
  gear_block_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), row_stride, L,
      static_cast<const long long*>(halo), avg_bits, static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}
