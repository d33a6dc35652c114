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
//   total count of candidates below n.  One pass over the buffer with a
//   decoupled look-back (Merrill and Garland, "Single-pass Parallel
//   Prefix Scan with Decoupled Look-back", NVIDIA 2016) over spans of
//   consecutive tiles, one span a block.
// - Dense form with a halo (fdfs_gear_block_mask): uint8 rows (B, L),
//   each with the gear values of the 31 bytes before it (B, 31), give a
//   bool mask (B, L).
//
// Design.  Persistent blocks, two per SM (the launcher asks the occupancy
// API), 256 threads each; a tile is 32 KiB of positions, a thread's run
// 128 of them.  A block fills the gear table once, in shared memory as
// [byte][lane] (32 KiB): lane l always reads bank l, so a warp's 32
// lookups never conflict and fmix32 leaves the hot loop.  While tile t is
// hashed, tile t+1 and the 32 bytes before it are staged by 16-byte
// cp.async into the other of two buffers; the staged layout leaves a
// spare 16 bytes after each thread's 128, so the 8 threads of a quarter
// warp, which read 16 bytes each from runs 144 bytes apart, touch 32
// different banks.  The dense form strides over the tiles by the grid.
//
// (h << 1) pushes a byte's term out of the low avg_bits bits after
// avg_bits steps, so the candidate test at a run's first position needs
// only the avg_bits - 1 bytes before it: a thread rolls 16 bytes before
// its run (32 where avg_bits > 17), then rolls h = (h << 1) + gear[b]
// over its run in 32-bit registers, one table read and one hash a
// position.  It keeps h shifted left by 32 - avg_bits (the table holds
// the values shifted), so a candidate is h == 0, and tests a chunk of 16
// positions by the least of their hashes (three-input min) before it
// looks at them one by one.  Positions before a row's first byte take
// the halo's values (zero in the compacted form); positions at or past
// the limit (n, or L) are never candidates.  The dense form expands 16
// mask bits into 16 bytes of 0/1 by a multiply and stores them 16 bytes
// at a time (a byte at a time where a row's start is not 16-byte
// aligned).
//
// The compacted form takes spans of ceil(tiles / grid) tiles in order
// from a counter (so every span it looks back on belongs to a block that
// is running), streams its span as above and stores the 128 candidate
// bits of each thread run that has any, beside a map of those runs.  It
// then publishes the span's count, looks back for its offset (256
// spans a step, 8 loads in flight a lane), and writes its candidates at
// their ranks from the stored runs; the last span's block writes the
// count and pads the slots past it.  A block waits only on spans taken
// before its own, whose blocks are running, so any number of the grid's
// blocks may be resident at once (other launches beside it included).
// A look-back per tile with the next tile prefetched was slower: a block
// holds a tile it has not hashed while later tiles wait on it.
//
// What bounds it on an H100: the bytes, one read of the buffer (and, in
// the dense form, one byte written a position): 0.020 ms per 2^26 bytes.
// With the table looked up, a position needs about 4 integer
// instructions (chip_smoke.py, CDC_OPS_PER_POSITION), under the bytes.
// Measured (PERF.md, device times): the dense form takes about 1.1x a
// PyTorch copy of the same bytes; the compacted form about 1.5x a PyTorch
// sum that reads its bytes, since its hashing does not fully hide under
// the stream (one tile in flight a block while it hashes).
//
// Contract: data uint8 with len bytes (1-D, contiguous), 0 <= n <= len,
// 0 <= avg_bits <= 32, k >= 0; out int64 (k + 1): positions, then the
// count; scratch int64, 16-byte aligned, of W + 516 T words for T =
// ceil(n / 32768) tiles and W = (T + 2) & ~1, any contents: a span
// counter and a status word a span (the launcher zeroes them), a map of
// the thread runs with candidates (4 words a tile), and those runs'
// candidate bits (4 KiB a tile), about n / 8 bytes in all.  rows uint8
// with row_stride bytes between rows and unit stride within one; halo
// int64 (B, 31), contiguous, values in [0, 2^32); out bool (B, L),
// contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 128;                      // positions per thread
constexpr int kTile = kThreads * kRun;         // positions per tile
constexpr int kChunk = 16;                     // bytes per cp.async
constexpr int kRunChunks = kRun / kChunk;
constexpr int kPreChunks = 2;                  // 32 bytes before a tile
constexpr int kHalo = 31;
constexpr int kTableWords = 256 * 32;          // [byte][lane]
constexpr int kMaxDevices = 64;

// Staged chunk c of a tile (c >= -kPreChunks; negative before the tile)
// lives at chunk slot(c) of its buffer: runs of kRunChunks chunks, each
// followed by a spare chunk.
__host__ __device__ constexpr int slot(int c) {
  return c + (c + kRunChunks) / kRunChunks + kRunChunks;
}
constexpr int kSlots = slot(kTile / kChunk - 1) + 1;
constexpr int kCompactSmem = 4 * kTableWords + 2 * kSlots * kChunk;
constexpr int kDenseSmem = kCompactSmem + kThreads * 16;  // + run masks
static_assert(kThreads == 256, "one table entry per thread");
static_assert(kRun == 128, "four 32-bit mask words a run");

// Status words of the look-back: a flag in the top two bits.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

__device__ __forceinline__ uint32_t gear(uint32_t byte) {
  uint32_t x = byte + 1u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The hash kept shifted left by 32 - avg_bits (zero where avg_bits is 0):
// only its low avg_bits bits decide a candidate, so the shifted hash is
// zero exactly at a candidate.
__device__ __forceinline__ uint32_t shifted(uint32_t x, int avg_bits) {
  return avg_bits == 0 ? 0u : x << (32 - avg_bits);
}

// Thread t writes entry t's 32 copies (its gear value, shifted) as 8
// uint4, starting at chunk t mod 8, so that a quarter warp's stores fall
// in 8 different bank groups.
__device__ __forceinline__ void fill_table(uint32_t* table, int avg_bits) {
  const int t = threadIdx.x;
  const uint32_t g = shifted(gear(static_cast<uint32_t>(t)), avg_bits);
  const uint4 v = make_uint4(g, g, g, g);
  uint4* row = reinterpret_cast<uint4*>(table) + 8 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) row[(j + t) & 7] = v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for all but the most recent group of this thread's copies.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// Stage bytes [base - 32, base + kTile) of a row with `lim` readable
// bytes into buf: a 16-byte cp.async for each chunk wholly inside the row
// when the row is 16-byte aligned, else byte loads, zero outside
// [0, lim) (those bytes' gear values are never used).
__device__ __forceinline__ void stage_tile(uint4* buf, const uint8_t* row,
                                           long long lim, long long base) {
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  for (int i = threadIdx.x; i < kTile / kChunk + kPreChunks; i += kThreads) {
    const int c = i - kPreChunks;
    const long long p = base + static_cast<long long>(kChunk) * c;
    uint4* dst = buf + slot(c);
    if (aligned && p >= 0 && p + kChunk <= lim) {
      cp_async16(dst, row + p);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
        if (p + b >= 0 && p + b < lim) {
          w[b >> 2] |= static_cast<uint32_t>(__ldg(row + p + b))
                       << (8 * (b & 3));
        }
      }
      *dst = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The table entry of byte `b` of word x; `col` is the shared-space
// address of the table's column of this thread's lane (rows of 128
// bytes), so the address costs one PRMT and one IMAD.
__device__ __forceinline__ uint32_t lookup(uint32_t col, uint32_t x, int b) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];\n"
      : "=r"(v)
      : "r"(col + (__byte_perm(x, 0u, 0x4440u + b) << 7)));
  return v;
}

// Roll the shifted hash over the 16 bytes of a staged chunk.
__device__ __forceinline__ uint32_t roll_chunk(uint32_t h, uint4 v,
                                               uint32_t col) {
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) h = (h << 1) + lookup(col, x[q], b);
  }
  return h;
}

// This thread's run of the staged tile: bit j of bits[j / 32] is set
// where position base + kRun * threadIdx.x + j is a candidate below
// `limit`.  `halo` (31 gear values, or null for zeros) stands before the
// row's first byte; `warm` chunks are rolled before any other run.  A
// chunk of 16 positions is tested one by one only where the least of its
// hashes is zero (one chunk in about 500 at avg_bits 13).
__device__ __forceinline__ void run_bits(const uint4* buf,
                                         const uint32_t* table,
                                         long long base, long long limit,
                                         int avg_bits, int warm,
                                         const long long* halo,
                                         uint32_t bits[4]) {
  const int t = threadIdx.x;
  const uint32_t col =
      static_cast<uint32_t>(__cvta_generic_to_shared(table + (t & 31)));
  uint32_t h = 0;
  if (base == 0 && t == 0) {
    if (halo != nullptr) {
#pragma unroll
      for (int j = 0; j < kHalo; ++j) {
        h = (h << 1) + shifted(static_cast<uint32_t>(halo[j]), avg_bits);
      }
    }
  } else {
    if (warm > 1) h = roll_chunk(h, buf[slot(kRunChunks * t - 2)], col);
    h = roll_chunk(h, buf[slot(kRunChunks * t - 1)], col);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) bits[q] = 0u;
#pragma unroll
  for (int c = 0; c < kRunChunks; ++c) {
    const uint4 v = buf[slot(kRunChunks * t + c)];
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    uint32_t hs[16];
    uint32_t least = 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      h = (h << 1) + lookup(col, x[j >> 2], j & 3);
      hs[j] = h;
      least = min(least, h);
    }
    if (least == 0u) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (hs[j] == 0u) bits[c >> 1] |= 1u << (16 * (c & 1) + j);
      }
    }
  }
  const long long valid = limit - (base + static_cast<long long>(kRun) * t);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long left = valid - 32 * q;
    if (left <= 0) {
      bits[q] = 0u;
    } else if (left < 32) {
      bits[q] &= (1u << left) - 1u;
    }
  }
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

// Warp 0 of the block that holds `tile`: publish the tile's count, add
// up the counts before it by looking back over the status words, 256 at
// a time (8 loads in flight a lane), and publish the inclusive prefix;
// returns the exclusive one.
__device__ __forceinline__ long long look_back(unsigned long long* status,
                                               long long tile,
                                               long long count) {
  constexpr int kDepth = 8;
  const int lane = threadIdx.x & 31;
  long long before = 0;
  if (tile > 0) {
    if (lane == 0) st_relaxed(status + tile, kAggregate | count);
    for (long long near = tile - 1;; near -= 32 * kDepth) {
      unsigned long long s[kDepth];
#pragma unroll
      for (int m = 0; m < kDepth; ++m) {
        const long long j = near - lane - 32 * m;
        s[m] = j >= 0 ? ld_relaxed(status + j) : kInclusive;
      }
      bool found = false;
#pragma unroll
      for (int m = 0; m < kDepth; ++m) {
        if (!found) {
          const long long j = near - lane - 32 * m;
          while ((s[m] >> 62) == 0ull) s[m] = ld_relaxed(status + j);
          const unsigned inc =
              __ballot_sync(0xFFFFFFFFu, (s[m] >> 62) == 2ull);
          const int last = inc != 0u ? __ffs(inc) - 1 : 31;
          long long v =
              lane <= last ? static_cast<long long>(s[m] & kValue) : 0;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
          }
          before += v;
          found = inc != 0u;
        }
      }
      if (found) break;
    }
  }
  if (lane == 0) st_relaxed(status + tile, kInclusive | (before + count));
  return before;
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// One block a span of per_span consecutive tiles, spans taken in order
// from a counter.  The block streams its span (the next tile staged while
// this one is hashed) and stores each thread run's 128 candidate bits in
// the scratch; then it looks back once for the span's offset and writes
// the span's candidates from those bits.
__global__ void __launch_bounds__(kThreads, 2)
    gear_compact_kernel(const uint8_t* __restrict__ data, long long len,
                        long long n, int avg_bits, long long k,
                        long long tiles, long long per_span,
                        unsigned long long* scratch,
                        long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);
  uint4* bufs = reinterpret_cast<uint4*>(smem + 4 * kTableWords);
  __shared__ long long s_span, s_prefix;
  unsigned long long* counter = scratch;
  unsigned long long* status = scratch + 1;
  const long long words = (tiles + 2) & ~1ll;
  uint32_t* run_map = reinterpret_cast<uint32_t*>(scratch + words);
  uint4* runs = reinterpret_cast<uint4*>(scratch + words + 4 * tiles);
  const int t = threadIdx.x;
  const int warm = avg_bits > 17 ? 2 : 1;

  fill_table(table, avg_bits);
  if (t == 0) s_span = static_cast<long long>(atomicAdd(counter, 1ull));
  __syncthreads();
  const long long span = s_span;
  const long long t0 = span * per_span;
  const long long t1 = t0 + per_span < tiles ? t0 + per_span : tiles;
  stage_tile(bufs, data, len, t0 * kTile);
  cp_async_commit();
  int count = 0;
  int b = 0;
  for (long long cur = t0; cur < t1; ++cur) {
    if (cur + 1 < t1) stage_tile(bufs + (b ^ 1) * kSlots, data, len,
                                 (cur + 1) * kTile);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile cur staged, the table filled
    uint32_t bits[4];
    run_bits(bufs + b * kSlots, table, cur * kTile, n, avg_bits, warm,
             nullptr, bits);
    const uint4 v = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    const bool any = (v.x | v.y | v.z | v.w) != 0u;
    const unsigned warp_map = __ballot_sync(0xFFFFFFFFu, any);
    if (any) runs[cur * kThreads + t] = v;
    if ((t & 31) == 0) run_map[cur * (kThreads / 32) + (t >> 5)] = warp_map;
    count += popc4(v);
    b ^= 1;
    __syncthreads();  // buffer b free for the tile after next
  }
  int span_count;
  block_exclusive_scan<kThreads, int>(count, &span_count);
  if (t < 32) {
    const long long before = look_back(status, span, span_count);
    if (t == 0) s_prefix = before;
  }
  // The span's runs in order, per_span of them a thread; only the runs
  // that the map marks were stored.  (The block's own stores, visible
  // after the barriers in the scan.)
  const long long lo = t0 * kThreads + t * (t1 - t0);
  const long long hi = lo + (t1 - t0);
  int mine = 0;
  for (long long r = lo; r < hi; ++r) {
    if ((run_map[r >> 5] >> (r & 31)) & 1u) mine += popc4(runs[r]);
  }
  int unused;
  long long idx = block_exclusive_scan<kThreads, int>(mine, &unused);
  idx += s_prefix;  // written before the scan's barriers
  for (long long r = lo; r < hi && idx < k; ++r) {
    if (((run_map[r >> 5] >> (r & 31)) & 1u) == 0u) continue;
    const uint4 v = runs[r];
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t w = w4[q];
      while (w != 0u && idx < k) {
        out[idx++] = r * kRun + 32 * q + __ffs(w) - 1;
        w &= w - 1u;
      }
    }
  }
  // The last span's block knows the count, its inclusive prefix, and
  // pads the slots past it; no block waits for another's end.
  if (span == gridDim.x - 1) {
    const long long total = s_prefix + span_count;
    if (t == 0) out[k] = total;
    for (long long i = total + t; i < k; i += kThreads) out[i] = len;
  }
}

// 16 bits -> 16 bytes of 0/1: each nibble spread over a word by a
// multiply (bit i lands on bit 8i; no two partial products meet).
__device__ __forceinline__ uint4 expand16(uint32_t m) {
  return make_uint4(((m & 0xFu) * 0x00204081u) & 0x01010101u,
                    (((m >> 4) & 0xFu) * 0x00204081u) & 0x01010101u,
                    (((m >> 8) & 0xFu) * 0x00204081u) & 0x01010101u,
                    (((m >> 12) & 0xFu) * 0x00204081u) & 0x01010101u);
}

__global__ void __launch_bounds__(kThreads, 2)
    gear_block_kernel(const uint8_t* __restrict__ rows, long long row_stride,
                      long long L, long long tiles_per_row, long long tiles,
                      const long long* __restrict__ halo, int avg_bits,
                      uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);
  uint4* bufs = reinterpret_cast<uint4*>(smem + 4 * kTableWords);
  uint4* masks = bufs + 2 * kSlots;
  const uint16_t* mask16 = reinterpret_cast<const uint16_t*>(masks);
  const int t = threadIdx.x;
  const int warm = avg_bits > 17 ? 2 : 1;

  fill_table(table, avg_bits);
  long long cur = blockIdx.x;
  if (cur < tiles) {
    stage_tile(bufs, rows + (cur / tiles_per_row) * row_stride, L,
               (cur % tiles_per_row) * kTile);
  }
  cp_async_commit();
  int b = 0;
  while (cur < tiles) {
    const long long next = cur + gridDim.x;
    if (next < tiles) {
      stage_tile(bufs + (b ^ 1) * kSlots,
                 rows + (next / tiles_per_row) * row_stride, L,
                 (next % tiles_per_row) * kTile);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile cur staged, the table filled, masks free
    const long long row = cur / tiles_per_row;
    const long long base = (cur % tiles_per_row) * kTile;
    uint32_t bits[4];
    run_bits(bufs + b * kSlots, table, base, L, avg_bits, warm,
             halo + row * kHalo, bits);
    masks[t] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
    __syncthreads();
    uint8_t* o = out + row * L + base;
    const int span = static_cast<int>(L - base < kTile ? L - base : kTile);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      done = span & ~15;
      for (int i = t; i < span >> 4; i += kThreads) {
        *reinterpret_cast<uint4*>(o + 16 * i) = expand16(mask16[i]);
      }
    }
    for (int i = done + t; i < span; i += kThreads) {
      o[i] = static_cast<uint8_t>((mask16[i >> 4] >> (i & 15)) & 1u);
    }
    cur = next;
    b ^= 1;
  }
}

// Blocks of the persistent grid of both forms on the current device: its
// SM count times the blocks of either kernel that fit on one SM (after
// opting each in to its dynamic shared memory).  Cached per device.
int persistent_grid(int* grid) {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices) {
    const int g = cached[dev].load(std::memory_order_relaxed);
    if (g > 0) {
      *grid = g;
      return 0;
    }
  }
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* fns[2] = {reinterpret_cast<const void*>(&gear_compact_kernel),
                        reinterpret_cast<const void*>(&gear_block_kernel)};
  const int smems[2] = {kCompactSmem, kDenseSmem};
  int fit = 1 << 30;
  for (int i = 0; i < 2; ++i) {
    e = cudaFuncSetAttribute(fns[i],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smems[i]);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(fns[i],
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fns[i], kThreads,
                                                      smems[i]);
    if (e != cudaSuccess) return static_cast<int>(e);
    fit = per < fit ? per : fit;
  }
  if (fit < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  *grid = sms * fit;
  if (dev < kMaxDevices) cached[dev].store(*grid, std::memory_order_relaxed);
  return 0;
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int fdfs_gear_candidates(const void* data, long long len,
                                    long long n, int avg_bits, long long k,
                                    void* out, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  int grid = 0;
  const int rc = persistent_grid(&grid);
  if (rc != 0) return rc;
  const long long per_span = (tiles + grid - 1) / grid;
  const long long spans = (tiles + per_span - 1) / per_span;
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(spans + 1) * sizeof(long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  gear_compact_kernel<<<static_cast<int>(spans), kThreads, kCompactSmem, st>>>(
      static_cast<const uint8_t*>(data), len, n, avg_bits, k, tiles, per_span,
      static_cast<unsigned long long*>(scratch), static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fdfs_gear_block_mask(const void* rows, long long row_stride,
                                    int b, long long L, const void* halo,
                                    int avg_bits, void* out, void* stream) {
  if (b <= 0 || L <= 0) return 0;
  const long long tiles_per_row = (L + kTile - 1) / kTile;
  const long long tiles = tiles_per_row * b;
  int grid = 0;
  const int rc = persistent_grid(&grid);
  if (rc != 0) return rc;
  if (grid > tiles) grid = static_cast<int>(tiles);
  gear_block_kernel<<<grid, kThreads, kDenseSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), row_stride, L, tiles_per_row, tiles,
      static_cast<const long long*>(halo), avg_bits,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
