// MinHash stage 4 over survivor vectors, for any permutation count P >= 1:
//
//     sig[i, j] = min over s with z[i, s] != EMPTY of (a_j z[i, s] + b_j) mod 2^32
//
// and EMPTY (0xFFFFFFFF) for a row with no survivor.  Replaces the
// reference's XLA stage 4, fastdfs_tpu/ops/minhash.py:minhash_signature
// (minhash.py:127), as the distributed ingest step runs it on a
// tensor-parallel rank's slice of the permutations (vmap(one_sig) at
// fastdfs_tpu/parallel/ingest_step.py:112-126), and wherever the count is
// not the fused sketch kernel's 64 or the shingle not its 5
// (csrc/minhash_survivor.cu).  Its plain twin is
// ops/minhash.py:signature_tiles.
//
// Design: a warp a row, eight rows a block, on a persistent grid (the SMs
// times the blocks that fit); warp w of the grid signs rows w, w + W, ...
// (W warps in all).  A lane reads its 32 words of a row as eight
// coalesced 16-byte loads (4-byte loads where z's base or row stride is
// not 16-byte aligned), and the next row's eight are in flight in
// registers while the current row is signed.  The non-EMPTY minima are
// compacted into the warp's own slice of shared memory: each lane counts
// its own, a shuffle scan gives each lane its offset, and only __syncwarp
// orders the slice's writes and reads; four copies of the first survivor
// pad it to a multiple of four (a copy cannot change a min) so that it is
// read back 16 bytes at a time.  Lane l owns permutations l, l + 32, ...:
// in passes of 1, 2 or 4 a lane (32, 64 or 128 a warp), it walks the
// survivors with broadcast reads, in native uint32 multiply-add, and
// writes its minima itself; no shuffle meets in a reduction.
//
// What bounds it on an H100: 4 KiB of z read and 4 P bytes written a
// row, against two instructions (IMAD, IMNMX) per survivor and
// permutation; at P = 32 or 64 and the ~40 survivors of a ~10 KiB chunk
// the bytes bind.
//
// Contract: z rows of 1024 uint32 words, z_stride words apart; words is
// (2, p) uint32, a_j then b_j; sig rows of p uint32 words, sig_stride
// words apart.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;                      // rows a block at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kSegments = 1024;
constexpr int kLoads = kSegments / (32 * 4);   // 16-byte loads a lane a row
constexpr int kSlice = kSegments + 4;          // survivors and 4 pad copies
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

// Lane `lane`'s words 4 (lane + 32 j) .. + 3 of a row, j < kLoads.
template <bool kVec>
__device__ __forceinline__ void load_row(const uint32_t* row, int lane,
                                         uint4 (&v)[kLoads]) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    if (kVec) {
      v[j] = __ldg(reinterpret_cast<const uint4*>(row) + lane + 32 * j);
    } else {
      const uint32_t* p = row + 4 * (lane + 32 * j);
      v[j] = make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
  }
}

__device__ __forceinline__ uint32_t perm_min(uint32_t best, uint32_t a,
                                             uint32_t b, const uint4& v) {
  return min(min(best, min(a * v.x + b, a * v.y + b)),
             min(a * v.z + b, a * v.w + b));
}

// Permutations j0 + lane + 32 u (u < kU, those below p) over the `quads`
// 16-byte groups of the warp's survivors, written to the row's `out`.
template <int kU>
__device__ __forceinline__ void sign(const uint4* surv, int quads,
                                     const uint32_t* __restrict__ words,
                                     int p, int j0, int lane,
                                     uint32_t* __restrict__ out) {
  uint32_t a[kU], b[kU], best[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int j = j0 + lane + 32 * u;
    a[u] = j < p ? __ldg(words + j) : 0u;
    b[u] = j < p ? __ldg(words + p + j) : 0u;
    best[u] = kEmpty;
  }
  for (int q = 0; q < quads; ++q) {
    const uint4 v = surv[q];
#pragma unroll
    for (int u = 0; u < kU; ++u) best[u] = perm_min(best[u], a[u], b[u], v);
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int j = j0 + lane + 32 * u;
    if (j < p) out[j] = best[u];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    minhash_sig_kernel(const uint32_t* __restrict__ z, long long z_stride,
                       long long n, const uint32_t* __restrict__ words, int p,
                       uint32_t* __restrict__ sig, long long sig_stride) {
  __shared__ __align__(16) uint32_t slices[kWarps][kSlice];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* surv = slices[warp];
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  uint4 cur[kLoads];
  if (row < n) load_row<kVec>(z + row * z_stride, lane, cur);
  for (; row < n; row += step) {
    uint4 next[kLoads];
    if (row + step < n) load_row<kVec>(z + (row + step) * z_stride, lane, next);

    // Compaction: each lane's survivors at its offset in the slice.
    int count = 0;
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      count += (cur[j].x != kEmpty) + (cur[j].y != kEmpty) +
               (cur[j].z != kEmpty) + (cur[j].w != kEmpty);
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int below = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += below;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    int at = incl - count;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const uint32_t v[4] = {cur[j].x, cur[j].y, cur[j].z, cur[j].w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (v[c] != kEmpty) surv[at++] = v[c];
    }
    __syncwarp();
    if (total > 0 && lane < 4) surv[total + lane] = surv[0];
    __syncwarp();

    const uint4* surv4 = reinterpret_cast<const uint4*>(surv);
    const int quads = (total + 3) / 4;
    uint32_t* out = sig + row * sig_stride;
    for (int j0 = 0; j0 < p;) {
      const int left = p - j0;
      if (left > 64) {
        sign<4>(surv4, quads, words, p, j0, lane, out);
        j0 += 128;
      } else if (left > 32) {
        sign<2>(surv4, quads, words, p, j0, lane, out);
        j0 += 64;
      } else {
        sign<1>(surv4, quads, words, p, j0, lane, out);
        j0 += 32;
      }
    }
    __syncwarp();  // the slice is read before the next row overwrites it
#pragma unroll
    for (int j = 0; j < kLoads; ++j) cur[j] = next[j];
  }
}

// Blocks of the persistent grid on the current device: its SM count times
// the blocks that fit on one SM (the two instantiations alike).
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
  const void* kernels[2] = {
      reinterpret_cast<const void*>(&minhash_sig_kernel<true>),
      reinterpret_cast<const void*>(&minhash_sig_kernel<false>)};
  int fit = 1 << 30;
  for (const void* f : kernels) {
    int per = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, f, kThreads, 0);
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
extern "C" int fdfs_minhash_sig(const void* z, long long z_stride, int n,
                                const void* words, int p, void* sig,
                                long long sig_stride, void* stream) {
  if (n <= 0 || p <= 0) return 0;
  int grid = 0;
  const int rc = persistent_grid(&grid);
  if (rc != 0) return rc;
  const int blocks_needed = (n + kWarps - 1) / kWarps;
  if (grid > blocks_needed) grid = blocks_needed;
  const bool vec = ((reinterpret_cast<uintptr_t>(z) |
                     static_cast<uintptr_t>(z_stride * 4)) & 15) == 0;
  const uint32_t* zz = static_cast<const uint32_t*>(z);
  const uint32_t* ww = static_cast<const uint32_t*>(words);
  uint32_t* out = static_cast<uint32_t*>(sig);
  const long long rows = n;
  if (vec)
    minhash_sig_kernel<true><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        zz, z_stride, rows, ww, p, out, sig_stride);
  else
    minhash_sig_kernel<false><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        zz, z_stride, rows, ww, p, out, sig_stride);
  return static_cast<int>(cudaGetLastError());
}
