// The ingest step's index query on the card: for each query signature,
// the largest number of equal lanes over every row of an index shard,
// as a fraction of the P lanes.
//
// Replaces device code that the reference leaves to XLA (jitted inside
// the shard_map step, not a Pallas kernel):
// fastdfs_tpu/parallel/ingest_step.py:128-133, which materialises the
// (N, M, P) comparison and takes eq.mean(axis=2, dtype=float32).max(1)
// with initial 0.0.
//
// Design.  A block owns a tile of 64 queries and one slice of the index
// rows, which it streams through shared memory 64 rows at a time.  For
// each chunk of 32 lanes both tiles are staged transposed (lane-major,
// one spare column, so neither the transposing stores nor the reads
// conflict on banks); each of the 256 threads then counts the equal
// lanes of a 4 x 4 block of (query, row) pairs in registers, queries
// ty + 16 i and rows tx + 16 j.  After a row tile, each thread folds its
// counts into a running best per query.  At the end the 16 threads that
// share a query reduce with shuffles and meet the other slices of the
// index in an int32 atomicMax on the output, which holds 0 bits (0 and
// 0.0f alike) before the launch.  A second launch turns each count k
// into k * fl32(1 / P) as float32, the same float as the reference's
// mean of k ones (XLA multiplies by the float32 reciprocal; a true
// division differs in the last bit for some k where P is not a power of
// two).  Lanes past P stage as 0 (queries) and 1 (rows), so they never
// match; rows past the slice and queries past N are masked.
//
// What bounds it on an H100: two integer instructions (compare, add)
// per (query, row, lane) over the INT32 rate; the bytes (each signature
// read once) are far fewer.
//
// Contract: sigs int32 (n, p) and index int32 (m, p), contiguous;
// best float32 (n), zero-filled; n, m, p >= 1; sms the card's
// multiprocessor count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 64;      // queries per block
constexpr int kTileR = 64;      // index rows per staged tile
constexpr int kLanes = 32;      // lanes per staged chunk
constexpr int kThreads = 256;   // 16 x 16, each 4 x 4 pairs
constexpr int kBlocksPerSm = 4;  // blocks the index split aims at per SM

__global__ void __launch_bounds__(kThreads)
    index_count_kernel(const int32_t* __restrict__ sigs,
                       const int32_t* __restrict__ index, int n, int m, int p,
                       int rows_per_block, int* __restrict__ best) {
  __shared__ int32_t sq[kLanes][kTileQ + 1];
  __shared__ int32_t sr[kLanes][kTileR + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTileQ;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long r_end = min(r_begin + rows_per_block,
                              static_cast<long long>(m));
  int top[4] = {0, 0, 0, 0};
  for (long long r0 = r_begin; r0 < r_end; r0 += kTileR) {
    int acc[4][4] = {};
    for (int l0 = 0; l0 < p; l0 += kLanes) {
      __syncthreads();
      for (int e = threadIdx.x; e < kTileQ * kLanes; e += kThreads) {
        const int i = e / kLanes, l = e % kLanes;
        const int lane = l0 + l;
        const int q = q0 + i;
        const long long r = r0 + i;
        sq[l][i] = (q < n && lane < p)
                       ? __ldg(sigs + static_cast<long long>(q) * p + lane)
                       : 0;
        sr[l][i] = (r < r_end && lane < p) ? __ldg(index + r * p + lane) : 1;
      }
      __syncthreads();
#pragma unroll 8
      for (int l = 0; l < kLanes; ++l) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sq[l][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sr[l][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] == b[j] ? 1 : 0;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (r0 + tx + 16 * j < r_end) {
#pragma unroll
        for (int i = 0; i < 4; ++i) top[i] = max(top[i], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int v = top[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
    }
    const int q = q0 + ty + 16 * i;
    if (tx == 0 && q < n && v > 0) atomicMax(best + q, v);
  }
}

__global__ void index_scale_kernel(float* __restrict__ best, int n, int p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int k = reinterpret_cast<const int*>(best)[i];
    const float inv = 1.0f / static_cast<float>(p);  // correctly rounded
    best[i] = static_cast<float>(k) * inv;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fdfs_index_best(const void* sigs, const void* index, int n,
                               int m, int p, int sms, void* best,
                               void* stream) {
  if (n <= 0 || m <= 0 || p <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_tiles = (n + kTileQ - 1) / kTileQ;
  const int r_tiles = (m + kTileR - 1) / kTileR;
  // Split the index so that about kBlocksPerSm blocks share each SM, at
  // most 65535 slices.
  const int wanted = kBlocksPerSm * (sms > 0 ? sms : 1);
  int splits = (wanted + q_tiles - 1) / q_tiles;
  splits = splits < 1 ? 1 : (splits > r_tiles ? r_tiles : splits);
  int tiles_per_block = (r_tiles + splits - 1) / splits;
  if ((r_tiles + tiles_per_block - 1) / tiles_per_block > 65535) {
    tiles_per_block = (r_tiles + 65534) / 65535;
  }
  splits = (r_tiles + tiles_per_block - 1) / tiles_per_block;
  index_count_kernel<<<dim3(q_tiles, splits), kThreads, 0, st>>>(
      static_cast<const int32_t*>(sigs), static_cast<const int32_t*>(index), n,
      m, p, tiles_per_block * kTileR, static_cast<int*>(best));
  index_scale_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<float*>(best),
                                                      n, p);
  return static_cast<int>(cudaGetLastError());
}
