// MinHash stage 4 over survivor vectors, for any permutation count P >= 1:
//
//     sig[i, j] = min over s with z[i, s] != EMPTY of (a_j z[i, s] + b_j) mod 2^32
//
// and EMPTY (0xFFFFFFFF) for a row with no survivor.  Replaces the
// reference's XLA stage 4, fastdfs_tpu/ops/minhash.py:minhash_signature
// (minhash.py:127), as the distributed ingest step runs it on a
// tensor-parallel rank's slice of the permutations (vmap(one_sig) at
// fastdfs_tpu/parallel/ingest_step.py:112-126), and wherever the count is
// not the fused sketch kernel's 64 (csrc/minhash_survivor.cu).  Its plain
// twin is ops/minhash.py:signature_tiles.
//
// Design: one block of 256 threads a row.  Each thread loads four of the
// row's 1024 segment minima (coalesced: t + 256 j), the non-EMPTY ones are
// compacted into shared memory (a warp ballot per slot, an offset per
// warp, as in minhash_survivor.cu), and then `lanes` threads share each
// permutation: lanes = 256 / P rounded down to a power of two, between 1
// and 32, so that the permutations of a pass fill the block.  A lane
// takes every lanes-th survivor in native uint32 multiply-add, and the
// lanes meet in warp shuffles.  Passes of 256 / lanes permutations repeat
// until all P are signed; every thread runs every pass, so the shuffles
// see whole warps.
//
// What bounds it on an H100: 4 KiB of z read and 4 P bytes written a row,
// against two instructions (IMAD, IMNMX) per survivor and permutation;
// at P = 32 or 64 and the ~230 survivors of a 64 KiB chunk the bytes bind.
//
// Contract: z rows of 1024 uint32 words, z_stride words apart; words is
// (2, p) uint32, a_j then b_j; sig rows of p uint32 words, sig_stride
// words apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegments = 1024;
constexpr int kSlots = kSegments / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
    minhash_sig_kernel(const uint32_t* __restrict__ z, long long z_stride,
                       const uint32_t* __restrict__ words, int p, int lanes,
                       uint32_t* __restrict__ sig, long long sig_stride) {
  __shared__ uint32_t survivors[kSegments];
  __shared__ int warp_count[kWarps];

  const long long i = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const uint32_t* row = z + i * z_stride;
  uint32_t m[kSlots];
  unsigned ballot[kSlots];
  int in_warp = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    m[j] = __ldg(row + t + j * kThreads);
    ballot[j] = __ballot_sync(0xFFFFFFFFu, m[j] != kEmpty);
    in_warp += __popc(ballot[j]);
  }
  if (lane == 0) warp_count[warp] = in_warp;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w];
    base += w < warp ? c : 0;
    total += c;
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (m[j] != kEmpty) survivors[base + __popc(ballot[j] & below)] = m[j];
    base += __popc(ballot[j]);
  }
  __syncthreads();

  const int per_pass = kThreads / lanes;
  const int slot = t / lanes, sub = t % lanes;
  for (int j0 = 0; j0 < p; j0 += per_pass) {
    const int j = j0 + slot;
    const bool live = j < p;
    uint32_t best = kEmpty;
    if (live) {
      const uint32_t a = __ldg(words + j), b = __ldg(words + p + j);
      for (int q = sub; q < total; q += lanes)
        best = min(best, a * survivors[q] + b);
    }
    for (int d = 1; d < lanes; d <<= 1)
      best = min(best, __shfl_xor_sync(0xFFFFFFFFu, best, d));
    if (live && sub == 0) sig[i * sig_stride + j] = best;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fdfs_minhash_sig(const void* z, long long z_stride, int n,
                                const void* words, int p, void* sig,
                                long long sig_stride, void* stream) {
  if (n <= 0 || p <= 0) return 0;
  int lanes = 32;
  while (lanes > 1 && lanes * p > kThreads) lanes >>= 1;
  minhash_sig_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(z), z_stride,
      static_cast<const uint32_t*>(words), p, lanes,
      static_cast<uint32_t*>(sig), sig_stride);
  return static_cast<int>(cudaGetLastError());
}
