// MinHash v2 sketch of N ragged chunks, stages 1-4 fused, one block per chunk.
//
// Replaces fastdfs_tpu/ops/pallas_minhash.py:survivor_segmin_pallas
// (kernel _survivor_kernel, stages 1-3) and the XLA stage 4 that the
// reference runs after it (ops/minhash.py:minhash_signature).  Chunk i is
// seg[offsets[i] : offsets[i] + lens[i]] at any byte offset.
//
// Stages 1-3.  For every byte position p <= bound of the chunk (bound =
// len - 5, or max(len, 1) - 1 when len < 5, whose windows read zeros past
// the end) take the 5-byte polynomial hash h (base 0x01000193, mod 2^32),
// keep it iff (h & 0xFF) == 0, and let z[s] be the unsigned min of the
// kept hashes with (p / 4) % 1024 == s, or 0xFFFFFFFF when there is none.
// 256 threads a block; thread t owns segments t + 256 j (j < 4) and walks
// the chunk's little-endian words q = 1024 r + t + 256 j, so a warp's
// loads are consecutive.  Word q starts at byte offsets[i] + 4q, which is
// unaligned when the chunk is; it is rebuilt from aligned segment words
// with one funnel shift.  Only aligned words that hold a byte of the chunk
// are loaded, and bytes past the chunk's end are masked to zero, so a
// neighbour's bytes never enter a window.  Within a word the hash is
// built once and rolled forward: h' = h B - b[p] B^5 + b[p+5].
//
// Stage 4.  The non-EMPTY z[s] are compacted into shared memory (a warp
// ballot per segment slot, an offset per warp), then sig[j] = min over
// them of (a_j z + b_j) mod 2^32 for the 64 permutations, in native
// uint32 multiply-add: four lanes per permutation, reduced with warp
// shuffles.  A chunk with no survivor signs as all EMPTY.  Only (N, 64)
// leaves the kernel, plus z when the caller asks for it (z != null).
//
// What bounds it on an H100: about 6 integer instructions per byte
// position with the hash rolled forward, against one byte read from HBM,
// so operations and bytes bound it about equally; stage 4 adds two per
// survivor and permutation.  A short chunk's block is mostly fixed cost.
//
// Contract: seg is uint8, every chunk inside it; offsets (n,) int64,
// lens (n,) int32 >= 0; order null or a permutation of [0, n) as int32
// (block b signs chunk order[b]); perms (2, 64) uint32, a_j then b_j;
// sig rows of 64 uint32 words, sig_stride words apart; z null or (n, 1024).
//
// Stages 1-3 alone at any shingle width k >= 1 (survivor_k_kernel, C entry
// fdfs_survivor_ragged_k): the same z, for the widths where the reference
// answers with its XLA survivor_segmin (fastdfs_tpu/ops/minhash.py:98; its
// Pallas kernel is k = 5 only).  Every k-byte window hashes with zeros
// past the chunk's end; a window is valid at p <= len - k, or at
// p < max(len, 1) when len < k.  One block a chunk, 256 threads; thread t
// hashes the 16 positions 4096 r + 16 t .. + 15 of each pass r, whose
// words all fall in its own four segments 4 t .. 4 t + 3, so it keeps
// their minima in registers and writes them as one 16-byte store.  The
// run's first hash takes k byte loads; then it rolls forward,
// h' = h B - b[p] B^k + b[p + k] (exact mod 2^32; B^k from the host).
// Every byte load at or past the chunk's end reads 0, so a neighbour's
// bytes never enter a window.  A simple kernel: each position costs two
// byte loads (L1 serves most) and about six integer instructions, plus k
// loads a run; stage 4 then runs on minhash_sig.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegments = 1024;
constexpr int kSlots = kSegments / kThreads;  // segments per thread
constexpr int kWarps = kThreads / 32;
constexpr int kPerms = 64;
constexpr int kLanesPerPerm = kThreads / kPerms;
constexpr uint32_t kPolyB = 0x01000193u;
constexpr uint32_t kPolyB5 = kPolyB * kPolyB * kPolyB * kPolyB * kPolyB;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

// Aligned word k of the chunk's aligned span (word 0 holds its first
// byte at byte s), or 0 when the word holds no byte of the chunk.
__device__ __forceinline__ uint32_t span_word(const uint32_t* span,
                                              long long k, int s,
                                              long long len) {
  return 4 * k - s < len ? __ldg(span + k) : 0u;
}

// Keep the bytes of a little-endian word at chunk positions < len.
__device__ __forceinline__ uint32_t clip(uint32_t w, long long first,
                                         long long len) {
  const long long v = len - first;
  if (v >= 4) return w;
  return v <= 0 ? 0u : w & ((1u << (8 * static_cast<int>(v))) - 1u);
}

__device__ __forceinline__ void keep(uint32_t& m, uint32_t h, long long p,
                                     long long bound) {
  if (p <= bound && (h & 0xFFu) == 0u) m = min(m, h);
}

__global__ void __launch_bounds__(kThreads)
    sketch_ragged_kernel(const uint8_t* __restrict__ seg,
                         const long long* __restrict__ offsets,
                         const int32_t* __restrict__ lens,
                         const int32_t* __restrict__ order,
                         const uint32_t* __restrict__ perms,
                         uint32_t* __restrict__ sig, long long sig_stride,
                         uint32_t* __restrict__ z) {
  __shared__ uint32_t survivors[kSegments];
  __shared__ int warp_count[kWarps];

  const long long i = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* msg = seg + offsets[i];
  const long long len = lens[i] > 0 ? lens[i] : 0;
  // Signed: complete shingles, or the degenerate rule for len < 5.
  const long long bound = len >= 5 ? len - 5 : (len > 1 ? len : 1) - 1;
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(msg) & 3);
  const uint32_t* span = reinterpret_cast<const uint32_t*>(msg - s);

  // Stages 1-3.
  uint32_t m[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) m[j] = kEmpty;
  for (long long q0 = t; 4 * q0 <= bound; q0 += kSegments) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const long long q = q0 + j * kThreads;
      const long long p = 4 * q;
      if (p > bound) continue;
      const uint32_t u0 = span_word(span, q, s, len);
      const uint32_t u1 = span_word(span, q + 1, s, len);
      const uint32_t u2 = span_word(span, q + 2, s, len);
      uint32_t w0 = __funnelshift_r(u0, u1, 8 * s);  // bytes p .. p+3
      uint32_t w1 = __funnelshift_r(u1, u2, 8 * s);  // bytes p+4 .. p+7
      if (p + 8 > len) {
        w0 = clip(w0, p, len);
        w1 = clip(w1, p + 4, len);
      }
      uint32_t h = w0 & 0xFFu;
      h = h * kPolyB + ((w0 >> 8) & 0xFFu);
      h = h * kPolyB + ((w0 >> 16) & 0xFFu);
      h = h * kPolyB + (w0 >> 24);
      h = h * kPolyB + (w1 & 0xFFu);
      keep(m[j], h, p, bound);
      h = h * kPolyB - (w0 & 0xFFu) * kPolyB5 + ((w1 >> 8) & 0xFFu);
      keep(m[j], h, p + 1, bound);
      h = h * kPolyB - ((w0 >> 8) & 0xFFu) * kPolyB5 + ((w1 >> 16) & 0xFFu);
      keep(m[j], h, p + 2, bound);
      h = h * kPolyB - ((w0 >> 16) & 0xFFu) * kPolyB5 + (w1 >> 24);
      keep(m[j], h, p + 3, bound);
    }
  }
  if (z != nullptr) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) z[i * kSegments + t + j * kThreads] = m[j];
  }

  // Stage 4: compact the non-EMPTY segment minima, then 64 permutations.
  const int lane = t & 31, warp = t >> 5;
  unsigned ballot[kSlots];
  int in_warp = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
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

  const int perm = t / kLanesPerPerm, sub = t % kLanesPerPerm;
  const uint32_t a = perms[perm], b = perms[kPerms + perm];
  uint32_t best = kEmpty;
  for (int k = sub; k < total; k += kLanesPerPerm)
    best = min(best, a * survivors[k] + b);
#pragma unroll
  for (int d = 1; d < kLanesPerPerm; d <<= 1)
    best = min(best, __shfl_xor_sync(0xFFFFFFFFu, best, d));
  if (sub == 0) sig[i * sig_stride + perm] = best;
}

// Byte p of a chunk of len bytes, 0 at or past its end.
__device__ __forceinline__ uint32_t byte_at(const uint8_t* msg, long long p,
                                            long long len) {
  return p < len ? static_cast<uint32_t>(__ldg(msg + p)) : 0u;
}

constexpr int kRun = 16;                  // positions a thread hashes a pass
constexpr int kPass = kThreads * kRun;    // 4 * kSegments positions

__global__ void __launch_bounds__(kThreads)
    survivor_k_kernel(const uint8_t* __restrict__ seg,
                      const long long* __restrict__ offsets,
                      const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ order, int k,
                      uint32_t poly_bk, uint32_t* __restrict__ z) {
  const long long i = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* msg = seg + offsets[i];
  const long long len = lens[i] > 0 ? lens[i] : 0;
  const long long bound = len >= k ? len - k : (len > 1 ? len : 1) - 1;

  uint32_t m[kRun / 4];
#pragma unroll
  for (int w = 0; w < kRun / 4; ++w) m[w] = kEmpty;
  for (long long p0 = static_cast<long long>(kRun) * t; p0 <= bound;
       p0 += kPass) {
    uint32_t h = 0;
    for (int j = 0; j < k; ++j) h = h * kPolyB + byte_at(msg, p0 + j, len);
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const long long p = p0 + r;
      keep(m[r / 4], h, p, bound);
      if (r + 1 < kRun)
        h = h * kPolyB - byte_at(msg, p, len) * poly_bk +
            byte_at(msg, p + k, len);
    }
  }
  reinterpret_cast<uint4*>(z + i * kSegments)[t] =
      make_uint4(m[0], m[1], m[2], m[3]);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fdfs_sketch_ragged(const void* seg, const void* offsets,
                                  const void* lens, const void* order,
                                  const void* perms, int n, void* sig,
                                  long long sig_stride, void* z,
                                  void* stream) {
  if (n <= 0) return 0;
  sketch_ragged_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seg), static_cast<const long long*>(offsets),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(order),
      static_cast<const uint32_t*>(perms), static_cast<uint32_t*>(sig),
      sig_stride, static_cast<uint32_t*>(z));
  return static_cast<int>(cudaGetLastError());
}

// Stages 1-3 at shingle width k >= 1 into z (n, 1024); poly_bk is
// 0x01000193^k mod 2^32.  Launches on `stream`; returns a cudaError_t.
extern "C" int fdfs_survivor_ragged_k(const void* seg, const void* offsets,
                                      const void* lens, const void* order,
                                      int n, int k, unsigned int poly_bk,
                                      void* z, void* stream) {
  if (n <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  survivor_k_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seg), static_cast<const long long*>(offsets),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(order), k,
      poly_bk, static_cast<uint32_t*>(z));
  return static_cast<int>(cudaGetLastError());
}
