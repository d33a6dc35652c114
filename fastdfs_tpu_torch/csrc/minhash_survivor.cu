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
// The same sketch at any shingle width k >= 1 (sketch_k_kernel, C entry
// fdfs_sketch_ragged_k), for the widths where the reference answers with
// its XLA survivor_segmin (fastdfs_tpu/ops/minhash.py:98; its Pallas
// kernel is k = 5 only) and then its XLA stage 4 (:127): the signature
// with stage 4 fused, z, or both; either output may be absent.  Every
// k-byte window hashes with zeros past the chunk's end; a window is valid
// at p <= len - k, or at p < max(len, 1) when len < k.
//
// What bounds it: the same 6 integer instructions a position at any k
// (the roll h' = h B + (b[p + k] - b[p] B^k) is two multiply-adds, B^k
// from the host) against one byte read from HBM, plus stage 4's two a
// survivor and permutation, or 4 KiB of z written a chunk.  What the
// design does about it:
// - Each 16-byte block of the chunk is read from device memory once, by
//   a 16-byte cp.async into shared memory (bytes at or past len
//   zero-filled by its src-size, so a neighbour's bytes never enter a
//   window).  A pass is 4096 positions, which cover each segment once; it
//   stages the 257 blocks from the aligned address at or below its start,
//   and a ring of four stages keeps two passes in flight while one
//   hashes.  The roll's trailing bytes b[p + k] come from the same ring
//   (this pass's stage and the next), so shared memory stays 16 KiB at any
//   k; for k of a pass or more they come from the segment.  A stage is
//   laid out as the segment is: the even/odd split that would make a
//   warp's 16-byte reads conflict-free splits its cp.async fill across
//   two rows, and measured slower on the card (PERF.md).  The last pass's
//   successor is staged only when its last run's trailing bytes reach
//   into it.
// - 128 threads a block; thread t hashes the 32 positions 4096 r + 32 t
//   .. + 31 of pass r, which fall in its own eight segments 8 t .. 8 t + 7,
//   so their minima stay in registers.  It funnel-shifts its leading and
//   trailing words out of three 16-byte loads each (by the offsets mod
//   16, uniform in the block); a byte is one PRMT, SHF or LOP3.  The roll
//   is one multiply-add on the hash's dependency chain (inline PTX: left
//   to itself the compiler put two there and a negation).  A survivor
//   test is a rotate: rotl(h, 24) is below 2^24 exactly when the low byte
//   of h is zero, and is h >> 8 then, so a segment's four positions meet
//   in two three-input mins and the least survivor comes back exactly.
//   A run's first hash takes k bytes (from its words up to k = 32).
// - Stage 4 runs in the same block (sign_minima, shared with the k = 5
//   kernel, over the ring's first 4 KiB), so the signature, not z, leaves
//   the kernel.
// - Idle work: narrower blocks.  Four warps, not eight, share a pass, so a
//   chunk's last partial pass leaves at most three warps idle (whole
//   warps: the runs are in thread order), a run is twice as long (half
//   the first-hash cost a position), and eight blocks fit an SM (62
//   registers a thread) to cover one another's waits, barriers and stage
//   4.  Two chunks a block (the longest with the shortest, the second's
//   stages streaming in behind the first's) measured slower: the second
//   chunk's stage 4 waits behind the first, and the hardware's block
//   scheduler already takes chunks longest first from `order`.  Runs of
//   16 or 64 positions measured slower too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegments = 1024;
constexpr int kSlots = kSegments / kThreads;  // segments per thread
constexpr int kWarps = kThreads / 32;
constexpr int kPerms = 64;
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

// Stage 4 of one chunk in a block of kT threads, each holding kS segment
// minima m: compact the non-EMPTY ones into survivors (a warp ballot per
// slot, an offset per warp), then sig_row[j] = min over them of
// a_j z + b_j for the 64 permutations, kT / 64 lanes a permutation
// reduced with warp shuffles.  All EMPTY when there is no survivor.
template <int kT, int kS>
__device__ __forceinline__ void sign_minima(const uint32_t (&m)[kS],
                                            uint32_t* survivors,
                                            int* warp_count,
                                            const uint32_t* __restrict__ perms,
                                            uint32_t* __restrict__ sig_row) {
  constexpr int kW = kT / 32;
  constexpr int kLanesPerPerm = kT / kPerms;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  unsigned ballot[kS];
  int in_warp = 0;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    ballot[j] = __ballot_sync(0xFFFFFFFFu, m[j] != kEmpty);
    in_warp += __popc(ballot[j]);
  }
  if (lane == 0) warp_count[warp] = in_warp;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int c = warp_count[w];
    base += w < warp ? c : 0;
    total += c;
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
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
  if (sub == 0) sig_row[perm] = best;
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
  sign_minima<kThreads, kSlots>(m, survivors, warp_count, perms,
                                sig + i * sig_stride);
}

// ---- Any shingle width ---------------------------------------------------

constexpr int kKRun = 32;                       // positions a thread a pass
constexpr int kKPass = 4 * kSegments;           // each segment once a pass
constexpr int kKThreads = kKPass / kKRun;       // 128
constexpr int kKSlots = kKRun / 4;              // segments a thread owns
constexpr int kKWarps = kKThreads / 32;
constexpr int kStages = 4;                      // passes staged at once
constexpr int kStageBlocks = kKPass / 16 + 1;   // 16-byte blocks a stage

// Copy `n` bytes (0 < n <= 16) of a 16-byte aligned global block into
// shared memory, zero-filling the rest.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int n) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage pass q of a chunk: its 16-byte blocks from the aligned address at
// or below msg + 4096 q, each byte at or past len zero (a block wholly
// past it is written as zeros, never read from the segment).
__device__ __forceinline__ void stage_pass(uint4* stage, const uint8_t* msg,
                                           int s, long long q,
                                           long long len) {
  const long long first = q * kKPass - s;  // chunk position of block 0
  for (int b = threadIdx.x; b < kStageBlocks; b += kKThreads) {
    const long long n = len - first - 16LL * b;
    uint4* dst = stage + b;
    if (n > 0)
      cp_async16(dst, msg + first + 16LL * b, n < 16 ? static_cast<int>(n) : 16);
    else
      *dst = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Eight little-endian words of the staged bytes at offset 32 t + o of
// pass r's stage (o >= 0 uniform in the block).  With kWrap, a block past
// the stage's last is read from the next stage, which holds pass r + 1
// from the stage's block 256 on.
template <bool kWrap>
__device__ __forceinline__ void staged_words(const uint4 (*ring)[kStageBlocks],
                                             int r, int o,
                                             uint32_t (&w)[kKSlots]) {
  constexpr int kBlocks = kKRun / 16 + 1;
  const int b0 = kKRun / 16 * static_cast<int>(threadIdx.x) + (o >> 4);
  uint32_t u[4 * kBlocks];
#pragma unroll
  for (int j = 0; j < kBlocks; ++j) {
    const int b = b0 + j;
    const int wrap = kWrap && b >= kStageBlocks;
    const uint4 v = ring[(r + wrap) % kStages][b - wrap * (kStageBlocks - 1)];
    u[4 * j] = v.x;
    u[4 * j + 1] = v.y;
    u[4 * j + 2] = v.z;
    u[4 * j + 3] = v.w;
  }
  const int f = 8 * (o & 3);
  switch ((o >> 2) & 3) {  // uniform in the block
#define FDFS_WORDS_CASE(q)                                        \
  case q:                                                         \
    _Pragma("unroll") for (int j = 0; j < kKSlots; ++j)           \
        w[j] = __funnelshift_r(u[j + q], u[j + q + 1], f);        \
    break;
    FDFS_WORDS_CASE(0)
    FDFS_WORDS_CASE(1)
    FDFS_WORDS_CASE(2)
    FDFS_WORDS_CASE(3)
#undef FDFS_WORDS_CASE
  }
}

// Eight words of the chunk from position p on, read from the segment
// (zero at or past len): the trailing bytes where k passes a stage.
__device__ __forceinline__ void segment_words(const uint8_t* msg, long long p,
                                              long long len,
                                              uint32_t (&w)[kKSlots]) {
  const uint8_t* at = msg + p;
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 3);
  const uint32_t* span = reinterpret_cast<const uint32_t*>(at - s);
  uint32_t u[kKSlots + 1];
#pragma unroll
  for (int j = 0; j <= kKSlots; ++j) u[j] = span_word(span, j, s, len - p);
#pragma unroll
  for (int j = 0; j < kKSlots; ++j) {
    w[j] = __funnelshift_r(u[j], u[j + 1], 8 * s);
    w[j] = clip(w[j], p + 4 * j, len);
  }
}

// Byte j (a compile-time index) of eight little-endian words.
__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[kKSlots],
                                            int j) {
  const uint32_t x = w[j >> 2];
  switch (j & 3) {
    case 0:
      return x & 0xFFu;
    case 1:
      return __byte_perm(x, 0u, 0x4441);
    case 2:
      return __byte_perm(x, 0u, 0x4442);
    default:
      return x >> 24;
  }
}

// The hash of the window at the thread's run start p = 4096 r + 32 t: its
// first 32 bytes are the run's leading words; past them (k > 32) a byte
// comes from the two staged passes while they reach, then from the
// segment (zero at or past len).
__device__ __forceinline__ uint32_t first_hash(
    const uint32_t (&lw)[kKSlots], const uint4 (*ring)[kStageBlocks], int r,
    int s, int k, const uint8_t* msg, long long p, long long len) {
  uint32_t h = 0;
#pragma unroll
  for (int q = 0; q < kKSlots; ++q) {
    const int j = 4 * q;
    if (j >= k) return h;
    h = h * kPolyB + byte_of(lw, j);
    if (j + 1 < k) h = h * kPolyB + byte_of(lw, j + 1);
    if (j + 2 < k) h = h * kPolyB + byte_of(lw, j + 2);
    if (j + 3 < k) h = h * kPolyB + byte_of(lw, j + 3);
  }
  const int o0 = s + kKRun * static_cast<int>(threadIdx.x);
  for (int j = kKRun; j < k; ++j) {
    const int o = o0 + j;  // staged offset in pass r's stage
    uint32_t b;
    if (o < 2 * kKPass) {
      const int wrap = o >= 16 * kStageBlocks;
      const int x = o - wrap * kKPass;
      b = reinterpret_cast<const uint8_t*>(ring[(r + wrap) % kStages])[x];
    } else {
      b = p + j < len ? static_cast<uint32_t>(__ldg(msg + p + j)) : 0u;
    }
    h = h * kPolyB + b;
  }
  return h;
}

// h B + c, kept as one multiply-add on the hash's dependency chain.
__device__ __forceinline__ uint32_t roll(uint32_t h, uint32_t c) {
  uint32_t out;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(out) : "r"(h), "r"(kPolyB), "r"(c));
  return out;
}

// A hash rotated left by 24 bits: below 2^24 exactly when its low byte is
// zero (a survivor), and then the survivor's hash shifted right by 8, so
// the min of rotated hashes is below 2^24 iff a survivor was seen and
// gives back the least survivor (survivor_of).
__device__ __forceinline__ uint32_t rotated(uint32_t h) {
  return __funnelshift_l(h, h, 24);
}

__device__ __forceinline__ uint32_t survivor_of(uint32_t m) {
  return m < (1u << 24) ? m << 8 : kEmpty;
}

// Take the run's 32 positions into the rotated segment minima m (with
// kChecked, only those at most lim past the run's start), rolling the
// hash between them: h' = h B + (b[p + k] - b[p] B^k), b[p] from the
// leading words and b[p + k] from the trailing ones; neg_bk = -B^k mod
// 2^32.  A segment's four positions meet in two three-input mins.
template <bool kChecked>
__device__ __forceinline__ void roll_run(uint32_t h,
                                         const uint32_t (&lw)[kKSlots],
                                         const uint32_t (&tw)[kKSlots],
                                         uint32_t neg_bk, int lim,
                                         uint32_t (&m)[kKSlots]) {
#pragma unroll
  for (int q = 0; q < kKSlots; ++q) {
    uint32_t rot[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * q + e;
      rot[e] = rotated(h);
      if (j + 1 < kKRun)
        h = roll(h, byte_of(lw, j) * neg_bk + byte_of(tw, j));
    }
    if (!kChecked) {
      m[q] = min(min(m[q], rot[0]), rot[1]);
      m[q] = min(min(m[q], rot[2]), rot[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e <= lim) m[q] = min(m[q], rot[e]);
      if (4 * q + 3 >= lim) return;
    }
  }
}

__global__ void __launch_bounds__(kKThreads, 8)
    sketch_k_kernel(const uint8_t* __restrict__ seg,
                    const long long* __restrict__ offsets,
                    const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ order, int k,
                    uint32_t poly_bk, const uint32_t* __restrict__ perms,
                    uint32_t* __restrict__ sig, long long sig_stride,
                    uint32_t* __restrict__ z) {
  __shared__ uint4 ring[kStages][kStageBlocks];
  __shared__ int warp_count[kKWarps];

  const long long i = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* msg = seg + offsets[i];
  const long long len = lens[i] > 0 ? lens[i] : 0;
  const long long bound = len >= k ? len - k : (len > 1 ? len : 1) - 1;
  const long long passes = (bound >> 12) + 1;  // 4096 positions a pass
  // Pass starts are multiples of 16: each stage's offset mod 16 is s.
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(msg) & 15);
  // The trailing bytes of a run sit k past its leading ones, in this
  // pass's stage and the next while s + k stays below a pass.
  const bool staged_trail = s + k < kKPass;
  // Passes staged: one more than hashed where the last run's trailing
  // blocks (or, for k past a pass, its first hash) reach past the last
  // pass's stage.
  const int t_max = static_cast<int>((bound - (passes - 1) * kKPass) / kKRun);
  const long long stages =
      passes + (!staged_trail ||
                ((s + k + kKRun * t_max) >> 4) + kKRun / 16 >= kStageBlocks);
  const uint32_t neg_bk = 0u - poly_bk;

  uint32_t m[kKSlots];
#pragma unroll
  for (int j = 0; j < kKSlots; ++j) m[j] = kEmpty;

  // Passes stage ahead; a group is committed for every pass index, staged
  // or not, so wait_group counts them.
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < stages) stage_pass(ring[q], msg, s, q, len);
    cp_async_commit();
  }
  for (long long r = 0; r < passes; ++r) {
    cp_async_wait_prev();  // passes r and r + 1 have landed
    __syncthreads();       // ... for every thread, and pass r - 1 is done
    const long long q = r + kStages - 1;
    if (q < stages) stage_pass(ring[q % kStages], msg, s, q, len);
    cp_async_commit();
    const long long p = r * kKPass + kKRun * t;
    if (p <= bound) {
      const int cur = static_cast<int>(r % kStages);
      uint32_t lw[kKSlots], tw[kKSlots];
      staged_words<false>(ring, cur, s, lw);
      if (staged_trail)
        staged_words<true>(ring, cur, s + k, tw);
      else
        segment_words(msg, p + k, len, tw);
      const uint32_t h = first_hash(lw, ring, cur, s, k, msg, p, len);
      if (p + kKRun - 1 <= bound)
        roll_run<false>(h, lw, tw, neg_bk, kKRun, m);
      else
        roll_run<true>(h, lw, tw, neg_bk, static_cast<int>(bound - p), m);
    }
  }

#pragma unroll
  for (int j = 0; j < kKSlots; ++j) m[j] = survivor_of(m[j]);
  if (z != nullptr) {
    uint4* row = reinterpret_cast<uint4*>(z + i * kSegments) + kKSlots / 4 * t;
#pragma unroll
    for (int j = 0; j < kKSlots / 4; ++j)
      row[j] = make_uint4(m[4 * j], m[4 * j + 1], m[4 * j + 2], m[4 * j + 3]);
  }
  // Stage 4 compacts the survivors into the ring's first 4 KiB: it writes
  // them only after a barrier that every thread meets past its last hash.
  if (sig != nullptr)
    sign_minima<kKThreads, kKSlots>(m, reinterpret_cast<uint32_t*>(ring),
                                    warp_count, perms, sig + i * sig_stride);
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

// The sketch at shingle width k >= 1: signatures (sig, with perms) and/or
// z, at least one of them; poly_bk is 0x01000193^k mod 2^32.  Launches on
// `stream`; returns a cudaError_t.
extern "C" int fdfs_sketch_ragged_k(const void* seg, const void* offsets,
                                    const void* lens, const void* order,
                                    const void* perms, int n, int k,
                                    unsigned int poly_bk, void* sig,
                                    long long sig_stride, void* z,
                                    void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || (sig == nullptr && z == nullptr) ||
      (sig != nullptr && perms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  sketch_k_kernel<<<n, kKThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seg), static_cast<const long long*>(offsets),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(order), k,
      poly_bk, static_cast<const uint32_t*>(perms), static_cast<uint32_t*>(sig),
      sig_stride, static_cast<uint32_t*>(z));
  return static_cast<int>(cudaGetLastError());
}
