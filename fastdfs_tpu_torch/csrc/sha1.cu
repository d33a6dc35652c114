// SHA-1 of N ragged chunks of one segment, one launch, one thread per chunk.
//
// Replaces fastdfs_tpu/ops/pallas_sha1.py:_sha1_pallas (kernel body
// _sha1_kernel), which packs one chunk per TPU lane of a padded
// (rows, blen) tile and walks the block axis as a sequential grid
// dimension.  Here the chunks stay where they arrived: chunk i is
// seg[offsets[i] : offsets[i] + lens[i]], at any byte offset.  A thread
// owns one message for its whole Merkle-Damgard chain (its blocks cannot
// run in parallel): the 5-word state and a rolling 16-word schedule live
// in registers, and the thread builds the padding (0x80 byte, zero fill,
// 64-bit big-endian bit length) itself, so no padded copy of the batch is
// ever written.  Length 0 gives the digest of "".
//
// - One launch covers every chunk of a segment (about 6.6k for 64 MB),
//   so all chains run at once instead of one row tile after another.
// - `order` (optional) lists the chunks longest first: thread t hashes
//   chunk order[t], so a warp's lanes run similar block counts and the
//   longest chains start first.  Digests land at the chunk's own index.
// - Unaligned starts: the big-endian message words are rebuilt from
//   aligned 4-byte loads with one PRMT (__byte_perm) each, selected by
//   the chunk's address mod 4; no byte-at-a-time path.  Only aligned
//   words that hold a byte of the chunk are loaded, so no load leaves the
//   chunk's aligned span; bytes past the chunk's end are masked to zero,
//   whatever the segment holds there.
// - The round's critical path is rotl(a,5) and f(b,c,d) side by side,
//   then one three-input add: e + K + w[t] is summed off the chain.
// - A thread streams its own chunk, so each new cache line is a miss:
//   the next block's words are loaded before the current block is
//   compressed, and their latency hides behind its rounds.
//
// What bounds it on an H100: the longest chunk's chain.  A 64-byte block
// is about 613 integer instructions, mostly issued by one warp that waits
// on its own dependent chain (two instructions a round), so a 64 KiB
// chunk costs about 1025 blocks x 80 rounds of latency however many SMs
// idle beside it.  The total work (operations over the INT32 rate) is far
// below that.
//
// Contract: seg is uint8, every chunk inside it; offsets (n,) int64,
// lens (n,) int32 >= 0; order null or a permutation of [0, n) as int32;
// out rows of 5 uint32 words, out_stride words apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void compress(uint32_t h[5], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      wt = rotl(w[(t - 3) & 15] ^ w[(t - 8) & 15] ^ w[(t - 14) & 15] ^
                    w[t & 15],
                1);
      w[t & 15] = wt;
    }
    uint32_t f, k;
    if (t < 20) {
      f = (b & c) | (~b & d);
      k = 0x5A827999u;
    } else if (t < 40) {
      f = b ^ c ^ d;
      k = 0x6ED9EBA1u;
    } else if (t < 60) {
      f = (b & c) | (b & d) | (c & d);
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      k = 0xCA62C1D6u;
    }
    // e is a from four rounds back: its sum with K and w[t] is ready
    // before a is, so the chain is rotl/f, then one IADD3.
    const uint32_t ekw = e + k + wt;
    const uint32_t tmp = rotl(a, 5) + f + ekw;
    e = d;
    d = c;
    c = rotl(b, 30);
    b = a;
    a = tmp;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
}

// Aligned word k of the chunk's aligned span (word 0 holds its first
// byte at byte s), or 0 when the word holds no byte of the chunk.
__device__ __forceinline__ uint32_t span_word(const uint32_t* span,
                                              long long k, int s,
                                              long long len) {
  return 4 * k - s < len ? __ldg(span + k) : 0u;
}

__global__ void __launch_bounds__(kThreads)
    sha1_ragged_kernel(const uint8_t* __restrict__ seg,
                       const long long* __restrict__ offsets,
                       const int32_t* __restrict__ lens,
                       const int32_t* __restrict__ order, int n,
                       uint32_t* __restrict__ out, long long out_stride) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= n) return;
  const int i = order != nullptr ? order[slot] : slot;
  const uint8_t* msg = seg + offsets[i];
  const long long len = lens[i] > 0 ? lens[i] : 0;
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(msg) & 3);
  const uint32_t* span = reinterpret_cast<const uint32_t*>(msg - s);
  // Big-endian word from message bytes s..s+3 of {next, cur}.
  const uint32_t sel = (s << 12) | ((s + 1) << 8) | ((s + 2) << 4) | (s + 3);
  const long long nfull = len / 64;           // blocks wholly in the message
  const long long nblk = (len + 8) / 64 + 1;  // padded length in blocks

  uint32_t h[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u,
                   0xC3D2E1F0u};
  uint32_t w[16];
  uint32_t cur = span_word(span, 0, s, len);
  // Full blocks, software-pipelined: the aligned words of block blk + 1
  // are loaded before block blk is compressed, so their memory latency
  // hides behind its 80 rounds.  Words 1..15 of a full block lie inside
  // the message; word 16 only when the message goes on past the block.
  uint32_t ahead[16];
  auto load_block = [&](long long blk) {
    const uint32_t* p = span + blk * 16;
#pragma unroll
    for (int t = 0; t < 15; ++t) ahead[t] = __ldg(p + t + 1);
    ahead[15] = span_word(span, blk * 16 + 16, s, len);
  };
  if (nfull > 0) load_block(0);
  // One loop, so one inlined compress, for full and tail blocks alike:
  // a loop each (two inlined copies of the 80 rounds) made a larger and
  // slower kernel.
  for (long long blk = 0; blk < nblk; ++blk) {
    if (blk < nfull) {
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        w[t] = __byte_perm(cur, ahead[t], sel);
        cur = ahead[t];
      }
      if (blk + 1 < nfull) load_block(blk + 1);
    } else {
      // One or two tail blocks: the message's last bytes, 0x80, zero
      // fill, and the bit length in the last block's final two words.
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const uint32_t next = span_word(span, blk * 16 + t + 1, s, len);
        uint32_t x = __byte_perm(cur, next, sel);
        cur = next;
        const long long rem = len - (blk * 64 + 4 * t);  // message bytes here
        if (rem < 4) {
          const int r = static_cast<int>(rem);
          x = r <= 0 ? 0u : x & ~(0xFFFFFFFFu >> (8 * r));
          if (r >= 0) x |= 0x80u << (8 * (3 - r));
        }
        w[t] = x;
      }
      if (blk == nblk - 1) {
        const unsigned long long bits = static_cast<unsigned long long>(len) * 8ull;
        w[14] = static_cast<uint32_t>(bits >> 32);
        w[15] = static_cast<uint32_t>(bits);
      }
    }
    compress(h, w);
  }
  uint32_t* o = out + static_cast<long long>(i) * out_stride;
#pragma unroll
  for (int k = 0; k < 5; ++k) o[k] = h[k];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fdfs_sha1_ragged(const void* seg, const void* offsets,
                                const void* lens, const void* order, int n,
                                void* out, long long out_stride,
                                void* stream) {
  if (n <= 0) return 0;
  // One warp a block: the ~200 warps of a segment spread over every SM.
  const int blocks = (n + kThreads - 1) / kThreads;
  sha1_ragged_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seg), static_cast<const long long*>(offsets),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(order), n,
      static_cast<uint32_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}
