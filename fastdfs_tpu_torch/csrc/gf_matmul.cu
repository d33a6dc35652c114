// GF(2^8) matrix product of Reed-Solomon encode and rebuild:
//
//     out[r, l] = XOR_i  PROD[M[r, i], shards[i, l]]
//
// for a uint8 (rows x k) matrix M and k shards of L bytes, rows and k in
// [1, 255] (the field's limit).  Replaces the reference's jitted XLA
// product fastdfs_tpu/ops/rs_code.py:_gf_matmul_jit (rs_code.py:170-178,
// driven by gf_matmul at :187-206): a (rows, k, L) gather in the product
// table, XOR-reduced over k.  Nothing of (rows, k, L) exists here.
//
// Design: split products in registers, no table lookup in the inner loop.
// The product is linear over GF(2) in x, so with x cut into its bit
// fields x = a | b << 3 | c << 6 (three, three and two bits),
//
//     c * x = T_a[x & 7] ^ T_b[(x >> 3) & 7] ^ T_c[x >> 6],
//
// where T_a[j] = c * j, T_b[j] = c * (j << 3) and T_c[j] = c * (j << 6).
// An 8-entry table of bytes is two registers, so one PRMT (__byte_perm)
// looks up four bytes at once, one per nibble of its selector; T_c's four
// entries fit one register.  A coefficient's tables are 20 bytes, built
// once a block from the product table into shared memory ([shard][row]:
// T_a and T_b as one 16-byte word, T_c beside them) and read as two
// broadcast loads.  The three selectors of a shard word depend only on the
// word, so a thread builds them once a shard (11 instructions for four
// bytes) and reuses them for every row of its group; the fields of shard
// bytes 0, 2, 1, 3 land in nibbles 0-3, and one PRMT a word puts the
// output bytes back in order before the store.  Per row, shard and 4-byte
// word: 3 PRMT and, with two shards summed at a time, 1.5 LOP3
// (three-way XOR into the accumulator), so 4.5 instructions for four
// products.
//
// A thread owns 16 consecutive output columns (four words, one 16-byte
// load a shard) of every row of its group and keeps 4 accumulator words a
// row in registers.  Rows split over blockIdx.y in groups of at most 32:
// 32 rows are 128 accumulator registers, about 200 a thread in all, under
// the 255 that one block of 256 threads an SM leaves without a spill
// (ptxas reports it in chip_smoke.py's phase 1); 32 and not 16 because
// each row group loads every shard and builds its selectors again.  The
// grid is persistent: the SMs times the blocks that fit, each block
// building its tables once and then striding over 4096-column tiles.
// Shards and out take any row stride (views such as d[m:] and
// torch.cat's need no copy); where a pointer or stride is not 16-byte
// aligned, or past the last whole 16 bytes, columns go byte by byte.
//
// What bounds it on an H100: rows * k * L products against (k + rows) * L
// bytes; at RS(32,8) the products bind (chip_smoke.py counts 1.25
// instructions a product for the bound; this design spends about 1.2 on
// the ALU pipe plus its loads).
//
// Contract: table is the 65,536-byte product table, row-major [a][b];
// matrix is (rows, k) uint8, row-major; shards rows of L bytes,
// shard_stride bytes apart; out rows of L bytes, out_stride bytes apart.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;                  // output words a thread
constexpr int kBytes = 4 * kWords;         // output columns a thread
constexpr int kTile = kThreads * kBytes;   // columns a block step
constexpr int kMaxK = 255;
constexpr int kCoefBytes = 20;             // T_a, T_b (16 B) and T_c (4 B)
constexpr int kKernelCount = 8;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The three PRMT selectors of a shard word s: nibble n holds the field of
// byte (0, 2, 1, 3)[n]; bits past 15 are cleared (PRMT reads 0-15).
struct Sel {
  uint32_t a, b, c;
};

__device__ __forceinline__ uint32_t nibbles(uint32_t f) {
  return (f | (f >> 12)) & 0xFFFFu;
}

__device__ __forceinline__ Sel selectors(uint32_t s) {
  return {nibbles(s & 0x07070707u), nibbles((s >> 3) & 0x07070707u),
          nibbles((s >> 6) & 0x03030303u)};
}

// c * each byte of the word whose selectors are `sel`, for the
// coefficient whose tables are (t, tc); bytes in selector order.
__device__ __forceinline__ uint32_t product(const uint4& t, uint32_t tc,
                                            const Sel& sel) {
  return prmt(t.x, t.y, sel.a) ^ prmt(t.z, t.w, sel.b) ^ prmt(tc, 0u, sel.c);
}

// PROD[c][first + step j] for j < 4, packed little-endian.
__device__ __forceinline__ uint32_t pack4(const uint8_t* row, int first,
                                          int step) {
  return static_cast<uint32_t>(__ldg(row + first)) |
         static_cast<uint32_t>(__ldg(row + first + step)) << 8 |
         static_cast<uint32_t>(__ldg(row + first + 2 * step)) << 16 |
         static_cast<uint32_t>(__ldg(row + first + 3 * step)) << 24;
}

// Bytes [col, col + 16) of a row, zero past `left` bytes.
template <bool kAligned>
__device__ __forceinline__ uint4 load16(const uint8_t* p, long long left) {
  if (kAligned && left >= kBytes) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[kWords] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < kBytes; ++b)
    if (b < left) w[b / 4] |= static_cast<uint32_t>(__ldg(p + b)) << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kAligned>
__device__ __forceinline__ void store16(uint8_t* p, const uint32_t (&w)[kWords],
                                        long long left) {
  if (kAligned && left >= kBytes) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int b = 0; b < kBytes; ++b)
    if (b < left) p[b] = static_cast<uint8_t>(w[b / 4] >> (8 * (b % 4)));
}

template <int kRows, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
    gf_matmul_kernel(const uint8_t* __restrict__ table,
                     const uint8_t* __restrict__ matrix, int rows, int k,
                     const uint8_t* __restrict__ shards,
                     long long shard_stride, long long L,
                     uint8_t* __restrict__ out, long long out_stride) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* tab = reinterpret_cast<uint4*>(smem);  // [i][r]: T_a, T_b
  uint32_t* tab_c = reinterpret_cast<uint32_t*>(smem + 16 * kRows * k);
  const int r0 = blockIdx.y * kRows;
  const int nr = min(kRows, rows - r0);

  for (int j = threadIdx.x; j < kRows * k; j += kThreads) {
    const int i = j / kRows, r = j % kRows;
    const uint32_t c =
        r < nr ? matrix[static_cast<long long>(r0 + r) * k + i] : 0u;
    const uint8_t* row = table + (c << 8);
    tab[j] = make_uint4(pack4(row, 0, 1), pack4(row, 4, 1), pack4(row, 0, 8),
                        pack4(row, 32, 8));
    tab_c[j] = pack4(row, 0, 64);
  }
  __syncthreads();

  const long long tiles = (L + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long col =
        tile * kTile + static_cast<long long>(kBytes) * threadIdx.x;
    const long long left = L - col;
    if (left <= 0) continue;
    const uint8_t* src = shards + col;
    uint32_t acc[kRows][kWords];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int w = 0; w < kWords; ++w) acc[r][w] = 0u;

    // Two shards a step (their six products meet in three LOP3), the
    // next two loaded while these are multiplied.
    uint4 s0 = load16<kAligned>(src, left);
    uint4 s1 = k > 1 ? load16<kAligned>(src + shard_stride, left)
                     : make_uint4(0u, 0u, 0u, 0u);
    int i = 0;
    for (; i + 1 < k; i += 2) {
      const Sel a[kWords] = {selectors(s0.x), selectors(s0.y),
                             selectors(s0.z), selectors(s0.w)};
      const Sel b[kWords] = {selectors(s1.x), selectors(s1.y),
                             selectors(s1.z), selectors(s1.w)};
      if (i + 2 < k) s0 = load16<kAligned>(src + (i + 2) * shard_stride, left);
      if (i + 3 < k) s1 = load16<kAligned>(src + (i + 3) * shard_stride, left);
      const uint4* t0 = tab + i * kRows;
      const uint32_t* c0 = tab_c + i * kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) {
          const uint4 x = t0[r], y = t0[kRows + r];
          const uint32_t cx = c0[r], cy = c0[kRows + r];
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            acc[r][w] ^= product(x, cx, a[w]) ^ product(y, cy, b[w]);
        }
      }
    }
    if (i < k) {  // an odd k: the last shard alone, already in s0
      const Sel a[kWords] = {selectors(s0.x), selectors(s0.y),
                             selectors(s0.z), selectors(s0.w)};
      const uint4* t0 = tab + i * kRows;
      const uint32_t* c0 = tab_c + i * kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) {
          const uint4 x = t0[r];
          const uint32_t cx = c0[r];
#pragma unroll
          for (int w = 0; w < kWords; ++w) acc[r][w] ^= product(x, cx, a[w]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) {
        uint32_t w[kWords];
#pragma unroll
        for (int q = 0; q < kWords; ++q) w[q] = prmt(acc[r][q], 0u, 0x3120u);
        store16<kAligned>(out + (r0 + r) * out_stride + col, w, left);
      }
    }
  }
}

typedef void (*Kernel)(const uint8_t*, const uint8_t*, int, int,
                       const uint8_t*, long long, long long, uint8_t*,
                       long long);

// The instantiations: 4, 8, 16 or 32 rows a block, each by 16-byte words
// or by bytes; kKernels[2 * log2(kRows / 4) + aligned].
const Kernel kKernels[kKernelCount] = {
    &gf_matmul_kernel<4, false>,  &gf_matmul_kernel<4, true>,
    &gf_matmul_kernel<8, false>,  &gf_matmul_kernel<8, true>,
    &gf_matmul_kernel<16, false>, &gf_matmul_kernel<16, true>,
    &gf_matmul_kernel<32, false>, &gf_matmul_kernel<32, true>};

int smem_bytes(int rows_per_block, int k) {
  return kCoefBytes * rows_per_block * k;
}

// Blocks of the persistent grid for instantiation `index` on the current
// device: its SM count times the blocks that fit on one SM at the most
// shared memory the instantiation can ask for (k = 255), after opting it
// in to that much.
int persistent_grid(int index, int* grid) {
  static std::atomic<int> cached[kMaxDevices][kKernelCount];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices) {
    const int g = cached[dev][index].load(std::memory_order_relaxed);
    if (g > 0) {
      *grid = g;
      return 0;
    }
  }
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* f = reinterpret_cast<const void*>(kKernels[index]);
  const int smem = smem_bytes(4 << (index / 2), kMaxK);
  e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, f, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  *grid = sms * per;
  if (dev < kMaxDevices)
    cached[dev][index].store(*grid, std::memory_order_relaxed);
  return 0;
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int fdfs_gf_matmul(const void* table, const void* matrix, int rows,
                              int k, const void* shards,
                              long long shard_stride, long long L, void* out,
                              long long out_stride, void* stream) {
  if (rows <= 0 || k <= 0 || L <= 0) return 0;
  if (rows > kMaxK || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  int shape = 0;  // rows a block: 4 << shape, the fewest that hold rows
  while (shape < 3 && (4 << shape) < rows) ++shape;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(shards) | reinterpret_cast<uintptr_t>(out) |
        static_cast<uintptr_t>(shard_stride) |
        static_cast<uintptr_t>(out_stride)) & (kBytes - 1)) == 0;
  const int index = 2 * shape + (aligned ? 1 : 0);
  int grid = 0;
  const int rc = persistent_grid(index, &grid);
  if (rc != 0) return rc;
  const int per_block = 4 << shape;
  const int groups = (rows + per_block - 1) / per_block;
  const long long tiles = (L + kTile - 1) / kTile;
  long long gx = (grid + groups - 1) / groups;
  if (gx > tiles) gx = tiles;
  const void* fn = reinterpret_cast<const void*>(kKernels[index]);
  const uint8_t* tab = static_cast<const uint8_t*>(table);
  const uint8_t* mat = static_cast<const uint8_t*>(matrix);
  const uint8_t* src = static_cast<const uint8_t*>(shards);
  uint8_t* dst = static_cast<uint8_t*>(out);
  void* args[] = {&tab, &mat, &rows, &k, &src, &shard_stride, &L, &dst,
                  &out_stride};
  const cudaError_t e = cudaLaunchKernel(
      fn, dim3(static_cast<unsigned>(gx), groups), dim3(kThreads), args,
      static_cast<size_t>(smem_bytes(per_block, k)),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
