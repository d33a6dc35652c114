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
// Design.  The 64 KiB product table PROD[a][b] = a * b (poly 0x11D) sits
// in dynamic shared memory, with the block's rows of M beside it,
// transposed, so that shard i's coefficients are one broadcast word read
// per four rows.  Rows split over blockIdx.y in groups of at most 32.  A
// thread owns four consecutive output columns (one 32-bit word) of every
// row of its group, walks i over k with one coalesced load of shard i's
// word a step (four shards loaded ahead of their lookups), and keeps one
// accumulator word a row in registers.  The grid is persistent: the SMs
// times the blocks that fit (about three an SM at 72 KiB of shared
// memory), so each block fills the table once and then strides over
// column words.  Shards and out take any row stride (views such as d[m:]
// and torch.cat's need no copy); where a pointer or stride is not
// 4-aligned, or past the last whole word, columns go byte by byte.
//
// What bounds it on an H100: rows * k * L table lookups (LDS), each with
// about two integer instructions to take its byte and place its result,
// against (k + rows) * L bytes; at RS(32,8) the lookups bind (chip_smoke.py
// counts 1.25 instructions a product for the bound).  Every lane of a warp
// looks up the same 256-byte table row, whose 64 words lie two to a bank,
// so a lookup costs at most a 2-way bank conflict.  A faster design (split
// nibble tables in registers selected with __byte_perm) is for later.
//
// Contract: table is the 65,536-byte product table, row-major [a][b];
// matrix is (rows, k) uint8, row-major; shards rows of L bytes,
// shard_stride bytes apart; out rows of L bytes, out_stride bytes apart.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kTable = 256 * 256;
constexpr int kMaxK = 255;
constexpr int kGroup = 32;      // rows a block at most
constexpr int kAhead = 4;       // shard words loaded before their lookups
constexpr int kSmemMax = kTable + kMaxK * kGroup;
constexpr int kMaxDevices = 64;

// Bytes [col, col + 4) of a row, zero past `left` bytes.
template <bool kAligned>
__device__ __forceinline__ uint32_t load4(const uint8_t* p, long long left) {
  if (kAligned && left >= 4) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < left) v |= static_cast<uint32_t>(__ldg(p + b)) << (8 * b);
  return v;
}

template <bool kAligned>
__device__ __forceinline__ void store4(uint8_t* p, uint32_t v,
                                       long long left) {
  if (kAligned && left >= 4) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < left) p[b] = static_cast<uint8_t>(v >> (8 * b));
}

// PROD[c][s_j] for the four bytes s_j of s, packed as s is.
__device__ __forceinline__ uint32_t mul4(const uint8_t* tab, uint32_t c,
                                         uint32_t s) {
  const uint8_t* row = tab + (c << 8);
  return static_cast<uint32_t>(row[s & 0xFFu]) |
         static_cast<uint32_t>(row[(s >> 8) & 0xFFu]) << 8 |
         static_cast<uint32_t>(row[(s >> 16) & 0xFFu]) << 16 |
         static_cast<uint32_t>(row[s >> 24]) << 24;
}

template <int kRows, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    gf_matmul_kernel(const uint8_t* __restrict__ table,
                     const uint8_t* __restrict__ matrix, int rows, int k,
                     const uint8_t* __restrict__ shards,
                     long long shard_stride, long long L,
                     uint8_t* __restrict__ out, long long out_stride) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tab = smem;
  uint8_t* coef = smem + kTable;  // coef[i * kRows + r] = M[r0 + r][i]
  const int r0 = blockIdx.y * kRows;
  const int nr = min(kRows, rows - r0);

  const uint4* src = reinterpret_cast<const uint4*>(table);
  uint4* dst = reinterpret_cast<uint4*>(tab);
  for (int j = threadIdx.x; j < kTable / 16; j += kThreads)
    dst[j] = __ldg(src + j);
  for (int j = threadIdx.x; j < kRows * k; j += kThreads) {
    const int i = j / kRows, r = j % kRows;
    coef[j] = r < nr ? matrix[static_cast<long long>(r0 + r) * k + i] : 0;
  }
  __syncthreads();

  const long long words = (L + 3) / 4;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       w < words; w += step) {
    const long long col = 4 * w;
    const long long left = L - col;
    uint32_t acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0;
    for (int i0 = 0; i0 < k; i0 += kAhead) {
      uint32_t s[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        s[u] = i0 + u < k
                   ? load4<kAligned>(shards + (i0 + u) * shard_stride + col,
                                     left)
                   : 0u;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (i0 + u >= k) break;
        const uint32_t* cw =
            reinterpret_cast<const uint32_t*>(coef + (i0 + u) * kRows);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const uint32_t c4 = cw[q];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int r = 4 * q + b;
            if (r < nr) acc[r] ^= mul4(tab, (c4 >> (8 * b)) & 0xFFu, s[u]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr)
        store4<kAligned>(out + (r0 + r) * out_stride + col, acc[r], left);
  }
}

typedef void (*Kernel)(const uint8_t*, const uint8_t*, int, int,
                       const uint8_t*, long long, long long, uint8_t*,
                       long long);

// The instantiations: 4, 8, 16 or 32 rows a block, each by words or by
// bytes; kKernels[2 * log2(kRows / 4) + aligned].
const Kernel kKernels[8] = {
    &gf_matmul_kernel<4, false>,  &gf_matmul_kernel<4, true>,
    &gf_matmul_kernel<8, false>,  &gf_matmul_kernel<8, true>,
    &gf_matmul_kernel<16, false>, &gf_matmul_kernel<16, true>,
    &gf_matmul_kernel<32, false>, &gf_matmul_kernel<32, true>};

// Blocks of the persistent grid on the current device: its SM count times
// the blocks of the widest instantiation that fit on one SM, after opting
// every instantiation in to kSmemMax bytes of dynamic shared memory.
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
  int fit = 1 << 30;
  for (const Kernel fn : kKernels) {
    const void* f = reinterpret_cast<const void*>(fn);
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, f, kThreads,
                                                      kSmemMax);
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
extern "C" int fdfs_gf_matmul(const void* table, const void* matrix, int rows,
                              int k, const void* shards,
                              long long shard_stride, long long L, void* out,
                              long long out_stride, void* stream) {
  if (rows <= 0 || k <= 0 || L <= 0) return 0;
  if (rows > kMaxK || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const int rc = persistent_grid(&grid);
  if (rc != 0) return rc;
  int shape = 0;  // rows a block: 4 << shape, the fewest that hold rows
  while (shape < 3 && (4 << shape) < rows) ++shape;
  const int per_block = 4 << shape;
  const int groups = (rows + per_block - 1) / per_block;
  const long long tiles = ((L + 3) / 4 + kThreads - 1) / kThreads;
  long long gx = (grid + groups - 1) / groups;
  if (gx > tiles) gx = tiles;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(shards) | reinterpret_cast<uintptr_t>(out) |
        static_cast<uintptr_t>(shard_stride) |
        static_cast<uintptr_t>(out_stride)) & 3) == 0;
  const void* fn =
      reinterpret_cast<const void*>(kKernels[2 * shape + (aligned ? 1 : 0)]);
  const uint8_t* tab = static_cast<const uint8_t*>(table);
  const uint8_t* mat = static_cast<const uint8_t*>(matrix);
  const uint8_t* src = static_cast<const uint8_t*>(shards);
  uint8_t* dst = static_cast<uint8_t*>(out);
  void* args[] = {&tab, &mat, &rows, &k, &src, &shard_stride, &L, &dst,
                  &out_stride};
  const cudaError_t e = cudaLaunchKernel(
      fn, dim3(static_cast<unsigned>(gx), groups), dim3(kThreads), args,
      static_cast<size_t>(kTable + k * per_block),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
