// The hash grid's exact 8-corner encode for Hopper (sm_90a), plain C ABI.
//
// Built by iris_tpu_torch/models/cuda_hashgrid.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and called through ctypes. The entry points launch on the caller's
// stream, allocate nothing, and return cudaGetLastError(); the kernels
// count their own launches (g_launches).
//
// It replaces no Pallas kernel: the JAX package leaves the encode to XLA
// (iris_tpu/models/hashgrid.py), whose fusions keep the index math in
// registers. PyTorch runs the same encode (models/hashgrid.py, the plain
// version) as ~200 passes over device memory, every (8, B*L) int64 index
// and float32 weight written and read again. Here one thread computes a
// (point, level)'s cell, its eight corner indices and weights in
// registers, reads the eight corners and writes the trilinear sums once,
// in the encode's final layout: the same float32 operations in the same
// order as the plain version (--fmad=false), so the same bits.
//
// What bounds it on this card: the corner reads. A render's 32 x 2 packed
// grid reads a 32-bit word (two bfloat16 features) a corner from a level
// block of 2^19 words (2 MB); the trainers' 4 x 16 row grid a 64-byte row
// a corner from a level block of 2^19 rows (33.5 MB). Both blocks fit the
// 50 MB L2, the whole tables (64 MB, 134 MB) do not. So the grid is level
// major: blockIdx.y picks the level (a group of 8 levels in the packed
// and flat modes), blockIdx.x runs over the points, and the blocks of one
// level run together while its table block stays in L2 (tiny-cuda-nn's
// shape). A packed block is 32 points x 8 levels, the level minor, so that
// each point's 8 consecutive outputs of a feature fill one 32-byte sector
// of the (B, F*L) output; a row block spreads each point's 64-byte rows
// over kRowVec-float lanes, 16-byte loads and stores (F a multiple of
// kRowVec: 4, 8 and 16 are the widths the repo runs).
//
// The packed words are made from the float32 table before each packed
// encode by pack_words, one pass (_pack_bf16's three PyTorch passes took
// 0.27 ms of a 1.27 ms render encode on the H100); reading the two float32
// features in the encode and rounding them there measured 2-3x slower than
// reading the words (PERF.md).
//
// Modes (cuda_hashgrid.MODES): packed, the (L*T,) words of _pack_bf16;
// flat, the (F*L*T,) float32 table, feature j's level tables at j*L*T;
// rows, the (L*T, F) float32 rows; rows_bf16, the same rows, each value
// rounded to bfloat16 (nearest even) as it is read, as _row_cast rounds
// the whole table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the hash's primes (models/hashgrid.py _PRIMES; the first is 1)
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
// a packed or flat block: kFlatPoints points x kFlatLevels levels
constexpr int kFlatLevels = 8;
constexpr int kFlatPoints = 32;
// a row block's threads, and the features a lane of a row block reads
constexpr int kRowThreads = 256;
constexpr int kRowVec = 4;

enum Mode { kPacked = 0, kFlat = 1, kRows = 2, kRowsBf16 = 3 };

// Launches, counted by the kernels themselves (thread 0 of the launch's
// first block), so that a launch replayed from a CUDA graph counts when it
// runs: {encode kernels, pack_words}; read by iris_hashgrid_launches,
// zeroed by iris_hashgrid_reset_launches.
enum Counted { kEncodeLaunches = 0, kPackLaunches = 1, kCounted = 2 };
__device__ unsigned long long g_launches[kCounted];

__device__ __forceinline__ void count_launch(int which) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[which], 1ULL);
}

// The grid's level constants (_level_constants), on the device.
struct Levels {
  const float* res;             // floor(base * scale^l), float32
  const long long* res1;        // res + 1
  const unsigned char* dense;   // (res + 1)^3 <= T
  int n_levels;
  uint32_t tmask;               // T - 1
  uint32_t last;                // L * T - 1
};

struct Corners {
  uint32_t idx[8];
  float w[8];
};

// torch.clamp(v, 0, 1): max first, then min, NaN passed through.
__device__ __forceinline__ float clamp01(float v) {
  v = (v < 0.f) ? 0.f : v;
  return (1.f < v) ? 1.f : v;
}

// The plain version's cell, frac, corner_index and _corners for point x at
// level l. The cells are int64 there; each index keeps only the low bits
// of its products and XORs (masked by T - 1, or a dense index below
// (res + 1)^3 <= T), which uint32 arithmetic gives alike, and a sum past
// the table is clamped to its last entry as there.
__device__ __forceinline__ void corners_of(const float* __restrict__ x,
                                           const Levels& lv, int l,
                                           Corners& c) {
  const float res = lv.res[l];
  const uint32_t r = static_cast<uint32_t>(lv.res1[l]);
  const bool dense = lv.dense[l] != 0;
  const uint32_t off = static_cast<uint32_t>(l) * (lv.tmask + 1u);
  uint32_t cell[3];
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = clamp01(x[a]) * res;
    const float c0 = floorf(p);
    cell[a] = static_cast<uint32_t>(static_cast<long long>(c0));
    frac[a] = p - c0;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t kx = (k >> 2) & 1, ky = (k >> 1) & 1, kz = k & 1;
    const uint32_t cx = cell[0] + kx, cy = cell[1] + ky, cz = cell[2] + kz;
    const uint32_t i = dense ? cx + r * (cy + r * cz)
                             : ((cx ^ cy * kPrime1 ^ cz * kPrime2) & lv.tmask);
    c.idx[k] = min(i + off, lv.last);
    const float wx = kx ? frac[0] : 1.f - frac[0];
    const float wy = ky ? frac[1] : 1.f - frac[1];
    const float wz = kz ? frac[2] : 1.f - frac[2];
    c.w[k] = wx * wy * wz;
  }
}

// Packed and flat modes: output (B, F*L), feature-major. Each sum starts
// from zero and adds the corners in order 0..7, as the plain version's.
template <bool kPackedWords>
__global__ void __launch_bounds__(kFlatPoints * kFlatLevels)
    encode_flat(const float* __restrict__ x, int n,
                const void* __restrict__ table, int n_features, Levels lv,
                float* __restrict__ out) {
  count_launch(kEncodeLaunches);
  const int l = blockIdx.y * kFlatLevels + threadIdx.x % kFlatLevels;
  const long long b =
      static_cast<long long>(blockIdx.x) * kFlatPoints +
      threadIdx.x / kFlatLevels;
  if (b >= n || l >= lv.n_levels) return;
  Corners c;
  corners_of(x + 3 * b, lv, l, c);
  float* o = out + b * n_features * lv.n_levels + l;
  if (kPackedWords) {
    const uint32_t* words = static_cast<const uint32_t*>(table);
    uint32_t wd[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) wd[k] = __ldg(words + c.idx[k]);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // feature 0 in the low half, feature 1 in the high half
      a0 = a0 + __uint_as_float(wd[k] << 16) * c.w[k];
      a1 = a1 + __uint_as_float(wd[k] & 0xffff0000u) * c.w[k];
    }
    o[0] = a0;
    o[lv.n_levels] = a1;
  } else {
    const float* t = static_cast<const float*>(table);
    const size_t block = static_cast<size_t>(lv.last) + 1;
    for (int j = 0; j < n_features; ++j) {
      const float* tj = t + j * block;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) a = a + __ldg(tj + c.idx[k]) * c.w[k];
      o[j * lv.n_levels] = a;
    }
  }
}

// a lane's kRowVec floats, aligned for 16-byte vector loads
struct alignas(16) Vec {
  float v[kRowVec];
};

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Row modes: output (B, L*F), level-major. A point's row is read by
// F/kRowVec lanes, kRowVec features each: one 16-byte load a corner.
template <bool kRound>
__global__ void __launch_bounds__(kRowThreads)
    encode_rows(const float* __restrict__ x, int n,
                const float* __restrict__ rows, int n_features, Levels lv,
                float* __restrict__ out) {
  count_launch(kEncodeLaunches);
  const int lanes = n_features / kRowVec;
  const long long t =
      static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x;
  const long long b = t / lanes;
  const int q = static_cast<int>(t - b * lanes);
  const int l = blockIdx.y;
  if (b >= n) return;
  Corners c;
  corners_of(x + 3 * b, lv, l, c);
  Vec g[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    g[k] = *reinterpret_cast<const Vec*>(
        rows + static_cast<size_t>(c.idx[k]) * n_features + q * kRowVec);
  Vec acc;
#pragma unroll
  for (int v = 0; v < kRowVec; ++v) acc.v[v] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int v = 0; v < kRowVec; ++v)
      acc.v[v] = acc.v[v] + (kRound ? to_bf16(g[k].v[v]) : g[k].v[v])
                 * c.w[k];
  *reinterpret_cast<Vec*>(
      out + (b * lv.n_levels + l) * n_features + q * kRowVec) = acc;
}

// _pack_bf16 on the card: word i holds bfloat16(table[i]) in its low half
// and bfloat16(table[block + i]) in its high half, each rounded to nearest
// even by the intrinsic PyTorch's own cast uses on the card.
__global__ void pack_words(const float* __restrict__ table, long long block,
                           uint32_t* __restrict__ words) {
  count_launch(kPackLaunches);
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= block) return;
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(table[i]));
  const uint32_t hi =
      __bfloat16_as_ushort(__float2bfloat16_rn(table[block + i]));
  words[i] = lo | (hi << 16);
}

}  // namespace

extern "C" {

// The exact encode of n points x (n, 3) at every level into out: (n, F*L)
// in the packed and flat modes, (n, L*F) in the row modes. table as the
// mode reads it (see the head of this file); res, res1 and dense the
// grid's (L,) level constants on the device. n > 0; in the row modes F a
// multiple of kRowVec. 0, or a CUDA error.
int iris_hashgrid_encode(const float* x, int n, const void* table, int mode,
                         int n_levels, int n_features, int log2_table,
                         const float* res, const long long* res1,
                         const unsigned char* dense, float* out,
                         cudaStream_t stream) {
  const uint32_t size = 1u << log2_table;
  const Levels lv{res, res1, dense, n_levels, size - 1u,
                  static_cast<uint32_t>(n_levels) * size - 1u};
  if (mode == kPacked || mode == kFlat) {
    dim3 grid((n + kFlatPoints - 1) / kFlatPoints,
              (n_levels + kFlatLevels - 1) / kFlatLevels);
    if (mode == kPacked)
      encode_flat<true><<<grid, kFlatPoints * kFlatLevels, 0, stream>>>(
          x, n, table, 2, lv, out);
    else
      encode_flat<false><<<grid, kFlatPoints * kFlatLevels, 0, stream>>>(
          x, n, table, n_features, lv, out);
    return static_cast<int>(cudaGetLastError());
  }
  if ((mode != kRows && mode != kRowsBf16) || n_features % kRowVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* rows = static_cast<const float*>(table);
  const long long threads =
      static_cast<long long>(n) * (n_features / kRowVec);
  dim3 grid(static_cast<unsigned>((threads + kRowThreads - 1) / kRowThreads),
            n_levels);
  if (mode == kRowsBf16)
    encode_rows<true><<<grid, kRowThreads, 0, stream>>>(
        x, n, rows, n_features, lv, out);
  else
    encode_rows<false><<<grid, kRowThreads, 0, stream>>>(
        x, n, rows, n_features, lv, out);
  return static_cast<int>(cudaGetLastError());
}

// The packed words of the (2 * block,) float32 table into words (block,).
// block > 0. 0, or a CUDA error.
int iris_hashgrid_pack(const float* table, long long block, void* words,
                       cudaStream_t stream) {
  constexpr int kThreads = 256;
  pack_words<<<static_cast<unsigned>((block + kThreads - 1) / kThreads),
               kThreads, 0, stream>>>(table, block,
                                      static_cast<uint32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

// Launches on the current device since the library was loaded or last
// reset, {encode kernels, pack_words}, into out[2], once the device has
// finished all its work. 0, or a CUDA error.
int iris_hashgrid_launches(unsigned long long* out) {
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess)
    rc = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return static_cast<int>(rc);
}

// Zero the launches on the current device once it has finished all its
// work. 0, or a CUDA error.
int iris_hashgrid_reset_launches() {
  static const unsigned long long zeros[kCounted] = {};
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess)
    rc = cudaMemcpyToSymbol(g_launches, zeros, sizeof(zeros));
  return static_cast<int>(rc);
}

}  // extern "C"
