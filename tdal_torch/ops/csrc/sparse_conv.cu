// The sparse 3D conv's contraction as one gather-GEMM launch a call, for Hopper (sm_90a):
//
//   y[r] = sum_k x[table[k, r]] @ w[k]      r an output row, k a tap, in tap order
//
// over the flattened (rows, channels) voxel buffers of tdal_torch/ops/sparse_conv.py:
// the forward of every submanifold and strided conv of the VoxelNet backbone, and their
// dgrad (the same table with the taps' weights flipped and transposed, or the strided
// conv's transposed table). A table entry equal to x's row count means "no voxel there".
//
// It replaces no TPU kernel: tdal/ops/sparse_conv.py leaves the contraction to XLA.
// PERF.md §5 asked for it: the port's plain path (an index_select and an addmm a tap)
// wrote a gathered copy of every row of the padded buffer to device memory 27 times a
// conv and read it back, though fewer than one gathered row in ten is a real neighbour
// pair, and it took most of a VoxelNet detection batch on the card.
//
// What bounds it. The work a conv needs is its real neighbour pairs, 2 Cin Cout FLOP
// each, against its live input rows, its live output rows and its weights, each moved
// once. At the Waymo VoxelNet's levels (4 ray-cast frames, PERF.md §6) that is about
// 23 FLOP a byte at the first level (16 channels, 5.8 pairs a live row) and about 470
// at the fourth (128 channels, 15 pairs), against the card's 20 for f32 FFMA (67
// TFLOP/s over 3.35 TB/s): the FMAs bound it, and at the first level, where a tap's
// rows are few and short, the latency of the row gathers. The benchmark's roofline
// share counts only the real pairs, against the tensor cores' TF32 peak.
//
// Design:
// - One block of 256 threads owns a tile of kTM output rows (256 for 16 output
//   channels, else 128) and all (up to 128) output channels; each thread keeps a
//   kRM x kRN block of f32 accumulators in registers: rows tr + i * kRT and channel
//   quads tc + j * kCT, so that every shared-memory read of a warp is free of bank
//   conflicts and every store of a row is contiguous.
// - Skip 1, rows. A row past its sample's occupied count (counts[b], a device tensor:
//   no host sync) has no voxel and no tap: it loads nothing and is written as zero. A
//   tile with no live row reads not even its table entries. Tiles may straddle two
//   samples (rows of sample b are b * rows_per_sample ..).
// - Skip 2, taps. A live tile first reads its table entries into shared memory and
//   ORs which taps any of its rows finds; a tap that none finds is not loaded.
// - The gathers go to shared memory, never to device memory: for each live tap and
//   each slice of kKC input channels, the tile's rows named by the table (cp.async
//   16-byte copies; a missing row is zero-filled without a read) and the slice of
//   W_k, through a ring of two stages, so that the next slice lands while this one is
//   multiplied. Input channels past Cin and output channels past Cout are zero-filled.
//   A row whose channels do not fill 16-byte copies (the input conv's 5 or 6) takes
//   element copies in the same kernel (kVec false).
// - Products on the CUDA cores, one f32 fma each, accumulated in a fixed order (taps
//   ascending, then channels), with no atomics: the same call gives the same bits. A
//   skipped tap or row adds exact zeros, so a row's value does not depend on which
//   tile it falls in. f32 operands take the products at f32's accuracy; bf16 operands
//   are widened to f32 (their products are exact), the weights arriving rounded to bf16
//   by the wrapper, as the plain twin rounds them.
// - Each output row is written once, rounded to the output's type.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by tdal_torch/ops/build.py:
// the launcher takes raw pointers and a stream, allocates nothing and does not
// synchronise; the caller checks tdal_last_error() right after the call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;    // shared-memory ring depth
constexpr int kMaxTaps = 27;  // taps a table may have

// The tile of one output width kCo: kRM rows x kRN channels a thread, kCT threads
// across the channels, kRT across the rows, kTM rows a tile.
template <int kCo>
struct Tile {
  static constexpr int kRN = kCo >= 64 ? 8 : 4;
  static constexpr int kRM = kCo >= 128 ? 8 : 4;
  static constexpr int kCT = kCo / kRN;
  static constexpr int kRT = kThreads / kCT;
  static constexpr int kTM = kRT * kRM;
  static_assert(kTM <= kThreads, "the liveness pass takes a row a thread");
};

// One ring stage for kKC input channels of T: the tile's gathered rows (stride kAS,
// 16 bytes past the slice) and the slice of W_k (f32, kCo a row).
template <typename T, int kCo, int kKC>
struct Stage {
  static constexpr int kVecE = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int kAS = kKC + kVecE;
  static constexpr int kTM = Tile<kCo>::kTM;
  static constexpr size_t kIdxBytes = sizeof(int) * kMaxTaps * kTM;
  static constexpr size_t kABytes = sizeof(T) * kTM * kAS;
  static constexpr size_t kWBytes = sizeof(float) * kKC * kCo;
  static constexpr size_t kSmem = kIdxBytes + kStages * (kABytes + kWBytes);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; valid false fills the 16 bytes with zero
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive elements, widened to f32 / rounded from f32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(a, b);
  q[1] = __floats2bfloat162_rn(c, d);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// x (n_in, cin) of T; table (taps, n_out) int64, entry n_in = missing; w (taps, cin,
// cout) f32; counts (n_out / rows_per_sample,) int64; y (n_out, cout) of T.
// Grid: ceil(n_out / kTM) blocks of kThreads.
template <typename T, int kCo, int kKC, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
sparse_conv_kernel(const T* __restrict__ x, int n_in, int cin,
                   const int64_t* __restrict__ table, int taps, int n_out,
                   const float* __restrict__ w, int cout,
                   const int64_t* __restrict__ counts, int rows_per_sample,
                   T* __restrict__ y) {
  using G = Tile<kCo>;
  using S = Stage<T, kCo, kKC>;
  constexpr int kTM = G::kTM, kAS = S::kAS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned int tapmask;
  __shared__ unsigned char live[kTM];
  int* idx = reinterpret_cast<int*>(smem_raw);  // [taps][kTM]
  T* a_ring = reinterpret_cast<T*>(smem_raw + S::kIdxBytes);
  float* w_ring = reinterpret_cast<float*>(smem_raw + S::kIdxBytes + kStages * S::kABytes);

  const int tid = threadIdx.x;
  const int tc = tid % G::kCT, tr = tid / G::kCT;
  const int r0 = blockIdx.x * kTM;

  // skip 1: the tile's live rows (kTM <= kThreads: a row a thread)
  bool mine = false;
  if (tid < kTM) {
    const int r = r0 + tid;
    if (r < n_out) {
      const int b = r / rows_per_sample;
      mine = r - b * rows_per_sample < counts[b];
    }
    live[tid] = mine;
  }
  if (tid == 0) tapmask = 0u;
  const bool any_live = __syncthreads_or(mine);

  // skip 2: the live rows' table entries, and which taps any of them finds
  if (any_live) {
    unsigned int found = 0u;
    for (int e = tid; e < taps * kTM; e += kThreads) {
      const int k = e / kTM, i = e - k * kTM;
      const int src = live[i] ? (int)table[(size_t)k * n_out + r0 + i] : n_in;
      idx[e] = src;
      if (src != n_in) found |= 1u << k;
    }
    if (found) atomicOr(&tapmask, found);
  }
  __syncthreads();
  const unsigned int mask = tapmask;
  const int n_chunks = (cin + kKC - 1) / kKC;
  const int n_stages = __popc(mask) * n_chunks;

  // stage s: the j-th found tap (in tap order), input channels c0 .. c0 + kKC
  auto load = [&](int s) {
    const int j = s / n_chunks, c0 = (s - j * n_chunks) * kKC;
    unsigned int m = mask;
    for (int t = 0; t < j; ++t) m &= m - 1u;
    const int tap = __ffs(m) - 1;
    T* as = a_ring + (s % kStages) * kTM * kAS;
    float* ws = w_ring + (s % kStages) * kKC * kCo;
    const int* ti = idx + tap * kTM;
    if constexpr (kVec) {
      constexpr int kQ = kKC / S::kVecE;  // 16-byte copies a row's slice
      for (int e = tid; e < kTM * kQ; e += kThreads) {
        const int i = e / kQ, q = e - i * kQ;
        const int src = ti[i], ch = c0 + q * S::kVecE;
        const bool ok = src != n_in && ch < cin;
        cp_async16(as + i * kAS + q * S::kVecE, ok ? x + (size_t)src * cin + ch : x, ok);
      }
    } else {
      for (int e = tid; e < kTM * kKC; e += kThreads) {
        const int i = e / kKC, ci = e - i * kKC;
        const int src = ti[i], ch = c0 + ci;
        as[i * kAS + ci] = src != n_in && ch < cin ? x[(size_t)src * cin + ch] : zero<T>();
      }
    }
    constexpr int kWQ = kCo / 4;  // 16-byte copies a weight row
    for (int e = tid; e < kKC * kWQ; e += kThreads) {
      const int ci = e / kWQ, col = 4 * (e - ci * kWQ);
      const bool ok = c0 + ci < cin && col < cout;
      cp_async16(ws + ci * kCo + col, ok ? w + ((size_t)tap * cin + c0 + ci) * cout + col : w,
                 ok);
    }
  };

  float acc[G::kRM][G::kRN];
#pragma unroll
  for (int i = 0; i < G::kRM; ++i)
#pragma unroll
    for (int j = 0; j < G::kRN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    // its stage's readers finished at the last sync
    if (s + kStages - 1 < n_stages) load(s + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // stage s has landed (this thread's copies)
    __syncthreads();               // ... and everyone's
    const T* as = a_ring + (s % kStages) * kTM * kAS;
    const float* ws = w_ring + (s % kStages) * kKC * kCo;
#pragma unroll 2
    for (int k = 0; k < kKC; k += 4) {
      float a[G::kRM][4];
#pragma unroll
      for (int i = 0; i < G::kRM; ++i) load4(as + (tr + i * G::kRT) * kAS + k, a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[G::kRN];
#pragma unroll
        for (int j = 0; j < G::kRN / 4; ++j) {
          float q[4];
          load4(ws + (k + kk) * kCo + 4 * (tc + j * G::kCT), q);
          b[4 * j] = q[0], b[4 * j + 1] = q[1], b[4 * j + 2] = q[2], b[4 * j + 3] = q[3];
        }
#pragma unroll
        for (int i = 0; i < G::kRM; ++i)
#pragma unroll
          for (int j = 0; j < G::kRN; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // the stage is free for stage s + 2
  }
  cp_async_wait<0>();

  // each row once, in T; a row with nothing found, live or not, is exactly zero
#pragma unroll
  for (int i = 0; i < G::kRM; ++i) {
    const int r = r0 + tr + i * G::kRT;
    if (r >= n_out) continue;
#pragma unroll
    for (int j = 0; j < G::kRN / 4; ++j) {
      const int col = 4 * (tc + j * G::kCT);
      if (col < cout)
        store4(y + (size_t)r * cout + col, acc[i][4 * j], acc[i][4 * j + 1],
               acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  }
}

inline bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename T, int kCo, int kKC, bool kVec>
void launch_as(const void* x, int n_in, int cin, const int64_t* table, int taps, int n_out,
               const float* w, int cout, const int64_t* counts, int rows_per_sample, void* y,
               void* stream) {
  auto kern = sparse_conv_kernel<T, kCo, kKC, kVec>;
  constexpr size_t smem = Stage<T, kCo, kKC>::kSmem;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int tiles = (n_out + Tile<kCo>::kTM - 1) / Tile<kCo>::kTM;
  kern<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), n_in, cin, table, taps, n_out, w, cout, counts,
      rows_per_sample, static_cast<T*>(y));
}

// The input-channel slice from Cin: 8 (the input conv; element copies unless its rows
// fill 16-byte copies), 16, else 32.
template <typename T, int kCo>
void launch_co(const void* x, int n_in, int cin, const int64_t* table, int taps, int n_out,
               const float* w, int cout, const int64_t* counts, int rows_per_sample, void* y,
               void* stream) {
  const bool vec = cin % (16 / sizeof(T)) == 0 && aligned(x, 16);
  if (cin <= 8 && vec)
    launch_as<T, kCo, 8, true>(x, n_in, cin, table, taps, n_out, w, cout, counts,
                               rows_per_sample, y, stream);
  else if (cin <= 8)
    launch_as<T, kCo, 8, false>(x, n_in, cin, table, taps, n_out, w, cout, counts,
                                rows_per_sample, y, stream);
  else if (cin <= 16)
    launch_as<T, kCo, 16, true>(x, n_in, cin, table, taps, n_out, w, cout, counts,
                                rows_per_sample, y, stream);
  else
    launch_as<T, kCo, 32, true>(x, n_in, cin, table, taps, n_out, w, cout, counts,
                                rows_per_sample, y, stream);
}

template <typename T>
void launch(const void* x, int n_in, int cin, const int64_t* table, int taps, int n_out,
            const float* w, int cout, const int64_t* counts, int rows_per_sample, void* y,
            void* stream) {
  if (cout <= 16)
    launch_co<T, 16>(x, n_in, cin, table, taps, n_out, w, cout, counts, rows_per_sample, y,
                     stream);
  else if (cout <= 32)
    launch_co<T, 32>(x, n_in, cin, table, taps, n_out, w, cout, counts, rows_per_sample, y,
                     stream);
  else if (cout <= 64)
    launch_co<T, 64>(x, n_in, cin, table, taps, n_out, w, cout, counts, rows_per_sample, y,
                     stream);
  else
    launch_co<T, 128>(x, n_in, cin, table, taps, n_out, w, cout, counts, rows_per_sample, y,
                      stream);
}

}  // namespace

extern "C" {

// Output rows of one tile for cout output channels, -1 past 128: the tiles the caller
// counts (tdal_torch/ops/sparse_conv.py's tile_rows asks here).
int tdal_sparse_conv_tile_rows(int cout) {
  return cout < 1 || cout > 128 ? -1 : cout <= 16 ? Tile<16>::kTM : cout <= 32 ? Tile<32>::kTM
       : cout <= 64 ? Tile<64>::kTM : Tile<128>::kTM;
}

// y (n_out, cout) = sum_k x[table[k]] @ w[k] (see the top of this file). x (n_in, cin)
// and y of f32 (bf16 = 0) or bf16; table (taps, n_out) int64 with n_in for a missing
// tap; w (taps, cin, cout) f32; counts (n_out / rows_per_sample,) int64: rows of sample
// b past b * rows_per_sample + counts[b] have no found tap. Returns 0, or -1 without
// launching where the shape is not one the kernel takes (taps 1..27, cin >= 1 and, past
// 8, whole 16-byte copies a row, cout a multiple of 8 up to 128).
int tdal_sparse_conv(const void* x, int n_in, int cin, const int64_t* table, int taps,
                     int n_out, const float* w, int cout, const int64_t* counts,
                     int rows_per_sample, void* y, int bf16, void* stream) {
  const int vec_e = bf16 ? 8 : 4;
  if (taps < 1 || taps > kMaxTaps || cin < 1 || (cin > 8 && cin % vec_e != 0) ||
      cout < 8 || cout > 128 || cout % 8 != 0 || rows_per_sample < 1 ||
      n_out % rows_per_sample != 0 || !aligned(w, 16) || !aligned(y, 16) ||
      (cin > 8 && !aligned(x, 16)))
    return -1;
  if (n_out == 0) return 0;
  if (bf16)
    launch<__nv_bfloat16>(x, n_in, cin, table, taps, n_out, w, cout, counts,
                          rows_per_sample, y, stream);
  else
    launch<float>(x, n_in, cin, table, taps, n_out, w, cout, counts, rows_per_sample, y,
                  stream);
  return 0;
}

}  // extern "C"
