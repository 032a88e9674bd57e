// Fused Frustum-PointNet instance-seg kernels for Hopper (sm_90a), f32 FMA.
//
// Replaces the two Pallas TPU kernels of tdal/ops/pallas_pointnet.py:
//   K1  _encoder_kernel (:69) via fused_seg_encoder (:99)
//       5 x (Dense + folded BN + ReLU), widths 64,64,64,128,1024; writes the 64-ch
//       skip after layer 2 and the per-set max of the 1024-ch output.
//   K2  _decoder_kernel (:137) via fused_seg_decoder (:166)
//       concat(skip, broadcast gmax) -> 4 x (Dense + ReLU) 512,256,128,128 -> 2 logits.
//
// What bounds them on an H100: operations. Per point K1 does ~295 kFLOP and K2 (in
// the split form below) ~426 kFLOP against 256 B of skip traffic, so both sit far
// above the card's ops:byte ridge; in f32 the ceiling is the 67 TFLOP/s of the CUDA
// cores. Weights (0.6 MB for K1, 1.3 MB for K2) stay resident in L2.
//
// Design:
// - One block of 256 threads per (point tile, set). The tile's activations live in
//   shared memory as [channel][point] through the whole layer chain; no activation
//   between layers touches device memory. Each layer is a small GEMM tiled
//   [TP points] x [64 out channels] x [32-deep K slice]: the K slice of the weights
//   is staged in shared memory, every thread owns a (TP/16) x 4 register tile.
// - K1's last layer (128 -> 1024) is never materialised: each 64-channel chunk is
//   reduced to its per-tile max in registers (warp shuffles over the 16 point
//   lanes) and written to a (B, tiles, 1024) partial buffer. Hopper runs blocks in
//   no order, so the TPU's revisited-output accumulation across the point-tile grid
//   axis (pallas_pointnet.py:92-96) becomes a second, deterministic pass
//   (seg_encoder_reduce_kernel).
// - The ragged tail is masked: the last tile zero-fills missing points, skips
//   their skip/logit writes and drops them from the max, so any N >= 1 works (the
//   TPU kernel asserts N % tile == 0).
// - K2's first layer is split: concat(skip, gmax) @ W0 + b0 ==
//   skip @ W0[:64] + (gmax @ W0[64:] + b0). The per-set term is computed once per
//   set (seg_decoder_gproj_kernel) and enters the point kernel as its bias, which
//   cuts K2's work from ~1.48 to ~0.43 MFLOP per point.
// - bf16 operand mode (bf16 != 0) reproduces the TPU kernels' numerics: both
//   operands of every product are rounded with __float2bfloat16_rn and the FMA
//   accumulates in f32 (a bf16 x bf16 product is exact in f32), so the result
//   matches the TPU kernel up to summation order. The skip and gmax outputs stay
//   unrounded f32, as on the TPU.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// tdal_torch/ops/build.py: launchers take raw pointers and a stream, allocate
// nothing and do not synchronise; the caller checks tdal_last_error() right after
// each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCO = 64;       // output channels per chunk
constexpr int kMC = 4;        // output channels per thread
constexpr int kKS = 32;       // K slice of the weights staged in shared memory
constexpr int kEncTile = 64;  // K1 points per block
constexpr int kDecTile = 32;  // K2 points per block
constexpr int kSkip = 64;
constexpr int kGlobal = 1024;
constexpr int kDec0 = 512;
constexpr int kEncWidest = 128;  // widest materialised K1 activation

struct EncParams {
  const float* w[5];
  const float* b[5];
};

struct DecParams {
  const float* w[4];  // w[0] is the full (1088, 512) weight; rows 0..63 used here
  const float* b[4];  // b[0] unused here: it is folded into gproj
  const float* lw;    // (128, 2)
  const float* lb;    // (2,)
};

__device__ __forceinline__ float rbf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MP>
__device__ __forceinline__ void load_points(const float* p, float (&a)[MP]) {
  if constexpr (MP == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else if constexpr (MP == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < MP; ++i) a[i] = p[i];
  }
}

enum Epilogue { kReluToSmem, kReluRowMax };

// One Dense layer over a tile: act_in [cin][TP] (shared) @ W (cin rows, row stride
// ldw, global) + bias, ReLU.
//   kReluToSmem: act_out[c][p] (shared), rounded to bf16 when bf16; when skip_out is
//                given, also the unrounded value to skip_out[p * cout + c] (p < n_valid).
//   kReluRowMax: max over the valid points into row_max[c] (global).
template <int TP, int EPI>
__device__ void dense_layer(const float* act_in, int cin, const float* __restrict__ W,
                            int ldw, int cout, const float* __restrict__ bias,
                            float* wsm, int bf16, int n_valid, float* act_out,
                            float* __restrict__ skip_out, float* __restrict__ row_max) {
  constexpr int MP = TP / 16;
  const int tid = threadIdx.x;
  const int tp = tid & 15;  // point group: points tp*MP .. tp*MP+MP-1
  const int tc = tid >> 4;  // channel group: channels co0 + tc*kMC .. +kMC-1
  for (int co0 = 0; co0 < cout; co0 += kCO) {
    float acc[MP][kMC];
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < kMC; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < cin; k0 += kKS) {
      const int kn = min(kKS, cin - k0);
      __syncthreads();  // act_in complete; previous readers of wsm done
      for (int e = tid; e < kn * kCO; e += kThreads) {
        const int kk = e / kCO, c = e - kk * kCO;
        const float w = W[(size_t)(k0 + kk) * ldw + co0 + c];
        wsm[kk * kCO + c] = bf16 ? rbf16(w) : w;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float a[MP];
        load_points<MP>(act_in + (k0 + kk) * TP + tp * MP, a);
        const float4 w4 = *reinterpret_cast<const float4*>(wsm + kk * kCO + tc * kMC);
        const float w[kMC] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < MP; ++i)
#pragma unroll
          for (int j = 0; j < kMC; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < kMC; ++j) {
      const int c = co0 + tc * kMC + j;
      const float bj = bias[c];
      if constexpr (EPI == kReluToSmem) {
#pragma unroll
        for (int i = 0; i < MP; ++i) {
          const int p = tp * MP + i;
          const float v = fmaxf(acc[i][j] + bj, 0.f);
          if (skip_out != nullptr && p < n_valid) skip_out[(size_t)p * cout + c] = v;
          act_out[c * TP + p] = bf16 ? rbf16(v) : v;
        }
      } else {
        float m = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
        for (int i = 0; i < MP; ++i) {
          if (tp * MP + i < n_valid) m = fmaxf(m, fmaxf(acc[i][j] + bj, 0.f));
        }
        // the 16 lanes sharing tc are one half-warp: xor 1..8 stays inside it
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (tp == 0) row_max[c] = m;
      }
    }
  }
}

template <int TP>
__global__ void __launch_bounds__(kThreads)
seg_encoder_kernel(const float* __restrict__ pts, int N, int cin, EncParams P,
                   float* __restrict__ skip, float* __restrict__ partial, int n_tiles,
                   int bf16) {
  extern __shared__ __align__(16) float smem[];
  float* buf_a = smem;                     // [<=128][TP]
  float* buf_b = buf_a + kEncWidest * TP;  // [<=128][TP]
  float* wsm = buf_b + kEncWidest * TP;    // [kKS][kCO]
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n0 = tile * TP;
  const int n_valid = min(TP, N - n0);

  const float* src = pts + ((size_t)b * N + n0) * cin;
  for (int e = threadIdx.x; e < cin * TP; e += kThreads) {
    const int p = e / cin, k = e - p * cin;
    const float v = p < n_valid ? src[p * cin + k] : 0.f;
    buf_a[k * TP + p] = bf16 ? rbf16(v) : v;
  }
  float* skip_tile = skip + ((size_t)b * N + n0) * kSkip;
  dense_layer<TP, kReluToSmem>(buf_a, cin, P.w[0], 64, 64, P.b[0], wsm, bf16, n_valid,
                               buf_b, nullptr, nullptr);
  dense_layer<TP, kReluToSmem>(buf_b, 64, P.w[1], 64, 64, P.b[1], wsm, bf16, n_valid,
                               buf_a, skip_tile, nullptr);
  dense_layer<TP, kReluToSmem>(buf_a, 64, P.w[2], 64, 64, P.b[2], wsm, bf16, n_valid,
                               buf_b, nullptr, nullptr);
  dense_layer<TP, kReluToSmem>(buf_b, 64, P.w[3], 128, 128, P.b[3], wsm, bf16, n_valid,
                               buf_a, nullptr, nullptr);
  dense_layer<TP, kReluRowMax>(buf_a, 128, P.w[4], kGlobal, kGlobal, P.b[4], wsm, bf16,
                               n_valid, nullptr, nullptr,
                               partial + ((size_t)b * n_tiles + tile) * kGlobal);
}

// gmax[b][c] = max over tiles of partial[b][t][c]
__global__ void __launch_bounds__(kThreads)
seg_encoder_reduce_kernel(const float* __restrict__ partial, int n_tiles,
                          float* __restrict__ gmax) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < kGlobal; c += kThreads) {
    const float* p = partial + (size_t)b * n_tiles * kGlobal + c;
    float m = p[0];
    for (int t = 1; t < n_tiles; ++t) m = fmaxf(m, p[(size_t)t * kGlobal]);
    gmax[(size_t)b * kGlobal + c] = m;
  }
}

// gproj[b][c] = b0[c] + sum_k gmax[b][k] * W0[64 + k][c]: the per-set half of
// K2's first layer.
__global__ void __launch_bounds__(kThreads)
seg_decoder_gproj_kernel(const float* __restrict__ gmax, const float* __restrict__ w0,
                         const float* __restrict__ b0, float* __restrict__ gproj,
                         int bf16) {
  __shared__ float g[kGlobal];
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < kGlobal; k += kThreads) {
    const float v = gmax[(size_t)b * kGlobal + k];
    g[k] = bf16 ? rbf16(v) : v;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kDec0; c += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < kGlobal; ++k) {
      const float w = w0[(size_t)(kSkip + k) * kDec0 + c];
      acc = fmaf(g[k], bf16 ? rbf16(w) : w, acc);
    }
    gproj[(size_t)b * kDec0 + c] = acc + b0[c];
  }
}

template <int TP>
__global__ void __launch_bounds__(kThreads)
seg_decoder_kernel(const float* __restrict__ skip, const float* __restrict__ gproj, int N,
                   DecParams P, float* __restrict__ out, int bf16) {
  extern __shared__ __align__(16) float smem[];
  float* buf_a = smem;                // [<=512][TP]
  float* buf_b = buf_a + kDec0 * TP;  // [<=256][TP]
  float* wsm = buf_b + 256 * TP;      // [kKS][kCO]
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n0 = tile * TP;
  const int n_valid = min(TP, N - n0);

  const float* src = skip + ((size_t)b * N + n0) * kSkip;
  for (int e = threadIdx.x; e < kSkip * TP; e += kThreads) {
    const int p = e / kSkip, k = e - p * kSkip;
    const float v = p < n_valid ? src[p * kSkip + k] : 0.f;
    buf_b[k * TP + p] = bf16 ? rbf16(v) : v;
  }
  dense_layer<TP, kReluToSmem>(buf_b, kSkip, P.w[0], kDec0, kDec0,
                               gproj + (size_t)b * kDec0, wsm, bf16, n_valid, buf_a,
                               nullptr, nullptr);
  dense_layer<TP, kReluToSmem>(buf_a, 512, P.w[1], 256, 256, P.b[1], wsm, bf16, n_valid,
                               buf_b, nullptr, nullptr);
  dense_layer<TP, kReluToSmem>(buf_b, 256, P.w[2], 128, 128, P.b[2], wsm, bf16, n_valid,
                               buf_a, nullptr, nullptr);
  dense_layer<TP, kReluToSmem>(buf_a, 128, P.w[3], 128, 128, P.b[3], wsm, bf16, n_valid,
                               buf_b, nullptr, nullptr);
  __syncthreads();
  for (int e = threadIdx.x; e < TP * 2; e += kThreads) {
    const int p = e >> 1, c = e & 1;
    if (p >= n_valid) continue;
    float acc = 0.f;
    for (int k = 0; k < 128; ++k) {
      const float w = P.lw[k * 2 + c];
      acc = fmaf(buf_b[k * TP + p], bf16 ? rbf16(w) : w, acc);
    }
    out[((size_t)b * N + n0 + p) * 2 + c] = acc + P.lb[c];
  }
}

constexpr size_t kEncSmem = sizeof(float) * (2 * kEncWidest * kEncTile + kKS * kCO);
constexpr size_t kDecSmem = sizeof(float) * ((kDec0 + 256) * kDecTile + kKS * kCO);

}  // namespace

extern "C" {

// The error state of the CUDA runtime this library launches through; the ctypes
// binding calls it right after each launcher.
int tdal_last_error() { return (int)cudaGetLastError(); }

int tdal_encoder_tile() { return kEncTile; }

// K1 main pass. pts (B, N, cin) f32; w[i] (in, out) row-major, b[i] (out,);
// skip (B, N, 64); partial (B, n_tiles, 1024) with n_tiles = ceil(N / kEncTile).
void tdal_seg_encoder(const float* pts, int B, int N, int cin, const float* const* w,
                      const float* const* b, float* skip, float* partial, int n_tiles,
                      int bf16, void* stream) {
  EncParams P;
  for (int i = 0; i < 5; ++i) {
    P.w[i] = w[i];
    P.b[i] = b[i];
  }
  cudaFuncSetAttribute(seg_encoder_kernel<kEncTile>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kEncSmem);
  seg_encoder_kernel<kEncTile><<<dim3(n_tiles, B), kThreads, kEncSmem,
                                 static_cast<cudaStream_t>(stream)>>>(
      pts, N, cin, P, skip, partial, n_tiles, bf16);
}

// K1 second pass: gmax (B, 1024) = max over tiles of partial.
void tdal_seg_encoder_reduce(const float* partial, int B, int n_tiles, float* gmax,
                             void* stream) {
  seg_encoder_reduce_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, n_tiles, gmax);
}

// K2 per-set pass: gproj (B, 512) = gmax @ w0[64:] + b0.
void tdal_seg_decoder_gproj(const float* gmax, int B, const float* w0, const float* b0,
                            float* gproj, int bf16, void* stream) {
  seg_decoder_gproj_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gmax, w0, b0, gproj, bf16);
}

// K2 point pass. skip (B, N, 64), gproj (B, 512); w[0] (1088, 512), w[1] (512, 256),
// w[2] (256, 128), w[3] (128, 128), b[1..3]; lw (128, 2), lb (2,); out (B, N, 2).
void tdal_seg_decoder(const float* skip, const float* gproj, int B, int N,
                      const float* const* w, const float* const* b, const float* lw,
                      const float* lb, float* out, int bf16, void* stream) {
  DecParams P;
  for (int i = 0; i < 4; ++i) {
    P.w[i] = w[i];
    P.b[i] = b[i];
  }
  P.lw = lw;
  P.lb = lb;
  const int n_tiles = (N + kDecTile - 1) / kDecTile;
  cudaFuncSetAttribute(seg_decoder_kernel<kDecTile>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDecSmem);
  seg_decoder_kernel<kDecTile><<<dim3(n_tiles, B), kThreads, kDecSmem,
                                 static_cast<cudaStream_t>(stream)>>>(skip, gproj, N, P,
                                                                      out, bf16);
}

}  // extern "C"
