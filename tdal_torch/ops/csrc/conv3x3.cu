// 3x3 stride-1 SAME NHWC convolution kernels for Hopper (sm_90a), f32 FMA.
//
// Replaces the Pallas TPU kernels of tdal/ops/pallas_conv.py:
//   K3  _fwd_stats_kernel (:147) via _pallas_fwd_stats (:213)
//       y = conv(act(x), w) + bias, act(x) = relu(x*s + t) with the halo outside the
//       image kept at zero (in_act) or x itself; per-channel [sum y, sum y^2] over the
//       valid image, taken from the f32 accumulator before y is rounded.
//   K4  _fwd_kernel (:267) via _pallas_fwd (:302)
//       y = conv(x, w) * scale + shift, optional ReLU. With spatially flipped,
//       in/out-swapped weights it is the dgrad of both custom VJPs.
//   K5  _wgrad_act_kernel (:519) via _pallas_wgrad_act (:570)
//       dw[ky,kx,ci,co] = sum_{b,h,w} act(x)[b,h+ky-1,w+kx-1,ci] * gy[b,h,w,co] in f32,
//       with K3's input affine, ReLU and halo mask.
//   K6  _wgrad_kernel (:622) via _pallas_wgrad (:655): K5 with in_act off, the same
//       CUDA kernel instantiated without the input affine.
//   K7  _dgrad_act_kernel (:375) via _pallas_dgrad_act (:438)
//       the dgrad of the in_act chain: acc = conv(gy, w flipped and in/out-swapped),
//       dxh = acc * [x*s + t > 0], dx = dxh * s rounded once to x's type, and per
//       channel [sum dxh*x, sum dxh] over the valid image. x is the forward's
//       unpadded saved input. It is K4's conv with another epilogue, so the tiling,
//       the halo and the fixed-order statistics are K3's.
//
// What bounds them on an H100: operations. At the detector's shapes (B=4, 468x468,
// 64..384 channels) a conv does 2*9*C*Co FLOP per pixel against 4*(C+Co) bytes, so
// 288..576 FLOP per byte in f32, far above the card's ridge; the ceiling is the
// 67 TFLOP/s of the CUDA cores in f32 (the bf16 tensor-core ceiling needs wgmma,
// which is later work).
//
// Design (right and simple first):
// - Conv (K3, K4, K7): one block of 256 threads per (8x16 output tile, image, 64 output
//   channels). The halo'd 10x18 input tile and the 9 taps' weights are staged in
//   shared memory one 16-channel slice at a time, the input affine + ReLU + halo mask
//   applied once at load. Each thread owns 8 pixels of one row x 4 output channels:
//   per (channel, kernel row) it loads 10 input values once and reuses them for the 3
//   kernel columns, so 96 FMAs cost 13 shared-memory loads.
// - Statistics (K3's [sum y, sum y^2], K7's [sum dxh*x, sum dxh]): each block reduces
//   its tile's valid pixels per channel in a fixed order and writes one partial; a
//   second kernel sums the partials per channel in double, in a fixed order. Hopper
//   runs blocks in no order, so the TPU's revisited (2, Co) output becomes this
//   deterministic second pass; no float atomics, the same result every run.
// - K7's epilogue reads x, s and t for its own output pixels only (no halo): the mask
//   x*s + t is taken as two rounded f32 operations (no fused multiply-add), as the
//   twin takes it, so both sides mask the same pixels. What bounds K7 is K4's
//   operations; the epilogue adds one read of x, where a separate pass would write
//   dxhat and read it and x back.
// - Wgrad (K5/K6): one block per (split of the tiles, 16 input channels, 64 output
//   channels). It walks its share of the 8x16 tiles, stages the activated halo'd x
//   tile and the gy tile in shared memory, and accumulates its 9x16x64 slice of dw in
//   registers (36 per thread; a sliding 3x3 window of x along each row, so 36 FMAs
//   cost 4 loads). Each split writes one partial; a second kernel sums the splits in
//   double, in a fixed order.
// - Ragged images and channel counts: loads outside the image or past C/Co read 0,
//   writes and statistics skip them, so any N, H, W >= 1 and any C, Co work.
// - bf16 (x, w, y of type __nv_bfloat16): values are widened to f32 in shared memory,
//   the activated input is rounded back to bf16 before the taps (as the TPU kernel
//   casts it to the input type), products accumulate in f32, the statistics come from
//   the f32 accumulator, and y is rounded to bf16 when stored. K7 rounds once, at dx,
//   as the TPU kernel does.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// tdal_torch/ops/build.py: launchers take raw pointers and a stream, allocate nothing
// and do not synchronise; the caller checks tdal_last_error() right after each call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8;            // output tile rows
constexpr int kTW = 16;           // output tile columns
constexpr int kHH = kTH + 2;      // halo'd tile rows
constexpr int kHW = kTW + 2;      // halo'd tile columns
constexpr int kCoT = 64;          // output channels per block
constexpr int kKC = 16;           // input channels per shared-memory slice
constexpr int kKCP = kKC + 1;     // padded pixel stride: the two pixel groups of a warp
                                  // (8 columns apart) fall in different banks
constexpr int kPX = 8;            // pixels per thread (one row segment)
constexpr int kCX = 4;            // output channels per thread
constexpr int kXS = kHH * kHW * kKCP;  // floats of the staged input tile

template <typename T>
__device__ __forceinline__ float widen(T v);
template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// f32 value of the working type's rounding of v
template <typename T>
__device__ __forceinline__ float round_to(float v) { return widen<T>(narrow<T>(v)); }

// Stage the halo'd input tile rows y0-1..y0+kTH, columns x0-1..x0+kTW, channels
// c0..c0+kKC of image xb into xs[pixel * kKCP + channel]; zero outside the image and
// past C. With in_act, relu(x*s + t) rounded to T, then the same zero outside.
template <typename T, bool kInAct>
__device__ __forceinline__ void stage_input(const T* __restrict__ xb, int H, int W, int C,
                                            int y0, int x0, int c0,
                                            const float* __restrict__ in_scale,
                                            const float* __restrict__ in_shift,
                                            float* xs) {
  for (int e = threadIdx.x; e < kHH * kHW * kKC; e += kThreads) {
    const int ci = e % kKC, pix = e / kKC;
    const int r = pix / kHW, c = pix - r * kHW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c, gc = c0 + ci;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C) {
      v = widen<T>(xb[((size_t)gy * W + gx) * C + gc]);
      // x*s, then + t, each rounded (no fused multiply-add): the twin's arithmetic
      if (kInAct) {
        v = __fadd_rn(__fmul_rn(v, in_scale[gc]), in_shift[gc]);
        v = round_to<T>(fmaxf(v, 0.f));
      }
    }
    xs[pix * kKCP + ci] = v;
  }
}

// What a conv kernel does with its f32 accumulator.
enum Epilogue {
  kAffine,     // K4: y = acc * out_scale + out_shift (ReLU if relu); out_scale may be null
  kStats,      // K3: y = acc + out_shift, and the tile's [sum y, sum y^2]
  kDgradAct,   // K7: pre = xres*out_scale + out_shift, dxh = acc * [pre > 0],
               //     y = dxh * out_scale, and the tile's [sum dxh*xres, sum dxh]
};

// K3, K4 and K7. Grid (tiles, B, ceil(Co / kCoT)).
//   kStats and kDgradAct: partial[(b * tiles + tile) * 2 + {0, 1}][co] = this tile's
//   two per-channel sums. xres (B, H, W, Co) is read by kDgradAct only.
template <typename T, bool kInAct, Epilogue kEpi>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, int H, int W, int C,
               int Co, int tiles_w, const float* __restrict__ in_scale,
               const float* __restrict__ in_shift, const float* __restrict__ out_scale,
               const float* __restrict__ out_shift, int relu, const T* __restrict__ xres,
               T* __restrict__ y, float* __restrict__ partial) {
  constexpr bool kSums = kEpi != kAffine;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;       // [kHH * kHW][kKCP]
  float* ws = xs + kXS;   // [9][kKC][kCoT]
  const int tile = blockIdx.x, b = blockIdx.y, co0 = blockIdx.z * kCoT;
  const int ty = tile / tiles_w, tx = tile - ty * tiles_w;
  const int y0 = ty * kTH, x0 = tx * kTW;
  const int tid = threadIdx.x;
  const int pg = tid >> 4, cg = tid & 15;
  const int pr = pg >> 1, pc0 = (pg & 1) * kPX;  // row, first column of the segment

  float acc[kPX][kCX];
#pragma unroll
  for (int i = 0; i < kPX; ++i)
#pragma unroll
    for (int j = 0; j < kCX; ++j) acc[i][j] = 0.f;

  const T* xb = x + (size_t)b * H * W * C;
  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // previous slice's readers are done
    stage_input<T, kInAct>(xb, H, W, C, y0, x0, c0, in_scale, in_shift, xs);
    for (int e = tid; e < 9 * kKC * kCoT; e += kThreads) {
      const int co = e % kCoT, rest = e / kCoT;
      const int ci = rest % kKC, tap = rest / kKC;
      const int gc = c0 + ci, gco = co0 + co;
      ws[e] = (gc < C && gco < Co) ? widen<T>(w[((size_t)tap * C + gc) * Co + gco]) : 0.f;
    }
    __syncthreads();
    const int kn = min(kKC, C - c0);
#pragma unroll 2
    for (int ci = 0; ci < kn; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float a[kPX + 2];
        const float* row = xs + ((pr + ky) * kHW + pc0) * kKCP + ci;
#pragma unroll
        for (int j = 0; j < kPX + 2; ++j) a[j] = row[j * kKCP];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              ws + ((ky * 3 + kx) * kKC + ci) * kCoT + cg * kCX);
#pragma unroll
          for (int i = 0; i < kPX; ++i) {
            const float v = a[i + kx];
            acc[i][0] = fmaf(v, w4.x, acc[i][0]);
            acc[i][1] = fmaf(v, w4.y, acc[i][1]);
            acc[i][2] = fmaf(v, w4.z, acc[i][2]);
            acc[i][3] = fmaf(v, w4.w, acc[i][3]);
          }
        }
      }
    }
  }

  const int gy = y0 + pr;
  float s[kCX], ss[kCX];
#pragma unroll
  for (int j = 0; j < kCX; ++j) {
    s[j] = 0.f;
    ss[j] = 0.f;
    const int co = co0 + cg * kCX + j;
    if (co >= Co) continue;
    const float sc = out_scale != nullptr ? out_scale[co] : 1.f;
    const float sh = out_shift[co];
#pragma unroll
    for (int i = 0; i < kPX; ++i) {
      const int gx = x0 + pc0 + i;
      if (gy >= H || gx >= W) continue;
      const size_t at = (((size_t)b * H + gy) * W + gx) * Co + co;
      float v;
      if constexpr (kEpi == kDgradAct) {
        const float xv = widen<T>(xres[at]);
        const float dxh = __fadd_rn(__fmul_rn(xv, sc), sh) > 0.f ? acc[i][j] : 0.f;
        s[j] = fmaf(dxh, xv, s[j]);
        ss[j] += dxh;
        v = dxh * sc;
      } else {
        v = fmaf(acc[i][j], sc, sh);
        if (relu) v = fmaxf(v, 0.f);
        if constexpr (kEpi == kStats) {
          s[j] += v;
          ss[j] = fmaf(v, v, ss[j]);
        }
      }
      y[at] = narrow<T>(v);
    }
  }
  if constexpr (kSums) {
    // per-tile sums in a fixed order: over the 16 pixel groups, then one partial
    __syncthreads();  // done with xs; reuse it
    float* red = xs;  // [2][16 pixel groups][kCoT]
#pragma unroll
    for (int j = 0; j < kCX; ++j) {
      red[pg * kCoT + cg * kCX + j] = s[j];
      red[16 * kCoT + pg * kCoT + cg * kCX + j] = ss[j];
    }
    __syncthreads();
    if (tid < kCoT && co0 + tid < Co) {
      float ts = 0.f, tss = 0.f;
      for (int p = 0; p < 16; ++p) {
        ts += red[p * kCoT + tid];
        tss += red[16 * kCoT + p * kCoT + tid];
      }
      float* out = partial + ((size_t)b * gridDim.x + tile) * 2 * Co + co0 + tid;
      out[0] = ts;
      out[Co] = tss;
    }
  }
}

// stats[0][co], stats[1][co] = sums over the n partials (n, 2, Co), in double, in a
// fixed order. Grid (Co).
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ partial, int n, int Co,
                    float* __restrict__ stats) {
  __shared__ double red[2][kThreads];
  const int co = blockIdx.x, tid = threadIdx.x;
  double s = 0.0, ss = 0.0;
  for (int i = tid; i < n; i += kThreads) {
    s += partial[(size_t)i * 2 * Co + co];
    ss += partial[((size_t)i * 2 + 1) * Co + co];
  }
  red[0][tid] = s;
  red[1][tid] = ss;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) {
      red[0][tid] += red[0][tid + h];
      red[1][tid] += red[1][tid + h];
    }
    __syncthreads();
  }
  if (tid == 0) {
    stats[co] = (float)red[0][0];
    stats[Co + co] = (float)red[1][0];
  }
}

// K5 (kInAct) / K6. Grid (splits, ceil(C / kKC), ceil(Co / kCoT)).
// partial[split][tap][ci][co] = this split's share of dw.
template <typename T, bool kInAct>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ gy, int H, int W, int C,
             int Co, int tiles_w, int tiles, int n_tiles,
             const float* __restrict__ in_scale, const float* __restrict__ in_shift,
             float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;      // [kHH * kHW][kKCP]
  float* gs = xs + kXS;  // [kTH * kTW][kCoT]
  const int split = blockIdx.x, c0 = blockIdx.y * kKC, co0 = blockIdx.z * kCoT;
  const int tid = threadIdx.x;
  const int cil = tid & 15;  // input channel c0 + cil
  const int cg = tid >> 4;   // output channels co0 + cg*4 .. +4

  float acc[9][kCX];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < kCX; ++j) acc[t][j] = 0.f;

  for (int t = split; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles, tile = t - b * tiles;
    const int ty = tile / tiles_w, tx = tile - ty * tiles_w;
    const int y0 = ty * kTH, x0 = tx * kTW;
    __syncthreads();
    stage_input<T, kInAct>(x + (size_t)b * H * W * C, H, W, C, y0, x0, c0, in_scale,
                           in_shift, xs);
    const T* gb = gy + (size_t)b * H * W * Co;
    for (int e = tid; e < kTH * kTW * kCoT; e += kThreads) {
      const int co = e % kCoT, pix = e / kCoT;
      const int r = pix / kTW, c = pix - r * kTW;
      const int py = y0 + r, px = x0 + c, gco = co0 + co;
      gs[e] = (py < H && px < W && gco < Co)
                  ? widen<T>(gb[((size_t)py * W + px) * Co + gco]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < kTH; ++r) {
      float a[3][3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        a[ky][0] = xs[((r + ky) * kHW + 0) * kKCP + cil];
        a[ky][1] = xs[((r + ky) * kHW + 1) * kKCP + cil];
      }
#pragma unroll
      for (int c = 0; c < kTW; ++c) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) a[ky][2] = xs[((r + ky) * kHW + c + 2) * kKCP + cil];
        const float4 g4 =
            *reinterpret_cast<const float4*>(gs + (r * kTW + c) * kCoT + cg * kCX);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            float* d = acc[ky * 3 + kx];
            const float v = a[ky][kx];
            d[0] = fmaf(v, g4.x, d[0]);
            d[1] = fmaf(v, g4.y, d[1]);
            d[2] = fmaf(v, g4.z, d[2]);
            d[3] = fmaf(v, g4.w, d[3]);
          }
          a[ky][0] = a[ky][1];
          a[ky][1] = a[ky][2];
        }
      }
    }
  }
  const int ci = c0 + cil;
  if (ci >= C) return;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < kCX; ++j) {
      const int co = co0 + cg * kCX + j;
      if (co < Co) partial[(((size_t)split * 9 + t) * C + ci) * Co + co] = acc[t][j];
    }
}

// dw[i] = sum over the splits of partial[split][i], in double, in a fixed order.
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ partial, int splits, size_t n,
                    float* __restrict__ dw) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
  dw[i] = (float)s;
}

constexpr size_t kConvSmem = sizeof(float) * (kXS + 9 * kKC * kCoT);
constexpr size_t kWgradSmem = sizeof(float) * (kXS + kTH * kTW * kCoT);
static_assert(2 * 16 * kCoT <= kXS, "the statistics scratch reuses the input tile");

inline int tiles_w_of(int W) { return (W + kTW - 1) / kTW; }
inline int tiles_of(int H, int W) { return ((H + kTH - 1) / kTH) * tiles_w_of(W); }
inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

template <typename T, bool kInAct, Epilogue kEpi>
void launch_conv(const void* x, const void* w, int B, int H, int W, int C, int Co,
                 const float* in_scale, const float* in_shift, const float* out_scale,
                 const float* out_shift, int relu, const void* xres, void* y,
                 float* partial, void* stream) {
  auto kern = conv3x3_kernel<T, kInAct, kEpi>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kConvSmem);
  const dim3 grid(tiles_of(H, W), B, (Co + kCoT - 1) / kCoT);
  kern<<<grid, kThreads, kConvSmem, as_stream(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), H, W, C, Co, tiles_w_of(W),
      in_scale, in_shift, out_scale, out_shift, relu, static_cast<const T*>(xres),
      static_cast<T*>(y), partial);
}

template <typename T, bool kInAct>
void launch_wgrad(const void* x, const void* gy, int B, int H, int W, int C, int Co,
                  const float* in_scale, const float* in_shift, int splits,
                  float* partial, void* stream) {
  auto kern = wgrad_kernel<T, kInAct>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kWgradSmem);
  const dim3 grid(splits, (C + kKC - 1) / kKC, (Co + kCoT - 1) / kCoT);
  kern<<<grid, kThreads, kWgradSmem, as_stream(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), H, W, C, Co, tiles_w_of(W),
      tiles_of(H, W), B * tiles_of(H, W), in_scale, in_shift, partial);
}

}  // namespace

extern "C" {

// Spatial tiles per image (rows of the K3 partial buffer are B * tiles).
int tdal_conv3x3_tiles(int H, int W) { return tiles_of(H, W); }

// (input-channel slices) * (output-channel chunks) of one wgrad split.
int tdal_conv3x3_wgrad_chunks(int C, int Co) {
  return ((C + kKC - 1) / kKC) * ((Co + kCoT - 1) / kCoT);
}

// K3. x (B, H, W, C), w (3, 3, C, Co), y (B, H, W, Co) of f32 (bf16 = 0) or bf16;
// in_scale/in_shift (C,) and bias (Co,) f32; partial (B * tiles, 2, Co) f32 scratch;
// stats (2, Co) f32.
void tdal_conv3x3_fwd_stats(const void* x, const void* w, int B, int H, int W, int C,
                            int Co, const float* in_scale, const float* in_shift,
                            int in_act, const float* bias, void* y, float* partial,
                            float* stats, int bf16, void* stream) {
  if (bf16) {
    if (in_act)
      launch_conv<__nv_bfloat16, true, kStats>(x, w, B, H, W, C, Co, in_scale, in_shift,
                                               nullptr, bias, 0, nullptr, y, partial,
                                               stream);
    else
      launch_conv<__nv_bfloat16, false, kStats>(x, w, B, H, W, C, Co, in_scale, in_shift,
                                                nullptr, bias, 0, nullptr, y, partial,
                                                stream);
  } else {
    if (in_act)
      launch_conv<float, true, kStats>(x, w, B, H, W, C, Co, in_scale, in_shift, nullptr,
                                       bias, 0, nullptr, y, partial, stream);
    else
      launch_conv<float, false, kStats>(x, w, B, H, W, C, Co, in_scale, in_shift, nullptr,
                                        bias, 0, nullptr, y, partial, stream);
  }
  if (cudaPeekAtLastError() != cudaSuccess) return;
  stats_reduce_kernel<<<Co, kThreads, 0, as_stream(stream)>>>(partial, B * tiles_of(H, W),
                                                              Co, stats);
}

// K4. y = conv(x, w) * scale + shift (scale may be null), ReLU if relu.
void tdal_conv3x3_fwd(const void* x, const void* w, int B, int H, int W, int C, int Co,
                      const float* scale, const float* shift, int relu, void* y, int bf16,
                      void* stream) {
  if (bf16)
    launch_conv<__nv_bfloat16, false, kAffine>(x, w, B, H, W, C, Co, nullptr, nullptr,
                                               scale, shift, relu, nullptr, y, nullptr,
                                               stream);
  else
    launch_conv<float, false, kAffine>(x, w, B, H, W, C, Co, nullptr, nullptr, scale,
                                       shift, relu, nullptr, y, nullptr, stream);
}

// K7. gy (B, H, W, Co), wt (3, 3, Co, C) (the forward weight flipped, in/out swapped),
// x (B, H, W, C) and dx (B, H, W, C) of f32 or bf16; s, t (C,) f32; partial
// (B * tiles, 2, C) f32 scratch; stats (2, C) f32 = [sum dxh*x, sum dxh].
void tdal_conv3x3_dgrad_act(const void* gy, const void* wt, const void* x, int B, int H,
                            int W, int Co, int C, const float* s, const float* t,
                            void* dx, float* partial, float* stats, int bf16,
                            void* stream) {
  if (bf16)
    launch_conv<__nv_bfloat16, false, kDgradAct>(gy, wt, B, H, W, Co, C, nullptr, nullptr,
                                                 s, t, 0, x, dx, partial, stream);
  else
    launch_conv<float, false, kDgradAct>(gy, wt, B, H, W, Co, C, nullptr, nullptr, s, t, 0,
                                         x, dx, partial, stream);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  stats_reduce_kernel<<<C, kThreads, 0, as_stream(stream)>>>(partial, B * tiles_of(H, W),
                                                             C, stats);
}

// K5 (in_act) / K6. x (B, H, W, C), gy (B, H, W, Co) of f32 or bf16; partial
// (splits, 9, C, Co) f32 scratch; dw (3, 3, C, Co) f32.
void tdal_conv3x3_wgrad(const void* x, const void* gy, int B, int H, int W, int C, int Co,
                        const float* in_scale, const float* in_shift, int in_act,
                        int splits, float* partial, float* dw, int bf16, void* stream) {
  if (bf16) {
    if (in_act)
      launch_wgrad<__nv_bfloat16, true>(x, gy, B, H, W, C, Co, in_scale, in_shift, splits,
                                        partial, stream);
    else
      launch_wgrad<__nv_bfloat16, false>(x, gy, B, H, W, C, Co, in_scale, in_shift, splits,
                                         partial, stream);
  } else {
    if (in_act)
      launch_wgrad<float, true>(x, gy, B, H, W, C, Co, in_scale, in_shift, splits, partial,
                                stream);
    else
      launch_wgrad<float, false>(x, gy, B, H, W, C, Co, in_scale, in_shift, splits,
                                 partial, stream);
  }
  if (cudaPeekAtLastError() != cudaSuccess) return;
  const size_t n = (size_t)9 * C * Co;
  wgrad_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                        as_stream(stream)>>>(partial, splits, n, dw);
}

}  // extern "C"
