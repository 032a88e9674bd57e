// The 3x3 conv kernels K3, K4, K5/K6 and K7 and their host-side launch templates,
// shared by conv3x3.cu (whole images: its design notes) and conv3x3_halo.cu (the row
// halo form). Each translation unit instantiates what its entry points launch.
//
// The row halo form (kHalo): the conv input x (K3, K4, K5/K6), or the cotangent gy taken
// as K7's and the K4 dgrad's conv input, holds top + H + bottom rows, top and bottom 0 or
// 1, all real image rows: a rank's slab of a map split by rows, with its neighbours' edge
// rows around it. Output row r reads input rows r + top - 1 .. r + top + 1; only rows
// outside the top + H + bottom read zero padding, so a side with a halo row is never
// padded, and the input affine + ReLU (in_act) applies to its halo row as to any real
// row. The output, the statistics, K7's x and the wgrad's gy cover the H own rows. Without
// the halo every instantiation is the whole-image kernel (kHalo false: top 0, input rows
// H).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8;            // output tile rows
constexpr int kTW = 16;           // output tile columns
constexpr int kHH = kTH + 2;      // halo'd tile rows
constexpr int kHW = kTW + 2;      // halo'd tile columns
constexpr int kHPix = kHH * kHW;  // halo'd tile pixels
constexpr int kTPix = kTH * kTW;  // output tile pixels
constexpr int kCoT = 64;          // output channels per block
constexpr int kStages = 2;        // shared-memory ring depth
constexpr int kWCi = 32;          // wgrad: input channels per block

// ---------------------------------------------------------------------------
// Element types and the tensor-core primitives
// ---------------------------------------------------------------------------

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

// Shared-memory geometry of one operand mode: a conv K slice is 64 bytes of channels
template <typename T>
struct Geo {
  static constexpr int kKC = 64 / sizeof(T);   // conv: input channels per slice
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kXS = kKC + kVec;        // conv: x pixel stride, 80 bytes
  static constexpr int kWS = kCoT + 8;          // weight and gy row stride
  static constexpr int kWXS = kWCi + 8;         // wgrad: x pixel stride
  // elements of one ring stage
  static constexpr int kConvStage = kHPix * kXS + 9 * kKC * kWS;
  static constexpr int kWgradStage = kHPix * kWXS + kTPix * kWS;
};
// elements of the wgrad kernel's lo buffer: the split of the f32 input tile
template <typename T>
constexpr int kXlo = sizeof(T) == 4 ? kHPix * Geo<T>::kWXS : 0;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 fills the 16 bytes with zero
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, m16n8k8, tf32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a = hi + lo: hi = a with its 13 low mantissa bits cleared (a TF32 value), lo = a - hi
// exactly (13 significant bits at most, below 2^-10 |a|), of which the tensor core reads
// the TF32 part. Two ops; splitting by cvt.rna.tf32.f32 instead measured 20-25% slower
// at the same error (PERF.md).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// a[0..N) = 0, and acc[0..N) += part[0..N): accumulator arrays seen flat (the indices
// are constants once unrolled, so they stay in registers)
template <int N>
__device__ __forceinline__ void zero(float* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}
template <int N>
__device__ __forceinline__ void add_to(float* acc, const float* part) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i];
}

// ---------------------------------------------------------------------------
// Conv (K3, K4, K7)
// ---------------------------------------------------------------------------

// What a conv kernel does with its f32 accumulator.
enum Epilogue {
  kAffine,     // K4: y = acc * out_scale + out_shift (ReLU if relu); out_scale may be null
  kStats,      // K3: y = acc + out_shift, and the tile's [sum y, sum y^2]
  kDgradAct,   // K7: pre = xres*out_scale + out_shift, dxh = acc * [pre > 0],
               //     y = dxh * out_scale, and the tile's [sum dxh*xres, sum dxh]
};

// Issue the copies of one conv slice (input channels c0.. of the halo'd tile at
// (y0 - 1, x0 - 1), and those channels' 9 weight taps for output channels co0..) into
// one ring stage; hv[pixel] = 1 where the halo'd pixel lies in the image.
template <typename T, bool kVec>
__device__ __forceinline__ void conv_load(T* xs, T* ws, unsigned char* hv,
                                          const T* __restrict__ xb,
                                          const T* __restrict__ w, int H, int W, int C,
                                          int Co, int y0, int x0, int c0, int co0) {
  using G = Geo<T>;
  const int tid = threadIdx.x;
  for (int p = tid; p < kHPix; p += kThreads) {
    const int r = p / kHW, c = p - r * kHW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    hv[p] = gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
  if constexpr (kVec) {
    // input: kQ 16-byte chunks a pixel; a thread keeps its chunk column q
    constexpr int kQ = G::kKC / G::kVec;
    const int q = tid % kQ, gc = c0 + q * G::kVec;
    for (int p = tid / kQ; p < kHPix; p += kThreads / kQ) {
      const int r = p / kHW, c = p - r * kHW;
      const int gy = y0 - 1 + r, gx = x0 - 1 + c;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C;
      cp_async16(xs + p * G::kXS + q * G::kVec,
                 ok ? xb + ((size_t)gy * W + gx) * C + gc : xb, ok);
    }
    // weights: kRQ chunks a (tap, channel) row of kCoT output channels
    constexpr int kRQ = kCoT / G::kVec;
    const int wq = tid % kRQ, gco = co0 + wq * G::kVec;
    for (int row = tid / kRQ; row < 9 * G::kKC; row += kThreads / kRQ) {
      const int tap = row / G::kKC, ci = row % G::kKC;
      const bool ok = c0 + ci < C && gco < Co;
      cp_async16(ws + row * G::kWS + wq * G::kVec,
                 ok ? w + ((size_t)tap * C + c0 + ci) * Co + gco : w, ok);
    }
  } else {
    for (int e = tid; e < kHPix * G::kKC; e += kThreads) {
      const int p = e / G::kKC, ci = e % G::kKC;
      const int r = p / kHW, c = p - r * kHW;
      const int gy = y0 - 1 + r, gx = x0 - 1 + c, gc = c0 + ci;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C;
      xs[p * G::kXS + ci] = ok ? xb[((size_t)gy * W + gx) * C + gc] : narrow<T>(0.f);
    }
    for (int e = tid; e < 9 * G::kKC * kCoT; e += kThreads) {
      const int row = e / kCoT, co = e % kCoT;
      const int tap = row / G::kKC, ci = row % G::kKC;
      const bool ok = c0 + ci < C && co0 + co < Co;
      ws[row * G::kWS + co] =
          ok ? w[((size_t)tap * C + c0 + ci) * Co + co0 + co] : narrow<T>(0.f);
    }
  }
}

// Four consecutive channels of a shared-memory tile (16 bytes f32, 8 bytes bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// A thread's share of an in-place pass over a landed input tile of kPix pixels x kC
// channels c0.. (pixel stride kStride): a fixed quad of 4 channels, every
// (kThreads / (kC / 4))-th pixel; its in_act scale and shift (0 past C).
template <int kC>
struct QuadPass {
  static constexpr int kQ = kC / 4;
  int q, p0;
  float sc[4], sh[4];
  bool ok[4];
  __device__ __forceinline__ QuadPass(int C, int c0, const float* __restrict__ s,
                                      const float* __restrict__ t)
      : q(threadIdx.x % kQ), p0(threadIdx.x / kQ) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + 4 * q + j;
      ok[j] = gc < C;
      sc[j] = ok[j] && s != nullptr ? s[gc] : 0.f;
      sh[j] = ok[j] && t != nullptr ? t[gc] : 0.f;
    }
  }
  // relu(v*s + t) (two rounded f32 ops, no fused multiply-add: the twin's arithmetic)
  // rounded to T, where the channel < C (the halo and the channels past C stay zero)
  template <typename T>
  __device__ __forceinline__ void apply(float (&v)[4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = fmaxf(__fadd_rn(__fmul_rn(v[j], sc[j]), sh[j]), 0.f);
      if (ok[j]) v[j] = widen<T>(narrow<T>(a));
    }
  }
};

// In place on a landed input tile: relu(x*s + t) rounded to T where the pixel lies in
// the image (hv) and the channel < C.
template <typename T, int kPix, int kC, int kStride>
__device__ __forceinline__ void activate_tile(T* xs, const unsigned char* hv, int C,
                                              int c0, const float* __restrict__ s,
                                              const float* __restrict__ t) {
  const QuadPass<kC> qp(C, c0, s, t);
  for (int p = qp.p0; p < kPix; p += kThreads / QuadPass<kC>::kQ) {
    if (!hv[p]) continue;
    T* at = xs + p * kStride + 4 * qp.q;
    float v[4];
    load4(at, v);
    qp.template apply<T>(v);
    store4(at, v);
  }
}

// The products of one landed conv slice: acc[mi][nj] += window(tap) x weights(tap)
// over the 9 taps, for the warp's 2 row tiles (mi) x 4 channel tiles (nj). The tap loop
// stays rolled: unrolled, it holds more fragments than 128 registers and spills.
// f32: split TF32, issued pass by pass (lo*hi, hi*lo, hi*hi over all 8 tiles), so the
// three products into one accumulator are 8 instructions apart.
__device__ __forceinline__ void conv_mma(float (&acc)[2][4][4], const float* xs,
                                         const float* ws, int wm, int wn, int lane) {
  using G = Geo<float>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    const float* a0 = xs + ((2 * wm + ky) * kHW + kx + g) * G::kXS + t;
    const float* b0 = ws + (tap * G::kKC + t) * G::kWS + wn * 32 + g;
#pragma unroll
    for (int k0 = 0; k0 < G::kKC; k0 += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* a = a0 + mi * kHW * G::kXS + k0;
        split_tf32(a[0], ah[mi][0], al[mi][0]);
        split_tf32(a[8 * G::kXS], ah[mi][1], al[mi][1]);
        split_tf32(a[4], ah[mi][2], al[mi][2]);
        split_tf32(a[8 * G::kXS + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const float* b = b0 + k0 * G::kWS + nj * 8;
        split_tf32(b[0], bh[nj][0], bl[nj][0]);
        split_tf32(b[4 * G::kWS], bh[nj][1], bl[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mi][nj], al[mi], bh[nj][0], bh[nj][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mi][nj], ah[mi], bl[nj][0], bl[nj][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mi][nj], ah[mi], bh[nj][0], bh[nj][1]);
    }
  }
}

__device__ __forceinline__ void conv_mma(float (&acc)[2][4][4], const __nv_bfloat16* xs,
                                         const __nv_bfloat16* ws, int wm, int wn,
                                         int lane) {
  using G = Geo<__nv_bfloat16>;
  // ldmatrix row addresses: A (pixels x channels) plain, B (channels x outputs) .trans
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 8;
  const int bk = am, bn = ak;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
#pragma unroll
    for (int k0 = 0; k0 < G::kKC; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], xs + ((2 * wm + mi + ky) * kHW + kx + am) * G::kXS + k0 + ak);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ws + (tap * G::kKC + k0 + bk) * G::kWS + wn * 32 + np * 16 + bn);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b, bool pair, bool second);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b, bool pair,
                                                  bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (second) p[1] = b;
  }
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                          float b, bool pair,
                                                          bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (second) p[1] = __float2bfloat16_rn(b);
  }
}

// K3, K4 and K7. Grid (tiles, B, ceil(Co / kCoT)).
//   kStats and kDgradAct: partial[(b * tiles + tile) * 2 + {0, 1}][co] = this tile's
//   two per-channel sums. xres (B, H, W, Co) is read by kDgradAct only. pair: Co is
//   even and y, xres allow two-element accesses.
//   kHalo: x has in_h = top + H + bottom rows (see the top of this file).
template <typename T, bool kInAct, Epilogue kEpi, bool kVec, bool kHalo>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, int H, int W, int C,
               int Co, int tiles_w, const float* __restrict__ in_scale,
               const float* __restrict__ in_shift, const float* __restrict__ out_scale,
               const float* __restrict__ out_shift, int relu, const T* __restrict__ xres,
               T* __restrict__ y, float* __restrict__ partial, int pair, int top,
               int in_h) {
  using G = Geo<T>;
  constexpr bool kSums = kEpi != kAffine;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][x tile | weights]
  unsigned char* hv = smem_raw + sizeof(T) * kStages * G::kConvStage;  // [kStages][kHPix]
  const int tile = blockIdx.x, b = blockIdx.y, co0 = blockIdx.z * kCoT;
  const int ty = tile / tiles_w, tx = tile - ty * tiles_w;
  const int y0 = ty * kTH, x0 = tx * kTW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // output rows 2wm, 2wm+1; channels 32wn..

  float acc[2][4][4];
  zero<32>(&acc[0][0][0]);

  // the input's rows and the input row of output row y0 (the tile's window starts one
  // above it)
  const int xh = kHalo ? in_h : H, xy0 = y0 + (kHalo ? top : 0);
  const T* xb = x + (size_t)b * xh * W * C;
  const int n_slices = (C + G::kKC - 1) / G::kKC;
  auto load = [&](int slice) {
    T* st = ring + (slice % kStages) * G::kConvStage;
    conv_load<T, kVec>(st, st + kHPix * G::kXS, hv + (slice % kStages) * kHPix, xb, w, xh,
                       W, C, Co, xy0, x0, slice * G::kKC, co0);
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_slices) load(i);
    cp_async_commit();
  }
  for (int s = 0; s < n_slices; ++s) {
    // its stage's readers finished at the last sync
    if (s + kStages - 1 < n_slices) load(s + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // slice s has landed (this thread's copies)
    __syncthreads();               // ... and everyone's
    T* xs = ring + (s % kStages) * G::kConvStage;
    if constexpr (kInAct) {
      activate_tile<T, kHPix, G::kKC, G::kXS>(xs, hv + (s % kStages) * kHPix, C,
                                              s * G::kKC, in_scale, in_shift);
      __syncthreads();
    }
    // the tensor cores truncate as they accumulate: the slice's sum starts from zero
    // and joins acc by a rounded f32 add, so the truncation stays that of one slice
    float part[2][4][4];
    zero<32>(&part[0][0][0]);
    conv_mma(part, xs, xs + kHPix * G::kXS, wm, wn, lane);
    add_to<32>(&acc[0][0][0], &part[0][0][0]);
    __syncthreads();  // the stage is free for slice s + 2
  }
  cp_async_wait<0>();

  // epilogue: element (mi, nj, q) of the accumulator is pixel (row 2wm + mi, column
  // g + 8 (q >> 1)) and output channel 32wn + 8nj + 2t + (q & 1) of the tile
  const int g = lane >> 2, t = lane & 3;
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) s1[nj][e] = s2[nj][e] = 0.f;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int co = co0 + wn * 32 + nj * 8 + 2 * t;
    if (co >= Co) continue;
    const bool second = co + 1 < Co;
    float sc[2], sh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = second ? co + e : co;
      sc[e] = out_scale != nullptr ? out_scale[c] : 1.f;
      sh[e] = out_shift[c];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int gy = y0 + 2 * wm + mi;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = x0 + g + 8 * h;
        if (gy >= H || gx >= W) continue;
        const size_t at = (((size_t)b * H + gy) * W + gx) * Co + co;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[mi][nj][2 * h + e];
          if constexpr (kEpi == kDgradAct) {
            const float xv = (e == 0 || second) ? widen<T>(xres[at + e]) : 0.f;
            const float dxh = __fadd_rn(__fmul_rn(xv, sc[e]), sh[e]) > 0.f ? a : 0.f;
            s1[nj][e] = fmaf(dxh, xv, s1[nj][e]);
            s2[nj][e] += dxh;
            v[e] = dxh * sc[e];
          } else {
            v[e] = fmaf(a, sc[e], sh[e]);
            if (relu) v[e] = fmaxf(v[e], 0.f);
            if constexpr (kEpi == kStats) {
              s1[nj][e] += v[e];
              s2[nj][e] = fmaf(v[e], v[e], s2[nj][e]);
            }
          }
        }
        store_pair<T>(y + at, v[0], v[1], pair, second);
      }
    }
  }
  if constexpr (kSums) {
    // per-tile sums in a fixed order: the warp's 8 pixel groups by a butterfly (every
    // lane ends with the same bits), then the 4 pixel warps in order
    float* red = reinterpret_cast<float*>(smem_raw);  // [2][4 pixel warps][kCoT]
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s1[nj][e] += __shfl_xor_sync(0xffffffffu, s1[nj][e], m);
          s2[nj][e] += __shfl_xor_sync(0xffffffffu, s2[nj][e], m);
        }
    if (g == 0) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * 32 + nj * 8 + 2 * t + e;
          red[wm * kCoT + c] = s1[nj][e];
          red[(4 + wm) * kCoT + c] = s2[nj][e];
        }
    }
    __syncthreads();
    if (tid < kCoT && co0 + tid < Co) {
      float ts = 0.f, tss = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        ts += red[p * kCoT + tid];
        tss += red[(4 + p) * kCoT + tid];
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

// ---------------------------------------------------------------------------
// Wgrad (K5/K6)
// ---------------------------------------------------------------------------

// Issue the copies of one wgrad pixel tile (tile at (y0, x0) of image b): the halo'd
// input tile of channels c0..c0+kWCi and the gy tile of channels co0..co0+kCoT;
// hv[pixel] = 1 where the halo'd pixel lies in the image. The input has xh rows, and
// output row y0 is its row y0 + xdy (the row halo form; xh = H, xdy = 0 without it).
template <typename T, bool kVec>
__device__ __forceinline__ void wgrad_load(T* xs, T* gs, unsigned char* hv,
                                           const T* __restrict__ xb,
                                           const T* __restrict__ gb, int H, int W, int C,
                                           int Co, int y0, int x0, int c0, int co0, int xh,
                                           int xdy) {
  using G = Geo<T>;
  const int tid = threadIdx.x;
  for (int p = tid; p < kHPix; p += kThreads) {
    const int r = p / kHW, c = p - r * kHW;
    const int gy = y0 + xdy - 1 + r, gx = x0 - 1 + c;
    hv[p] = gy >= 0 && gy < xh && gx >= 0 && gx < W;
  }
  if constexpr (kVec) {
    constexpr int kQ = kWCi / G::kVec;
    const int q = tid % kQ, gc = c0 + q * G::kVec;
    for (int p = tid / kQ; p < kHPix; p += kThreads / kQ) {
      const int r = p / kHW, c = p - r * kHW;
      const int gy = y0 + xdy - 1 + r, gx = x0 - 1 + c;
      const bool ok = gy >= 0 && gy < xh && gx >= 0 && gx < W && gc < C;
      cp_async16(xs + p * G::kWXS + q * G::kVec,
                 ok ? xb + ((size_t)gy * W + gx) * C + gc : xb, ok);
    }
    constexpr int kRQ = kCoT / G::kVec;
    const int gq = tid % kRQ, gco = co0 + gq * G::kVec;
    for (int p = tid / kRQ; p < kTPix; p += kThreads / kRQ) {
      const int py = y0 + p / kTW, px = x0 + p % kTW;
      const bool ok = py < H && px < W && gco < Co;
      cp_async16(gs + p * G::kWS + gq * G::kVec,
                 ok ? gb + ((size_t)py * W + px) * Co + gco : gb, ok);
    }
  } else {
    for (int e = tid; e < kHPix * kWCi; e += kThreads) {
      const int p = e / kWCi, ci = e % kWCi;
      const int r = p / kHW, c = p - r * kHW;
      const int gy = y0 + xdy - 1 + r, gx = x0 - 1 + c, gc = c0 + ci;
      const bool ok = gy >= 0 && gy < xh && gx >= 0 && gx < W && gc < C;
      xs[p * G::kWXS + ci] = ok ? xb[((size_t)gy * W + gx) * C + gc] : narrow<T>(0.f);
    }
    for (int e = tid; e < kTPix * kCoT; e += kThreads) {
      const int p = e / kCoT, co = e % kCoT;
      const int py = y0 + p / kTW, px = x0 + p % kTW;
      const bool ok = py < H && px < W && co0 + co < Co;
      gs[p * G::kWS + co] = ok ? gb[((size_t)py * W + px) * Co + co0 + co] : narrow<T>(0.f);
    }
  }
}

// In place on a landed wgrad input tile, before its products: f32 splits each value
// once into hi (kept in xs) and lo (into xlo), after the input affine with in_act; bf16
// applies the input affine only.
template <bool kInAct>
__device__ __forceinline__ void prepare_wgrad_x(float* xs, float* xlo,
                                                const unsigned char* hv, int C, int c0,
                                                const float* __restrict__ s,
                                                const float* __restrict__ t) {
  using G = Geo<float>;
  const QuadPass<kWCi> qp(C, c0, kInAct ? s : nullptr, kInAct ? t : nullptr);
  for (int p = qp.p0; p < kHPix; p += kThreads / QuadPass<kWCi>::kQ) {
    const int at = p * G::kWXS + 4 * qp.q;
    float v[4], hi[4], lo[4];
    load4(xs + at, v);
    if (kInAct && hv[p]) qp.apply<float>(v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t h, l;
      split_tf32(v[j], h, l);
      hi[j] = __uint_as_float(h);
      lo[j] = __uint_as_float(l);
    }
    store4(xs + at, hi);
    store4(xlo + at, lo);
  }
}
template <bool kInAct>
__device__ __forceinline__ void prepare_wgrad_x(__nv_bfloat16* xs, __nv_bfloat16*,
                                                const unsigned char* hv, int C, int c0,
                                                const float* __restrict__ s,
                                                const float* __restrict__ t) {
  if constexpr (kInAct)
    activate_tile<__nv_bfloat16, kHPix, kWCi, Geo<__nv_bfloat16>::kWXS>(xs, hv, C, c0, s, t);
}

// The products of one landed wgrad tile: acc[tap][nj] += window(tap)^T x gy over the
// tile's pixels, for the warp's 16 input channels (wm) x 2 channel tiles of 8 (nj).
// f32: the input tile comes split (xs hi, xlo lo); the 3 taps of a kernel row go pass
// by pass (lo*hi, hi*lo, hi*hi over 6 tiles), so no product waits on the one before.
__device__ __forceinline__ void wgrad_mma(float (&acc)[9][2][4], const float* xs,
                                          const float* xlo, const float* gs, int wm,
                                          int wn, int lane) {
  using G = Geo<float>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int r = 0; r < kTH; ++r) {
#pragma unroll
    for (int hc = 0; hc < kTW; hc += 8) {  // a k-step of 8 pixels of row r
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const float* bp = gs + (r * kTW + hc + t) * G::kWS + wn * 16 + nj * 8 + g;
        split_tf32(bp[0], bh[nj][0], bl[nj][0]);
        split_tf32(bp[4 * G::kWS], bh[nj][1], bl[nj][1]);
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        uint32_t ah[3][4], al[3][4];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int at = ((r + ky) * kHW + hc + kx + t) * G::kWXS + wm * 16 + g;
          const int off[4] = {0, 8, 4 * G::kWXS, 4 * G::kWXS + 8};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ah[kx][q] = __float_as_uint(xs[at + off[q]]);
            al[kx][q] = __float_as_uint(xlo[at + off[q]]);
          }
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int nj = 0; nj < 2; ++nj)
            mma_tf32(acc[ky * 3 + kx][nj], al[kx], bh[nj][0], bh[nj][1]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int nj = 0; nj < 2; ++nj)
            mma_tf32(acc[ky * 3 + kx][nj], ah[kx], bl[nj][0], bl[nj][1]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int nj = 0; nj < 2; ++nj)
            mma_tf32(acc[ky * 3 + kx][nj], ah[kx], bh[nj][0], bh[nj][1]);
      }
    }
  }
}

__device__ __forceinline__ void wgrad_mma(float (&acc)[9][2][4], const __nv_bfloat16* xs,
                                          const __nv_bfloat16*, const __nv_bfloat16* gs,
                                          int wm, int wn, int lane) {
  using G = Geo<__nv_bfloat16>;
  // ldmatrix .trans row addresses: A = window^T (channels x pixels) from the
  // pixel-major tile, B = gy (pixels x outputs)
  const int ap = (lane & 7) + ((lane >> 4) & 1) * 8, ac = ((lane >> 3) & 1) * 8;
  const int bp = (lane & 7) + ((lane >> 3) & 1) * 8, bn = (lane >> 4) * 8;
#pragma unroll 2
  for (int r = 0; r < kTH; ++r) {  // a k-step of the 16 pixels of row r
    uint32_t b[4];
    ldmatrix_x4_trans(b, gs + (r * kTW + bp) * G::kWS + wn * 16 + bn);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t a[4];
      ldmatrix_x4_trans(a, xs + ((r + ky) * kHW + kx + ap) * G::kWXS + wm * 16 + ac);
      mma_bf16(acc[tap][0], a, b[0], b[1]);
      mma_bf16(acc[tap][1], a, b[2], b[3]);
    }
  }
}

// K5 (kInAct) / K6. Grid (splits, ceil(C / kWCi), ceil(Co / kCoT)).
// partial[split][tap][ci][co] = this split's share of dw. kHalo: x has in_h = top + H +
// bottom rows, gy H.
template <typename T, bool kInAct, bool kVec, bool kHalo>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ gy, int H, int W, int C,
             int Co, int tiles_w, int tiles, int n_tiles,
             const float* __restrict__ in_scale, const float* __restrict__ in_shift,
             float* __restrict__ partial, int top, int in_h) {
  using G = Geo<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][x tile | gy tile]
  T* xlo = ring + kStages * G::kWgradStage;   // f32: the lo half of the split x tile
  unsigned char* hv = reinterpret_cast<unsigned char*>(xlo + kXlo<T>);
  const int split = blockIdx.x, c0 = blockIdx.y * kWCi, co0 = blockIdx.z * kCoT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // channels c0 + 16wm.., co0 + 16wn..

  float acc[9][2][4];
  zero<72>(&acc[0][0][0]);

  const int n_mine = split < n_tiles ? (n_tiles - split + gridDim.x - 1) / gridDim.x : 0;
  const int xh = kHalo ? in_h : H, xdy = kHalo ? top : 0;
  auto load = [&](int k) {
    const int tt = split + k * gridDim.x;
    const int b = tt / tiles, tile = tt - b * tiles;
    const int ty = tile / tiles_w, tx = tile - ty * tiles_w;
    T* st = ring + (k % kStages) * G::kWgradStage;
    wgrad_load<T, kVec>(st, st + kHPix * G::kWXS, hv + (k % kStages) * kHPix,
                        x + (size_t)b * xh * W * C, gy + (size_t)b * H * W * Co, H, W, C,
                        Co, ty * kTH, tx * kTW, c0, co0, xh, xdy);
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_mine) load(i);
    cp_async_commit();
  }
  for (int k = 0; k < n_mine; ++k) {
    if (k + kStages - 1 < n_mine) load(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    T* xs = ring + (k % kStages) * G::kWgradStage;
    if constexpr (kInAct || kXlo<T> > 0) {
      prepare_wgrad_x<kInAct>(xs, xlo, hv + (k % kStages) * kHPix, C, c0, in_scale,
                              in_shift);
      __syncthreads();
    }
    float part[9][2][4];  // the tile's sum, joined by a rounded add (see conv3x3_kernel)
    zero<72>(&part[0][0][0]);
    wgrad_mma(part, xs, xlo, xs + kHPix * G::kWXS, wm, wn, lane);
    add_to<72>(&acc[0][0][0], &part[0][0][0]);
    __syncthreads();
  }
  cp_async_wait<0>();

  // element (tap, nj, q): input channel c0 + 16wm + g + 8 (q >> 1), output channel
  // co0 + 16wn + 8nj + 2t + (q & 1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = c0 + wm * 16 + g + 8 * (q >> 1);
        const int co = co0 + wn * 16 + nj * 8 + 2 * t + (q & 1);
        if (ci < C && co < Co)
          partial[(((size_t)split * 9 + tap) * C + ci) * Co + co] = acc[tap][nj][q];
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

template <typename T>
constexpr size_t conv_smem() {
  return sizeof(T) * kStages * Geo<T>::kConvStage + kStages * kHPix;
}
template <typename T>
constexpr size_t wgrad_smem() {
  return sizeof(T) * (kStages * Geo<T>::kWgradStage + kXlo<T>) + kStages * kHPix;
}
static_assert(conv_smem<float>() <= 113 * 1024, "two conv blocks fit an SM");
static_assert(wgrad_smem<float>() <= 232448, "a wgrad block fits an SM");
static_assert(2 * 4 * kCoT * sizeof(float) <= sizeof(float) * Geo<float>::kConvStage,
              "the statistics scratch reuses the ring");

inline int tiles_w_of(int W) { return (W + kTW - 1) / kTW; }
inline int tiles_of(int H, int W) { return ((H + kTH - 1) / kTH) * tiles_w_of(W); }
inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }
inline bool aligned(const void* p, size_t n) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % n == 0;
}

// 16-byte copies need every channel row to start on 16 bytes: the channel counts a
// multiple of 16 bytes and the bases aligned
template <typename T>
bool vec_ok(int C, int Co, const void* a, const void* b) {
  constexpr int v = Geo<T>::kVec;
  return C % v == 0 && Co % v == 0 && aligned(a, 16) && aligned(b, 16);
}

// H is the output's rows; the input has top + H + bottom (both 0 unless kHalo).
template <typename T, bool kInAct, Epilogue kEpi, bool kVec, bool kHalo>
void launch_conv_as(const void* x, const void* w, int B, int H, int W, int C, int Co,
                    const float* in_scale, const float* in_shift, const float* out_scale,
                    const float* out_shift, int relu, const void* xres, void* y,
                    float* partial, int top, int bottom, void* stream) {
  auto kern = conv3x3_kernel<T, kInAct, kEpi, kVec, kHalo>;
  constexpr size_t smem = conv_smem<T>();
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int pair = Co % 2 == 0 && aligned(y, 2 * sizeof(T)) && aligned(xres, 2 * sizeof(T));
  const dim3 grid(tiles_of(H, W), B, (Co + kCoT - 1) / kCoT);
  kern<<<grid, kThreads, smem, as_stream(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), H, W, C, Co, tiles_w_of(W),
      in_scale, in_shift, out_scale, out_shift, relu, static_cast<const T*>(xres),
      static_cast<T*>(y), partial, pair, top, top + H + bottom);
}

template <typename T, bool kInAct, Epilogue kEpi, bool kHalo = false>
void launch_conv(const void* x, const void* w, int B, int H, int W, int C, int Co,
                 const float* in_scale, const float* in_shift, const float* out_scale,
                 const float* out_shift, int relu, const void* xres, void* y,
                 float* partial, void* stream, int top = 0, int bottom = 0) {
  if (vec_ok<T>(C, Co, x, w))
    launch_conv_as<T, kInAct, kEpi, true, kHalo>(x, w, B, H, W, C, Co, in_scale, in_shift,
                                                 out_scale, out_shift, relu, xres, y,
                                                 partial, top, bottom, stream);
  else
    launch_conv_as<T, kInAct, kEpi, false, kHalo>(x, w, B, H, W, C, Co, in_scale, in_shift,
                                                  out_scale, out_shift, relu, xres, y,
                                                  partial, top, bottom, stream);
}

template <typename T, bool kInAct, bool kVec, bool kHalo>
void launch_wgrad_as(const void* x, const void* gy, int B, int H, int W, int C, int Co,
                     const float* in_scale, const float* in_shift, int splits,
                     float* partial, int top, int bottom, void* stream) {
  auto kern = wgrad_kernel<T, kInAct, kVec, kHalo>;
  constexpr size_t smem = wgrad_smem<T>();
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(splits, (C + kWCi - 1) / kWCi, (Co + kCoT - 1) / kCoT);
  kern<<<grid, kThreads, smem, as_stream(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), H, W, C, Co, tiles_w_of(W),
      tiles_of(H, W), B * tiles_of(H, W), in_scale, in_shift, partial, top,
      top + H + bottom);
}

template <typename T, bool kInAct, bool kHalo = false>
void launch_wgrad(const void* x, const void* gy, int B, int H, int W, int C, int Co,
                  const float* in_scale, const float* in_shift, int splits,
                  float* partial, void* stream, int top = 0, int bottom = 0) {
  if (vec_ok<T>(C, Co, x, gy))
    launch_wgrad_as<T, kInAct, true, kHalo>(x, gy, B, H, W, C, Co, in_scale, in_shift,
                                            splits, partial, top, bottom, stream);
  else
    launch_wgrad_as<T, kInAct, false, kHalo>(x, gy, B, H, W, C, Co, in_scale, in_shift,
                                             splits, partial, top, bottom, stream);
}

// ---------------------------------------------------------------------------
// Entry-point bodies: kHalo false is conv3x3.cu's (top = bottom = 0), true
// conv3x3_halo.cu's. H is the output's rows.
// ---------------------------------------------------------------------------

// K3. x (B, top + H + bottom, W, C), w (3, 3, C, Co), y (B, H, W, Co) of f32 (bf16 = 0)
// or bf16; in_scale/in_shift (C,) and bias (Co,) f32; partial (B * tiles, 2, Co) f32
// scratch; stats (2, Co) f32.
template <bool kHalo>
void run_fwd_stats(const void* x, const void* w, int B, int H, int W, int C, int Co,
                   const float* in_scale, const float* in_shift, int in_act,
                   const float* bias, void* y, float* partial, float* stats, int bf16,
                   int top, int bottom, void* stream) {
  using BF = __nv_bfloat16;
  if (bf16) {
    if (in_act)
      launch_conv<BF, true, kStats, kHalo>(x, w, B, H, W, C, Co, in_scale, in_shift,
                                           nullptr, bias, 0, nullptr, y, partial, stream,
                                           top, bottom);
    else
      launch_conv<BF, false, kStats, kHalo>(x, w, B, H, W, C, Co, in_scale, in_shift,
                                            nullptr, bias, 0, nullptr, y, partial, stream,
                                            top, bottom);
  } else {
    if (in_act)
      launch_conv<float, true, kStats, kHalo>(x, w, B, H, W, C, Co, in_scale, in_shift,
                                              nullptr, bias, 0, nullptr, y, partial, stream,
                                              top, bottom);
    else
      launch_conv<float, false, kStats, kHalo>(x, w, B, H, W, C, Co, in_scale, in_shift,
                                               nullptr, bias, 0, nullptr, y, partial,
                                               stream, top, bottom);
  }
  if (cudaPeekAtLastError() != cudaSuccess) return;
  stats_reduce_kernel<<<Co, kThreads, 0, as_stream(stream)>>>(partial, B * tiles_of(H, W),
                                                              Co, stats);
}

// K4. y = conv(x, w) * scale + shift (scale may be null), ReLU if relu.
template <bool kHalo>
void run_fwd(const void* x, const void* w, int B, int H, int W, int C, int Co,
             const float* scale, const float* shift, int relu, void* y, int bf16, int top,
             int bottom, void* stream) {
  if (bf16)
    launch_conv<__nv_bfloat16, false, kAffine, kHalo>(x, w, B, H, W, C, Co, nullptr,
                                                      nullptr, scale, shift, relu, nullptr,
                                                      y, nullptr, stream, top, bottom);
  else
    launch_conv<float, false, kAffine, kHalo>(x, w, B, H, W, C, Co, nullptr, nullptr, scale,
                                              shift, relu, nullptr, y, nullptr, stream, top,
                                              bottom);
}

// K7. gy (B, top + H + bottom, W, Co), wt (3, 3, Co, C) (the forward weight flipped,
// in/out swapped), x (B, H, W, C) and dx (B, H, W, C) of f32 or bf16; s, t (C,) f32;
// partial (B * tiles, 2, C) f32 scratch; stats (2, C) f32 = [sum dxh*x, sum dxh].
template <bool kHalo>
void run_dgrad_act(const void* gy, const void* wt, const void* x, int B, int H, int W,
                   int Co, int C, const float* s, const float* t, void* dx, float* partial,
                   float* stats, int bf16, int top, int bottom, void* stream) {
  if (bf16)
    launch_conv<__nv_bfloat16, false, kDgradAct, kHalo>(gy, wt, B, H, W, Co, C, nullptr,
                                                        nullptr, s, t, 0, x, dx, partial,
                                                        stream, top, bottom);
  else
    launch_conv<float, false, kDgradAct, kHalo>(gy, wt, B, H, W, Co, C, nullptr, nullptr, s,
                                                t, 0, x, dx, partial, stream, top, bottom);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  stats_reduce_kernel<<<C, kThreads, 0, as_stream(stream)>>>(partial, B * tiles_of(H, W),
                                                             C, stats);
}

// K5 (in_act) / K6. x (B, top + H + bottom, W, C), gy (B, H, W, Co) of f32 or bf16;
// partial (splits, 9, C, Co) f32 scratch; dw (3, 3, C, Co) f32.
template <bool kHalo>
void run_wgrad(const void* x, const void* gy, int B, int H, int W, int C, int Co,
               const float* in_scale, const float* in_shift, int in_act, int splits,
               float* partial, float* dw, int bf16, int top, int bottom, void* stream) {
  using BF = __nv_bfloat16;
  if (bf16) {
    if (in_act)
      launch_wgrad<BF, true, kHalo>(x, gy, B, H, W, C, Co, in_scale, in_shift, splits,
                                    partial, stream, top, bottom);
    else
      launch_wgrad<BF, false, kHalo>(x, gy, B, H, W, C, Co, in_scale, in_shift, splits,
                                     partial, stream, top, bottom);
  } else {
    if (in_act)
      launch_wgrad<float, true, kHalo>(x, gy, B, H, W, C, Co, in_scale, in_shift, splits,
                                       partial, stream, top, bottom);
    else
      launch_wgrad<float, false, kHalo>(x, gy, B, H, W, C, Co, in_scale, in_shift, splits,
                                        partial, stream, top, bottom);
  }
  if (cudaPeekAtLastError() != cudaSuccess) return;
  const size_t n = (size_t)9 * C * Co;
  wgrad_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                        as_stream(stream)>>>(partial, splits, n, dw);
}

}  // namespace
