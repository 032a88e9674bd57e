// Fused Frustum-PointNet instance-seg kernels for Hopper (sm_90a), on the tensor cores
// by wgmma.
//
// Replaces the two Pallas TPU kernels of tdal/ops/pallas_pointnet.py:
//   K1  _encoder_kernel (:69) via fused_seg_encoder (:99)
//       5 x (Dense + folded BN + ReLU), widths 64,64,64,128,1024; writes the 64-ch
//       skip after layer 2 and the per-set max of the 1024-ch output.
//   K2  _decoder_kernel (:137) via fused_seg_decoder (:166)
//       concat(skip, broadcast gmax) -> 4 x (Dense + ReLU) 512,256,128,128 -> 2 logits.
//
// What bounds them on an H100: operations. Per point K1 does ~295 kFLOP and K2 (in
// the split form below) ~426 kFLOP against 256 B of skip traffic, far above the
// card's ops:byte ridge. f32 operands take three TF32 products per f32 product
// (below), so their ceiling is 495/3 = 165 TFLOP/s; bf16 operands the 989 TFLOP/s of
// the bf16 tensor cores.
//
// Design:
// - A block of 256 threads (two warpgroups) owns a tile of 128 points of one set; each
//   warpgroup owns 64 of them, the M of one wgmma. Every product is a wgmma
//   m64n64k8 (tf32) or m64n64k16 (bf16) with A, the activations, in registers and B,
//   the weights, in shared memory. No activation touches shared or device memory
//   between layers: a layer's f32 accumulator fragment is, element for element, the
//   A fragment of the next layer's product (bf16: adjacent column pairs packed; tf32:
//   the fragment wants columns t and t+4 of each group of 8 where the accumulator
//   holds 2t and 2t+1, so the wrapper permutes the next weight's input rows within
//   each group of 8, by PERM8 of tdal_torch/ops/fused_pointnet.py, instead of the
//   kernel moving data).
// - Weights stream through a ring of kStages 64 KB shared-memory stages filled by
//   16-byte cp.async copies, one slice of a layer per stage, in the order the layers
//   consume them. The wrapper packs every weight once per call into that stream, in
//   wgmma's K-major core-matrix layout without swizzle (8 output rows x 16 bytes of
//   input channels per core matrix; kKC apart along K, kNG apart along N), so a
//   stage fill is one contiguous copy. The two warpgroups share each stage, so each
//   weight byte fetched from L2 serves 128 points.
// - f32 operands: split TF32 ("3xTF32"). Each operand a = hi + lo, hi = a with its 13
//   low mantissa bits cleared, lo = a - hi; products lo*hi + hi*lo + hi*hi accumulate
//   in f32. The wrapper splits the weights (both halves are in the stream); the
//   kernel splits the activations in registers. The tensor cores truncate as they
//   accumulate, an error that grows with the depth K; at these depths (64..512) one
//   accumulator per output stays within 1.5e-6 of float64 in the CPU emulation of
//   tests/test_torch_fused_pointnet.py, so no K slice needs an accumulator of its own.
// - bf16 operands reproduce the TPU kernels' numerics: both operands of every product
//   are rounded to bf16 (activations as they are packed into A fragments), products
//   accumulate in f32. The skip and gmax outputs stay unrounded f32, as on the TPU.
// - K1: layer 1 (K = 3 or 4, 0.1% of the work) runs on the CUDA cores straight into
//   the accumulator layout. The skip is written from the layer-2 accumulators. The
//   128 -> 1024 layer is never materialised: per 128 channels (two 64-input slices into
//   two accumulator tiles), each thread takes the ReLU'd maximum over its two rows, the
//   warp by shuffles, the block's 8 warps through shared memory, into a (B, tiles,
//   1024) partial buffer. Hopper runs blocks in no order, so the TPU's revisited-output
//   accumulation across the point-tile grid axis (pallas_pointnet.py:92-96) becomes a
//   second, deterministic pass (seg_encoder_reduce_kernel).
// - K2: the first layer is split: concat(skip, gmax) @ W0 + b0 == skip @ W0[:64] +
//   (gmax @ W0[64:] + b0). The per-set term (gproj, 64 x 1024 x 512 MACs for 64 sets)
//   is a small wgmma kernel of its own (seg_decoder_gproj_kernel: its K of 1024 needs
//   an accumulator per slice of 128, below) and enters the point kernel as its bias.
//   Layer 1's 512 outputs are made 64 at a time and fed straight into layer 2's 256
//   accumulators, so the 512-wide activation never exists. The 128 -> 2 logits run on
//   the CUDA cores from the layer-4 fragments.
// - The ragged tail is masked: the last tile zero-fills missing points, skips their
//   skip/logit writes and drops them from the max, so any N >= 1 works (the TPU kernel
//   asserts N % tile == 0).
//
// What still bounds them (PERF.md has the card's readings): every slice's wgmma batch
// ends in a wait for the tensor cores and a __syncthreads that both warpgroups stop
// at, so the tensor pipe drains once a slice (a third ring stage measured no faster:
// the copies are not late); and each 128-point block streams the whole weight set from
// L2, 1.2 MB (K1) and 1.7 MB (K2) in f32. A wgmma group kept in flight across slices
// and thread block clusters that multicast a stage to several SMs are the next steps.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// tdal_torch/ops/build.py: launchers take raw pointers and a stream, allocate nothing
// and do not synchronise; the caller checks tdal_last_error() right after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTile = 128;     // points per block, 64 per warpgroup
constexpr int kSkip = 64;
constexpr int kGlobal = 1024;
constexpr int kDec0 = 512;
constexpr int kStageBytes = 64 * 1024;
constexpr int kStages = 2;
constexpr uint32_t kKC = 1024;  // packed B: core-matrix stride along K (16 bytes of K), bytes
constexpr uint32_t kNG = 128;   // packed B: core-matrix stride along N (8 output rows), bytes
constexpr int kSkipStride = kSkip + 4;  // floats a point in K2's skip tile
constexpr int kPtsStride = 4;           // floats a point in K1's input tile

// Bytes of one stream slice of Ks input x N output channels: hi and lo f32, or bf16
template <bool BF>
__host__ __device__ constexpr int slice_bytes(int ks, int n) { return ks * n * (BF ? 2 : 8); }

struct EncParams {
  const float* w0;      // (cin, 64), raw
  const float* b[5];
  const void* wstream;  // layers 2-5, packed
};

struct DecParams {
  const void* wstream;  // K2's packed stream: W0[:64] and layers 2-4 come first
  const float* b[4];    // b[0] unused here: it is folded into gproj
  const float* lw;      // (128, 2)
  const float* lb;      // (2,)
};

__device__ __forceinline__ float rbf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; valid false fills the 16 bytes with zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a = hi + lo: hi = a with its 13 low mantissa bits cleared (a TF32 value), lo = a - hi
// exactly, of which the tensor core reads the TF32 part (tdal_torch/ops/csrc/conv3x3.cu
// splits the same way)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a packed B tile: K-major, no swizzle; the leading
// byte offset is the core-matrix stride along K (kKC), the stride byte offset the one
// along N (kNG)
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kKC >> 4) << 16) |
         ((uint64_t)(kNG >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of the generic proxy (cp.async, st.shared) made visible to
// wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accesses of registers an in-flight wgmma owns
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d += a * b: m64n64k8, A (tf32) from registers, B (64 n x 8 k, K-major) by descriptor
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// d += a * b: m64n64k16, A (bf16 pairs) from registers, B (64 n x 16 k, K-major) by
// descriptor
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// acc[nt] += A x B over S k-steps, f32 operands as 3xTF32. The stage holds the slice's
// hi tiles, then its lo tiles; tile nt (64 outputs x ks inputs) is ks/4 core-matrix
// columns of kKC bytes, and k-step j (8 inputs) starts 2 columns after k-step j - 1.
template <int NT, int S>
__device__ __forceinline__ void run_tf32(float (&acc)[NT][32], uint32_t (&hi)[S][4],
                                         uint32_t (&lo)[S][4], uint32_t stage, int ks,
                                         int j0) {
  const uint32_t tile = ks / 4 * kKC;
  const uint32_t bh = stage + j0 * 2 * kKC, bl = bh + NT * tile;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) reg_fence(acc[nt]);
  reg_fence(hi);
  reg_fence(lo);
  wg_fence();
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t off = nt * tile + j * 2 * kKC;
      wgmma_tf32(acc[nt], lo[j], desc_b(bh + off));
      wgmma_tf32(acc[nt], hi[j], desc_b(bl + off));
      wgmma_tf32(acc[nt], hi[j], desc_b(bh + off));
    }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) reg_fence(acc[nt]);
}

// acc[nt] += A x B over S k-steps of 16 inputs, bf16 operands; tile nt is ks/8 core-matrix
// columns
template <int NT, int S>
__device__ __forceinline__ void run_bf16(float (&acc)[NT][32], uint32_t (&a)[S][4],
                                         uint32_t stage, int ks, int j0) {
  const uint32_t tile = ks / 8 * kKC;
  const uint32_t bh = stage + j0 * 2 * kKC;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) reg_fence(acc[nt]);
  reg_fence(a);
  wg_fence();
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      wgmma_bf16(acc[nt], a[j], desc_b(bh + nt * tile + j * 2 * kKC));
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) reg_fence(acc[nt]);
}

// The A fragment of tf32 k-step j (columns 8j..8j+7) of a 64-column accumulator tile d:
// the thread holds rows g, g+8 and columns 2t, 2t+1 of each group of 8; the fragment
// wants k positions t and t+4, so position t reads column 2t and position t+4 column
// 2t+1 (the next weight's input rows are permuted to match: kPerm8 in the wrapper)
__device__ __forceinline__ void frag_tf32(const float (&d)[32], int j, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_tf32(d[4 * j], hi[0], lo[0]);      // row g,     column 2t
  split_tf32(d[4 * j + 2], hi[1], lo[1]);  // row g + 8, column 2t
  split_tf32(d[4 * j + 1], hi[2], lo[2]);  // row g,     column 2t + 1
  split_tf32(d[4 * j + 3], hi[3], lo[3]);  // row g + 8, column 2t + 1
}

// The A fragment of bf16 k-step s (columns 16s..16s+15): column pairs as they lie
__device__ __forceinline__ void frag_bf16(const float (&d)[32], int s, uint32_t (&a)[4]) {
  const int q = 8 * s;
  a[0] = pack_bf16(d[q], d[q + 1]);
  a[1] = pack_bf16(d[q + 2], d[q + 3]);
  a[2] = pack_bf16(d[q + 4], d[q + 5]);
  a[3] = pack_bf16(d[q + 6], d[q + 7]);
}

// acc += (columns c0 .. c0 + NCOL of the accumulator tile d, after its epilogue) x the
// stage's slice (NCOL inputs, NT x 64 outputs)
template <bool BF, int NT, int NCOL>
__device__ __forceinline__ void from_acc(float (&acc)[NT][32], const float (&d)[32], int c0,
                                         uint32_t stage) {
  if constexpr (BF) {
    constexpr int S = NCOL / 16;
    uint32_t a[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) frag_bf16(d, c0 / 16 + s, a[s]);
    run_bf16<NT, S>(acc, a, stage, NCOL, 0);
  } else {
    constexpr int S = NCOL / 8;
    uint32_t hi[S][4], lo[S][4];
#pragma unroll
    for (int j = 0; j < S; ++j) frag_tf32(d, c0 / 8 + j, hi[j], lo[j]);
    run_tf32<NT, S>(acc, hi, lo, stage, NCOL, 0);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][32]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nt][i] = 0.f;
}

// d = relu(d + bias) on a 64-column accumulator tile whose columns start at bias
__device__ __forceinline__ void bias_relu(float (&d)[32], const float* __restrict__ bias,
                                          int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
    d[4 * j] = fmaxf(d[4 * j] + bb.x, 0.f);
    d[4 * j + 1] = fmaxf(d[4 * j + 1] + bb.y, 0.f);
    d[4 * j + 2] = fmaxf(d[4 * j + 2] + bb.x, 0.f);
    d[4 * j + 3] = fmaxf(d[4 * j + 3] + bb.y, 0.f);
  }
}

// The weight streams, slice by slice in the order the kernels consume them (bytes)
template <bool BF>
struct EncSlices {  // K1: layers 2 and 3 (64 x 64), 4 (64 x 128), then layer 5 by 128
                    // outputs, each in two slices of 64 x 128
  static constexpr int kCount = 19;
  __host__ __device__ static constexpr int bytes(int i) {
    return i < 2 ? slice_bytes<BF>(64, 64) : slice_bytes<BF>(64, 128);
  }
};
template <bool BF>
struct DecSlices {  // K2: per chunk of 64 layer-1 outputs, W0[:64]'s 64 x 64 and W1's
                    // 2 x (32 x 256); then layers 3 and 4 in slices of 32 x 128
  static constexpr int kCount = 36;
  __host__ __device__ static constexpr int bytes(int i) {
    return i < 24 ? (i % 3 == 0 ? slice_bytes<BF>(kSkip, 64) : slice_bytes<BF>(32, 256))
                  : slice_bytes<BF>(32, 128);
  }
};
template <bool BF>
struct GprojSlices {  // K2's gproj, one 64-output tile: W0[64:] in 8 slices of 128 x 64
  static constexpr int kCount = 8;
  __host__ __device__ static constexpr int bytes(int) { return slice_bytes<BF>(128, 64); }
};
template <class S>
__host__ __device__ constexpr int stream_bytes() {
  int n = 0;
  for (int i = 0; i < S::kCount; ++i) n += S::bytes(i);
  return n;
}

// The weight stream through the ring of kStages shared-memory stages: slice i lands in
// stage i % kStages, kStages - 1 slices ahead of the one in use.
template <class S>
struct Ring {
  unsigned char* base;
  const unsigned char* src;  // the next slice's first byte
  int fetched, used;

  // all threads: the copies of the next slice (if any) as one cp.async group
  __device__ __forceinline__ void fetch() {
    if (fetched < S::kCount) {
      const int bytes = S::bytes(fetched);
      unsigned char* dst = base + (fetched % kStages) * kStageBytes;
      for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
        cp_async16(dst + i, src + i, true);
      src += bytes;
    }
    cp_async_commit();
    ++fetched;
  }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) fetch();
  }
  // the stage of the next slice, once it has landed; first starts fetching the slice
  // kStages - 1 ahead into the stage released last
  __device__ __forceinline__ uint32_t acquire() {
    fetch();
    cp_async_wait<kStages - 1>();
    fence_proxy_async();
    __syncthreads();
    return smem_u32(base + (used++ % kStages) * kStageBytes);
  }
  // every warpgroup has waited for its products on the stage
  __device__ __forceinline__ void release() { __syncthreads(); }
};

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

template <bool BF>
__global__ void __launch_bounds__(kThreads, 1)
seg_encoder_kernel(const float* __restrict__ pts, int N, int cin, EncParams P,
                   float* __restrict__ skip, float* __restrict__ partial, int n_tiles) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [kTile][4]
  float* red = xs + kTile * kPtsStride;                                // [2][8 warps][128]
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n0 = tile * kTile, n_valid = min(kTile, N - n0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile

  Ring<EncSlices<BF>> ring{smem, static_cast<const unsigned char*>(P.wstream), 0, 0};
  ring.start();
  const float* src = pts + ((size_t)b * N + n0) * cin;
  for (int e = threadIdx.x; e < kTile * kPtsStride; e += kThreads) {
    const int p = e >> 2, k = e & 3;
    const float v = p < n_valid && k < cin ? src[p * cin + k] : 0.f;
    xs[e] = BF ? rbf16(v) : v;
  }
  __syncthreads();

  // layer 1 (K = cin) on the CUDA cores, straight into the accumulator layout
  float h1[1][32];
  {
    const float4 xa = *reinterpret_cast<const float4*>(xs + r0 * kPtsStride);
    const float4 xb = *reinterpret_cast<const float4*>(xs + (r0 + 8) * kPtsStride);
    const float x0[4] = {xa.x, xa.y, xa.z, xa.w}, x1[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < cin) {
            const float w = BF ? rbf16(__ldg(P.w0 + k * 64 + c)) : __ldg(P.w0 + k * 64 + c);
            a0 = fmaf(x0[k], w, a0);
            a1 = fmaf(x1[k], w, a1);
          }
        }
        const float bb = __ldg(P.b[0] + c);
        h1[0][4 * j + e] = fmaxf(a0 + bb, 0.f);
        h1[0][4 * j + 2 + e] = fmaxf(a1 + bb, 0.f);
      }
  }

  // layer 2 (64 -> 64), whose unrounded output is the skip
  float h2[1][32];
  zero(h2);
  uint32_t st = ring.acquire();
  from_acc<BF, 1, 64>(h2, h1[0], 0, st);
  ring.release();
  bias_relu(h2[0], P.b[1], t);
  {
    float* dst = skip + ((size_t)b * N + n0 + r0) * kSkip;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (r0 < n_valid)
        *reinterpret_cast<float2*>(dst + c) = make_float2(h2[0][4 * j], h2[0][4 * j + 1]);
      if (r0 + 8 < n_valid)
        *reinterpret_cast<float2*>(dst + 8 * kSkip + c) =
            make_float2(h2[0][4 * j + 2], h2[0][4 * j + 3]);
    }
  }

  // layer 3 (64 -> 64)
  float h3[1][32];
  zero(h3);
  st = ring.acquire();
  from_acc<BF, 1, 64>(h3, h2[0], 0, st);
  ring.release();
  bias_relu(h3[0], P.b[2], t);

  // layer 4 (64 -> 128)
  float h4[2][32];
  zero(h4);
  st = ring.acquire();
  from_acc<BF, 2, 64>(h4, h3[0], 0, st);
  ring.release();
  bias_relu(h4[0], P.b[3], t);
  bias_relu(h4[1], P.b[3] + 64, t);

  // layer 5 (128 -> 1024), 128 outputs (two accumulator tiles, so two independent
  // wgmma chains) per pair of slices of 64 inputs, reduced to the tile's per-channel max
  constexpr int S = BF ? 4 : 8;  // k-steps over 64 inputs, one h4 tile
  uint32_t fa[2][S][4], fb[2][BF ? 1 : S][4];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if constexpr (BF) {
        frag_bf16(h4[half], j, fa[half][j]);
      } else {
        frag_tf32(h4[half], j, fa[half][j], fb[half][j]);
      }
    }
  float* part = partial + ((size_t)b * n_tiles + tile) * kGlobal;
  const float neg_inf = -__int_as_float(0x7f800000);
#pragma unroll 1
  for (int grp = 0; grp < kGlobal / 128; ++grp) {
    float h5[2][32];
    zero(h5);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      st = ring.acquire();
      if constexpr (BF) {
        run_bf16<2, S>(h5, fa[half], st, 64, 0);
      } else {
        run_tf32<2, S>(h5, fa[half], fb[half], st, 64, 0);
      }
      if (half == 0) ring.release();
    }
    float* rw = red + ((grp & 1) * 8 + warp) * 128;
    const float* bias = P.b[4] + 128 * grp;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 64 * nt + 8 * j + 2 * t + e;
          const float bb = __ldg(bias + c);
          float m = r0 < n_valid ? fmaxf(h5[nt][4 * j + e] + bb, 0.f) : neg_inf;
          if (r0 + 8 < n_valid) m = fmaxf(m, fmaxf(h5[nt][4 * j + 2 + e] + bb, 0.f));
          // the 8 lanes of one column t differ in g: lane bits 2..4
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          if (g == 0) rw[c] = m;
        }
    ring.release();
    if (threadIdx.x < 128) {
      const float* rr = red + (grp & 1) * 8 * 128 + threadIdx.x;
      float m = rr[0];
#pragma unroll
      for (int w = 1; w < 8; ++w) m = fmaxf(m, rr[w * 128]);
      part[128 * grp + threadIdx.x] = m;
    }
  }
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

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

constexpr int kGpThreads = 128;  // gproj: one warpgroup, 64 sets
constexpr int kGpKS = 128;       // gproj: inputs a slice, each summed on its own

// gproj[b][c] = b0[c] + sum_k gmax[b][k] * W0[64 + k][c]: the per-set half of K2's first
// layer. A block is one warpgroup: 64 sets (rows, zero past B) x 64 outputs, K = 1024 in
// 8 slices of 128 streamed through the ring. With 3xTF32 one accumulator over K = 1024
// would lose the f32 tolerance to the tensor cores' truncation (1.06e-5 in the CPU
// emulation), so each slice sums into a zeroed accumulator that joins the total by a
// rounded f32 add.
template <bool BF>
__global__ void __launch_bounds__(kGpThreads, 1)
seg_decoder_gproj_kernel(const float* __restrict__ gmax, int B, const void* gstream,
                         const float* __restrict__ b0, float* __restrict__ gproj) {
  extern __shared__ __align__(1024) unsigned char smem[];
  using S = GprojSlices<BF>;
  const int nt = blockIdx.x, s0 = blockIdx.y * 64;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // this thread's sets s0 + r0 and + 8
  const bool ok0 = s0 + r0 < B, ok1 = s0 + r0 + 8 < B;
  const float* x0 = gmax + (size_t)(ok0 ? s0 + r0 : 0) * kGlobal;
  const float* x1 = gmax + (size_t)(ok1 ? s0 + r0 + 8 : 0) * kGlobal;

  Ring<S> ring{smem, static_cast<const unsigned char*>(gstream) +
                         (size_t)nt * stream_bytes<S>(), 0, 0};
  ring.start();
  float total[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) total[i] = 0.f;
#pragma unroll 1
  for (int sl = 0; sl < S::kCount; ++sl) {
    const uint32_t st = ring.acquire();
    float part[1][32];
    zero(part);
    const int kb = sl * kGpKS;
    if constexpr (BF) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t a[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kb + 16 * (4 * half + j) + 2 * t;
          a[j][0] = pack_bf16(ok0 ? x0[k] : 0.f, ok0 ? x0[k + 1] : 0.f);
          a[j][1] = pack_bf16(ok1 ? x1[k] : 0.f, ok1 ? x1[k + 1] : 0.f);
          a[j][2] = pack_bf16(ok0 ? x0[k + 8] : 0.f, ok0 ? x0[k + 9] : 0.f);
          a[j][3] = pack_bf16(ok1 ? x1[k + 8] : 0.f, ok1 ? x1[k + 9] : 0.f);
        }
        run_bf16<1, 4>(part, a, st, kGpKS, 4 * half);
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t hi[8][4], lo[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = kb + 8 * (8 * half + j) + t;
          split_tf32(ok0 ? x0[k] : 0.f, hi[j][0], lo[j][0]);
          split_tf32(ok1 ? x1[k] : 0.f, hi[j][1], lo[j][1]);
          split_tf32(ok0 ? x0[k + 4] : 0.f, hi[j][2], lo[j][2]);
          split_tf32(ok1 ? x1[k + 4] : 0.f, hi[j][3], lo[j][3]);
        }
        run_tf32<1, 8>(part, hi, lo, st, kGpKS, 8 * half);
      }
    }
    ring.release();
#pragma unroll
    for (int i = 0; i < 32; ++i) total[i] += part[0][i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 64 * nt + 8 * j + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b0 + c));
    if (ok0)
      *reinterpret_cast<float2*>(gproj + (size_t)(s0 + r0) * kDec0 + c) =
          make_float2(total[4 * j] + bb.x, total[4 * j + 1] + bb.y);
    if (ok1)
      *reinterpret_cast<float2*>(gproj + (size_t)(s0 + r0 + 8) * kDec0 + c) =
          make_float2(total[4 * j + 2] + bb.x, total[4 * j + 3] + bb.y);
  }
}

template <bool BF>
__global__ void __launch_bounds__(kThreads, 1)
seg_decoder_kernel(const float* __restrict__ skip, const float* __restrict__ gproj, int N,
                   DecParams P, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [kTile][kSkipStride]
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n0 = tile * kTile, n_valid = min(kTile, N - n0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // this thread's rows r0 and r0 + 8

  const float* src = skip + ((size_t)b * N + n0) * kSkip;
  for (int e = threadIdx.x; e < kTile * (kSkip / 4); e += kThreads) {
    const int p = e >> 4, q = e & 15;
    const bool ok = p < n_valid;
    cp_async16(sk + p * kSkipStride + q * 4, ok ? src + (size_t)p * kSkip + q * 4 : src, ok);
  }
  Ring<DecSlices<BF>> ring{smem, static_cast<const unsigned char*>(P.wstream), 0, 0};
  ring.start();  // the skip tile lands with the first slice

  // layers 1 and 2: layer 1's 512 outputs 64 at a time, each chunk fed straight into
  // layer 2's 256 accumulators
  float h2[4][32];
  zero(h2);
  const float* x0 = sk + r0 * kSkipStride;
  const float* x1 = x0 + 8 * kSkipStride;
  const float* gp = gproj + (size_t)b * kDec0;
#pragma unroll 1
  for (int c = 0; c < kDec0 / 64; ++c) {
    float h1[1][32];
    zero(h1);
    uint32_t st = ring.acquire();
    if constexpr (BF) {
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 16 * s + 2 * t;
        const float2 u0 = *reinterpret_cast<const float2*>(x0 + k);
        const float2 u1 = *reinterpret_cast<const float2*>(x1 + k);
        const float2 v0 = *reinterpret_cast<const float2*>(x0 + k + 8);
        const float2 v1 = *reinterpret_cast<const float2*>(x1 + k + 8);
        a[s][0] = pack_bf16(u0.x, u0.y);
        a[s][1] = pack_bf16(u1.x, u1.y);
        a[s][2] = pack_bf16(v0.x, v0.y);
        a[s][3] = pack_bf16(v1.x, v1.y);
      }
      run_bf16<1, 4>(h1, a, st, kSkip, 0);
    } else {
      // the skip as it lies (W0[:64] is not permuted), in two halves of 4 k-steps
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 8 * (4 * half + j) + t;
          split_tf32(x0[k], hi[j][0], lo[j][0]);
          split_tf32(x1[k], hi[j][1], lo[j][1]);
          split_tf32(x0[k + 4], hi[j][2], lo[j][2]);
          split_tf32(x1[k + 4], hi[j][3], lo[j][3]);
        }
        run_tf32<1, 4>(h1, hi, lo, st, kSkip, 4 * half);
      }
    }
    ring.release();
    bias_relu(h1[0], gp + 64 * c, t);
    st = ring.acquire();
    from_acc<BF, 4, 32>(h2, h1[0], 0, st);
    ring.release();
    st = ring.acquire();
    from_acc<BF, 4, 32>(h2, h1[0], 32, st);
    ring.release();
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) bias_relu(h2[nt], P.b[1] + 64 * nt, t);

  // layer 3 (256 -> 128), 32 inputs a slice
  float h3[2][32];
  zero(h3);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t st = ring.acquire();
    from_acc<BF, 2, 32>(h3, h2[i / 2], 32 * (i % 2), st);
    ring.release();
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) bias_relu(h3[nt], P.b[2] + 64 * nt, t);

  // layer 4 (128 -> 128)
  float h4[2][32];
  zero(h4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t st = ring.acquire();
    from_acc<BF, 2, 32>(h4, h3[i / 2], 32 * (i % 2), st);
    ring.release();
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) bias_relu(h4[nt], P.b[3] + 64 * nt, t);

  // logits (128 -> 2) on the CUDA cores: each thread's 32 columns of its two rows, then
  // the 4 lanes that share the rows
  float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 64 * nt + 8 * j + 2 * t + e;
        float2 w = __ldg(reinterpret_cast<const float2*>(P.lw + 2 * c));
        float xa = h4[nt][4 * j + e], xb = h4[nt][4 * j + 2 + e];
        if constexpr (BF) {
          w = make_float2(rbf16(w.x), rbf16(w.y));
          xa = rbf16(xa);
          xb = rbf16(xb);
        }
        l[0][0] = fmaf(xa, w.x, l[0][0]);
        l[0][1] = fmaf(xa, w.y, l[0][1]);
        l[1][0] = fmaf(xb, w.x, l[1][0]);
        l[1][1] = fmaf(xb, w.y, l[1][1]);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      l[i][o] += __shfl_xor_sync(0xffffffffu, l[i][o], 1);
      l[i][o] += __shfl_xor_sync(0xffffffffu, l[i][o], 2);
    }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = r0 + 8 * i;
      if (p < n_valid) {
        float* o = out + ((size_t)b * N + n0 + p) * 2;
        o[0] = l[i][0] + __ldg(P.lb);
        o[1] = l[i][1] + __ldg(P.lb + 1);
      }
    }
  }
}

constexpr int kEncSmem =
    kStages * kStageBytes + (int)sizeof(float) * (kTile * kPtsStride + 2 * 8 * 128);
constexpr int kDecSmem = kStages * kStageBytes + (int)sizeof(float) * kTile * kSkipStride;
constexpr int kGpSmem = kStages * kStageBytes;
// K2's whole stream: the point kernel's slices, then gproj's for each of 8 output tiles
template <bool BF>
constexpr int kDecStream =
    stream_bytes<DecSlices<BF>>() + (kDec0 / 64) * stream_bytes<GprojSlices<BF>>();

}  // namespace

extern "C" {

// The error state of the CUDA runtime this library launches through; the ctypes
// binding calls it right after each launcher.
int tdal_last_error() { return (int)cudaGetLastError(); }

int tdal_encoder_tile() { return kTile; }

// Bytes of the packed weight stream of K1 (decoder 0) or K2 (decoder 1: the point
// kernel's, then gproj's), by mode
int tdal_seg_stream_bytes(int decoder, int bf16) {
  if (decoder)
    return bf16 ? kDecStream<true> : kDecStream<false>;
  return bf16 ? stream_bytes<EncSlices<true>>() : stream_bytes<EncSlices<false>>();
}

// Dynamic shared memory of one block of K1's main kernel (0), K2's (1) or gproj (2), bytes
int tdal_seg_smem(int which) { return which == 0 ? kEncSmem : which == 1 ? kDecSmem : kGpSmem; }

// K1 main pass. pts (B, N, cin) f32; w0 (cin, 64) and b[i] (out,) as folded; wstream the
// packed layers 2-5 (tdal_torch/ops/fused_pointnet.py); skip (B, N, 64); partial
// (B, n_tiles, 1024) with n_tiles = ceil(N / kTile).
void tdal_seg_encoder(const float* pts, int B, int N, int cin, const float* w0,
                      const float* const* b, const void* wstream, float* skip,
                      float* partial, int n_tiles, int bf16, void* stream) {
  EncParams P;
  P.w0 = w0;
  for (int i = 0; i < 5; ++i) P.b[i] = b[i];
  P.wstream = wstream;
  const dim3 grid(n_tiles, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(seg_encoder_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kEncSmem);
    seg_encoder_kernel<true><<<grid, kThreads, kEncSmem, s>>>(pts, N, cin, P, skip, partial,
                                                              n_tiles);
  } else {
    cudaFuncSetAttribute(seg_encoder_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kEncSmem);
    seg_encoder_kernel<false><<<grid, kThreads, kEncSmem, s>>>(pts, N, cin, P, skip, partial,
                                                               n_tiles);
  }
}

// K1 second pass: gmax (B, 1024) = max over tiles of partial.
void tdal_seg_encoder_reduce(const float* partial, int B, int n_tiles, float* gmax,
                             void* stream) {
  seg_encoder_reduce_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, n_tiles, gmax);
}

// K2 per-set pass: gproj (B, 512) = gmax @ W0[64:] + b0, W0[64:] from the decoder's
// packed stream wstream (it follows the point kernel's part).
void tdal_seg_decoder_gproj(const float* gmax, int B, const void* wstream, const float* b0,
                            float* gproj, int bf16, void* stream) {
  const dim3 grid(kDec0 / 64, (B + 63) / 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* gs = static_cast<const unsigned char*>(wstream);
  if (bf16) {
    cudaFuncSetAttribute(seg_decoder_gproj_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGpSmem);
    seg_decoder_gproj_kernel<true><<<grid, kGpThreads, kGpSmem, s>>>(
        gmax, B, gs + stream_bytes<DecSlices<true>>(), b0, gproj);
  } else {
    cudaFuncSetAttribute(seg_decoder_gproj_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGpSmem);
    seg_decoder_gproj_kernel<false><<<grid, kGpThreads, kGpSmem, s>>>(
        gmax, B, gs + stream_bytes<DecSlices<false>>(), b0, gproj);
  }
}

// K2 point pass. skip (B, N, 64), gproj (B, 512); wstream the decoder's packed stream
// (W0[:64] and layers 2-4 first); b[1..3]; lw (128, 2), lb (2,); out (B, N, 2).
void tdal_seg_decoder(const float* skip, const float* gproj, int B, int N,
                      const void* wstream, const float* const* b, const float* lw,
                      const float* lb, float* out, int bf16, void* stream) {
  DecParams P;
  P.wstream = wstream;
  for (int i = 0; i < 4; ++i) P.b[i] = b[i];
  P.lw = lw;
  P.lb = lb;
  const dim3 grid((N + kTile - 1) / kTile, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(seg_decoder_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kDecSmem);
    seg_decoder_kernel<true><<<grid, kThreads, kDecSmem, s>>>(skip, gproj, N, P, out);
  } else {
    cudaFuncSetAttribute(seg_decoder_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kDecSmem);
    seg_decoder_kernel<false><<<grid, kThreads, kDecSmem, s>>>(skip, gproj, N, P, out);
  }
}

}  // extern "C"
