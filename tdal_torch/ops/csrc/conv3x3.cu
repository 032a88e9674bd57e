// 3x3 stride-1 SAME NHWC convolution kernels for Hopper (sm_90a), as implicit GEMMs on
// the tensor cores.
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
//       unpadded saved input. It is K4's conv with another epilogue.
//
// What bounds them on an H100: operations. At the detector's shapes (B=4, 468x468,
// 64..384 channels) a conv does 2*9*C*Co FLOP per pixel against (C+Co) values, far
// above the card's ridge. bf16 operands: the 989 TFLOP/s of the bf16 tensor cores.
// f32 operands: products as accurate as f32 on the tensor cores take three TF32
// products each (below), so the ceiling is 495/3 = 165 TFLOP/s.
//
// Design: both kernels are implicit GEMMs with warp-level mma.sync; no im2col. A tile
// of the input with its one-pixel halo sits in shared memory, and each of the 9 taps
// reads it as a window shifted by (ky, kx).
// - Products. bf16: mma.m16n8k16 bf16 -> f32, fragments by ldmatrix. f32: split TF32
//   ("3xTF32"): each operand a = hi + lo, hi = a with its 13 low mantissa bits cleared
//   and lo = a - hi exactly, and acc += lo*hi + hi*lo + hi*hi by mma.m16n8k8 tf32 -> f32,
//   issued pass by pass over the warp's tiles: about 2^-20 relative per product, within
//   f32's summation-order noise (one-pass TF32, ~2^-11, would change the function).
//   Fragments by 32-bit shared-memory loads; the wgrad splits its input tile once in
//   shared memory, where each value serves 9 taps.
// - Accumulation. The tensor cores truncate as they add into the accumulator, a bias
//   that grows with the number of MMAs into one sum (2.2e-5 of max |y| at C = 384 when
//   the whole K went into one accumulator, against the 1e-5 tolerance). So each slice
//   (conv) or pixel tile (wgrad) sums into a zeroed accumulator that joins the running
//   sum by a rounded f32 add.
// - Copies. A ring of 2 shared-memory stages filled by cp.async.cg 16-byte copies
//   (zero-filled outside the image and past C/Co), so the next slice lands while this
//   one is multiplied (a third stage measured no faster). A channel count that is not
//   a multiple of 16 bytes, or an unaligned base, takes element copies in the same
//   kernel (kVec = false). cp.async
//   cannot transform, so in_act is an in-place pass over the landed input tile:
//   relu(x*s + t) (two rounded f32 ops, as the twin) rounded to T, with the halo and the
//   channels past C left at zero. Row strides are padded (80 bytes a pixel, 16 bytes
//   past each channel row) so every fragment load and ldmatrix phase is free of
//   shared-memory bank conflicts.
// - Conv (K3, K4, K7): a block of 256 threads owns 8x16 output pixels x 64 output
//   channels; K runs over slices of 64 bytes of input channels (16 f32 / 32 bf16) x 9
//   taps, the halo'd 10x18 input tile and the slice's 9 weight taps staged per stage.
//   8 warps of 32 pixels (2 rows) x 32 channels. The epilogues read the accumulator
//   fragments: K4 affine/ReLU, K3 bias + moments, K7 mask/dx/[sum dxh*x, sum dxh].
// - Statistics: per channel, each thread sums its fragment's valid pixels, the warp by
//   a fixed __shfl_xor butterfly, the block's four pixel warps in a fixed order; each
//   tile writes one partial and stats_reduce_kernel sums the partials in double. No
//   float atomics: the same bits every run.
// - Wgrad (K5/K6): dw[(tap, ci), co] = sum_p act(x)[p + off(tap), ci] * gy[p, co], K =
//   pixels. A block owns 32 input x 64 output channels x all 9 taps and walks its
//   split's 8x16 pixel tiles through the ring (x halo tile and gy tile per stage), so a
//   gy tile is staged once for 32 input channels. 8 warps of 16 ci x 16 co x 9 taps, 72
//   accumulators a thread in registers; the gy fragment of a k-step serves all 9 taps.
//   Each split writes one partial; wgrad_reduce_kernel sums the splits in double, in a
//   fixed order.
// - Ragged images and channel counts: copies outside the image or past C/Co fill 0,
//   writes and statistics skip them, so any N, H, W >= 1 and any C, Co work.
// - bf16: the activated input is rounded to bf16 before the taps (as the TPU kernel
//   casts it to the input type), products accumulate in f32, the statistics come from
//   the f32 accumulator, y is rounded once when stored; K7 rounds once, at dx.
//
// What still bounds them (PERF.md has the card's readings): mma.sync issues from each
// warp, so the fragment loads and, in f32, the hi/lo splits share the issue slots with
// the products; the conv's 128-register budget (two blocks an SM) and the wgrad's one
// resident block an SM (72 + 72 accumulators a thread) leave few warps to hide the
// latency. wgmma on canonical shared-memory layouts fed by TMA is the next step.
//
// The kernels and their launch templates are in conv3x3.cuh, shared with
// conv3x3_halo.cu: the row halo form of the same four entry points, for a map split by
// rows over ranks (tdal_torch/parallel/mesh.py), compiled beside this file by its own
// nvcc. The entry points here launch the whole-image instantiations (kHalo false).
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// tdal_torch/ops/build.py: launchers take raw pointers and a stream, allocate nothing
// and do not synchronise; the caller checks tdal_last_error() right after each call.

#include "conv3x3.cuh"

extern "C" {

// Spatial tiles per image (rows of the K3 partial buffer are B * tiles).
int tdal_conv3x3_tiles(int H, int W) { return tiles_of(H, W); }

// Dynamic shared memory of a block of the conv (wgrad = 0) or the wgrad kernel, bytes.
int tdal_conv3x3_smem(int wgrad, int bf16) {
  if (wgrad) return (int)(bf16 ? wgrad_smem<__nv_bfloat16>() : wgrad_smem<float>());
  return (int)(bf16 ? conv_smem<__nv_bfloat16>() : conv_smem<float>());
}

// (input-channel blocks) * (output-channel blocks) of one wgrad split.
int tdal_conv3x3_wgrad_chunks(int C, int Co) {
  return ((C + kWCi - 1) / kWCi) * ((Co + kCoT - 1) / kCoT);
}

// K3. x (B, H, W, C), w (3, 3, C, Co), y (B, H, W, Co) of f32 (bf16 = 0) or bf16;
// in_scale/in_shift (C,) and bias (Co,) f32; partial (B * tiles, 2, Co) f32 scratch;
// stats (2, Co) f32.
void tdal_conv3x3_fwd_stats(const void* x, const void* w, int B, int H, int W, int C,
                            int Co, const float* in_scale, const float* in_shift,
                            int in_act, const float* bias, void* y, float* partial,
                            float* stats, int bf16, void* stream) {
  run_fwd_stats<false>(x, w, B, H, W, C, Co, in_scale, in_shift, in_act, bias, y, partial,
                       stats, bf16, 0, 0, stream);
}

// K4. y = conv(x, w) * scale + shift (scale may be null), ReLU if relu.
void tdal_conv3x3_fwd(const void* x, const void* w, int B, int H, int W, int C, int Co,
                      const float* scale, const float* shift, int relu, void* y, int bf16,
                      void* stream) {
  run_fwd<false>(x, w, B, H, W, C, Co, scale, shift, relu, y, bf16, 0, 0, stream);
}

// K7. gy (B, H, W, Co), wt (3, 3, Co, C) (the forward weight flipped, in/out swapped),
// x (B, H, W, C) and dx (B, H, W, C) of f32 or bf16; s, t (C,) f32; partial
// (B * tiles, 2, C) f32 scratch; stats (2, C) f32 = [sum dxh*x, sum dxh].
void tdal_conv3x3_dgrad_act(const void* gy, const void* wt, const void* x, int B, int H,
                            int W, int Co, int C, const float* s, const float* t,
                            void* dx, float* partial, float* stats, int bf16,
                            void* stream) {
  run_dgrad_act<false>(gy, wt, x, B, H, W, Co, C, s, t, dx, partial, stats, bf16, 0, 0,
                       stream);
}

// K5 (in_act) / K6. x (B, H, W, C), gy (B, H, W, Co) of f32 or bf16; partial
// (splits, 9, C, Co) f32 scratch; dw (3, 3, C, Co) f32.
void tdal_conv3x3_wgrad(const void* x, const void* gy, int B, int H, int W, int C, int Co,
                        const float* in_scale, const float* in_shift, int in_act,
                        int splits, float* partial, float* dw, int bf16, void* stream) {
  run_wgrad<false>(x, gy, B, H, W, C, Co, in_scale, in_shift, in_act, splits, partial, dw,
                   bf16, 0, 0, stream);
}

}  // extern "C"
