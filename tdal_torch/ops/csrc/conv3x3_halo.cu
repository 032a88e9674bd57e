// The row halo form of the 3x3 conv kernels K3, K4, K5/K6 and K7: the entry points of
// conv3x3.cu for one rank's row slab of a map split by rows over ranks (BEV spatial
// partitioning, tdal_torch/parallel/mesh.py), the conv input carrying top (0 or 1) of
// the neighbour above's rows over its own H rows and bottom (0 or 1) of the neighbour
// below's under them. conv3x3.cuh has the kernels (instantiated here with kHalo) and
// the rule of the halo: zero padding only outside the top + H + bottom rows, the input
// affine + ReLU on halo rows as on any real row, outputs and statistics over the H own
// rows. Same plain C interface as conv3x3.cu, built by its own nvcc beside it.

#include "conv3x3.cuh"

extern "C" {

// K3: x (B, top + H + bottom, W, C); the rest as tdal_conv3x3_fwd_stats.
void tdal_conv3x3_fwd_stats_halo(const void* x, const void* w, int B, int H, int W, int C,
                                 int Co, const float* in_scale, const float* in_shift,
                                 int in_act, const float* bias, void* y, float* partial,
                                 float* stats, int top, int bottom, int bf16,
                                 void* stream) {
  run_fwd_stats<true>(x, w, B, H, W, C, Co, in_scale, in_shift, in_act, bias, y, partial,
                      stats, bf16, top, bottom, stream);
}

// K4: x (B, top + H + bottom, W, C); the rest as tdal_conv3x3_fwd.
void tdal_conv3x3_fwd_halo(const void* x, const void* w, int B, int H, int W, int C, int Co,
                           const float* scale, const float* shift, int relu, void* y,
                           int top, int bottom, int bf16, void* stream) {
  run_fwd<true>(x, w, B, H, W, C, Co, scale, shift, relu, y, bf16, top, bottom, stream);
}

// K7: gy (B, top + H + bottom, W, Co), x and dx (B, H, W, C); the rest as
// tdal_conv3x3_dgrad_act.
void tdal_conv3x3_dgrad_act_halo(const void* gy, const void* wt, const void* x, int B,
                                 int H, int W, int Co, int C, const float* s,
                                 const float* t, void* dx, float* partial, float* stats,
                                 int top, int bottom, int bf16, void* stream) {
  run_dgrad_act<true>(gy, wt, x, B, H, W, Co, C, s, t, dx, partial, stats, bf16, top,
                      bottom, stream);
}

// K5 / K6: x (B, top + H + bottom, W, C), gy (B, H, W, Co); the rest as
// tdal_conv3x3_wgrad.
void tdal_conv3x3_wgrad_halo(const void* x, const void* gy, int B, int H, int W, int C,
                             int Co, const float* in_scale, const float* in_shift,
                             int in_act, int splits, float* partial, float* dw, int top,
                             int bottom, int bf16, void* stream) {
  run_wgrad<true>(x, gy, B, H, W, C, Co, in_scale, in_shift, in_act, splits, partial, dw,
                  bf16, top, bottom, stream);
}

}  // extern "C"
