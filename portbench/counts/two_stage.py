"""Operations of the two-stage detector, from its configuration and the frames' voxels.

``work.py`` counts a one-stage VoxelNet of 5 point features and a CenterHead without
velocity; the two-sweep first stage reads 6 features (the time lag) and its head has a
``vel`` branch, and a second stage follows:

- ``dense_flops``: the RPN and CenterHead, with the ``vel`` branch's two convs;
- ``sparse_convs``: ``work.sparse_convs`` with the input conv's width set to the
  points' features;
- ``second_stage_flops``: a frame's fixed ``NMS_POST_MAXSIZE`` RoI rows (valid or not:
  the program runs them all) through the bilinear BEV samples (4 corners a point and
  channel) and the RoIHead's FC layers and final Linears.
"""

from __future__ import annotations

from portbench.counts import work
from portbench.reference.two_stage import first_cfg

VEL = 2  # the velocity branch's outputs


def dense_flops(cfg: dict) -> float:
    """Forward FLOP of one frame's RPN and CenterHead, the ``vel`` branch included."""
    one = first_cfg(cfg)
    layers = work.dense_layers(one)
    h, w = layers[-1][3], layers[-1][4]
    vel = [(3, 1, h, w, work.HEAD_CONV, work.HEAD_CONV, False),
           (3, 1, h, w, work.HEAD_CONV, VEL, False)]
    n_tasks = len(one["model"]["bbox_head"]["tasks"])
    return work.dense_flops(one) + n_tasks * sum(work.layer_flops(*l) for l in vel)


def sparse_convs(levels, cin: int) -> list:
    """``work.sparse_convs`` with ``cin`` features into the input conv."""
    out = []
    n0 = len(levels[0][1])
    c0 = work.SPARSE_CHANNELS[0]
    for label, pairs, flops, nbytes in work.sparse_convs(levels):
        if label == "subm in":
            flops = 2.0 * pairs * cin * c0
            nbytes = work.F32 * (n0 * cin + n0 * c0 + 27 * cin * c0)
        out.append((label, pairs, flops, nbytes))
    return out


def second_stage_flops(cfg: dict) -> float:
    """Forward FLOP of one frame's second stage over its fixed RoI rows."""
    model = cfg["model"]
    mc = model["roi_head"]["model_cfg"]
    rois = int(model["NMS_POST_MAXSIZE"])
    cin = int(model["roi_head"]["input_channels"])  # every sample point's channels
    sample = 2.0 * 4 * cin  # a multiply-add a corner, point and channel
    macs, c = 0, cin
    for width in mc["SHARED_FC"]:
        macs, c = macs + c * width, width
    shared = c
    for widths, out in ((mc["CLS_FC"], 1), (mc["REG_FC"], int(model["roi_head"]["code_size"]))):
        c = shared
        for width in widths:
            macs, c = macs + c * width, width
        macs += c * out
    return rois * (sample + 2.0 * macs)
