"""Heading-bin and size-cluster codecs for the Frustum-PointNet labelers.

Torch port of ``tdal/core/codecs.py`` (reference ``tools/utils.py:53-79``): 12 heading
bins + residual, 3 size clusters + residual, ``MEAN_SIZE_ARR`` as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_HEADING_BIN = 12
NUM_SIZE_CLUSTER = 3

# reference tools/utils.py:10-14
MEAN_SIZE_ARR = np.array(
    [
        [4.8, 1.8, 1.5],
        [10.0, 2.6, 3.2],
        [2.0, 1.0, 1.6],
    ],
    dtype=np.float32,
)

TWO_PI = 2.0 * np.pi


def mean_size(like: torch.Tensor) -> torch.Tensor:
    """``MEAN_SIZE_ARR`` as a tensor with ``like``'s dtype and device."""
    return torch.as_tensor(MEAN_SIZE_ARR, dtype=like.dtype, device=like.device)


def angle2class(angle: torch.Tensor, num_class: int = NUM_HEADING_BIN):
    """Angle -> (bin id int32, residual). Parity: tools/utils.py:53-60."""
    angle = torch.remainder(angle, TWO_PI)
    angle_per_class = TWO_PI / float(num_class)
    shifted = torch.remainder(angle + angle_per_class / 2.0, TWO_PI)
    class_id = torch.floor(shifted / angle_per_class).to(torch.int32)
    # Guard the shifted == 2*pi boundary exactly like int() truncation would.
    class_id = class_id.clamp(0, num_class - 1)
    residual = shifted - (
        class_id.to(angle.dtype) * angle_per_class + angle_per_class / 2.0
    )
    return class_id, residual


def class2angle(
    class_id: torch.Tensor,
    residual: torch.Tensor,
    num_class: int = NUM_HEADING_BIN,
    to_label_format: bool = True,
):
    """(bin id, residual) -> angle. Parity: tools/utils.py:69-75."""
    angle_per_class = TWO_PI / float(num_class)
    angle = class_id.to(residual.dtype) * angle_per_class + residual
    if to_label_format:
        angle = torch.where(angle > np.pi, angle - TWO_PI, angle)
    return angle


def size2class(lwh: torch.Tensor):
    """Box dims (..., 3) -> (cluster id int32 (...,), residual (..., 3)).

    Nearest mean size by L2 distance. Parity: tools/utils.py:62-67."""
    mean = mean_size(lwh)
    dist = torch.linalg.norm(lwh[..., None, :] - mean, dim=-1)
    class_id = torch.argmin(dist, dim=-1)
    return class_id.to(torch.int32), lwh - mean[class_id]


def class2size(class_id: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """(cluster id, residual (..., 3)) -> dims (..., 3). Parity: tools/utils.py:77-79."""
    return mean_size(residual)[class_id.long()] + residual
