"""The port's models: detection models (the CenterPoint family) and the Frustum-PointNet
auto-labelers.

Importing this package fills the name registries (``tdal_torch.runtime.registry``)
under tdal's names (``tdal/models/__init__.py``), so that configs dispatch on their
``type`` strings. It builds no kernel: the kernels build at their first launch.
"""

from tdal_torch.models.center_head import CenterHead
from tdal_torch.models.detectors import PointPillars, VoxelNet
from tdal_torch.models.dynamic_labeler import DynamicLabeler
from tdal_torch.models.readers import PillarFeatureNet, VoxelMeanEncoder
from tdal_torch.models.rpn import RPN
from tdal_torch.models.scn import MiddleBackbone
from tdal_torch.models.static_labeler import StaticLabelerOneBox, StaticLabelerTwoBox
from tdal_torch.models.two_stage import BEVFeatureExtractor, RoIHead
from tdal_torch.runtime import registry as _reg

_reg.READERS.register_module(PillarFeatureNet)
_reg.READERS.register_module(VoxelMeanEncoder, name="VoxelFeatureExtractorV3")
_reg.BACKBONES.register_module(MiddleBackbone, name="SpMiddleResNetFHD")
_reg.NECKS.register_module(RPN)
_reg.HEADS.register_module(CenterHead)
_reg.DETECTORS.register_module(PointPillars)
_reg.DETECTORS.register_module(VoxelNet)
_reg.SECOND_STAGE.register_module(BEVFeatureExtractor)
_reg.ROI_HEAD.register_module(RoIHead)
_reg.LABELERS.register_module(StaticLabelerOneBox, name="one_box_est")
_reg.LABELERS.register_module(StaticLabelerTwoBox, name="two_box_est")
_reg.LABELERS.register_module(DynamicLabeler, name="dynamic")
