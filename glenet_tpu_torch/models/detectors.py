"""Detector composition (torch counterpart of glenet_tpu/models/detectors.py)
for these topologies:

  - VoxelRCNN (GLENet-VR, plain Voxel R-CNN): voxelize -> MeanVFE ->
    VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone -> anchor head
    -> proposal NMS -> (train: RoI target sampling) -> VoxelRCNNHead ->
    final NMS over the refined RoIs;
  - SECONDNetIoU (SECOND-IoU): the same stage 1 with AnchorHeadSingle,
    then SECONDHead scores the RoIs (sampled from the 2D backbone's map) by
    their predicted IoU; the boxes are the RoIs;
  - SECONDNet, single stage (GLENet-S, GLENet-C, plain SECOND,
    SECOND-multihead, SE-SSD's head): voxelize -> MeanVFE ->
    VoxelBackBone8x(Ciassd) -> HeightCompression -> BaseBEVBackbone or
    SSFA -> AnchorHeadSingle, AnchorHeadMulti, AnchorHeadSessd (its od-IoU
    regression loss) or the KL-label family -> final NMS over the dense
    head's decoded anchors (per class with MULTI_CLASSES_NMS);
  - PointPillar: voxelize into pillars -> PillarVFE -> PointPillarScatter
    -> BaseBEVBackbone -> AnchorHeadSingle -> final NMS;
  - PVRCNN: VoxelRCNN's stage 1 with AnchorHeadSingle; before the
    proposals, VoxelSetAbstraction keypoints (FPS over the raw points,
    features from the BEV map, the raw points and the backbone levels) and
    PointHeadSimple's foreground score, which weighs the keypoint features
    that PVRCNNHead pools into each RoI's grid; its segmentation loss adds
    `point_loss_cls`;
  - PVRCNNPlusPlus (PV-RCNN++): the same slots with a CenterHead RPN, in
    another order: proposals -> (train: RoI sampling) -> keypoints of those
    rois (SPC: FPS over the points near a roi) with VectorPool features of
    each source's points near a roi -> PointHeadSimple -> PVRCNNHead with
    VectorPool RoI-grid pooling;
  - PartA2Net (PartA2): voxelize -> MeanVFE -> UNetV2 (sparse encoder,
    HeightCompression of its encoded tensor into the BEV stages and the
    anchor head; UR-block decoder to per-voxel features) ->
    PointIntraPartOffsetHead (segmentation and part offsets of the level-1
    voxel centres) -> proposal NMS -> PartA2FCHead over RoI-aware pooled
    voxel features and part features -> final NMS;
  - PointRCNN in its PartA2-free form (a UNetV2 backbone, no DENSE_HEAD):
    the part head's box branch (PointResidualCoder) gives anchor-free
    proposals, PartA2FCHead with DISABLE_PART refines them;
  - PointRCNN, point-based (pointrcnn.yaml, pointrcnn_iou.yaml): no
    voxels; PointNet2MSG's per-point features -> PointHeadBox (per-point
    class logits and PointResidualCoder boxes) -> final NMS, or, with
    PointRCNNHead, proposal NMS over the point boxes -> (train: RoI target
    sampling) -> RoI point pooling of [xyz, score, depth, features] (no
    gradient, as the reference's no_grad) -> PointRCNNHead -> final NMS
    over the refined rois;
  - CenterPoint: voxelize -> MeanVFE -> VoxelResBackBone8x (or
    VoxelBackBone8x) -> HeightCompression -> BaseBEVBackbone -> CenterHead
    (heatmap and box maps) -> top-k decode -> final NMS; or pillars
    (PillarVFE or DynamicPillarVFE -> PointPillarScatter) at stride 1.  A
    CenterHead also serves VoxelRCNN and PVRCNN as their RPN: its decoded
    boxes (DENSE_HEAD.POST_PROCESSING's MAX_OBJ_PER_SAMPLE and
    SCORE_THRESH) go into the proposal NMS;
  - CaDDN, camera only: ImageVFE (a depth-distribution network over the
    image, frustum features, trilinear frustum-to-voxel sampling) ->
    Conv2DCollapse -> BaseBEVBackbone -> AnchorHeadSingle -> final NMS; its
    loss adds the depth loss (`loss_depth`).

The dynamic VFEs (DynamicMeanVFE, DynamicPillarVFE) take the points with
their voxel slots (voxelize_dynamic) instead of the padded voxel table, the
batch flattened into the point and slot axes.

The dense head's targets come from the axis-aligned assigner or ATSS, on
nearest-BEV IoU or, with MATCH_HEIGHT, on 3D IoU.  The point features are
those of POINT_FEATURE_ENCODING's used_feature_list (4 on KITTI, 5 on
Waymo).

Every other family or option raises NotImplementedError naming itself.

  - `DetectorNet` (nn.Module) holds the neural slots and runs the forward
    from raw padded points.  Train mode runs at the train voxel budget
    (with NMS_CONFIG.TRAIN proposals in VoxelRCNN); eval mode at the test
    budget.
  - `Detector` owns the static state (anchors, box coder, configs) and
    exposes `predict` (decode + variance-voting or greedy NMS into fixed
    slots) and `loss_fn` (train forward, anchor targets and every loss
    term).

`build_detector(cfg, device=None)` puts the model on the GPU unless the
caller passes device='cpu'; without a GPU it raises.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config import Cfg
from ..ops import nms as nms_ops
from ..ops import roipoint_pool
from ..ops import voxelize as vox_ops
from ..parallel import distributed as dp
from ..utils import box_coder as box_coder_lib
from ..utils import common
from ..utils import trace
from . import anchor_heads, anchors, target_assigner
from . import center_head as center_lib
from . import pfe as pfe_lib
from . import point_heads
from . import roi_heads as roi_lib
from .bev_backbone import SSFA, BaseBEVBackbone
from .image_vfe import Conv2DCollapse, ImageVFE, ddn_loss
from .map_to_bev import PointPillarScatter
from .point_rcnn_head import (PointRCNNHead, canonicalize_pooled,
                              pool_prefix_features)
from .pointnet2_backbone import PointNet2MSG
from .roi_heads import (PartA2FCHead, PVRCNNHead, SECONDHead, VoxelRCNNHead,
                        decode_rcnn_boxes)
from .spconv_backbone import build_backbone_3d
from .vfe import (DYNAMIC_MEAN, DYNAMIC_PILLAR, DynamicMeanVFE,
                  DynamicPillarVFE, MeanVFE, PillarVFE)


def _require(cond, what):
    if not cond:
        raise NotImplementedError(f'{what} is not ported yet')


# the MODEL names the port builds
FAMILIES = ('VoxelRCNN', 'SECONDNet', 'SECONDNetIoU', 'PointPillar',
            'PVRCNN', 'PVRCNNPlusPlus', 'PartA2Net', 'PointRCNN',
            'CenterPoint', 'CaDDN')
# topology (_topology: the MODEL name, PointRCNN by its backbone) -> the
# ROI_HEAD names it builds, None for a topology that may have none (the
# others: none)
_ROI_HEADS = {'VoxelRCNN': ('VoxelRCNNKLLabelIoUHead', 'VoxelRCNNHead'),
              'SECONDNetIoU': ('SECONDHead',), 'PVRCNN': ('PVRCNNHead',),
              'PVRCNNPlusPlus': ('PVRCNNHead',),
              'PartA2Net': ('PartA2FCHead',),
              'PartA2-free': ('PartA2FCHead',),
              'PointRCNN': ('PointRCNNHead', None)}
# topology -> the POINT_HEAD it needs (the others: none)
_POINT_HEADS = {'PVRCNN': 'PointHeadSimple',
                'PVRCNNPlusPlus': 'PointHeadSimple',
                'PartA2Net': 'PointIntraPartOffsetHead',
                'PartA2-free': 'PointIntraPartOffsetHead',
                'PointRCNN': 'PointHeadBox'}


def _topology(model_cfg):
    """The MODEL name, except for PointRCNN without a DENSE_HEAD, which
    glenet_tpu builds by its backbone: 'PointRCNN' (point-based,
    PointNet2MSG) or 'PartA2-free' (UNetV2)."""
    name = model_cfg.get('NAME')
    if name != 'PointRCNN':
        return name
    bb = (model_cfg.get('BACKBONE_3D') or {}).get('NAME')
    _require(bb in ('PointNet2MSG', 'UNetV2')
             and 'DENSE_HEAD' not in model_cfg,
             f'MODEL PointRCNN with BACKBONE_3D {bb}')
    return 'PartA2-free' if bb == 'UNetV2' else 'PointRCNN'


class DetectorNet(nn.Module):
    """Neural slots of the VoxelRCNN, SECONDNetIoU, single-stage SECONDNet,
    PointPillar, PVRCNN, PVRCNNPlusPlus, PartA2Net, PartA2-free,
    point-based PointRCNN, CenterPoint or CaDDN detector."""

    def __init__(self, model_cfg, grid_size, voxel_size, pc_range,
                 max_voxels_train: int, max_voxels_test: int,
                 max_points_per_voxel: int, num_class: int, anchor_set,
                 box_coder, num_point_features: int = 4, point_coder=None):
        super().__init__()
        mcfg = Cfg(model_cfg)
        name = _topology(mcfg)      # of a MODEL in FAMILIES (Detector)
        self.part_free = name == 'PartA2-free'
        self.point_based = name == 'PointRCNN'
        # CaDDN: camera only, no points, no 3D backbone
        self.camera = name == 'CaDDN'
        roi_cfg = mcfg.get('ROI_HEAD')
        roi_name = None if roi_cfg is None else roi_cfg.NAME
        _require(roi_name in _ROI_HEADS.get(name, (None,)),
                 f'MODEL {mcfg.NAME} with ROI_HEAD {roi_name}')
        if roi_cfg is not None:
            score_type = (roi_cfg.get('TARGET_CONFIG', {}) or {}).get(
                'CLS_SCORE_TYPE', 'roi_iou')
            _require(score_type in ('roi_iou', 'cls'),
                     f'CLS_SCORE_TYPE {score_type}')
        pfe_cfg, ph_cfg = mcfg.get('PFE'), mcfg.get('POINT_HEAD')
        ph_name = None if ph_cfg is None else ph_cfg.NAME
        _require(ph_name == _POINT_HEADS.get(name),
                 f'POINT_HEAD {ph_name} in {mcfg.NAME}')
        self.model_cfg = mcfg
        self.point_coder = point_coder
        self.box_coder = box_coder
        if self.point_based:
            self._build_point_based(mcfg, num_point_features, num_class)
            return
        pillars = 'BACKBONE_3D' not in mcfg and not self.camera
        vfe_name = mcfg.VFE.NAME
        _require(vfe_name in (('ImageVFE',) if self.camera
                              else ('PillarVFE',) + DYNAMIC_PILLAR if pillars
                              else ('MeanVFE',) + DYNAMIC_MEAN),
                 f'VFE {vfe_name}')
        _require(pillars == (name == 'PointPillar') or name == 'CenterPoint',
                 f'MODEL {name} with{"out" * pillars} BACKBONE_3D')
        self.dynamic = vfe_name in DYNAMIC_MEAN + DYNAMIC_PILLAR
        bb3d = (mcfg.get('BACKBONE_3D') or {}).get('NAME')
        _require(bb3d is None or not self.camera, f'BACKBONE_3D {bb3d} in '
                 f'{name}')
        unet = bb3d == 'UNetV2'
        _require(unet == (name in ('PartA2Net', 'PartA2-free')),
                 f'BACKBONE_3D {bb3d} in {name}')
        if not self.part_free:
            m2b = mcfg.MAP_TO_BEV
            _require(m2b.NAME == ('Conv2DCollapse' if self.camera
                                  else 'PointPillarScatter' if pillars
                                  else 'HeightCompression'),
                     f'MAP_TO_BEV {m2b.NAME}')
            _require(mcfg.BACKBONE_2D.NAME in ('BaseBEVBackbone', 'SSFA'),
                     f'BACKBONE_2D {mcfg.BACKBONE_2D.NAME}')
            head_cfg = mcfg.DENSE_HEAD
            ta_cfg = head_cfg.get('TARGET_ASSIGNER_CONFIG', {}) or {}
            assigner = ta_cfg.get('NAME', 'AxisAlignedTargetAssigner')
            _require(assigner in ('AxisAlignedTargetAssigner',
                                  'WeightedAxisAlignedTargetAssigner',
                                  'ATSSTargetAssigner'), assigner)
        _require((pfe_cfg is not None) == (name in ('PVRCNN',
                                                    'PVRCNNPlusPlus'))
                 and (pfe_cfg is None
                      or pfe_cfg.NAME == 'VoxelSetAbstraction'),
                 f'PFE {None if pfe_cfg is None else pfe_cfg.NAME} in {name}')
        # PV-RCNN++ runs its proposals before the keypoints (SPC and the
        # roi-filtered sources need the rois), PV-RCNN after them
        self.pvpp = name == 'PVRCNNPlusPlus'
        if self.part_free:
            _require(ph_cfg.get('REG_FC') is not None
                     and point_coder is not None,
                     'a PartA2-free POINT_HEAD without REG_FC and '
                     'TARGET_CONFIG.BOX_CODER')

        self.grid_size, self.voxel_size = tuple(grid_size), tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.max_voxels_train = max_voxels_train
        self.max_voxels_test = max_voxels_test
        self.max_points_per_voxel = max_points_per_voxel
        self.anchor_set = anchor_set
        self.vfe = DynamicMeanVFE() if self.dynamic else MeanVFE()
        self.backbone_2d = self.dense_head = self.part_head = None
        self.pfe = self.point_head_simple = self.roi_head = None
        if unet:
            self.backbone_3d = build_backbone_3d(
                mcfg.BACKBONE_3D, grid_size, num_point_features,
                voxel_size=voxel_size, pc_range=pc_range)
            self.part_head = point_heads.PointIntraPartOffsetHead(
                self.backbone_3d.level_channels['x_conv1'],
                1 if ph_cfg.get('CLASS_AGNOSTIC', True) else num_class,
                tuple(ph_cfg.get('CLS_FC', ())),
                tuple(ph_cfg.get('PART_FC', ())),
                tuple(ph_cfg.get('REG_FC', ()) if self.part_free else ()),
                point_coder.code_size if self.part_free else 0)
            self.roi_head = PartA2FCHead(
                roi_cfg, self.backbone_3d.level_channels['x_conv1'],
                code_size=box_coder.code_size)
        if self.part_free:
            return
        if self.camera:
            self.vfe = ImageVFE(mcfg.VFE, grid_size, pc_range)
            self.backbone_3d = None
            c_bev = int(mcfg.MAP_TO_BEV.NUM_BEV_FEATURES)
            self.map_to_bev = Conv2DCollapse(
                int(grid_size[2]) * self.vfe.num_features, c_bev)
        elif pillars:
            vfe_cfg = mcfg.VFE
            self.vfe = (DynamicPillarVFE if self.dynamic else PillarVFE)(
                num_point_features, vfe_cfg.NUM_FILTERS, voxel_size,
                pc_range,
                use_absolute_xyz=vfe_cfg.get('USE_ABSLOTE_XYZ', True),
                with_distance=vfe_cfg.get('WITH_DISTANCE', False),
                use_norm=vfe_cfg.get('USE_NORM', True))
            self.backbone_3d = None
            self.map_to_bev = PointPillarScatter(grid_size)
            c_bev = self.vfe.num_out_features
        else:
            if not unet:
                self.backbone_3d = build_backbone_3d(
                    mcfg.BACKBONE_3D, grid_size, num_point_features,
                    site_lists=pfe_cfg is not None)
            c_bev = self.backbone_3d.num_bev_features
        bb = mcfg.BACKBONE_2D
        if bb.NAME == 'SSFA':
            self.backbone_2d = SSFA(c_bev)
        else:
            self.backbone_2d = BaseBEVBackbone(
                in_channels=c_bev,
                layer_nums=tuple(bb.LAYER_NUMS),
                layer_strides=tuple(bb.LAYER_STRIDES),
                num_filters=tuple(bb.NUM_FILTERS),
                upsample_strides=tuple(bb.get('UPSAMPLE_STRIDES', ())),
                num_upsample_filters=tuple(bb.get('NUM_UPSAMPLE_FILTERS',
                                                  ())))
        self.num_dir_bins = (head_cfg.get('NUM_DIR_BINS', 2)
                             if head_cfg.get('USE_DIRECTION_CLASSIFIER', False)
                             else 0)
        self.dir_offset = head_cfg.get('DIR_OFFSET', 0.78539)
        self.dir_limit_offset = head_cfg.get('DIR_LIMIT_OFFSET', 0.0)
        c_2d = self.backbone_2d.num_bev_features
        self.is_center_head = head_cfg.NAME == 'CenterHead'
        if self.is_center_head:
            self.dense_head = center_lib.CenterHead(
                c_2d, num_class, head_cfg.get('SHARED_CONV_CHANNEL', 64),
                head_cfg.get('USE_BIAS_BEFORE_NORM', False))
        elif head_cfg.NAME == 'AnchorHeadMulti':
            groups = [tuple(h['HEAD_CLS_NAME'])
                      for h in head_cfg.RPN_HEAD_CFGS]
            names = tuple(anchor_set.class_names)
            if tuple(n for g in groups for n in g) != names:
                raise ValueError('RPN_HEAD_CFGS must partition CLASS_NAMES '
                                 'in anchor order')
            self.dense_head = anchor_heads.AnchorHeadMulti(
                c_2d, num_class, names,
                [sl.stop - sl.start for sl in anchor_set.class_slices],
                groups, box_coder.code_size, self.num_dir_bins,
                shared_ch=head_cfg.get('SHARED_CONV_NUM_FILTER', 64))
        else:
            self.dense_head = anchor_heads.build_dense_head(
                head_cfg.NAME, c_2d, num_class,
                anchor_set.num_anchors_per_location, box_coder.code_size,
                self.num_dir_bins)
        if pfe_cfg is not None:
            self.pfe = pfe_lib.VoxelSetAbstraction(
                pfe_cfg, voxel_size, pc_range, c_bev, num_point_features,
                self.backbone_3d.level_channels)
            self.use_features_before_fusion = bool(ph_cfg.get(
                'USE_POINT_FEATURES_BEFORE_FUSION', True))
            self.point_head_simple = pfe_lib.PointHeadSimple(
                self.pfe.num_features_before_fusion
                if self.use_features_before_fusion
                else int(pfe_cfg.NUM_OUTPUT_FEATURES),
                1 if ph_cfg.get('CLASS_AGNOSTIC', True) else num_class,
                tuple(ph_cfg.CLS_FC))
            if self.pfe.needs_rois and not self.pvpp:
                raise ValueError(
                    f'MODEL {name} samples its keypoints before the '
                    f'proposals: SAMPLE_METHOD SPC and '
                    f'FILTER_NEIGHBOR_WITH_ROI need PVRCNNPlusPlus')
        if roi_cfg is None or unet:             # PartA2FCHead: built above
            pass
        elif name in ('PVRCNN', 'PVRCNNPlusPlus'):
            self.roi_head = PVRCNNHead(roi_cfg,
                                       int(pfe_cfg.NUM_OUTPUT_FEATURES),
                                       code_size=box_coder.code_size)
        elif name == 'SECONDNetIoU':
            self.roi_head = SECONDHead(roi_cfg, voxel_size, pc_range, c_2d,
                                       code_size=box_coder.code_size)
        else:
            self.roi_head = VoxelRCNNHead(
                roi_cfg, voxel_size, pc_range,
                level_channels=self.backbone_3d.level_channels,
                code_size=box_coder.code_size,
                kl_label='KLLabel' in roi_name)
        if anchor_set is not None:
            self.register_buffer('flat_anchors',
                                 torch.from_numpy(anchor_set.flat_anchors),
                                 persistent=False)

    def _build_point_based(self, mcfg, num_point_features, num_class):
        """PointRCNN's slots: PointNet2MSG, PointHeadBox and, when ROI_HEAD
        is set, the class-agnostic PointRCNNHead."""
        _require(mcfg.BACKBONE_3D.get('SA_CONFIG') is not None
                 and mcfg.BACKBONE_3D.get('FP_MLPS') is not None,
                 'PointNet2MSG without SA_CONFIG and FP_MLPS')
        ph_cfg, roi_cfg = mcfg.POINT_HEAD, mcfg.get('ROI_HEAD')
        _require(self.point_coder is not None,
                 'a PointHeadBox without TARGET_CONFIG.BOX_CODER')
        self.backbone_3d = PointNet2MSG(mcfg.BACKBONE_3D, num_point_features)
        self.point_head = point_heads.PointHeadBox(
            self.backbone_3d.num_point_features, num_class,
            self.point_coder.code_size, tuple(ph_cfg.CLS_FC),
            tuple(ph_cfg.REG_FC))
        self.roi_head = None
        if roi_cfg is not None:
            _require(roi_cfg.get('CLASS_AGNOSTIC', True),
                     'PointRCNNHead with CLASS_AGNOSTIC False')
            _require(not roi_cfg.get('USE_BN', False),
                     'PointRCNNHead with USE_BN True')
            self.roi_head = PointRCNNHead(
                roi_cfg, self.backbone_3d.num_point_features,
                code_size=self.box_coder.code_size)

    def voxelize(self, points, points_mask, max_voxels):
        """Per sample voxelize, or voxelize_dynamic for a dynamic VFE."""
        if self.dynamic:
            outs = [vox_ops.voxelize_dynamic(
                points[i], points_mask[i], self.voxel_size, self.pc_range,
                self.grid_size, max_voxels) for i in range(points.shape[0])]
        else:
            outs = [vox_ops.voxelize(
                points[i], points_mask[i], self.voxel_size, self.pc_range,
                self.grid_size, max_voxels, self.max_points_per_voxel)
                for i in range(points.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def voxel_features(self, points, vox, train):
        """The VFE's (B, V, C) features.  The pillar encoders and the
        dynamic VFEs take the batch flattened into the voxel (and point)
        axis, so their BN statistics span the batch; a dynamic VFE's
        segments are the slots offset by b * V, its empty slots zeroed."""
        b, v = vox['voxel_coords'].shape[:2]
        if self.dynamic:
            n = points.shape[1]
            pvi = vox['point_voxel_idx']
            offs = torch.arange(b, device=pvi.device)[:, None] * v
            flat_idx = torch.where(pvi >= 0, pvi + offs, -1).reshape(b * n)
            flat_pts = points.reshape(b * n, -1)
            if isinstance(self.vfe, DynamicPillarVFE):
                feats = self.vfe(flat_pts, flat_idx,
                                 vox['voxel_coords'].reshape(b * v, 3),
                                 b * v, train)
            else:
                feats = self.vfe(flat_pts, flat_idx, b * v)
            return torch.where(vox['voxel_mask'][..., None],
                               feats.reshape(b, v, -1), 0.0)
        if isinstance(self.vfe, PillarVFE):
            return self.vfe(vox['voxels'].flatten(0, 1),
                            vox['voxel_num_points'].flatten(0, 1),
                            vox['voxel_coords'].flatten(0, 1),
                            train).reshape(b, v, -1)
        return self.vfe(vox['voxels'], vox['voxel_num_points'])

    def forward(self, points, points_mask, train: bool = False,
                gt_boxes=None, gt_mask=None, gt_uncertainty=None,
                generator=None, roi_targets=None, camera=None):
        """points (B, P, C), points_mask (B, P) -> dict with vox,
        backbone_3d and dense_head outputs; in VoxelRCNN also proposals and
        rcnn outputs, plus roi_targets in train mode.  CaDDN takes
        `camera` (images, trans_lidar_to_cam, trans_cam_to_img,
        image_shape) instead of the points and returns dense_head and
        depth_logits.

        Train mode needs gt_boxes (B, M, 8), gt_mask (B, M) and optionally
        gt_uncertainty (B, M, 7); `generator` feeds the RoI sampling and
        dropout draws.  Given `roi_targets` (a dict as out['roi_targets']),
        train mode skips proposals and sampling and refines those rois.
        """
        if self.point_based:
            return self._point_forward(points, points_mask, train, gt_boxes,
                                       gt_mask, gt_uncertainty, generator,
                                       roi_targets)
        if self.camera:
            vfe_out = self.vfe(camera['images'],
                               camera['trans_lidar_to_cam'],
                               camera['trans_cam_to_img'],
                               camera['image_shape'], train)
            bev = self.map_to_bev(vfe_out['voxel_features'], train)
            return {'dense_head': self.dense_head(
                        self.backbone_2d(bev, train), train),
                    'depth_logits': vfe_out['depth_logits']}
        max_voxels = self.max_voxels_train if train else self.max_voxels_test
        with trace.span('voxelize'):
            vox = self.voxelize(points, points_mask, max_voxels)
        out = {'vox': vox}
        with trace.span('vfe'):
            feats = self.voxel_features(points, vox, train)
        if self.part_free:
            with trace.span('backbone_3d'):
                sp_out = self.backbone_3d(feats, vox['voxel_coords'],
                                          vox['voxel_mask'], train)
            out['backbone_3d'] = sp_out
            out['part_head'] = self._part_head(sp_out, train)
            if roi_targets is None or not train:
                with torch.no_grad():
                    out['proposals'] = self._point_proposals(
                        out['part_head'], train)
            roi_in = self._roi_input(out, train, gt_boxes, gt_mask,
                                     gt_uncertainty, generator, roi_targets)
            out['rcnn'] = self._part_roi_head(
                roi_in, sp_out, out['part_head'], train, generator,
                use_coords=self.model_cfg.ROI_HEAD.get('DISABLE_PART',
                                                       False))
            out['rcnn']['rois'] = roi_in
            return out
        if self.backbone_3d is None:
            with trace.span('backbone_2d'):
                bev = self.map_to_bev(feats, vox['voxel_coords'],
                                      vox['voxel_mask'])
        else:
            with trace.span('backbone_3d'):
                sp_out = self.backbone_3d(feats, vox['voxel_coords'],
                                          vox['voxel_mask'], train)
            out['backbone_3d'] = sp_out
            bev = sp_out['bev_features']
        with trace.span('backbone_2d'):
            spatial_2d = self.backbone_2d(bev, train)
        with trace.span('dense_head'):
            out['dense_head'] = self.dense_head(spatial_2d, train)
        if self.part_head is not None:
            out['part_head'] = self._part_head(sp_out, train)
        if self.roi_head is None:
            return out
        if self.pfe is not None and not self.pvpp:
            # before the proposals, as glenet_tpu's plain PV-RCNN
            kp_weighted = self._keypoints(points, points_mask, sp_out, out,
                                          train)

        if roi_targets is None or not train:
            # proposals carry no gradient, as in the reference's no_grad
            # proposal layer
            with torch.no_grad():
                out['proposals'] = self._proposals(out['dense_head'], train)
        roi_in = self._roi_input(out, train, gt_boxes, gt_mask,
                                 gt_uncertainty, generator, roi_targets)
        if self.pvpp:
            # PV-RCNN++: the keypoints of the (detached) rois the head
            # refines, all valid in train mode
            roi_valid = (torch.ones(roi_in.shape[:2], dtype=torch.bool,
                                    device=roi_in.device) if train
                         else out['proposals']['roi_valid'])
            kp_weighted = self._keypoints(points, points_mask, sp_out, out,
                                          train, roi_in, roi_valid)
        if self.part_head is not None:
            out['rcnn'] = self._part_roi_head(roi_in, sp_out,
                                              out['part_head'], train,
                                              generator, use_coords=False)
        elif self.pfe is not None:
            out['rcnn'] = self.roi_head(roi_in, out['pfe']['keypoints'],
                                        kp_weighted, train, generator)
        else:
            features = (spatial_2d if isinstance(self.roi_head, SECONDHead)
                        else sp_out['multi_scale'])
            out['rcnn'] = self.roi_head(roi_in, features, train, generator)
        out['rcnn']['rois'] = roi_in
        return out

    def _point_forward(self, points, points_mask, train, gt_boxes, gt_mask,
                       gt_uncertainty, generator, roi_targets):
        """PointRCNN: out['point_head'] (point_cls_preds, point_box_preds,
        point_xyz, point_mask); with PointRCNNHead also proposals (unless
        train mode has fixed roi_targets), roi_targets in train mode and
        rcnn."""
        feats = self.backbone_3d(points, points_mask, train)
        head = self.point_head(feats, points_mask, train)
        xyz = points[..., :3]
        head.update(point_xyz=xyz, point_mask=points_mask)
        out = {'point_head': head}
        if self.roi_head is None:
            return out
        with torch.no_grad():
            boxes, scores, labels = self.decode_point_boxes(head)
            if roi_targets is None or not train:
                out['proposals'] = self._nms_proposals(
                    boxes, scores, labels, self.model_cfg.ROI_HEAD.NMS_CONFIG[
                        'TRAIN' if train else 'TEST'])
        roi_in = self._roi_input(out, train, gt_boxes, gt_mask,
                                 gt_uncertainty, generator, roi_targets)
        with torch.no_grad():
            pooled, empty = self._pool_roi_points(xyz, feats, scores, roi_in,
                                                  points_mask)
        out['rcnn'] = self.roi_head(pooled, empty, train, generator)
        out['rcnn']['rois'] = roi_in
        return out

    def decode_point_boxes(self, head):
        """Each valid point's box from its box encodings and best class
        (classes scored by their sigmoid, invalid points at 0) -> (boxes
        (B, N, 7), best scores (B, N), best labels (B, N) from 1)."""
        cls = torch.sigmoid(head['point_cls_preds'])
        cls = torch.where(head['point_mask'][..., None], cls, 0.0)
        best_scores, best = cls.max(dim=-1)
        boxes = self.point_coder.decode(head['point_box_preds'],
                                        head['point_xyz'], best + 1)
        return boxes, best_scores, best + 1

    def _pool_roi_points(self, xyz, feats, scores, rois, points_mask):
        """ROI_POINT_POOL: each roi's NUM_SAMPLED_POINTS points carrying
        [xyz, score, depth, features] in the roi's canonical frame, and
        the empty flags, flattened to (B * R, S, 5 + C) and (B * R,)."""
        pool_cfg = self.model_cfg.ROI_HEAD.ROI_POINT_POOL
        prefix = pool_prefix_features(xyz, feats, scores,
                                      float(pool_cfg.DEPTH_NORMALIZER))
        pooled, empty = roipoint_pool.roipoint_pool3d(
            xyz, prefix, rois, int(pool_cfg.NUM_SAMPLED_POINTS),
            tuple(pool_cfg.POOL_EXTRA_WIDTH), points_mask)
        b, r, s = pooled.shape[:3]
        pooled = canonicalize_pooled(pooled.reshape(b * r, s, -1),
                                     rois.reshape(b * r, -1),
                                     empty.reshape(b * r))
        return pooled, empty.reshape(b * r)

    def _roi_input(self, out, train, gt_boxes, gt_mask, gt_uncertainty,
                   generator, roi_targets):
        """The rois the RoI head refines: in train mode the sampled (or the
        given) RoI targets' rois, which also go to out['roi_targets'];
        else the proposals."""
        if not train:
            return out['proposals']['rois']
        if roi_targets is None:
            prop = out['proposals']
            roi_targets = self._sample_roi_targets(
                prop['rois'], prop['roi_scores'], prop['roi_labels'],
                gt_boxes, gt_mask, gt_uncertainty, generator)
        out['roi_targets'] = roi_targets
        return roi_targets['rois']

    def _part_head(self, sp_out, train):
        """PointIntraPartOffsetHead on UNetV2's voxel-point features, with
        the voxel centres and mask it ran on."""
        part = self.part_head(sp_out['point_features'], sp_out['point_mask'],
                              train)
        part['point_coords'] = sp_out['point_coords']
        part['point_mask'] = sp_out['point_mask']
        return part

    def _part_roi_head(self, roi_in, sp_out, part, train, generator,
                       use_coords):
        """PartA2FCHead over the part features (partA2_head.py:118-126):
        the sigmoid part offsets (the voxel centres with DISABLE_PART) and
        the detached best segmentation score, the first three zeroed below
        SEG_MASK_SCORE_THRESH."""
        thresh = float(self.model_cfg.ROI_HEAD.get('SEG_MASK_SCORE_THRESH',
                                                   0.3))
        score = torch.sigmoid(part['point_cls_preds']).amax(-1).detach()
        first3 = (part['point_coords'] if use_coords
                  else torch.sigmoid(part['point_part_preds']))
        first3 = torch.where((score >= thresh)[..., None], first3, 0.0)
        part_feats = torch.cat([first3, score[..., None]], dim=-1)
        return self.roi_head(roi_in, sp_out['point_coords'],
                             sp_out['point_features'], part_feats,
                             sp_out['point_mask'], train, generator)

    def _point_proposals(self, part, train):
        """PartA2-free stage 1: each voxel centre's box from the part head's
        box branch (decode_point_boxes) through the proposal NMS."""
        boxes, scores, labels = self.decode_point_boxes(
            dict(part, point_xyz=part['point_coords']))
        return self._nms_proposals(boxes, scores, labels,
                                   self.model_cfg.ROI_HEAD.NMS_CONFIG[
                                       'TRAIN' if train else 'TEST'])

    def _keypoints(self, points, points_mask, sp_out, out, train, rois=None,
                   roi_valid=None):
        """VoxelSetAbstraction (of the rois, for PV-RCNN++) and
        PointHeadSimple: sets out['pfe'] (keypoints, keypoint_idx,
        point_cls_preds) and returns the fused keypoint features times the
        sigmoid of their best foreground logit."""
        vsa = self.pfe(points, points_mask, sp_out['multi_scale'],
                       sp_out['bev_features'], 8, rois, roi_valid, train)
        cls = self.point_head_simple(
            vsa['point_features_before_fusion']
            if self.use_features_before_fusion else vsa['point_features'],
            train)
        out['pfe'] = {'keypoints': vsa['keypoints'],
                      'keypoint_idx': vsa['keypoint_idx'],
                      'point_cls_preds': cls}
        return vsa['point_features'] * torch.sigmoid(cls).amax(-1)[..., None]

    def decode_center(self, head_out, post):
        """The CenterHead's top-k boxes, scores and labels under `post`'s
        MAX_OBJ_PER_SAMPLE (500) and SCORE_THRESH (0)."""
        stride = int(self.model_cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG
                     .FEATURE_MAP_STRIDE)
        return center_lib.decode_center_boxes(
            head_out, int(post.get('MAX_OBJ_PER_SAMPLE', 500)),
            self.voxel_size, self.pc_range, stride,
            score_thresh=float(post.get('SCORE_THRESH', 0.0)))

    def _proposals(self, dense_head_out, train):
        nms_cfg = self.model_cfg.ROI_HEAD.NMS_CONFIG[
            'TRAIN' if train else 'TEST']
        if self.is_center_head:
            boxes, best_scores, best_labels = self.decode_center(
                dense_head_out,
                self.model_cfg.DENSE_HEAD.get('POST_PROCESSING') or {})
            return self._nms_proposals(boxes, best_scores, best_labels,
                                       nms_cfg)
        decoded = anchor_heads.decode_predictions(
            dense_head_out, self.flat_anchors, self.box_coder,
            dir_offset=self.dir_offset,
            dir_limit_offset=self.dir_limit_offset,
            num_dir_bins=self.num_dir_bins)
        cls_scores = torch.sigmoid(decoded['batch_cls_preds'])
        best_scores = cls_scores.amax(dim=-1)
        best_labels = cls_scores.argmax(dim=-1) + 1
        return self._nms_proposals(decoded['batch_box_preds'], best_scores,
                                   best_labels, nms_cfg)

    @torch.no_grad()
    def _sample_roi_targets(self, rois, roi_scores, roi_labels, gt_boxes,
                            gt_mask, gt_uncertainty, generator):
        """Train-time fg/bg roi subsampling and canonical-frame gt targets,
        per sample, draws from `generator`; carries no gradient.  In the
        data-parallel train step a rank draws for every sample of the
        global batch and samples with its own rows' draws."""
        tcfg = self.model_cfg.ROI_HEAD.TARGET_CONFIG
        if gt_uncertainty is None:
            gt_uncertainty = gt_boxes.new_ones((*gt_boxes.shape[:2], 7))
        r = int(tcfg.ROI_PER_IMAGE)
        rank, world = dp.data_rows()
        b = rois.shape[0]
        draws = [roi_lib.draw_roi_sampling(rois.shape[1], r, generator,
                                           rois.device)
                 for _ in range(b * world)][rank * b:(rank + 1) * b]
        per_sample = []
        for i in range(b):
            t = roi_lib.sample_rois_single(
                rois[i], roi_scores[i], roi_labels[i], gt_boxes[i],
                gt_mask[i], gt_uncertainty[i], tcfg, *draws[i])
            t['gt_of_rois_ct'] = roi_lib.canonical_gt_of_rois(
                t['rois'], t['gt_of_rois_src'])
            per_sample.append(t)
        return {k: torch.stack([t[k] for t in per_sample])
                for k in per_sample[0]}

    def _nms_proposals(self, boxes, scores, labels, nms_cfg):
        """Per-sample fixed-slot BEV NMS over decoded stage-1 boxes -> a
        dict of rois, roi_scores, roi_labels and roi_valid."""
        res = []
        for i in range(boxes.shape[0]):
            b_s, s_s, l_s = boxes[i, :, :7], scores[i], labels[i]
            idx, valid = nms_ops.nms_bev(
                b_s, s_s, float(nms_cfg.NMS_THRESH),
                pre_max=int(nms_cfg.NMS_PRE_MAXSIZE),
                post_max=int(nms_cfg.NMS_POST_MAXSIZE),
                score_threshold=float(nms_cfg.get('SCORE_THRESH', 0.0)))
            res.append((b_s[idx], torch.where(valid, s_s[idx], 0.0),
                        torch.where(valid, l_s[idx], 0), valid))
        return dict(zip(('rois', 'roi_scores', 'roi_labels', 'roi_valid'),
                        (torch.stack(t) for t in zip(*res))))


class Detector:
    """Static-state wrapper: build from a reference-style config; predict
    and the training loss."""

    def __init__(self, model_cfg, data_cfg, num_class, device):
        # before any slot is read: a point-based family has no DENSE_HEAD
        _require(model_cfg.get('NAME') in FAMILIES,
                 f'MODEL {model_cfg.get("NAME")}')
        topology = _topology(model_cfg)
        self.part_free = topology == 'PartA2-free'
        self.point_based = topology == 'PointRCNN'
        no_dense = self.part_free or self.point_based
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.num_class = num_class
        self.device = torch.device(device)
        self.pc_range = tuple(data_cfg.POINT_CLOUD_RANGE)
        proc_cfgs = {p.NAME: p for p in data_cfg.DATA_PROCESSOR}
        # the dynamic VFEs' configs name it a placeholder, CaDDN's grid
        # comes from calculate_grid_size
        vox_cfg = proc_cfgs.get(
            'transform_points_to_voxels',
            proc_cfgs.get('transform_points_to_voxels_placeholder',
                          proc_cfgs.get('calculate_grid_size')))
        self.voxel_size = tuple(vox_cfg.VOXEL_SIZE)
        self.grid_size = vox_ops.compute_grid_size(self.pc_range,
                                                   self.voxel_size)
        self.max_points_per_voxel = int(vox_cfg.get('MAX_POINTS_PER_VOXEL', 1))
        mv = vox_cfg.get('MAX_NUMBER_OF_VOXELS', 1)
        # training runs with the train voxel budget, predict with the test
        # budget (KITTI: 16000 / 40000); the parameters are shared
        self.max_voxels_train = int(mv['train'] if isinstance(mv, dict)
                                    else mv)
        self.max_voxels_test = int(mv['test'] if isinstance(mv, dict) else mv)

        ph_cfg = model_cfg.get('POINT_HEAD') or {}
        pt_coder = (ph_cfg.get('TARGET_CONFIG', {}) or {}).get('BOX_CODER')
        self.point_coder = None if pt_coder is None else \
            box_coder_lib.build_box_coder(
                pt_coder, **ph_cfg.TARGET_CONFIG.get('BOX_CODER_CONFIG', {}))
        # PartA2-free and PointRCNN have no dense head: the RCNN stage
        # decodes with the ResidualCoder, as glenet_tpu's stand-in head
        # config gives it
        head_cfg = (Cfg({'NAME': 'PointHead'}) if no_dense
                    else model_cfg.DENSE_HEAD)
        ta_cfg = head_cfg.get('TARGET_ASSIGNER_CONFIG', {}) or {}
        self.box_coder = box_coder_lib.build_box_coder(
            ta_cfg.get('BOX_CODER', 'ResidualCoder'),
            **ta_cfg.get('BOX_CODER_CONFIG', {}))
        self.is_center_head = head_cfg.NAME == 'CenterHead'
        self.anchor_set = None if no_dense or self.is_center_head else \
            anchors.generate_anchors(head_cfg.ANCHOR_GENERATOR_CONFIG,
                                     self.grid_size, self.pc_range)
        # predict-only configs may leave the loss weights out
        self.loss_weights = (head_cfg.get('LOSS_CONFIG', {}) or {}).get(
            'LOSS_WEIGHTS', {})
        self.code_weights = list(self.loss_weights.get('code_weights',
                                                       [1.0] * 7))
        # the regression loss and score rules of the dense head, as JAX's
        # Detector reads them off its name
        self.use_kl_loss = 'KLLabel' in head_cfg.NAME
        self.use_kl_nolabel = head_cfg.NAME == 'AnchorHeadKL'
        self.use_odiou = head_cfg.NAME == 'AnchorHeadSessd'
        self.use_iou_branch = 'IoU' in head_cfg.NAME
        self.assigner = ta_cfg.get('NAME', 'AxisAlignedTargetAssigner')
        self.match_height = bool(ta_cfg.get('MATCH_HEIGHT', False))
        self.atss_topk = int(ta_cfg.get('TOPK', 9))
        encoding = data_cfg.get('POINT_FEATURE_ENCODING', None)
        self.num_point_features = (
            len(encoding['used_feature_list']) if encoding is not None
            else 4)
        self.net = DetectorNet(
            model_cfg, self.grid_size, self.voxel_size, self.pc_range,
            self.max_voxels_train, self.max_voxels_test,
            self.max_points_per_voxel, num_class, self.anchor_set,
            self.box_coder, self.num_point_features,
            self.point_coder).to(self.device).eval()

    @torch.no_grad()
    def predict(self, batch):
        """batch: points (B, P, C), points_mask (B, P) on the detector's
        device (CaDDN: the camera items of camera_of instead).  Returns
        fixed-shape final_boxes (B, K, 7), final_scores (B, K), final_labels
        (B, K), final_valid (B, K)."""
        with trace.call_span('predict'):
            return self.finalize(self.net(batch.get('points'),
                                          batch.get('points_mask'),
                                          camera=camera_of(batch)))

    def loss_fn(self, batch, generator=None):
        """Train forward and loss.  batch: points, points_mask, gt_boxes
        (B, M, 8), gt_mask (B, M), gt_uncertainty (B, M, 7), and optionally
        roi_targets (fixed RoI targets instead of sampling); CaDDN's the
        camera items, depth_maps (B, h, w), gt_boxes2d (B, M, 4) at the
        feature map's scale and gt_boxes2d_mask.  Returns (total loss,
        metrics); the BN running stats update in place."""
        out = self.net(batch.get('points'), batch.get('points_mask'),
                       train=True, gt_boxes=batch['gt_boxes'],
                       gt_mask=batch['gt_mask'],
                       gt_uncertainty=batch.get('gt_uncertainty'),
                       generator=generator,
                       roi_targets=batch.get('roi_targets'),
                       camera=camera_of(batch))
        return self.compute_loss(out, batch)

    def assign_targets(self, gt_boxes, gt_mask, gt_uncertainty):
        """One sample's anchor targets: ATSS (TOPK candidates per gt) or
        the axis-aligned assigner, on 3D IoU with MATCH_HEIGHT."""
        if self.assigner == 'ATSSTargetAssigner':
            return target_assigner.atss_assign_targets(
                self.anchor_set, gt_boxes, gt_mask, gt_uncertainty,
                self.box_coder, topk=self.atss_topk,
                match_height=self.match_height)
        return target_assigner.assign_targets(
            self.anchor_set, gt_boxes, gt_mask, gt_uncertainty,
            self.box_coder, match_height=self.match_height)

    def compute_loss(self, full_out, batch):
        """Anchor-head losses (focal cls; KL-label, KL, od-IoU or
        sin-difference smooth-L1 regression; direction bins; the IoU
        branch), in PartA2 the part head's losses, in PVRCNN the keypoint
        segmentation loss and in the two-stage families the RCNN losses ->
        (total, metrics).  PartA2-free: _part_free_loss; PointRCNN:
        _point_loss."""
        if self.part_free:
            return self._part_free_loss(full_out, batch)
        if self.point_based:
            return self._point_loss(full_out, batch)
        if self.is_center_head:
            return self._center_loss(full_out, batch)
        with trace.span('targets'), torch.no_grad():
            per_sample = [self.assign_targets(gb, gm, gu) for gb, gm, gu in
                          zip(batch['gt_boxes'], batch['gt_mask'],
                              batch['gt_uncertainty'])]
            targets = target_assigner.TargetDict(
                *(torch.stack(t) for t in zip(*per_sample)))
        with trace.span('loss'):
            return self._anchor_loss(full_out, batch, targets)

    def _anchor_loss(self, full_out, batch, targets):
        """compute_loss of the anchor heads past the targets."""
        flat = anchor_heads._flatten_preds(full_out['dense_head'])
        lw = self.loss_weights
        metrics = {}
        c_loss = anchor_heads.cls_loss(
            flat['cls_preds'], targets.box_cls_labels,
            self.num_class) * lw['cls_weight']
        if self.use_kl_loss:
            r_loss, parts = anchor_heads.reg_loss_kl_label(
                flat['box_preds'], flat['box_std_preds'],
                targets.box_reg_targets, targets.box_cls_labels,
                targets.label_uncertainty, code_weights=self.code_weights)
            metrics.update({k: v * lw['loc_weight'] for k, v in parts.items()})
        elif self.use_kl_nolabel:
            r_loss = anchor_heads.reg_loss_kl(
                flat['box_preds'], flat['box_std_preds'],
                targets.box_reg_targets, targets.box_cls_labels,
                code_weights=self.code_weights)
        elif self.use_odiou:
            r_loss = anchor_heads.reg_loss_odiou(
                flat['box_preds'], targets.box_reg_targets,
                targets.box_cls_labels, self.net.flat_anchors,
                self.box_coder)
        else:
            r_loss = anchor_heads.reg_loss_smooth_l1(
                flat['box_preds'], targets.box_reg_targets,
                targets.box_cls_labels, code_weights=self.code_weights)
        r_loss = r_loss * lw['loc_weight']
        metrics['loss_cls'] = c_loss
        metrics['loss_loc'] = r_loss
        total = c_loss + r_loss
        if self.net.num_dir_bins > 0 and 'dir_cls_preds' in flat:
            b = flat['box_preds'].shape[0]
            anc = self.net.flat_anchors[None].expand(
                b, *self.net.flat_anchors.shape)
            dir_t = anchor_heads.get_direction_targets(
                anc, targets.box_reg_targets, self.net.dir_offset,
                self.net.num_dir_bins)
            d_loss = anchor_heads.dir_loss(
                flat['dir_cls_preds'], dir_t, targets.box_cls_labels > 0,
                self.net.num_dir_bins) * lw['dir_weight']
            metrics['loss_dir'] = d_loss
            total = total + d_loss
        if self.use_iou_branch and 'iou_preds' in flat:
            i_loss = anchor_heads.iou_branch_loss(
                flat['iou_preds'], flat['box_preds'],
                targets.box_reg_targets, targets.box_cls_labels,
                self.net.flat_anchors, self.box_coder)
            metrics['loss_iou'] = i_loss
            total = total + i_loss
        if 'part_head' in full_out:
            c_l, p_l = self._part_loss(full_out['part_head'], batch)
            metrics['point_loss_cls'] = c_l
            metrics['point_loss_part'] = p_l
            total = total + c_l + p_l
        if 'pfe' in full_out:
            seg = self._pfe_loss(full_out, batch)
            metrics['point_loss_cls'] = seg
            total = total + seg
        if 'depth_logits' in full_out and 'depth_maps' in batch:
            metrics['loss_depth'] = self._depth_loss(full_out, batch)
            total = total + metrics['loss_depth']
        if 'rcnn' in full_out:
            rcnn_total, rcnn_metrics = self._rcnn_loss(full_out)
            total = total + rcnn_total
            metrics.update(rcnn_metrics)
        metrics['loss'] = total
        return total, metrics

    def _depth_loss(self, full_out, batch):
        """CaDDN's depth loss (ddn_loss) with the config's LOSS.ARGS."""
        ffn_cfg = self.model_cfg.VFE.FFN
        args = dict(ffn_cfg.LOSS.get('ARGS', {}))
        return ddn_loss(
            full_out['depth_logits'], batch['depth_maps'],
            batch['gt_boxes2d'], batch['gt_boxes2d_mask'],
            dict(ffn_cfg.DISCRETIZE), weight=float(args.get('weight', 3.0)),
            alpha=float(args.get('alpha', 0.25)),
            gamma=float(args.get('gamma', 2.0)),
            fg_weight=float(args.get('fg_weight', 13)),
            bg_weight=float(args.get('bg_weight', 1)))

    def _center_loss(self, full_out, batch):
        """CenterPoint: the heatmap's focal loss times cls_weight (loss_cls)
        and the L1 box loss at the gt cells times loc_weight (loss_loc); as
        an RPN also the keypoint segmentation loss (PVRCNN) and the RCNN
        losses."""
        out = full_out['dense_head']
        ta = self.model_cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG
        h, w = out['hm'].shape[1:3]
        with trace.span('targets'), torch.no_grad():
            per_sample = [center_lib.assign_targets_single(
                gb, gm, self.num_class, (w, h),
                int(ta.FEATURE_MAP_STRIDE), self.voxel_size, self.pc_range,
                gaussian_overlap=float(ta.get('GAUSSIAN_OVERLAP', 0.1)),
                min_radius=int(ta.get('MIN_RADIUS', 2)))
                for gb, gm in zip(batch['gt_boxes'], batch['gt_mask'])]
            heatmaps, tboxes, inds, masks = (torch.stack(t)
                                             for t in zip(*per_sample))
        with trace.span('loss'):
            return self._center_loss_terms(
                full_out, batch, (heatmaps, tboxes, inds, masks))

    def _center_loss_terms(self, full_out, batch, targets):
        """_center_loss past the targets (heatmaps, boxes, cell indices,
        masks)."""
        out = full_out['dense_head']
        heatmaps, tboxes, inds, masks = targets
        lw = self.loss_weights
        c_loss = center_lib.centernet_focal_loss(
            out['hm'].permute(0, 3, 1, 2), heatmaps) * lw.get('cls_weight',
                                                              1.0)
        reg_maps = torch.cat([out['center'], out['center_z'], out['dim'],
                              out['rot']], dim=-1)
        r_loss = center_lib.center_reg_loss(
            reg_maps, tboxes, inds, masks.float()) * lw.get('loc_weight',
                                                            2.0)
        total = c_loss + r_loss
        metrics = {'loss_cls': c_loss, 'loss_loc': r_loss}
        if 'pfe' in full_out:
            seg = self._pfe_loss(full_out, batch)
            metrics['point_loss_cls'] = seg
            total = total + seg
        if 'rcnn' in full_out:
            rcnn_total, rcnn_metrics = self._rcnn_loss(full_out)
            total = total + rcnn_total
            metrics.update(rcnn_metrics)
        metrics['loss'] = total
        return total, metrics

    def _point_head_cfg(self):
        ph_cfg = self.model_cfg.POINT_HEAD
        extra = tuple(ph_cfg.TARGET_CONFIG.get('GT_EXTRA_WIDTH',
                                               [0.2, 0.2, 0.2]))
        return extra, ph_cfg.LOSS_CONFIG.LOSS_WEIGHTS

    def _part_loss(self, po, batch):
        """PartA2's part head: focal segmentation loss over the voxel
        centres (class-agnostic labels, ignored in the GT_EXTRA_WIDTH shell)
        and the part-location BCE over the foreground."""
        extra, lw = self._point_head_cfg()
        with torch.no_grad():
            seg, part, fg = point_heads.assign_part_targets(
                po['point_coords'], po['point_mask'], batch['gt_boxes'],
                batch['gt_mask'], extra)
        flat = {'point_cls_preds': po['point_cls_preds'].reshape(
                    -1, po['point_cls_preds'].shape[-1]),
                'point_part_preds': po['point_part_preds'].reshape(-1, 3)}
        return point_heads.intra_part_loss(
            flat, seg.reshape(-1), part.reshape(-1, 3), fg.reshape(-1), lw)

    def _part_free_loss(self, full_out, batch):
        """PartA2-free: multi-class focal cls and smooth-L1 box loss of the
        anchor-free branch (loss_cls, loss_loc), the part-location BCE over
        the foreground (point_loss_part) and the RCNN losses."""
        po = full_out['part_head']
        extra, lw = self._point_head_cfg()
        coords, pmask = po['point_coords'], po['point_mask']
        with torch.no_grad():
            cls_l, box_t, fg = point_heads.assign_point_targets(
                coords, pmask, batch['gt_boxes'], batch['gt_mask'],
                self.point_coder, extra)
            _, part_t, fg_p = point_heads.assign_part_targets(
                coords, pmask, batch['gt_boxes'], batch['gt_mask'], extra)
        nc = po['point_cls_preds'].shape[-1]
        flat = {'point_cls_preds': po['point_cls_preds'].reshape(-1, nc),
                'point_box_preds': po['point_box_preds'].reshape(
                    -1, po['point_box_preds'].shape[-1])}
        c_l, b_l = point_heads.point_head_loss(
            flat, cls_l.reshape(-1), box_t.reshape(-1, box_t.shape[-1]),
            fg.reshape(-1), nc, lw)
        p_l = point_heads.part_bce_loss(
            po['point_part_preds'].reshape(-1, 3), part_t.reshape(-1, 3),
            fg_p.reshape(-1)) * lw.get('point_part_weight', 1.0)
        total = c_l + b_l + p_l
        metrics = {'loss_cls': c_l, 'loss_loc': b_l, 'point_loss_part': p_l}
        if 'rcnn' in full_out:
            rcnn_total, rcnn_metrics = self._rcnn_loss(full_out)
            total = total + rcnn_total
            metrics.update(rcnn_metrics)
        metrics['loss'] = total
        return total, metrics

    def _point_loss(self, full_out, batch):
        """PointRCNN: PointHeadBox's multi-class focal cls and smooth-L1
        box losses over the points (loss_cls, loss_loc), plus the RCNN
        losses with PointRCNNHead."""
        po = full_out['point_head']
        extra, lw = self._point_head_cfg()
        with torch.no_grad():
            cls_l, box_t, fg = point_heads.assign_point_targets(
                po['point_xyz'], po['point_mask'], batch['gt_boxes'],
                batch['gt_mask'], self.point_coder, extra)
        flat = {k: po[k].reshape(-1, po[k].shape[-1])
                for k in ('point_cls_preds', 'point_box_preds')}
        c_l, b_l = point_heads.point_head_loss(
            flat, cls_l.reshape(-1), box_t.reshape(-1, box_t.shape[-1]),
            fg.reshape(-1), self.num_class, lw)
        total = c_l + b_l
        metrics = {'loss_cls': c_l, 'loss_loc': b_l}
        if 'rcnn' in full_out:
            rcnn_total, rcnn_metrics = self._rcnn_loss(full_out)
            total = total + rcnn_total
            metrics.update(rcnn_metrics)
        metrics['loss'] = total
        return total, metrics

    def _pfe_loss(self, full_out, batch):
        """PointHeadSimple's focal loss on the keypoints' foreground labels
        (inside a gt box, ignored in its GT_EXTRA_WIDTH shell), normalised
        over the batch, times point_cls_weight."""
        ph_cfg = self.model_cfg.POINT_HEAD
        extra = tuple(ph_cfg.TARGET_CONFIG.get('GT_EXTRA_WIDTH',
                                               [0.2, 0.2, 0.2]))
        with torch.no_grad():
            labels = pfe_lib.assign_keypoint_seg_targets(
                full_out['pfe']['keypoints'], batch['gt_boxes'],
                batch['gt_mask'], extra)
        preds = full_out['pfe']['point_cls_preds']
        seg = pfe_lib.keypoint_seg_loss(preds.reshape(-1, preds.shape[-1]),
                                        labels.reshape(-1), preds.shape[-1])
        return seg * ph_cfg.LOSS_CONFIG.LOSS_WEIGHTS.get('point_cls_weight',
                                                         1.0)

    def _rcnn_loss(self, full_out):
        """BCE cls on the IoU labels, KL-label (or, for the plain head,
        smooth-L1) reg loss and corner loss; SECONDHead's BCE alone."""
        rcnn = full_out['rcnn']
        rt = full_out['roi_targets']
        roi_lw = self.model_cfg.ROI_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
        c_loss = roi_lib.rcnn_cls_loss(rcnn['rcnn_cls'], rt['rcnn_cls_labels'])
        c_loss = c_loss * roi_lw.get('rcnn_cls_weight',
                                     roi_lw.get('rcnn_iou_weight', 1.0))
        if 'no_reg_loss' in rcnn:           # SECONDHead: IoU scoring only
            return c_loss, {'rcnn_loss_cls': c_loss}
        r_loss, parts = roi_lib.rcnn_reg_loss(
            rcnn['rcnn_reg'], rcnn.get('rcnn_reg_std'), rt['rois'],
            rt['gt_of_rois_ct'], rt['gt_of_rois_src'], rt['gt_unc_of_rois'],
            rt['reg_valid_mask'], self.box_coder, roi_lw,
            corner_weight=roi_lw.get('rcnn_corner_weight', 1.0),
            code_weights=list(roi_lw.get('code_weights', [1.0] * 7)))
        return c_loss + r_loss, {'rcnn_loss_cls': c_loss,
                                 'rcnn_loss_reg': r_loss, **parts}

    def finalize(self, full_out):
        """DetectorNet outputs -> predict's fixed-slot final boxes."""
        if 'rcnn' not in full_out and self.point_based:
            # PointRCNN's stage 1 alone: every valid point's box
            boxes, scores, labels = self.net.decode_point_boxes(
                full_out['point_head'])
            return self._final_nms(boxes, scores, labels,
                                   torch.zeros_like(boxes))
        if 'rcnn' not in full_out:
            return self._finalize_dense(full_out['dense_head'])
        rcnn = full_out['rcnn']
        rois = rcnn['rois']
        b, r = rois.shape[:2]
        boxes_all = decode_rcnn_boxes(rois, rcnn['rcnn_reg'], self.box_coder)
        best_scores = torch.sigmoid(rcnn['rcnn_cls']).reshape(b, r)
        best_scores = torch.where(full_out['proposals']['roi_valid'],
                                  best_scores, 0.0)
        # the plain head predicts no variance: voting then weighs by 1
        std_all = rcnn.get('rcnn_reg_std',
                           torch.zeros_like(rcnn['rcnn_reg']))
        return self._final_nms(boxes_all[..., :7], best_scores,
                               full_out['proposals']['roi_labels'],
                               std_all.reshape(b, r, -1))

    def _finalize_dense(self, head_out):
        """Single stage: the decoded anchors' sigmoid scores (for IoU heads
        zeroed below PRE_CLS_THRESH and times clip((iou + 1) / 2, 0) ** POW,
        the rectified IoU zeroed below PRE_IOU_THRESH), best class, and
        the head's log variances (zeros without a variance branch) into
        the final NMS; CenterPoint's top-k decode (POST_PROCESSING's
        MAX_OBJ_PER_SAMPLE, SCORE_THRESH) with zero variances."""
        if self.is_center_head:
            with trace.span('decode'):
                boxes, scores, labels = self.net.decode_center(
                    head_out, self.model_cfg.POST_PROCESSING)
            return self._final_nms(boxes, scores, labels,
                                   torch.zeros_like(boxes))
        with trace.span('decode'):
            boxes, best_scores, best_labels, std, scores = \
                self._decode_anchors(head_out)
        return self._final_nms(boxes, best_scores, best_labels, std,
                               cls_scores_all=scores)

    def _decode_anchors(self, head_out):
        """The anchor heads' decoded boxes (B, N, 7), best scores and
        labels, log variances and per-class scores."""
        decoded = anchor_heads.decode_predictions(
            head_out, self.net.flat_anchors, self.box_coder,
            dir_offset=self.net.dir_offset,
            dir_limit_offset=self.net.dir_limit_offset,
            num_dir_bins=self.net.num_dir_bins)
        scores = torch.sigmoid(decoded['batch_cls_preds'])
        if self.use_iou_branch and 'batch_iou_preds' in decoded:
            head_cfg = self.model_cfg.DENSE_HEAD
            iou = (decoded['batch_iou_preds'] + 1.0) * 0.5
            scores = torch.where(
                scores < head_cfg.get('PRE_CLS_THRESH', 0.0), 0.0, scores)
            iou = torch.where(iou < head_cfg.get('PRE_IOU_THRESH', 0.0), 0.0,
                              iou)
            scores = scores * torch.pow(iou.clamp_min(0.0),
                                        head_cfg.get('POW', 1.0))
        best_scores, best_labels = scores.max(dim=-1)
        boxes = decoded['batch_box_preds']
        std = decoded.get('batch_box_std_preds', torch.zeros_like(boxes))
        return boxes[..., :7], best_scores, best_labels + 1, std, scores

    def _final_nms(self, boxes_all, best_scores, best_labels, std_all,
                   cls_scores_all=None):
        """Final NMS per sample.  With MULTI_CLASSES_NMS and the dense
        head's per-class scores (B, N, num_class > 1): one greedy BEV NMS
        per class, merged into the top NMS_POST_MAXSIZE slots by score.
        Otherwise over each box's best class: variance voting (new_nms_gpu /
        variance_voting, std_all (B, R, 7) the predicted log variances) or
        greedy BEV NMS (nms_gpu) on the scores at or above SCORE_THRESH."""
        post = self.model_cfg.POST_PROCESSING
        nms_cfg = post.NMS_CONFIG
        _require(nms_cfg.NMS_TYPE in ('new_nms_gpu', 'variance_voting',
                                      'nms_gpu'),
                 f'final NMS_TYPE {nms_cfg.NMS_TYPE}')
        use_voting = nms_cfg.NMS_TYPE != 'nms_gpu'
        pre_max = int(nms_cfg.NMS_PRE_MAXSIZE)
        post_max = int(nms_cfg.NMS_POST_MAXSIZE)
        thresh = float(nms_cfg.NMS_THRESH)
        score_thresh = float(post.get('SCORE_THRESH', 0.0))
        post_score_thresh = float(post.get('POST_SCORE_THRESH', 0.0))
        multi = (nms_cfg.get('MULTI_CLASSES_NMS', False)
                 and cls_scores_all is not None
                 and cls_scores_all.shape[-1] > 1)
        with trace.span('nms'):
            res = []
            for i in range(boxes_all.shape[0]):
                boxes_s = boxes_all[i]
                if multi:
                    idx, valid, labels, scores = nms_ops.multi_classes_nms(
                        boxes_s, cls_scores_all[i], thresh, self.num_class,
                        pre_max=pre_max, post_max=post_max,
                        score_threshold=score_thresh)
                    idx, valid = idx[:post_max], valid[:post_max]
                    final_boxes = boxes_s[idx]
                    final_scores = torch.where(valid, scores[:post_max], 0.0)
                    final_labels = torch.where(valid, labels[:post_max], 0)
                elif use_voting:
                    boxes_wrapped = torch.cat([
                        boxes_s[:, :6],
                        common.limit_period(boxes_s[:, 6:7], 0.5,
                                            2 * math.pi)], dim=1)
                    idx, valid, final_boxes, final_scores = \
                        nms_ops.variance_voting_nms(
                            boxes_wrapped, best_scores[i],
                            torch.exp(std_all[i, :, :7]), thresh,
                            pre_max=pre_max, post_max=post_max,
                            score_threshold=score_thresh)
                else:
                    masked = torch.where(best_scores[i] >= score_thresh,
                                         best_scores[i], 0.0)
                    idx, valid = nms_ops.nms_bev(
                        boxes_s, masked, thresh, pre_max=pre_max,
                        post_max=post_max, score_threshold=score_thresh)
                    final_boxes = boxes_s[idx]
                    final_scores = torch.where(valid, best_scores[i][idx], 0.0)
                if not multi:
                    final_labels = torch.where(valid, best_labels[i][idx], 0)
                if post_score_thresh > 0:
                    keep = final_scores > post_score_thresh
                    valid = valid & keep
                    final_scores = torch.where(keep, final_scores, 0.0)
                res.append((final_boxes, final_scores, final_labels, valid))
            fb, fs, fl, fv = (torch.stack(t) for t in zip(*res))
            return {'final_boxes': fb, 'final_scores': fs, 'final_labels': fl,
                    'final_valid': fv}


CAMERA_KEYS = ('images', 'trans_lidar_to_cam', 'trans_cam_to_img',
               'image_shape')


def camera_of(batch):
    """A batch's camera items (CaDDN's input), or None without images."""
    if 'images' not in batch:
        return None
    return {k: batch[k] for k in CAMERA_KEYS}


def build_detector(cfg, device=None):
    """cfg: full config with CLASS_NAMES / DATA_CONFIG / MODEL.  The model
    goes to `device`; by default the GPU, and without one this raises."""
    return Detector(cfg.MODEL, cfg.DATA_CONFIG,
                    num_class=len(cfg.CLASS_NAMES),
                    device=common.resolve_device(device))
