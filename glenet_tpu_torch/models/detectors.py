"""Detector composition for the GLENet-VR predict path (torch counterpart of
glenet_tpu/models/detectors.py).

  - `DetectorNet` (nn.Module) holds the neural slots and runs the forward
    from raw padded points: voxelize -> MeanVFE -> VoxelBackBone8x ->
    HeightCompression -> BaseBEVBackbone -> AnchorHeadSingle -> proposal NMS
    -> VoxelRCNNHead.  Only this VoxelRCNN / anchor-head topology is
    wired; every other family raises NotImplementedError.
  - `Detector` owns the static state (anchors, box coder, configs) and
    exposes `predict`: decode + variance-voting NMS into fixed slots.

`build_detector(cfg, device=None)` puts the model on the GPU unless the
caller passes device='cpu'; without a GPU it raises.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config import Cfg
from ..ops import nms as nms_ops
from ..ops import voxelize as vox_ops
from ..utils import box_coder as box_coder_lib
from ..utils import common
from . import anchor_heads, anchors
from .bev_backbone import BaseBEVBackbone
from .roi_heads import VoxelRCNNHead, decode_rcnn_boxes
from .spconv_backbone import build_backbone_3d
from .vfe import MeanVFE


def _require(cond, what):
    if not cond:
        raise NotImplementedError(f'{what} is not ported yet')


class DetectorNet(nn.Module):
    """Neural slots of the VoxelRCNN / anchor-head detector."""

    def __init__(self, model_cfg, grid_size, voxel_size, pc_range,
                 max_voxels: int, max_points_per_voxel: int, num_class: int,
                 anchor_set, box_coder, num_point_features: int = 4):
        super().__init__()
        mcfg = Cfg(model_cfg)
        _require(mcfg.get('NAME') == 'VoxelRCNN', f"MODEL {mcfg.get('NAME')}")
        _require(mcfg.VFE.NAME == 'MeanVFE', f'VFE {mcfg.VFE.NAME}')
        _require(mcfg.MAP_TO_BEV.NAME == 'HeightCompression',
                 f'MAP_TO_BEV {mcfg.MAP_TO_BEV.NAME}')
        _require(mcfg.BACKBONE_2D.NAME == 'BaseBEVBackbone',
                 f'BACKBONE_2D {mcfg.BACKBONE_2D.NAME}')
        head_cfg = mcfg.DENSE_HEAD
        _require(head_cfg.NAME == 'AnchorHeadSingle',
                 f'DENSE_HEAD {head_cfg.NAME}')
        roi_cfg = mcfg.ROI_HEAD
        _require(roi_cfg.NAME == 'VoxelRCNNKLLabelIoUHead',
                 f'ROI_HEAD {roi_cfg.NAME}')
        for absent in ('PFE', 'POINT_HEAD'):
            _require(absent not in mcfg, absent)

        self.model_cfg = mcfg
        self.grid_size, self.voxel_size = tuple(grid_size), tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.max_voxels = max_voxels
        self.max_points_per_voxel = max_points_per_voxel
        self.anchor_set = anchor_set
        self.box_coder = box_coder

        self.vfe = MeanVFE()
        self.backbone_3d = build_backbone_3d(mcfg.BACKBONE_3D, grid_size,
                                             max_voxels, num_point_features)
        bb = mcfg.BACKBONE_2D
        self.backbone_2d = BaseBEVBackbone(
            in_channels=self.backbone_3d.num_bev_features,
            layer_nums=tuple(bb.LAYER_NUMS),
            layer_strides=tuple(bb.LAYER_STRIDES),
            num_filters=tuple(bb.NUM_FILTERS),
            upsample_strides=tuple(bb.get('UPSAMPLE_STRIDES', ())),
            num_upsample_filters=tuple(bb.get('NUM_UPSAMPLE_FILTERS', ())))
        self.num_dir_bins = (head_cfg.get('NUM_DIR_BINS', 2)
                             if head_cfg.get('USE_DIRECTION_CLASSIFIER', False)
                             else 0)
        self.dir_offset = head_cfg.get('DIR_OFFSET', 0.78539)
        self.dir_limit_offset = head_cfg.get('DIR_LIMIT_OFFSET', 0.0)
        self.dense_head = anchor_heads.AnchorHeadSingle(
            self.backbone_2d.num_bev_features, num_class,
            anchor_set.num_anchors_per_location, box_coder.code_size,
            self.num_dir_bins)
        self.roi_head = VoxelRCNNHead(
            roi_cfg, voxel_size, pc_range,
            level_channels=self.backbone_3d.level_channels,
            code_size=box_coder.code_size)
        self.register_buffer('flat_anchors',
                             torch.from_numpy(anchor_set.flat_anchors),
                             persistent=False)

    def voxelize(self, points, points_mask):
        outs = [vox_ops.voxelize(points[i], points_mask[i], self.voxel_size,
                                 self.pc_range, self.grid_size,
                                 self.max_voxels, self.max_points_per_voxel)
                for i in range(points.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def forward(self, points, points_mask, train: bool = False):
        """points (B, P, C), points_mask (B, P) -> dict with dense_head,
        proposals and rcnn outputs (eval only)."""
        if train:
            raise NotImplementedError('the train step is not ported yet')
        vox = self.voxelize(points, points_mask)
        feats = self.vfe(vox['voxels'], vox['voxel_num_points'])
        sp_out = self.backbone_3d(feats, vox['voxel_coords'],
                                  vox['voxel_mask'], train)
        spatial_2d = self.backbone_2d(sp_out['bev_features'], train)
        out = {'vox': vox, 'backbone_3d': sp_out,
               'dense_head': self.dense_head(spatial_2d, train)}

        decoded = anchor_heads.decode_predictions(
            out['dense_head'], self.flat_anchors, self.box_coder,
            dir_offset=self.dir_offset,
            dir_limit_offset=self.dir_limit_offset,
            num_dir_bins=self.num_dir_bins)
        cls_scores = torch.sigmoid(decoded['batch_cls_preds'])
        best_scores = cls_scores.amax(dim=-1)
        best_labels = cls_scores.argmax(dim=-1) + 1
        nms_cfg = self.model_cfg.ROI_HEAD.NMS_CONFIG.TEST
        rois, roi_scores, roi_labels, roi_valid = self._nms_proposals(
            decoded['batch_box_preds'], best_scores, best_labels, nms_cfg)
        out['proposals'] = {'rois': rois, 'roi_scores': roi_scores,
                            'roi_labels': roi_labels, 'roi_valid': roi_valid}
        out['rcnn'] = self.roi_head(rois, sp_out['multi_scale'], train)
        out['rcnn']['rois'] = rois
        return out

    def _nms_proposals(self, boxes, scores, labels, nms_cfg):
        """Per-sample fixed-slot BEV NMS over decoded stage-1 boxes ->
        (rois, roi_scores, roi_labels, roi_valid)."""
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
        return tuple(torch.stack(t) for t in zip(*res))


class Detector:
    """Static-state wrapper: build from a reference-style config, predict."""

    def __init__(self, model_cfg, data_cfg, num_class, device):
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.num_class = num_class
        self.device = torch.device(device)
        self.pc_range = tuple(data_cfg.POINT_CLOUD_RANGE)
        proc_cfgs = {p.NAME: p for p in data_cfg.DATA_PROCESSOR}
        vox_cfg = proc_cfgs['transform_points_to_voxels']
        self.voxel_size = tuple(vox_cfg.VOXEL_SIZE)
        self.grid_size = vox_ops.compute_grid_size(self.pc_range,
                                                   self.voxel_size)
        self.max_points_per_voxel = int(vox_cfg.get('MAX_POINTS_PER_VOXEL', 1))
        mv = vox_cfg.get('MAX_NUMBER_OF_VOXELS', 1)
        # predict runs with the test voxel budget
        self.max_voxels_test = int(mv['test'] if isinstance(mv, dict) else mv)

        head_cfg = model_cfg.DENSE_HEAD
        ta_cfg = head_cfg.get('TARGET_ASSIGNER_CONFIG', {}) or {}
        self.box_coder = box_coder_lib.build_box_coder(
            ta_cfg.get('BOX_CODER', 'ResidualCoder'),
            **ta_cfg.get('BOX_CODER_CONFIG', {}))
        self.anchor_set = anchors.generate_anchors(
            head_cfg.ANCHOR_GENERATOR_CONFIG, self.grid_size, self.pc_range)
        self.net = DetectorNet(
            model_cfg, self.grid_size, self.voxel_size, self.pc_range,
            self.max_voxels_test, self.max_points_per_voxel, num_class,
            self.anchor_set, self.box_coder).to(self.device).eval()

    @torch.no_grad()
    def predict(self, batch):
        """batch: points (B, P, C), points_mask (B, P) on the detector's
        device.  Returns fixed-shape final_boxes (B, K, 7), final_scores
        (B, K), final_labels (B, K), final_valid (B, K)."""
        return self.finalize(self.net(batch['points'], batch['points_mask']))

    def finalize(self, full_out):
        """DetectorNet outputs -> predict's fixed-slot final boxes."""
        rcnn = full_out['rcnn']
        rois = rcnn['rois']
        b, r = rois.shape[:2]
        boxes_all = decode_rcnn_boxes(rois, rcnn['rcnn_reg'], self.box_coder)
        best_scores = torch.sigmoid(rcnn['rcnn_cls']).reshape(b, r)
        best_scores = torch.where(full_out['proposals']['roi_valid'],
                                  best_scores, 0.0)
        return self._final_nms(boxes_all[..., :7], best_scores,
                               full_out['proposals']['roi_labels'],
                               rcnn['rcnn_reg_std'].reshape(b, r, -1))

    def _final_nms(self, boxes_all, best_scores, best_labels, std_all):
        """Single-class variance-voting final NMS per sample."""
        post = self.model_cfg.POST_PROCESSING
        nms_cfg = post.NMS_CONFIG
        _require(not nms_cfg.get('MULTI_CLASSES_NMS', False),
                 'multi-class final NMS')
        _require(nms_cfg.NMS_TYPE in ('new_nms_gpu', 'variance_voting'),
                 f'final NMS_TYPE {nms_cfg.NMS_TYPE}')
        pre_max = int(nms_cfg.NMS_PRE_MAXSIZE)
        post_max = int(nms_cfg.NMS_POST_MAXSIZE)
        thresh = float(nms_cfg.NMS_THRESH)
        score_thresh = float(post.get('SCORE_THRESH', 0.0))
        post_score_thresh = float(post.get('POST_SCORE_THRESH', 0.0))
        res = []
        for i in range(boxes_all.shape[0]):
            boxes_s = boxes_all[i]
            boxes_wrapped = torch.cat([
                boxes_s[:, :6],
                common.limit_period(boxes_s[:, 6:7], 0.5, 2 * math.pi)], dim=1)
            vote = nms_ops.variance_voting_nms(
                boxes_wrapped, best_scores[i], torch.exp(std_all[i, :, :7]),
                thresh, pre_max=pre_max, post_max=post_max,
                score_threshold=score_thresh)
            idx, valid, final_boxes, final_scores = vote
            final_labels = torch.where(valid, best_labels[i][idx], 0)
            if post_score_thresh > 0:
                keep = final_scores > post_score_thresh
                valid = valid & keep
                final_scores = torch.where(keep, final_scores, 0.0)
            res.append((final_boxes, final_scores, final_labels, valid))
        fb, fs, fl, fv = (torch.stack(t) for t in zip(*res))
        return {'final_boxes': fb, 'final_scores': fs, 'final_labels': fl,
                'final_valid': fv}


def build_detector(cfg, device=None):
    """cfg: full config with CLASS_NAMES / DATA_CONFIG / MODEL.  The model
    goes to `device`; by default the GPU, and without one this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" to run the '
                               'port on the CPU')
        device = 'cuda'
    return Detector(cfg.MODEL, cfg.DATA_CONFIG,
                    num_class=len(cfg.CLASS_NAMES), device=device)
