"""Detector composition (torch counterpart of glenet_tpu/models/detectors.py)
for two topologies:

  - VoxelRCNN (GLENet-VR, plain Voxel R-CNN): voxelize -> MeanVFE ->
    VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone -> anchor head
    -> proposal NMS -> (train: RoI target sampling) -> VoxelRCNNHead ->
    final NMS over the refined RoIs;
  - SECONDNet, single stage (GLENet-S, GLENet-C, plain SECOND, SE-SSD's
    head): voxelize -> MeanVFE -> VoxelBackBone8x(Ciassd) ->
    HeightCompression -> BaseBEVBackbone or SSFA -> AnchorHeadSingle,
    AnchorHeadSessd (its od-IoU regression loss) or the KL-label family ->
    final NMS over the dense head's decoded anchors.

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
from ..ops import voxelize as vox_ops
from ..utils import box_coder as box_coder_lib
from ..utils import common
from . import anchor_heads, anchors, target_assigner
from . import roi_heads as roi_lib
from .bev_backbone import SSFA, BaseBEVBackbone
from .roi_heads import VoxelRCNNHead, decode_rcnn_boxes
from .spconv_backbone import build_backbone_3d
from .vfe import MeanVFE


def _require(cond, what):
    if not cond:
        raise NotImplementedError(f'{what} is not ported yet')


class DetectorNet(nn.Module):
    """Neural slots of the VoxelRCNN or single-stage SECONDNet detector."""

    def __init__(self, model_cfg, grid_size, voxel_size, pc_range,
                 max_voxels_train: int, max_voxels_test: int,
                 max_points_per_voxel: int, num_class: int, anchor_set,
                 box_coder, num_point_features: int = 4):
        super().__init__()
        mcfg = Cfg(model_cfg)
        name = mcfg.get('NAME')
        _require(name in ('VoxelRCNN', 'SECONDNet'), f'MODEL {name}')
        roi_cfg = mcfg.get('ROI_HEAD')
        roi_name = None if roi_cfg is None else roi_cfg.NAME
        _require((name == 'VoxelRCNN') == (roi_cfg is not None),
                 f'MODEL {name} with ROI_HEAD {roi_name}')
        _require(mcfg.VFE.NAME == 'MeanVFE', f'VFE {mcfg.VFE.NAME}')
        _require(mcfg.MAP_TO_BEV.NAME == 'HeightCompression',
                 f'MAP_TO_BEV {mcfg.MAP_TO_BEV.NAME}')
        _require(mcfg.BACKBONE_2D.NAME in ('BaseBEVBackbone', 'SSFA'),
                 f'BACKBONE_2D {mcfg.BACKBONE_2D.NAME}')
        head_cfg = mcfg.DENSE_HEAD
        ta_cfg = head_cfg.get('TARGET_ASSIGNER_CONFIG', {}) or {}
        assigner = ta_cfg.get('NAME', 'AxisAlignedTargetAssigner')
        _require(assigner in ('AxisAlignedTargetAssigner',
                              'WeightedAxisAlignedTargetAssigner',
                              'ATSSTargetAssigner'), assigner)
        if roi_cfg is not None:
            _require(roi_name in ('VoxelRCNNKLLabelIoUHead',
                                  'VoxelRCNNHead'), f'ROI_HEAD {roi_name}')
            score_type = (roi_cfg.get('TARGET_CONFIG', {}) or {}).get(
                'CLS_SCORE_TYPE', 'roi_iou')
            _require(score_type == 'roi_iou', f'CLS_SCORE_TYPE {score_type}')
        for absent in ('PFE', 'POINT_HEAD'):
            _require(absent not in mcfg, absent)

        self.model_cfg = mcfg
        self.grid_size, self.voxel_size = tuple(grid_size), tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.max_voxels_train = max_voxels_train
        self.max_voxels_test = max_voxels_test
        self.max_points_per_voxel = max_points_per_voxel
        self.anchor_set = anchor_set
        self.box_coder = box_coder

        self.vfe = MeanVFE()
        self.backbone_3d = build_backbone_3d(mcfg.BACKBONE_3D, grid_size,
                                             num_point_features)
        bb = mcfg.BACKBONE_2D
        if bb.NAME == 'SSFA':
            self.backbone_2d = SSFA(self.backbone_3d.num_bev_features)
        else:
            self.backbone_2d = BaseBEVBackbone(
                in_channels=self.backbone_3d.num_bev_features,
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
        self.dense_head = anchor_heads.build_dense_head(
            head_cfg.NAME, self.backbone_2d.num_bev_features, num_class,
            anchor_set.num_anchors_per_location, box_coder.code_size,
            self.num_dir_bins)
        self.roi_head = None if roi_cfg is None else VoxelRCNNHead(
            roi_cfg, voxel_size, pc_range,
            level_channels=self.backbone_3d.level_channels,
            code_size=box_coder.code_size,
            kl_label='KLLabel' in roi_name)
        self.register_buffer('flat_anchors',
                             torch.from_numpy(anchor_set.flat_anchors),
                             persistent=False)

    def voxelize(self, points, points_mask, max_voxels):
        outs = [vox_ops.voxelize(points[i], points_mask[i], self.voxel_size,
                                 self.pc_range, self.grid_size,
                                 max_voxels, self.max_points_per_voxel)
                for i in range(points.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def forward(self, points, points_mask, train: bool = False,
                gt_boxes=None, gt_mask=None, gt_uncertainty=None,
                generator=None, roi_targets=None):
        """points (B, P, C), points_mask (B, P) -> dict with vox,
        backbone_3d and dense_head outputs; in VoxelRCNN also proposals and
        rcnn outputs, plus roi_targets in train mode.

        Train mode needs gt_boxes (B, M, 8), gt_mask (B, M) and optionally
        gt_uncertainty (B, M, 7); `generator` feeds the RoI sampling and
        dropout draws.  Given `roi_targets` (a dict as out['roi_targets']),
        train mode skips proposals and sampling and refines those rois.
        """
        max_voxels = self.max_voxels_train if train else self.max_voxels_test
        vox = self.voxelize(points, points_mask, max_voxels)
        feats = self.vfe(vox['voxels'], vox['voxel_num_points'])
        sp_out = self.backbone_3d(feats, vox['voxel_coords'],
                                  vox['voxel_mask'], train)
        spatial_2d = self.backbone_2d(sp_out['bev_features'], train)
        out = {'vox': vox, 'backbone_3d': sp_out,
               'dense_head': self.dense_head(spatial_2d, train)}
        if self.roi_head is None:
            return out

        if roi_targets is None or not train:
            # proposals carry no gradient, as in the reference's no_grad
            # proposal layer
            with torch.no_grad():
                out['proposals'] = self._proposals(out['dense_head'], train)
        if train:
            if roi_targets is None:
                prop = out['proposals']
                roi_targets = self._sample_roi_targets(
                    prop['rois'], prop['roi_scores'], prop['roi_labels'],
                    gt_boxes, gt_mask, gt_uncertainty, generator)
            out['roi_targets'] = roi_targets
            roi_in = roi_targets['rois']
        else:
            roi_in = out['proposals']['rois']
        out['rcnn'] = self.roi_head(roi_in, sp_out['multi_scale'], train,
                                    generator)
        out['rcnn']['rois'] = roi_in
        return out

    def _proposals(self, dense_head_out, train):
        decoded = anchor_heads.decode_predictions(
            dense_head_out, self.flat_anchors, self.box_coder,
            dir_offset=self.dir_offset,
            dir_limit_offset=self.dir_limit_offset,
            num_dir_bins=self.num_dir_bins)
        cls_scores = torch.sigmoid(decoded['batch_cls_preds'])
        best_scores = cls_scores.amax(dim=-1)
        best_labels = cls_scores.argmax(dim=-1) + 1
        nms_cfg = self.model_cfg.ROI_HEAD.NMS_CONFIG[
            'TRAIN' if train else 'TEST']
        rois, roi_scores, roi_labels, roi_valid = self._nms_proposals(
            decoded['batch_box_preds'], best_scores, best_labels, nms_cfg)
        return {'rois': rois, 'roi_scores': roi_scores,
                'roi_labels': roi_labels, 'roi_valid': roi_valid}

    @torch.no_grad()
    def _sample_roi_targets(self, rois, roi_scores, roi_labels, gt_boxes,
                            gt_mask, gt_uncertainty, generator):
        """Train-time fg/bg roi subsampling and canonical-frame gt targets,
        per sample, draws from `generator`; carries no gradient."""
        tcfg = self.model_cfg.ROI_HEAD.TARGET_CONFIG
        if gt_uncertainty is None:
            gt_uncertainty = gt_boxes.new_ones((*gt_boxes.shape[:2], 7))
        r = int(tcfg.ROI_PER_IMAGE)
        per_sample = []
        for i in range(rois.shape[0]):
            draws = roi_lib.draw_roi_sampling(rois.shape[1], r, generator,
                                              rois.device)
            t = roi_lib.sample_rois_single(
                rois[i], roi_scores[i], roi_labels[i], gt_boxes[i],
                gt_mask[i], gt_uncertainty[i], tcfg, *draws)
            t['gt_of_rois_ct'] = roi_lib.canonical_gt_of_rois(
                t['rois'], t['gt_of_rois_src'])
            per_sample.append(t)
        return {k: torch.stack([t[k] for t in per_sample])
                for k in per_sample[0]}

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
    """Static-state wrapper: build from a reference-style config; predict
    and the training loss."""

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
        # training runs with the train voxel budget, predict with the test
        # budget (KITTI: 16000 / 40000); the parameters are shared
        self.max_voxels_train = int(mv['train'] if isinstance(mv, dict)
                                    else mv)
        self.max_voxels_test = int(mv['test'] if isinstance(mv, dict) else mv)

        head_cfg = model_cfg.DENSE_HEAD
        ta_cfg = head_cfg.get('TARGET_ASSIGNER_CONFIG', {}) or {}
        self.box_coder = box_coder_lib.build_box_coder(
            ta_cfg.get('BOX_CODER', 'ResidualCoder'),
            **ta_cfg.get('BOX_CODER_CONFIG', {}))
        self.anchor_set = anchors.generate_anchors(
            head_cfg.ANCHOR_GENERATOR_CONFIG, self.grid_size, self.pc_range)
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
            self.box_coder, self.num_point_features).to(self.device).eval()

    @torch.no_grad()
    def predict(self, batch):
        """batch: points (B, P, C), points_mask (B, P) on the detector's
        device.  Returns fixed-shape final_boxes (B, K, 7), final_scores
        (B, K), final_labels (B, K), final_valid (B, K)."""
        return self.finalize(self.net(batch['points'], batch['points_mask']))

    def loss_fn(self, batch, generator=None):
        """Train forward and loss.  batch: points, points_mask, gt_boxes
        (B, M, 8), gt_mask (B, M), gt_uncertainty (B, M, 7), and optionally
        roi_targets (fixed RoI targets instead of sampling).  Returns
        (total loss, metrics); the BN running stats update in place."""
        out = self.net(batch['points'], batch['points_mask'], train=True,
                       gt_boxes=batch['gt_boxes'], gt_mask=batch['gt_mask'],
                       gt_uncertainty=batch.get('gt_uncertainty'),
                       generator=generator,
                       roi_targets=batch.get('roi_targets'))
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
        branch) and, in VoxelRCNN, the RCNN losses -> (total, metrics)."""
        with torch.no_grad():
            per_sample = [self.assign_targets(gb, gm, gu) for gb, gm, gu in
                          zip(batch['gt_boxes'], batch['gt_mask'],
                              batch['gt_uncertainty'])]
        targets = target_assigner.TargetDict(
            *(torch.stack(t) for t in zip(*per_sample)))
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
        if 'rcnn' in full_out:
            rcnn_total, rcnn_metrics = self._rcnn_loss(full_out)
            total = total + rcnn_total
            metrics.update(rcnn_metrics)
        metrics['loss'] = total
        return total, metrics

    def _rcnn_loss(self, full_out):
        """BCE cls on the IoU labels, KL-label (or, for the plain head,
        smooth-L1) reg loss and corner loss."""
        rcnn = full_out['rcnn']
        rt = full_out['roi_targets']
        roi_lw = self.model_cfg.ROI_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
        c_loss = roi_lib.rcnn_cls_loss(rcnn['rcnn_cls'], rt['rcnn_cls_labels'])
        c_loss = c_loss * roi_lw.get('rcnn_cls_weight',
                                     roi_lw.get('rcnn_iou_weight', 1.0))
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
        the final NMS."""
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
        return self._final_nms(boxes[..., :7], best_scores, best_labels + 1,
                               std)

    def _final_nms(self, boxes_all, best_scores, best_labels, std_all):
        """Final NMS per sample over each box's best class (the
        class-agnostic path; MULTI_CLASSES_NMS is not ported): variance
        voting (new_nms_gpu / variance_voting, std_all (B, R, 7) the
        predicted log variances) or greedy BEV NMS (nms_gpu) on the scores
        at or above SCORE_THRESH."""
        post = self.model_cfg.POST_PROCESSING
        nms_cfg = post.NMS_CONFIG
        _require(not nms_cfg.get('MULTI_CLASSES_NMS', False),
                 'multi-class final NMS')
        _require(nms_cfg.NMS_TYPE in ('new_nms_gpu', 'variance_voting',
                                      'nms_gpu'),
                 f'final NMS_TYPE {nms_cfg.NMS_TYPE}')
        use_voting = nms_cfg.NMS_TYPE != 'nms_gpu'
        pre_max = int(nms_cfg.NMS_PRE_MAXSIZE)
        post_max = int(nms_cfg.NMS_POST_MAXSIZE)
        thresh = float(nms_cfg.NMS_THRESH)
        score_thresh = float(post.get('SCORE_THRESH', 0.0))
        post_score_thresh = float(post.get('POST_SCORE_THRESH', 0.0))
        res = []
        for i in range(boxes_all.shape[0]):
            boxes_s = boxes_all[i]
            if use_voting:
                boxes_wrapped = torch.cat([
                    boxes_s[:, :6],
                    common.limit_period(boxes_s[:, 6:7], 0.5, 2 * math.pi)],
                    dim=1)
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
    return Detector(cfg.MODEL, cfg.DATA_CONFIG,
                    num_class=len(cfg.CLASS_NAMES),
                    device=common.resolve_device(device))
