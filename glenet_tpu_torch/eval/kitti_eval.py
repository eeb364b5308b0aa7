"""Official KITTI AP evaluation (R11 and R40; bbox, BEV, 3D, AOS): the
port's counterpart of glenet_tpu/eval/kitti_eval.py, with its semantics:

  - `clean_data` difficulty gating: MIN_HEIGHT (40, 25, 25) px,
    MAX_OCCLUSION (0, 1, 2), MAX_TRUNCATION (0.15, 0.3, 0.5); neighbour
    classes (Van for Car, Person_sitting for Pedestrian) ignored; small
    detections ignored;
  - greedy matching per gt: the threshold pass takes the highest-scoring
    overlapping detection; the precision-recall pass takes the
    most-overlapping real detection, else the first ignored one; DontCare
    boxes absorb unmatched detections (bbox metric, criterion-0 overlap);
  - 41 score thresholds from the matched scores; precision right-max
    smoothing; R11 = mean over every 4th point, R40 = mean over points
    1..40.

On the device (the GPU by default): the rotated BEV overlaps of every frame
in one padded batch (`ops/iou3d.py`, each pair clipped about its gt box's
centre), computed once per metric for all 18 (metric, difficulty, overlap)
cells, and the greedy matcher as torch ops
batched over frames x thresholds, looping over the padded gt slots as the
JAX package's `fori_loop` does.  Host-side numpy: `clean_data`, the 2D box
overlaps, the IoU arithmetic on the overlap areas (f64),
`get_thresholds` and the smoothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import iou3d
from ..utils.common import resolve_device

CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting', 'truck']
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
_NO_SCORE = -1e9
# frame pairs of one batch of the overlap computation, and elements of one
# (frames, thresholds, detections) chunk of the matcher
_PAIRS_PER_CHUNK = 1 << 21
_MATCH_CHUNK = 1 << 24


# ---------------------------------------------------------------------------
# host-side preparation
# ---------------------------------------------------------------------------

def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int):
    """Per-frame ignore flags.

    Returns (num_valid_gt, ignored_gt (G,), ignored_dt (D,), dc_bboxes).
    Flags: 0 = counted, 1 = ignored, -1 = not this class.
    """
    cls_name = CLASS_NAMES[current_class]
    ignored_gt = []
    num_valid = 0
    for i in range(len(gt_anno['name'])):
        name = gt_anno['name'][i].lower()
        height = gt_anno['bbox'][i, 3] - gt_anno['bbox'][i, 1]
        if name == cls_name:
            valid_class = 1
        elif cls_name == 'pedestrian' and name == 'person_sitting':
            valid_class = 0
        elif cls_name == 'car' and name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
    dc_bboxes = gt_anno['bbox'][gt_anno['name'] == 'DontCare']

    ignored_dt = []
    for i in range(len(dt_anno['name'])):
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif dt_anno['name'][i].lower() == cls_name:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return (num_valid, np.array(ignored_gt, np.int64),
            np.array(ignored_dt, np.int64), np.asarray(dc_bboxes, np.float64))


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D box overlap, (N, 4) x (K, 4) -> (N, K)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter = np.where((iw > 0) & (ih > 0), inter, 0.0)
    area_b = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))
    if criterion == -1:
        ua = area_b[:, None] + area_q[None, :] - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b[:, None], inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q[None, :], inter.shape)
    else:
        ua = np.ones_like(inter)
    with np.errstate(divide='ignore', invalid='ignore'):
        out = np.where(ua > 0, inter / ua, 0.0)
    return out


def _camera_bev_boxes(annos):
    """annos -> (N, 5) [x_cam, z_cam, l, w, ry] rotated BEV boxes."""
    loc = annos['location'][:, [0, 2]]
    dims = annos['dimensions'][:, [0, 2]]
    rots = annos['rotation_y'][..., None]
    return np.concatenate([loc, dims, rots], axis=1)


def _to7(bev):
    """(N, 5) BEV boxes -> (N, 7) boxes for ops/iou3d.py (f32)."""
    out = np.zeros((bev.shape[0], 7), np.float32)
    out[:, [0, 1, 3, 4, 6]] = bev
    return out


def _bev_overlaps(gt_annos, dt_annos, device):
    """Rotated BEV overlap areas of every frame, (G_f, D_f) f64 each: all
    frames padded into one batch of box pairs on `device`, in chunks.  Each
    pair is clipped in the frame of its gt box's centre: the shoelace sum
    of f32 corners 60 m from the origin would lose ~1e-4 of the area."""
    gts = [_to7(_camera_bev_boxes(a)) for a in gt_annos]
    dts = [_to7(_camera_bev_boxes(a)) for a in dt_annos]
    f = len(gts)
    gmax = max([len(g) for g in gts] + [1])
    dmax = max([len(d) for d in dts] + [1])
    g_pad = np.zeros((f, gmax, 7), np.float32)
    d_pad = np.zeros((f, dmax, 7), np.float32)
    for i in range(f):
        g_pad[i, :len(gts[i])] = gts[i]
        d_pad[i, :len(dts[i])] = dts[i]
    g_pad, d_pad = (torch.from_numpy(x).to(device) for x in (g_pad, d_pad))
    # corners about each box's own centre
    ca = iou3d.box_to_bev_corners(torch.cat(
        [torch.zeros_like(g_pad[..., :2]), g_pad[..., 2:]], -1))
    cb = iou3d.box_to_bev_corners(torch.cat(
        [torch.zeros_like(d_pad[..., :2]), d_pad[..., 2:]], -1))
    step = max(_PAIRS_PER_CHUNK // (gmax * dmax), 1)
    areas = []
    for s in range(0, f, step):
        a, b = ca[s:s + step], cb[s:s + step]              # (n, G|D, 4, 2)
        n = a.shape[0]
        # detection centre relative to the gt centre, (n, G, D, 1, 2)
        rel = (d_pad[s:s + step, None, :, None, :2]
               - g_pad[s:s + step, :, None, None, :2])
        a = a[:, :, None].expand(n, gmax, dmax, 4, 2)
        b = b[:, None] + rel

        def flat(c):
            return c.reshape(-1, 4).T                        # (4, n*G*D)

        areas.append(iou3d._overlap_soa(
            flat(a[..., 0]), flat(a[..., 1]),
            flat(b[..., 0]), flat(b[..., 1])).reshape(n, gmax, dmax))
    areas = torch.cat(areas).cpu().numpy().astype(np.float64)
    return [areas[i, :len(gts[i]), :len(dts[i])] for i in range(f)]


def _bev_iou(gt_annos_f, dt_annos_f, inter):
    g = _camera_bev_boxes(gt_annos_f)
    d = _camera_bev_boxes(dt_annos_f)
    area_g = (g[:, 2] * g[:, 3])[:, None]
    area_d = (d[:, 2] * d[:, 3])[None, :]
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(inter > 0, inter / (area_g + area_d - inter), 0.0)


def _d3_iou(gt_annos_f, dt_annos_f, rinc):
    """3D IoU in the camera frame, where y is the bottom of the box and
    grows downward."""
    g_loc, g_dim = gt_annos_f['location'], gt_annos_f['dimensions']
    d_loc, d_dim = dt_annos_f['location'], dt_annos_f['dimensions']
    # dims order (l, h, w): h = dims[:, 1]
    iw = (np.minimum(g_loc[:, None, 1], d_loc[None, :, 1])
          - np.maximum(g_loc[:, None, 1] - g_dim[:, None, 1],
                       d_loc[None, :, 1] - d_dim[None, :, 1]))
    vol_g = np.prod(g_dim, axis=1)[:, None]
    vol_d = np.prod(d_dim, axis=1)[None, :]
    inter = np.clip(iw, 0, None) * rinc
    inter = np.where(iw > 0, inter, 0.0)
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(inter > 0, inter / (vol_g + vol_d - inter), 0.0)


def bev_box_overlap(gt_annos_f, dt_annos_f, device=None):
    """Rotated BEV IoU of one frame (camera frame), (G, D)."""
    inter = _bev_overlaps([gt_annos_f], [dt_annos_f],
                          resolve_device(device))[0]
    return _bev_iou(gt_annos_f, dt_annos_f, inter)


def d3_box_overlap(gt_annos_f, dt_annos_f, device=None):
    """3D IoU of one frame (camera frame), (G, D)."""
    rinc = _bev_overlaps([gt_annos_f], [dt_annos_f],
                         resolve_device(device))[0]
    return _d3_iou(gt_annos_f, dt_annos_f, rinc)


def frame_overlaps(gt_annos, dt_annos, metric: int, device):
    """Per frame the (D, G) f32 overlaps of `metric` (0 bbox, 1 BEV, 2 3D)."""
    if metric == 0:
        return [image_box_overlap(d['bbox'], g['bbox']).astype(np.float32)
                for g, d in zip(gt_annos, dt_annos)]
    areas = _bev_overlaps(gt_annos, dt_annos, device)
    iou = _bev_iou if metric == 1 else _d3_iou
    return [iou(g, d, a).T.astype(np.float32)
            for g, d, a in zip(gt_annos, dt_annos, areas)]


def get_thresholds(scores, num_gt, num_sample_pts=N_SAMPLE_PTS):
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


# ---------------------------------------------------------------------------
# greedy matcher on the device
# ---------------------------------------------------------------------------

def _match(ov, gt_ig, det_ig, det_scores, gt_alpha, det_alpha, dc_ov,
           min_overlap, thresholds, compute_fp: bool, metric0: bool):
    """Greedy matcher of F padded frames at T score thresholds at once.

    ov (F, D, G) overlaps; gt_ig (F, G), det_ig (F, D) in {-1, 0, 1} (-1
    also for padding); det_scores, det_alpha (F, D); gt_alpha (F, G); dc_ov
    (F, D, C) detection-vs-DontCare criterion-0 overlaps; thresholds (T,).
    Returns (tp, fp, fn) (F, T) int, similarity (F, T) f32 (-1 where a frame
    has neither tp nor fp) and tp_scores (F, T, G) (_NO_SCORE where a gt
    slot has no true positive).
    """
    f, d, g = ov.shape
    t = thresholds.shape[0]
    if compute_fp:
        ignored_thresh = det_scores[:, None, :] < thresholds[None, :, None]
    else:
        ignored_thresh = torch.zeros((f, t, d), dtype=torch.bool,
                                     device=ov.device)
    det_usable = (det_ig != -1)[:, None, :] & ~ignored_thresh   # (F, T, D)
    real_det = (det_ig == 0)[:, None, :]
    ign_det = (det_ig == 1)[:, None, :]
    assigned = torch.zeros((f, t, d), dtype=torch.bool, device=ov.device)
    tp = torch.zeros((f, t), dtype=torch.int32, device=ov.device)
    fn = torch.zeros_like(tp)
    sim_sum = torch.zeros((f, t), dtype=torch.float32, device=ov.device)
    tp_scores = torch.full((f, t, g), _NO_SCORE, dtype=torch.float32,
                           device=ov.device)
    scores = det_scores[:, None, :].expand(f, t, d)
    min_overlap = float(min_overlap)

    def take(x, j):
        # x (F, D) at the chosen detection j (F, T) -> (F, T)
        return x[:, None, :].expand(f, t, d).gather(2, j[..., None])[..., 0]

    for i in range(g):
        ov_i = ov[:, None, :, i]                                 # (F, 1, D)
        cand = det_usable & ~assigned & (ov_i > min_overlap)
        if compute_fp:
            real = cand & real_det
            any_real = real.any(-1)
            j_real = torch.where(real, ov_i, -1.0).argmax(-1)
            ign = cand & ign_det
            any_ign = ign.any(-1)
            j_ign = ign.to(torch.uint8).argmax(-1)              # first True
            has_match = any_real | any_ign
            j = torch.where(any_real, j_real, j_ign)
        else:
            has_match = cand.any(-1)
            j = torch.where(cand, scores, _NO_SCORE).argmax(-1)
        gi = gt_ig[:, i:i + 1]                                   # (F, 1)
        active = gi != -1
        has_match = has_match & active
        is_tp = has_match & (gi == 0) & (take(det_ig, j) == 0)
        is_fn = active & ~has_match & (gi == 0)
        # a match (true positive or ignored) takes the detection
        assigned.scatter_(2, j[..., None],
                          assigned.gather(2, j[..., None])
                          | has_match[..., None])
        tp += is_tp.to(torch.int32)
        fn += is_fn.to(torch.int32)
        tp_scores[..., i] = torch.where(is_tp, take(det_scores, j),
                                        _NO_SCORE)
        sim = (1.0 + torch.cos(gt_alpha[:, i:i + 1]
                               - take(det_alpha, j))) / 2.0
        sim_sum += torch.where(is_tp, sim, 0.0)

    if not compute_fp:
        zero = torch.zeros_like(tp)
        return tp, zero, fn, sim_sum.zero_(), tp_scores
    fp_mask = ~assigned & real_det & ~ignored_thresh
    fp = fp_mask.sum(-1, dtype=torch.int32)
    if metric0:
        in_dc = (dc_ov > min_overlap).any(-1)[:, None, :]       # (F, 1, D)
        fp = fp - (fp_mask & in_dc).sum(-1, dtype=torch.int32)
    similarity = torch.where((tp > 0) | (fp > 0), sim_sum, -1.0)
    return tp, fp, fn, similarity, tp_scores


def _stage1_all_frames(ov, gt_ig, det_ig, det_scores, gt_alpha, det_alpha,
                       min_overlap, metric0: bool):
    """Threshold-collection pass over all frames -> tp_scores (F, G)."""
    zero = torch.zeros(1, dtype=torch.float32, device=ov.device)
    dc = torch.zeros((*ov.shape[:2], 1), device=ov.device)
    return _match(ov, gt_ig, det_ig, det_scores, gt_alpha, det_alpha, dc,
                  min_overlap, zero, False, metric0)[4][:, 0]


def _stage2_all_frames(ov, gt_ig, det_ig, det_scores, gt_alpha, det_alpha,
                       dc_ov, min_overlap, thresholds, metric0: bool):
    """Precision-recall pass: tp / fp / fn / similarity per threshold,
    summed over the frames (in f64) -> (T, 4) numpy."""
    f, d, _ = ov.shape
    step = max(_MATCH_CHUNK // (thresholds.shape[0] * d), 1)
    total = torch.zeros((thresholds.shape[0], 4), dtype=torch.float64,
                        device=ov.device)
    for s in range(0, f, step):
        sl = slice(s, s + step)
        tp, fp, fn, sim, _ = _match(
            ov[sl], gt_ig[sl], det_ig[sl], det_scores[sl], gt_alpha[sl],
            det_alpha[sl], dc_ov[sl], min_overlap, thresholds, True, metric0)
        sim = torch.where(sim != -1.0, sim, 0.0)
        total += torch.stack([tp, fp, fn, sim], -1).to(torch.float64).sum(0)
    return total.cpu().numpy()


# ---------------------------------------------------------------------------
# the evaluation
# ---------------------------------------------------------------------------

def _pad_stack(arrays, max_len, fill, dtype=np.float32):
    out = np.full((len(arrays), max_len, *np.shape(arrays[0])[1:]), fill,
                  dtype)
    for i, a in enumerate(arrays):
        if len(a):
            out[i, :len(a)] = a
    return out


def eval_class(gt_annos, dt_annos, current_class: int, difficulty: int,
               metric: int, min_overlap: float, compute_aos=False,
               device=None, overlaps=None):
    """One (class, difficulty, metric, overlap) cell -> precision / recall /
    aos arrays of length N_SAMPLE_PTS.  `overlaps`: frame_overlaps of this
    metric, when the caller has them."""
    device = resolve_device(device)
    f = len(gt_annos)
    assert f == len(dt_annos)

    cleaned = [clean_data(gt_annos[i], dt_annos[i], current_class, difficulty)
               for i in range(f)]
    num_valid_gt = sum(c[0] for c in cleaned)
    if overlaps is None:
        overlaps = frame_overlaps(gt_annos, dt_annos, metric, device)

    gmax = max(max((o.shape[1] for o in overlaps), default=1), 1)
    dmax = max(max((o.shape[0] for o in overlaps), default=1), 1)
    cmax = max(max((len(c[3]) for c in cleaned), default=1), 1)

    ov_pad = np.zeros((f, dmax, gmax), np.float32)
    for i, o in enumerate(overlaps):
        ov_pad[i, :o.shape[0], :o.shape[1]] = o
    gt_ig = _pad_stack([c[1] for c in cleaned], gmax, -1, np.int32)
    det_ig = _pad_stack([c[2] for c in cleaned], dmax, -1, np.int32)
    det_scores = _pad_stack([dt_annos[i]['score'] for i in range(f)],
                            dmax, _NO_SCORE)
    gt_alpha = _pad_stack([gt_annos[i]['alpha'] for i in range(f)], gmax, 0.0)
    det_alpha = _pad_stack([dt_annos[i]['alpha'] for i in range(f)], dmax, 0.0)

    # DontCare overlaps (criterion 0: intersection / det area), bbox only
    dc_ov = np.zeros((f, dmax, cmax), np.float32)
    if metric == 0:
        for i in range(f):
            dc = cleaned[i][3]
            if len(dc):
                o = image_box_overlap(dt_annos[i]['bbox'], dc, criterion=0)
                dc_ov[i, :o.shape[0], :o.shape[1]] = o

    dev = [torch.from_numpy(a).to(device) for a in (
        ov_pad, gt_ig, det_ig, det_scores, gt_alpha, det_alpha, dc_ov)]
    ov_t, gt_ig_t, det_ig_t, scores_t, gt_alpha_t, det_alpha_t, dc_t = dev

    # stage 1: collect tp scores -> thresholds
    tp_scores = _stage1_all_frames(ov_t, gt_ig_t, det_ig_t, scores_t,
                                   gt_alpha_t, det_alpha_t, min_overlap,
                                   metric == 0).cpu().numpy().reshape(-1)
    tp_scores = tp_scores[tp_scores > _NO_SCORE / 2]
    if num_valid_gt == 0 or len(tp_scores) == 0:
        z = np.zeros(N_SAMPLE_PTS)
        return {'precision': z, 'recall': z.copy(), 'orientation': z.copy()}
    thresholds = get_thresholds(tp_scores, num_valid_gt)

    # stage 2: precision-recall curves
    pr = _stage2_all_frames(
        ov_t, gt_ig_t, det_ig_t, scores_t, gt_alpha_t, det_alpha_t, dc_t,
        min_overlap,
        torch.from_numpy(thresholds.astype(np.float32)).to(device),
        metric == 0)

    t = len(thresholds)
    precision = np.zeros(N_SAMPLE_PTS)
    recall = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    with np.errstate(divide='ignore', invalid='ignore'):
        precision[:t] = pr[:, 0] / np.maximum(pr[:, 0] + pr[:, 1], 1e-9)
        recall[:t] = pr[:, 0] / np.maximum(pr[:, 0] + pr[:, 2], 1e-9)
        if compute_aos:
            aos[:t] = pr[:, 3] / np.maximum(pr[:, 0] + pr[:, 1], 1e-9)
    # right-max smoothing
    for i in range(N_SAMPLE_PTS):
        precision[i] = precision[i:].max()
        recall[i] = recall[i:].max()
        if compute_aos:
            aos[i] = aos[i:].max()
    return {'precision': precision, 'recall': recall, 'orientation': aos}


def get_mAP_R11(prec):
    return sum(prec[..., i] for i in range(0, N_SAMPLE_PTS, 4)) / 11 * 100


def get_mAP_R40(prec):
    return sum(prec[..., i] for i in range(1, N_SAMPLE_PTS)) / 40 * 100


# official overlap thresholds [hard, loose][metric bbox/bev/3d][class]
_OVERLAP_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7]] * 3)
_OVERLAP_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
                         [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                         [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
_MIN_OVERLAPS = np.stack([_OVERLAP_0_7, _OVERLAP_0_5], axis=0)  # (2, 3, 6)

_NAME_TO_CLASS = {'Car': 0, 'Pedestrian': 1, 'Cyclist': 2, 'Van': 3,
                  'Person_sitting': 4, 'Truck': 5}


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             device=None):
    """-> (result_str, ret_dict), ret_dict keys '{cls}_3d/easy_R40' etc.
    and their R11 variants.  The overlaps and the matcher run on `device`
    (the GPU by default)."""
    device = resolve_device(device)
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    class_ids = [_NAME_TO_CLASS[c] if isinstance(c, str) else c
                 for c in current_classes]
    class_names = {v: k for k, v in _NAME_TO_CLASS.items()}

    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            compute_aos = anno['alpha'][0] != -10
            break

    overlaps = {m: frame_overlaps(gt_annos, dt_annos, m, device)
                for m in range(3)}
    result = ''
    ret_dict = {}
    for cls_id in class_ids:
        name = class_names[cls_id]
        for oi in range(2):  # 0: strict overlaps, 1: loose
            table = {}
            for metric, mname in [(0, 'bbox'), (1, 'bev'), (2, '3d')]:
                mo = _MIN_OVERLAPS[oi, metric, cls_id]
                r11, r40, aos11, aos40 = [], [], [], []
                for diff in (0, 1, 2):
                    cell = eval_class(gt_annos, dt_annos, cls_id, diff,
                                      metric, mo, compute_aos=compute_aos,
                                      device=device,
                                      overlaps=overlaps[metric])
                    r11.append(get_mAP_R11(cell['precision']))
                    r40.append(get_mAP_R40(cell['precision']))
                    if compute_aos and metric == 0:
                        aos11.append(get_mAP_R11(cell['orientation']))
                        aos40.append(get_mAP_R40(cell['orientation']))
                table[mname] = (r11, r40)
                if compute_aos and metric == 0:
                    table['aos'] = (aos11, aos40)

            mo_str = ', '.join(f'{_MIN_OVERLAPS[oi, m, cls_id]:.2f}'
                               for m in range(3))
            result += f'{name} AP@{mo_str}:\n'
            for mname in ('bbox', 'bev', '3d', 'aos'):
                if mname not in table:
                    continue
                r11, r40 = table[mname]
                result += (f'{mname:4s} AP:{r11[0]:.4f}, {r11[1]:.4f}, '
                           f'{r11[2]:.4f}\n')
            result += f'{name} AP_R40@{mo_str}:\n'
            for mname in ('bbox', 'bev', '3d', 'aos'):
                if mname not in table:
                    continue
                r11, r40 = table[mname]
                result += (f'{mname:4s} AP:{r40[0]:.4f}, {r40[1]:.4f}, '
                           f'{r40[2]:.4f}\n')

            if oi == 0:
                for di, dn in enumerate(('easy', 'moderate', 'hard')):
                    for mname, key in (('3d', '3d'), ('bev', 'bev'),
                                       ('bbox', 'image')):
                        ret_dict[f'{name}_{key}/{dn}_R40'] = table[mname][1][di]
                        ret_dict[f'{name}_{key}/{dn}_R11'] = table[mname][0][di]
                    if 'aos' in table:
                        ret_dict[f'{name}_aos/{dn}_R40'] = table['aos'][1][di]
    return result, ret_dict
