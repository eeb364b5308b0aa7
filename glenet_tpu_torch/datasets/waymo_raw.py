"""Raw Waymo TFRecord extraction -> per-sequence info pkl + per-frame npy
(the port's own copy of glenet_tpu/datasets/waymo_raw.py, numpy only).

Output schema matches the reference's pcdet/datasets/waymo/waymo_utils.py
(process_single_sequence) so sequences extracted by either pipeline are
interchangeable:

  <save_path>/<sequence_name>/<sequence_name>.pkl
      list of per-frame info dicts:
        point_cloud: {num_features: 5, lidar_sequence, sample_idx}
        frame_id:    '<sequence_name>_%03d'
        metadata:    {context_name, timestamp_micros}
        image:       {image_shape_0..4: (H, W)}
        pose:        (4, 4) float32
        annos:       name/difficulty/dimensions/location/heading_angles/
                     obj_ids/tracking_difficulty/num_points_in_gt/
                     gt_boxes_lidar (N, 7)   [has_label only]
        num_points_of_each_lidar: [int x 5]
  <save_path>/<sequence_name>/%04d.npy
      (N, 6) float32 [x, y, z, intensity, elongation, NLZ_flag]

The TF/SDK surface is kept to two seams so the assembly logic is testable
without either package installed:
  - `_iter_frames(path)` — TFRecord decode (needs tensorflow + SDK protos);
  - `extract_points(frame)` — range-image -> cartesian points (needs the
    SDK's frame_utils; NLZ flags are recovered with plain numpy from the
    parsed range images).
`process_frame(frame, ...)` and everything below it is numpy-only and is
exercised by tests/test_torch_waymo_raw.py with a fake SDK.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

WAYMO_CLASSES = ['unknown', 'Vehicle', 'Pedestrian', 'Sign', 'Cyclist']


# ---------------------------------------------------------------------------
# SDK seams
# ---------------------------------------------------------------------------

def _iter_frames(sequence_file):
    """Yield parsed `dataset_pb2.Frame` protos from a TFRecord file."""
    import tensorflow as tf
    from waymo_open_dataset import dataset_pb2
    dataset = tf.data.TFRecordDataset(str(sequence_file), compression_type='')
    for data in dataset:
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        yield frame


def _nlz_flags(range_images, laser_name, ri_index):
    """NLZ (no-label-zone) flag per valid point of one lidar/return, in the
    same row-major order the SDK's cartesian gather uses (mask = range>0
    on channel 0, flag = channel 3)."""
    ri = range_images[laser_name][ri_index]
    tensor = np.asarray(ri.data, np.float32).reshape(
        [int(d) for d in ri.shape.dims])
    mask = tensor[..., 0] > 0
    return tensor[..., 3][mask]


def extract_points(frame, use_two_returns=True):
    """frame -> (points (N, 6) float32 [x y z i e nlz], per-lidar counts).

    Uses the SDK's `convert_range_image_to_point_cloud` with
    keep_polar_features=True (columns [range, intensity, elongation,
    x, y, z]) per return, and re-derives the NLZ flag from the parsed
    range images (the reference keeps it as a 6th column,
    waymo_utils.py:161-180)."""
    from waymo_open_dataset.utils import frame_utils

    parsed = frame_utils.parse_range_image_and_camera_projection(frame)
    # SDK >= 2.6 returns a 4-tuple (with seg labels), older a 3-tuple
    range_images, camera_projections = parsed[0], parsed[1]
    range_image_top_pose = parsed[-1]

    per_lidar_pts = None
    per_lidar_nlz = None
    for ri_index in (0, 1) if use_two_returns else (0,):
        points, _cp = frame_utils.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose,
            ri_index=ri_index, keep_polar_features=True)
        nlz = [_nlz_flags(range_images, name, ri_index)
               for name in sorted(range_images.keys())]
        if per_lidar_pts is None:
            per_lidar_pts = [[np.asarray(p)] for p in points]
            per_lidar_nlz = [[f] for f in nlz]
        else:
            for i, p in enumerate(points):
                per_lidar_pts[i].append(np.asarray(p))
                per_lidar_nlz[i].append(nlz[i])

    merged = [np.concatenate(chunks, 0) for chunks in per_lidar_pts]
    merged_nlz = [np.concatenate(chunks, 0) for chunks in per_lidar_nlz]
    num_points_of_each_lidar = [int(len(p)) for p in merged]

    allp = np.concatenate(merged, 0)
    allnlz = np.concatenate(merged_nlz, 0).reshape(-1, 1)
    # polar layout: [range, intensity, elongation, x, y, z]
    save_points = np.concatenate(
        [allp[:, 3:6], allp[:, 1:2], allp[:, 2:3], allnlz],
        axis=-1).astype(np.float32)
    return save_points, num_points_of_each_lidar


# ---------------------------------------------------------------------------
# numpy-only assembly (fake-SDK testable)
# ---------------------------------------------------------------------------

def generate_labels(frame):
    """laser_labels -> annos dict (reference waymo_utils.py:23-63);
    'unknown' rows dropped, gt_boxes_lidar = [loc, lwh, heading]."""
    names, difficulty, dims, locs, headings = [], [], [], [], []
    tracking_difficulty, obj_ids, num_points_in_gt = [], [], []
    for lab in frame.laser_labels:
        box = lab.box
        names.append(WAYMO_CLASSES[lab.type])
        difficulty.append(lab.detection_difficulty_level)
        tracking_difficulty.append(lab.tracking_difficulty_level)
        dims.append([box.length, box.width, box.height])
        locs.append([box.center_x, box.center_y, box.center_z])
        headings.append(box.heading)
        obj_ids.append(lab.id)
        num_points_in_gt.append(lab.num_lidar_points_in_box)

    keep = np.array([n != 'unknown' for n in names], bool)
    annos = {
        'name': np.array(names)[keep],
        'difficulty': np.array(difficulty)[keep],
        'dimensions': np.array(dims, np.float32).reshape(-1, 3)[keep],
        'location': np.array(locs, np.float32).reshape(-1, 3)[keep],
        'heading_angles': np.array(headings, np.float32)[keep],
        'obj_ids': np.array(obj_ids)[keep],
        'tracking_difficulty': np.array(tracking_difficulty)[keep],
        'num_points_in_gt': np.array(num_points_in_gt)[keep],
    }
    if len(annos['name']) > 0:
        annos['gt_boxes_lidar'] = np.concatenate(
            [annos['location'], annos['dimensions'],
             annos['heading_angles'][:, None]], axis=1)
    else:
        annos['gt_boxes_lidar'] = np.zeros((0, 7), np.float32)
    return annos


def process_frame(frame, cnt, sequence_name, cur_save_dir, has_label=True,
                  use_two_returns=True, point_extractor=None):
    """One frame -> info dict + saved npy.  `point_extractor` defaults to
    the SDK-backed `extract_points`; tests inject a fake."""
    extractor = point_extractor or extract_points
    info = {
        'point_cloud': {'num_features': 5, 'lidar_sequence': sequence_name,
                        'sample_idx': cnt},
        'frame_id': sequence_name + ('_%03d' % cnt),
        'metadata': {
            'context_name': frame.context.name,
            'timestamp_micros': frame.timestamp_micros,
        },
    }
    image_info = {}
    for j, calib in enumerate(frame.context.camera_calibrations[:5]):
        image_info['image_shape_%d' % j] = (calib.height, calib.width)
    info['image'] = image_info
    info['pose'] = np.array(frame.pose.transform,
                            np.float32).reshape(4, 4)
    if has_label:
        info['annos'] = generate_labels(frame)

    points, num_points_of_each_lidar = extractor(
        frame, use_two_returns=use_two_returns)
    np.save(str(cur_save_dir / ('%04d.npy' % cnt)), points)
    info['num_points_of_each_lidar'] = num_points_of_each_lidar
    return info


def process_single_sequence(sequence_file, save_path, sampled_interval=1,
                            has_label=True, use_two_returns=True,
                            frame_iter=None, point_extractor=None):
    """TFRecord -> <save_path>/<seq>/{<seq>.pkl, %04d.npy}.  Skips
    sequences already extracted (reference waymo_utils.py:186-246)."""
    sequence_file = Path(sequence_file)
    sequence_name = sequence_file.name.replace('.tfrecord', '')
    cur_save_dir = Path(save_path) / sequence_name
    cur_save_dir.mkdir(parents=True, exist_ok=True)
    pkl_file = cur_save_dir / f'{sequence_name}.pkl'
    if pkl_file.exists():
        with open(str(pkl_file), 'rb') as f:
            return pickle.load(f)
    if frame_iter is None:
        if not sequence_file.exists():
            print(f'NotFoundError: {sequence_file}')
            return []
        frame_iter = _iter_frames(sequence_file)

    sequence_infos = []
    for cnt, frame in enumerate(frame_iter):
        if cnt % sampled_interval != 0:
            continue
        sequence_infos.append(process_frame(
            frame, cnt, sequence_name, cur_save_dir, has_label=has_label,
            use_two_returns=use_two_returns,
            point_extractor=point_extractor))

    with open(str(pkl_file), 'wb') as f:
        pickle.dump(sequence_infos, f)
    return sequence_infos


# ---------------------------------------------------------------------------
# schema validator (usable on externally-extracted data too)
# ---------------------------------------------------------------------------

_INFO_KEYS = ('point_cloud', 'frame_id', 'metadata', 'image', 'pose',
              'num_points_of_each_lidar')
_ANNO_KEYS = ('name', 'difficulty', 'dimensions', 'location',
              'heading_angles', 'obj_ids', 'tracking_difficulty',
              'num_points_in_gt', 'gt_boxes_lidar')


def validate_sequence_dir(seq_dir, expect_annos=True):
    """Assert one extracted sequence directory matches the consumer schema
    (WaymoDataset.include_waymo_data/get_lidar).  Returns the infos."""
    seq_dir = Path(seq_dir)
    pkl_file = seq_dir / f'{seq_dir.name}.pkl'
    assert pkl_file.exists(), f'missing {pkl_file}'
    with open(str(pkl_file), 'rb') as f:
        infos = pickle.load(f)
    assert isinstance(infos, list) and infos, 'empty sequence infos'
    for info in infos:
        for k in _INFO_KEYS:
            assert k in info, f'info missing key {k}'
        pc = info['point_cloud']
        assert pc['lidar_sequence'] == seq_dir.name
        assert pc['num_features'] == 5
        pose = np.asarray(info['pose'])
        assert pose.shape == (4, 4)
        npy = seq_dir / ('%04d.npy' % pc['sample_idx'])
        assert npy.exists(), f'missing {npy}'
        pts = np.load(str(npy))
        assert pts.ndim == 2 and pts.shape[1] == 6, (
            f'points must be (N, 6) [x y z i e nlz], got {pts.shape}')
        assert pts.shape[0] == sum(info['num_points_of_each_lidar'])
        if expect_annos:
            assert 'annos' in info, 'info missing annos'
            annos = info['annos']
            for k in _ANNO_KEYS:
                assert k in annos, f'annos missing key {k}'
            n = len(annos['name'])
            assert annos['gt_boxes_lidar'].shape == (n, 7)
            assert not np.any(annos['name'] == 'unknown')
    return infos


def create_waymo_infos(raw_data_path, save_path, splits=('train', 'val'),
                       sampled_interval=1, use_two_returns=True,
                       imagesets_path=None):
    """Extract every sequence listed in ImageSets/<split>.txt.  Requires
    the waymo-open-dataset SDK + tensorflow (import checked up front)."""
    try:
        import waymo_open_dataset  # noqa: F401
    except ImportError as e:
        raise ImportError(
            'raw Waymo TFRecord extraction requires the waymo-open-dataset '
            'SDK (pip install waymo-open-dataset-tf-2-11-0); the extracted '
            'info/npy schema is documented in '
            'glenet_tpu_torch/datasets/waymo_raw.py and validated by '
            'validate_sequence_dir()') from e

    raw_data_path = Path(raw_data_path)
    save_path = Path(save_path)
    imagesets = Path(imagesets_path) if imagesets_path else \
        raw_data_path.parent / 'ImageSets'
    for split in splits:
        split_file = imagesets / f'{split}.txt'
        seqs = [x.strip() for x in open(str(split_file)).readlines()]
        print(f'--- split {split}: {len(seqs)} sequences')
        for seq in seqs:
            infos = process_single_sequence(
                raw_data_path / seq, save_path,
                sampled_interval=sampled_interval,
                use_two_returns=use_two_returns)
            print(f'{seq}: {len(infos)} frames')
