"""nuScenes and Lyft info building (the port's own copy of
glenet_tpu/datasets/nuscenes_raw.py, numpy only).

The adapters (nuscenes_dataset.py, lyft_dataset.py) read info pickles in
the reference's schema: lidar_path, token, sweeps [{lidar_path,
sample_data_token, transform_matrix, time_lag, ...}], ref_from_car,
car_from_global, timestamp, gt_boxes (N, 9) [x y z dx dy dz yaw vx vy],
gt_boxes_velocity, gt_names, gt_boxes_token, num_lidar_pts,
num_radar_pts, and with a camera seam cam_front_path / cam_intrinsic.

Every geometry and assembly step is plain numpy over record dicts
(ego_pose / calibrated_sensor / sample_data rows), so it runs without the
devkits; `create_nuscenes_info` and `create_lyft_info` are the thin seams
that import the nuScenes devkit or the Lyft SDK, turn their objects into
records and write the pickles.  Without the package they raise a
RuntimeError naming it.

Frames follow the devkit's convention: a pose or calibration record holds
a translation t and a rotation quaternion q (w, x, y, z) mapping the child
frame into the parent (sensor -> ego, ego -> global).
"""
from __future__ import annotations

import pickle
from functools import reduce
from pathlib import Path

import numpy as np

# nuScenes general -> detection class mapping (the reference's
# map_name_from_general_to_detection)
NAME_MAP = {
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.wheelchair': 'ignore',
    'human.pedestrian.stroller': 'ignore',
    'human.pedestrian.personal_mobility': 'ignore',
    'human.pedestrian.police_officer': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'animal': 'ignore',
    'vehicle.car': 'car',
    'vehicle.motorcycle': 'motorcycle',
    'vehicle.bicycle': 'bicycle',
    'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus',
    'vehicle.truck': 'truck',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.emergency.ambulance': 'ignore',
    'vehicle.emergency.police': 'ignore',
    'vehicle.trailer': 'trailer',
    'movable_object.barrier': 'barrier',
    'movable_object.trafficcone': 'traffic_cone',
    'movable_object.pushable_pullable': 'ignore',
    'movable_object.debris': 'ignore',
    'static_object.bicycle_rack': 'ignore',
}


def quat_to_rot(q):
    """(w, x, y, z) unit quaternion -> (3, 3) rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def transform_matrix(translation, rotation_q, inverse=False):
    """4x4 homogeneous child->parent transform (or its inverse)."""
    rot = quat_to_rot(rotation_q)
    t = np.asarray(translation, np.float64)
    tm = np.eye(4)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ t
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = t
    return tm


def quaternion_yaw(q):
    """Yaw of the rotated x-axis (reference quaternion_yaw semantics)."""
    v = quat_to_rot(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def _rotate_quat(q, r):
    """Hamilton product r * q (apply rotation r after q)."""
    w1, x1, y1, z1 = r
    w2, x2, y2, z2 = q
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


def _quat_conj(q):
    w, x, y, z = q
    return (w, -x, -y, -z)


def boxes_global_to_sensor(centers, sizes_wlh, yaw_quats, velocities,
                           ego_pose, calib):
    """Vectorized global-frame boxes -> sensor-frame (N, 9) gt array.

    centers (N, 3), sizes_wlh (N, 3) as (w, l, h), yaw_quats list of
    (w, x, y, z), velocities (N, 3) global; ego_pose / calib are records
    with 'translation' and 'rotation'.  Returns gt_boxes (N, 9):
    [x y z dx dy dz yaw vx vy] with dims reordered wlh -> (l, w, h) as
    the reference does (nuscenes_utils.py:352 wlh -> dxdydz), plus the
    full (N, 3) SENSOR-frame velocities (the reference's get_sample_data
    rotates box.velocity into the sensor frame before fill_trainval_infos
    stores it as gt_boxes_velocity).
    """
    n = len(centers)
    if n == 0:
        return np.zeros((n, 9), np.float32), np.zeros((n, 3), np.float32)
    r_ge = quat_to_rot(ego_pose['rotation']).T         # global -> ego
    r_es = quat_to_rot(calib['rotation']).T            # ego -> sensor
    c = (np.asarray(centers, np.float64)
         - np.asarray(ego_pose['translation'], np.float64)) @ r_ge.T
    c = (c - np.asarray(calib['translation'], np.float64)) @ r_es.T
    v = np.asarray(velocities, np.float64) @ r_ge.T @ r_es.T
    qe = _quat_conj(tuple(ego_pose['rotation']))
    qs = _quat_conj(tuple(calib['rotation']))
    yaws = [quaternion_yaw(_rotate_quat(_rotate_quat(q, qe), qs))
            for q in yaw_quats]
    dims = np.asarray(sizes_wlh, np.float64)[:, [1, 0, 2]]
    out = np.concatenate(
        [c, dims, np.asarray(yaws)[:, None], v[:, :2]], axis=1)
    return out.astype(np.float32), v.astype(np.float32)


def chain_sweeps(get, ref_sd, ref_cs, ref_pose, data_path, path_of,
                 max_sweeps):
    """Sweep list for one sample (reference fill_trainval_infos sweep
    walk): follow sample_data['prev'] links, composing
    ref_from_car @ car_from_global @ global_from_car @ car_from_current
    per sweep; when the chain ends early, repeat the last entry (or a
    transform-less self entry when there is no history at all).

    Args:
        get: callable(table, token) -> record dict;
        ref_sd / ref_cs / ref_pose: the reference sample_data,
            calibrated_sensor, ego_pose records;
        path_of: callable(sample_data_token) -> absolute file path;
    Returns: list of max_sweeps - 1 sweep dicts.
    """
    ref_from_car = transform_matrix(
        ref_cs['translation'], ref_cs['rotation'], inverse=True)
    car_from_global = transform_matrix(
        ref_pose['translation'], ref_pose['rotation'], inverse=True)
    ref_time = 1e-6 * ref_sd['timestamp']

    sweeps = []
    cur = ref_sd
    while len(sweeps) < max_sweeps - 1:
        if cur['prev'] == '':
            if not sweeps:
                sweeps.append({
                    'lidar_path': _rel(path_of(ref_sd['token']), data_path),
                    'sample_data_token': cur['token'],
                    'transform_matrix': None,
                    'time_lag': 0.0,
                })
            else:
                sweeps.append(sweeps[-1])
        else:
            cur = get('sample_data', cur['prev'])
            pose = get('ego_pose', cur['ego_pose_token'])
            cs = get('calibrated_sensor', cur['calibrated_sensor_token'])
            global_from_car = transform_matrix(
                pose['translation'], pose['rotation'], inverse=False)
            car_from_current = transform_matrix(
                cs['translation'], cs['rotation'], inverse=False)
            tm = reduce(np.dot, [ref_from_car, car_from_global,
                                 global_from_car, car_from_current])
            sweeps.append({
                'lidar_path': _rel(path_of(cur['token']), data_path),
                'sample_data_token': cur['token'],
                'transform_matrix': tm,
                'global_from_car': global_from_car,
                'car_from_current': car_from_current,
                'time_lag': ref_time - 1e-6 * cur['timestamp'],
            })
    return sweeps


def _rel(path, root):
    try:
        return str(Path(path).relative_to(root))
    except ValueError:
        return str(path)


def build_sample_info(get, sample, data_path, path_of, max_sweeps,
                      test=False, box_fn=None, cam_fn=None):
    """One reference-schema info dict from plain records.

    box_fn: callable(sample) -> (centers, sizes_wlh, yaw_quats,
    velocities, names, tokens, num_lidar_pts, num_radar_pts) in the
    GLOBAL frame (the devkit seam supplies it; tests mock it).
    cam_fn: optional callable(sample) -> (cam_front_path, cam_intrinsic
    (3, 3)) writing the reference's camera fields
    (nuscenes_utils.py fill_trainval_infos cam_front_path/cam_intrinsic)."""
    ref_sd = get('sample_data', sample['data']['LIDAR_TOP'])
    ref_cs = get('calibrated_sensor', ref_sd['calibrated_sensor_token'])
    ref_pose = get('ego_pose', ref_sd['ego_pose_token'])

    info = {
        'lidar_path': _rel(path_of(ref_sd['token']), data_path),
        'token': sample['token'],
        'ref_from_car': transform_matrix(
            ref_cs['translation'], ref_cs['rotation'], inverse=True),
        'car_from_global': transform_matrix(
            ref_pose['translation'], ref_pose['rotation'], inverse=True),
        'timestamp': 1e-6 * ref_sd['timestamp'],
        'sweeps': chain_sweeps(get, ref_sd, ref_cs, ref_pose, data_path,
                               path_of, max_sweeps),
    }
    if cam_fn is not None:
        cam_path, cam_intrinsic = cam_fn(sample)
        info['cam_front_path'] = _rel(cam_path, data_path)
        info['cam_intrinsic'] = np.asarray(cam_intrinsic, np.float64)
    if not test and box_fn is not None:
        (centers, sizes, quats, vels, names, tokens,
         n_lidar, n_radar) = box_fn(sample)
        gt, v_sensor = boxes_global_to_sensor(centers, sizes, quats, vels,
                                              ref_pose, ref_cs)
        n_lidar = np.asarray(n_lidar)
        n_radar = np.asarray(n_radar)
        # reference filter: drop boxes with zero lidar+radar points
        keep = (n_lidar + n_radar) > 0
        info['gt_boxes'] = gt[keep]
        # SENSOR-frame, matching the reference (get_sample_data rotates
        # box.velocity into the sensor frame before fill_trainval_infos
        # reads it) and consistent with gt_boxes[:, 7:9]
        info['gt_boxes_velocity'] = v_sensor[keep]
        info['gt_names'] = np.array(
            [NAME_MAP.get(n, n) for n in names])[keep]
        info['gt_boxes_token'] = np.asarray(tokens)[keep]
        info['num_lidar_pts'] = n_lidar[keep]
        info['num_radar_pts'] = n_radar[keep]
    return info


def create_nuscenes_info(version, data_path, save_path, max_sweeps=10):
    """Devkit seam (reference nuscenes_dataset.py:299): builds and writes
    nuscenes_infos_{N}sweeps_{train,val,test}.pkl.  Requires the
    `nuscenes` package; the assembly above is what the unit tests
    cover, this function is the thin adapter."""
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError as e:                      # pragma: no cover
        raise RuntimeError(
            'create_nuscenes_info needs the nuscenes devkit '
            '(pip install nuscenes-devkit)') from e

    data_path = Path(data_path) / version
    save_path = Path(save_path) / version
    assert version in ('v1.0-trainval', 'v1.0-test', 'v1.0-mini')
    scene_split = {
        'v1.0-trainval': (splits.train, splits.val),
        'v1.0-test': (splits.test, []),
        'v1.0-mini': (splits.mini_train, splits.mini_val),
    }[version]

    nusc = NuScenes(version=version, dataroot=str(data_path), verbose=True)

    def get(table, token):
        return nusc.get(table, token)

    def path_of(sd_token):
        return nusc.get_sample_data_path(sd_token)

    def box_fn(sample):
        annos = [nusc.get('sample_annotation', t) for t in sample['anns']]
        boxes = [nusc.get_box(t) for t in sample['anns']]
        centers = [b.center for b in boxes]
        sizes = [b.wlh for b in boxes]
        quats = [tuple(b.orientation.elements) for b in boxes]
        vels = [nusc.box_velocity(b.token) for b in boxes]
        names = [b.name for b in boxes]
        tokens = [b.token for b in boxes]
        n_lidar = [a['num_lidar_pts'] for a in annos]
        n_radar = [a['num_radar_pts'] for a in annos]
        return (centers, sizes, quats, vels, names, tokens, n_lidar,
                n_radar)

    def cam_fn(sample):
        cam_sd = nusc.get('sample_data', sample['data']['CAM_FRONT'])
        cam_cs = nusc.get('calibrated_sensor',
                          cam_sd['calibrated_sensor_token'])
        return (nusc.get_sample_data_path(cam_sd['token']),
                cam_cs['camera_intrinsic'])

    # scenes whose first lidar file exists on disk (reference
    # get_available_scenes)
    name_to_token = {}
    for scene in nusc.scene:
        first = nusc.get('sample', scene['first_sample_token'])
        sd = nusc.get('sample_data', first['data']['LIDAR_TOP'])
        if Path(nusc.get_sample_data_path(sd['token'])).exists():
            name_to_token[scene['name']] = scene['token']
    train_tokens = {name_to_token[s] for s in scene_split[0]
                    if s in name_to_token}

    train_infos, val_infos = [], []
    test = version == 'v1.0-test'
    for sample in nusc.sample:
        info = build_sample_info(get, sample, data_path, path_of,
                                 max_sweeps, test=test, box_fn=box_fn,
                                 cam_fn=cam_fn)
        (train_infos if sample['scene_token'] in train_tokens
         else val_infos).append(info)

    save_path.mkdir(parents=True, exist_ok=True)
    if test:
        (save_path / f'nuscenes_infos_{max_sweeps}sweeps_test.pkl'
         ).write_bytes(pickle.dumps(train_infos))
    else:
        (save_path / f'nuscenes_infos_{max_sweeps}sweeps_train.pkl'
         ).write_bytes(pickle.dumps(train_infos))
        (save_path / f'nuscenes_infos_{max_sweeps}sweeps_val.pkl'
         ).write_bytes(pickle.dumps(val_infos))
    return len(train_infos), len(val_infos)


def create_lyft_info(version, data_path, save_path, split_scenes,
                     max_sweeps=10):
    """Lyft variant of the devkit seam (reference lyft_dataset.py:251):
    the Lyft SDK is a nuScenes fork with the same record schema, so the
    whole devkit-free assembly above applies unchanged — only the
    entry-point class and the split source differ (Lyft splits come from
    caller-provided scene-name lists instead of nuscenes.utils.splits).

    Args:
        split_scenes: {'train': [scene names], 'val': [...]}.
    Writes lyft_infos_{train,val}.pkl with the same info schema.
    """
    try:
        from lyft_dataset_sdk.lyftdataset import LyftDataset
    except ImportError as e:                      # pragma: no cover
        raise RuntimeError(
            'create_lyft_info needs lyft_dataset_sdk') from e

    data_path = Path(data_path)
    save_path = Path(save_path)
    lyft = LyftDataset(data_path=str(data_path),
                       json_path=str(data_path / version), verbose=True)

    def get(table, token):
        return lyft.get(table, token)

    def path_of(sd_token):
        return lyft.get_sample_data_path(sd_token)

    def box_fn(sample):
        annos = [lyft.get('sample_annotation', t) for t in sample['anns']]
        boxes = [lyft.get_box(t) for t in sample['anns']]
        return ([b.center for b in boxes], [b.wlh for b in boxes],
                [tuple(b.orientation.elements) for b in boxes],
                np.zeros((len(boxes), 3)),        # lyft has no velocities
                [b.name for b in boxes], [b.token for b in boxes],
                [a.get('num_lidar_pts', 1) for a in annos],
                [a.get('num_radar_pts', 0) for a in annos])

    scene_name = {s['token']: s['name'] for s in lyft.scene}
    train_names = set(split_scenes.get('train', []))
    train_infos, val_infos = [], []
    for sample in lyft.sample:
        info = build_sample_info(get, sample, data_path, path_of,
                                 max_sweeps, box_fn=box_fn)
        (train_infos if scene_name[sample['scene_token']] in train_names
         else val_infos).append(info)

    save_path.mkdir(parents=True, exist_ok=True)
    (save_path / 'lyft_infos_train.pkl').write_bytes(
        pickle.dumps(train_infos))
    (save_path / 'lyft_infos_val.pkl').write_bytes(
        pickle.dumps(val_infos))
    return len(train_infos), len(val_infos)
