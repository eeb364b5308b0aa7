"""Detection cells (traffic kind `predict`): `Detector.predict` in a closed
loop over a pool of frames drawn from the seed.  A request runs from
handing over the frame's host tensors (pinned, copied non_blocking) until
the final boxes, scores, labels and validity are on the host; the next
frame is handed over then.

Set-up builds the detector, draws the weights and warms the call up with
two requests.  After the window, a sample of the window's requests drawn
from the seed, the slowest among them, is checked against the reference
on the same frames.
"""
from __future__ import annotations

import time

import numpy as np

from .. import compare, frames, harness, program
from ..reference.common import Precision
from . import closed_loop, traced
from .train import plain_flops

OUTPUTS = ('final_boxes', 'final_scores', 'final_labels', 'final_valid')
SPANS = {'voxelize_vfe': ('start', 'backbone_3d>'),
         'backbone3d': ('backbone_3d>', 'backbone_3d<'),
         'dense_head': ('backbone_3d<', 'dense_head<'),
         'nms': ('dense_head<', 'end')}
WARM_UPS = 2


class Session:
    """The program's detector and the request the window drives."""

    def __init__(self, h, seed):
        self.h, self.dev = h, h.device
        self.cfg, self.det = program.build(h.config, h.device)
        self.w0 = program.load_seeded(self.det, h.config, seed, h.device)
        self.pool = harness.pinned(frames.make_pool(h.traffic, seed),
                                   h.device)
        self.n_pool = self.pool['points'].shape[0]
        self.served = []        # (pool index, latency s, host outputs)

    def call(self):
        t = time.perf_counter()
        i = len(self.served) % self.n_pool
        out = self.det.predict(harness.to_device(self.pool, i, self.dev))
        host = {k: out[k][0].to('cpu') for k in OUTPUTS}
        self.served.append((i, time.perf_counter() - t, host))

    def release(self):
        del self.det
        harness.free_cache(self.dev)


def reference_readings(h, pool, w0, requests, control=False):
    """Numbers of each request (pool index, host outputs) against the
    reference on its frame; with `control` the outputs are replaced by the
    reference's in fp8."""
    ref_mod = harness.reference(h.config['reference'])
    cell_m = cell_metres(h.config['config'])
    nms = nms_params(h.config['config'])
    readings = []
    for i, host in requests:
        args = (h.config['config'], h.config['budgets'], w0,
                pool['points'][i, 0].to(h.device),
                pool['points_mask'][i, 0].to(h.device))
        ref = ref_mod.predict(*args, Precision('f32'))
        if control:
            ctl = ref_mod.predict(*args, Precision('fp8'))
            got = {k: ctl[k] for k in ('boxes', 'scores', 'labels')}
        else:
            got = valid_part(host)
        readings.append(compare.detection_numbers(got, ref, cell_m, nms))
    return readings


def run(h):
    s = Session(h, h.seed)
    for _ in range(WARM_UPS):
        s.call()
    harness.sync(s.dev)
    setup_peak = harness.peak_bytes(s.dev)
    harness.reset_peak(s.dev)
    first = len(s.served)
    out = {'setup_s': time.perf_counter() - h.t0}
    if h.trace:
        det = s.det
        out['trace'] = traced(s.call, h.seconds, h.traffic['profiled_calls'],
                              lambda sp: _attach(sp, det), SPANS,
                              program.merge_module(), s.dev)
        del det
        plain = s.served[first:first + out['trace']['plain_calls']]
    else:
        lat, t0, t1 = closed_loop(s.call, h.seconds)
        out['e2e'] = {
            'setup_s': out['setup_s'],
            'predict_scans_per_s': len(lat) / (t1 - t0),
            'predict_p95_ms': 1e3 * p95(lat),
            'peak_mem_gib': harness.peak_bytes(s.dev) / harness.GIB}
    harness.sync(s.dev)
    out['memory_peak_bytes'] = max(setup_peak, harness.peak_bytes(s.dev))
    window = s.served[first:]
    s.release()
    sample = checked_sample(window, h.seed, int(h.traffic['checked_requests']))
    readings = reference_readings(h, s.pool, s.w0,
                                  [(window[j][0], window[j][2])
                                   for j in sample])
    failed = sum(not harness.checks_of(r, h.limits)[1] for r in readings)
    out.update(numbers=compare.worst(readings), attempted=len(window),
               failed=failed)
    if h.trace:
        out['trace'].update(kind='predict', plain_flops=plain_flops(
            h, s.pool, [i for i, _, _ in plain], False))
    return out


def p95(values):
    """The 95th percentile of all values (linear interpolation between
    order statistics, numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def checked_sample(window, seed, n):
    """Indices of the checked requests: the slowest of the window and
    n - 1 others drawn from the seed."""
    slowest = max(range(len(window)), key=lambda j: window[j][1])
    rng = frames.rng_for(seed, stream=1)
    rest = [j for j in rng.permutation(len(window)) if j != slowest]
    return [slowest] + [int(j) for j in rest[:n - 1]]


def valid_part(host):
    v = host['final_valid'].numpy()
    return {'boxes': host['final_boxes'].numpy()[v],
            'scores': host['final_scores'].numpy()[v],
            'labels': host['final_labels'].numpy()[v]}


def cell_metres(config):
    """Metres of one cell of the head's map (x)."""
    vox = {p['NAME']: p for p in config['DATA_CONFIG']['DATA_PROCESSOR']}[
        'transform_points_to_voxels']
    stride = config['MODEL']['DENSE_HEAD']['TARGET_ASSIGNER_CONFIG'][
        'FEATURE_MAP_STRIDE']
    return vox['VOXEL_SIZE'][0] * stride


def nms_params(config):
    """The final NMS's parameters, as the configuration states them."""
    post = config['MODEL']['POST_PROCESSING']
    return {'thresh': post['NMS_CONFIG']['NMS_THRESH'],
            'score_thresh': post['SCORE_THRESH'],
            'top_k': post['MAX_OBJ_PER_SAMPLE'],
            'post_max': post['NMS_CONFIG']['NMS_POST_MAXSIZE']}


def _attach(spans, det):
    spans.hook_module(det.net.backbone_3d, 'backbone_3d')
    spans.hook_module(det.net.dense_head, 'dense_head')
