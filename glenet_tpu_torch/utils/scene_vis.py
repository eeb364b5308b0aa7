"""3D scene export for the demo (the port's own copy of the repository's
tools/visual_utils/scene_vis.py): a machine without a display opens no
mayavi or open3d window, so the scene is written out instead:

  - `export_scene_html`: one self-contained interactive HTML file (an
    inline canvas renderer, no external JS): orbit / zoom / pan, points
    coloured by height or intensity, gt boxes green and detections coloured
    by score, with per-box score labels;
  - `export_ply`: an ASCII PLY point cloud (with box wireframes as edges)
    for meshlab, open3d or CloudCompare.

Boxes are (x, y, z, dx, dy, dz, heading) with z the box centre.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import box_utils

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>glenet_tpu_torch scene</title>
<style>
 body {{ margin:0; background:#101418; overflow:hidden;
        font:12px monospace; color:#9fb2c8; }}
 #hud {{ position:fixed; left:10px; top:8px; user-select:none; }}
 canvas {{ display:block; }}
</style></head><body>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan
 &nbsp; <span id="info"></span></div>
<canvas id="c"></canvas>
<script>
const DATA = {data_json};
const cv = document.getElementById('c');
const ctx = cv.getContext('2d');
let yaw = -0.9, pitch = 0.42, dist = 55, cx = 0, cy = 0;
const pts = DATA.points, n = pts.length / 4;
document.getElementById('info').textContent =
  n + ' pts, ' + DATA.boxes.length + ' boxes';

function boxEdges(b) {{
  const [x, y, z, dx, dy, dz, ry] = b;
  const c = Math.cos(ry), s = Math.sin(ry), out = [];
  const corn = [];
  for (let i = 0; i < 8; i++) {{
    const lx = ((i & 1) ? 0.5 : -0.5) * dx;
    const ly = ((i & 2) ? 0.5 : -0.5) * dy;
    const lz = ((i & 4) ? 0.5 : -0.5) * dz;
    corn.push([x + lx * c - ly * s, y + lx * s + ly * c, z + lz]);
  }}
  const E = [[0,1],[1,3],[3,2],[2,0],[4,5],[5,7],[7,6],[6,4],
             [0,4],[1,5],[2,6],[3,7],[1,3+4],[3,1+4]]; // X on +x face
  for (const [a, b2] of E) out.push([corn[a], corn[b2]]);
  return out;
}}

function project(p, W, H) {{
  const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  let x = p[0] - DATA.center[0] + cx, y = p[1] - DATA.center[1] + cy,
      z = p[2] - DATA.center[2];
  let x1 = x * cyaw - y * syaw, y1 = x * syaw + y * cyaw;
  let y2 = y1 * cp - z * sp, z2 = y1 * sp + z * cp;
  const d = dist - y2;
  if (d < 1) return null;
  const f = 0.9 * Math.min(W, H) * 1.2 / d * 10;
  return [W / 2 + x1 * f, H / 2 - z2 * f, d];
}}

function heightColor(t) {{
  t = Math.max(0, Math.min(1, t));
  const r = Math.round(40 + 200 * t);
  const g = Math.round(90 + 120 * (1 - Math.abs(t - 0.5) * 2));
  const b = Math.round(230 - 190 * t);
  return `rgb(${{r}},${{g}},${{b}})`;
}}

function draw() {{
  const W = cv.width = innerWidth, H = cv.height = innerHeight;
  ctx.fillStyle = '#101418'; ctx.fillRect(0, 0, W, H);
  const zlo = DATA.zrange[0], zspan = DATA.zrange[1] - zlo + 1e-6;
  // points bucketed by color for fast fillRect batching
  const buckets = new Map();
  for (let i = 0; i < n; i++) {{
    const p = project([pts[4*i], pts[4*i+1], pts[4*i+2]], W, H);
    if (!p) continue;
    const col = heightColor((pts[4*i+2] - zlo) / zspan);
    if (!buckets.has(col)) buckets.set(col, []);
    buckets.get(col).push(p[0], p[1]);
  }}
  for (const [col, arr] of buckets) {{
    ctx.fillStyle = col;
    for (let i = 0; i < arr.length; i += 2)
      ctx.fillRect(arr[i], arr[i+1], 1.4, 1.4);
  }}
  for (const item of DATA.boxes) {{
    ctx.strokeStyle = item.color; ctx.lineWidth = 1.5;
    ctx.beginPath();
    for (const [a, b] of boxEdges(item.box)) {{
      const pa = project(a, W, H), pb = project(b, W, H);
      if (!pa || !pb) continue;
      ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]);
    }}
    ctx.stroke();
    if (item.label) {{
      const top = project([item.box[0], item.box[1],
                           item.box[2] + item.box[5] / 2 + 0.3], W, H);
      if (top) {{ ctx.fillStyle = item.color;
                 ctx.fillText(item.label, top[0], top[1]); }}
    }}
  }}
}}

let dragging = false, panning = false, lx = 0, ly = 0;
cv.onmousedown = e => {{ dragging = true; panning = e.shiftKey;
                         lx = e.clientX; ly = e.clientY; }};
window.onmouseup = () => dragging = false;
window.onmousemove = e => {{
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  lx = e.clientX; ly = e.clientY;
  if (panning) {{
    const cyaw = Math.cos(-yaw), syaw = Math.sin(-yaw);
    cx += (dx * cyaw) * dist / 900; cy += (-dx * syaw) * dist / 900;
  }} else {{ yaw += dx * 0.008; pitch += dy * 0.008;
            pitch = Math.max(-1.5, Math.min(1.55, pitch)); }}
  requestAnimationFrame(draw);
}};
cv.onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001);
                    dist = Math.max(3, Math.min(400, dist));
                    e.preventDefault(); requestAnimationFrame(draw); }};
window.onresize = draw;
draw();
</script></body></html>
"""


def _score_color(score: float) -> str:
    """Red (low) -> yellow -> cyan (high confidence)."""
    t = float(np.clip(score, 0.0, 1.0))
    r = int(255 * (1 - max(0.0, t - 0.5) * 2))
    g = int(255 * min(1.0, t * 2))
    return f'rgb({r},{g},{int(180 * max(0.0, t - 0.3))})'


def export_scene_html(points, path, gt_boxes=None, ref_boxes=None,
                      ref_scores=None, ref_labels=None,
                      class_names=None, max_points: int = 60000):
    """Write a standalone interactive HTML scene.

    points (N, >=3); gt_boxes (G, 7) drawn green; ref_boxes (R, 7)
    score-colored with optional labels (open3d_vis_utils.draw_scenes
    argument convention)."""
    pts = np.asarray(points, np.float32)
    if pts.shape[0] > max_points:
        sel = np.random.RandomState(0).choice(
            pts.shape[0], max_points, replace=False)
        pts = pts[sel]
    xyz = pts[:, :3]
    inten = (pts[:, 3] if pts.shape[1] > 3
             else np.zeros(len(pts), np.float32))
    flat = np.concatenate([xyz, inten[:, None]], axis=1).reshape(-1)

    boxes = []
    for i, b in enumerate(np.asarray(gt_boxes)[:, :7]
                          if gt_boxes is not None and len(gt_boxes)
                          else []):
        boxes.append({'box': [round(float(v), 3) for v in b],
                      'color': 'rgb(40,220,80)', 'label': ''})
    if ref_boxes is not None:
        rb = np.asarray(ref_boxes)
        for i in range(len(rb)):
            sc = float(ref_scores[i]) if ref_scores is not None else 1.0
            name = ''
            if ref_labels is not None:
                li = int(ref_labels[i])
                name = (class_names[li - 1] if class_names
                        and 0 < li <= len(class_names) else str(li))
            boxes.append({'box': [round(float(v), 3) for v in rb[i, :7]],
                          'color': _score_color(sc),
                          'label': f'{name} {sc:.2f}'.strip()})

    center = xyz.mean(axis=0) if len(xyz) else np.zeros(3)
    z = xyz[:, 2] if len(xyz) else np.zeros(1)
    data = {
        'points': [round(float(v), 3) for v in flat],
        'boxes': boxes,
        'center': [float(v) for v in center],
        'zrange': [float(np.percentile(z, 2)), float(np.percentile(z, 98))],
    }
    html = _HTML_TEMPLATE.format(data_json=json.dumps(data))
    Path(path).write_text(html)
    return str(path)


def export_ply(points, path, gt_boxes=None, ref_boxes=None):
    """ASCII PLY: points (+ box corner vertices joined by edges)."""
    pts = np.asarray(points, np.float32)[:, :3]
    verts = [pts]
    edges = []
    base = len(pts)
    for arr in (gt_boxes, ref_boxes):
        if arr is None or len(arr) == 0:
            continue
        corners = box_utils.boxes_to_corners_3d_np(
            np.asarray(arr, np.float32)[:, :7])         # (B, 8, 3)
        e = [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7],
             [7, 4], [0, 4], [1, 5], [2, 6], [3, 7]]
        for b in range(len(corners)):
            verts.append(corners[b])
            edges.extend([[base + a, base + c] for a, c in e])
            base += 8
    allv = np.concatenate(verts)
    lines = ['ply', 'format ascii 1.0',
             f'element vertex {len(allv)}',
             'property float x', 'property float y', 'property float z',
             f'element edge {len(edges)}',
             'property int vertex1', 'property int vertex2', 'end_header']
    lines += [f'{v[0]:.3f} {v[1]:.3f} {v[2]:.3f}' for v in allv]
    lines += [f'{a} {b}' for a, b in edges]
    Path(path).write_text('\n'.join(lines) + '\n')
    return str(path)
