#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (glenet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. set-up: the card's name and power limit, torch / CUDA versions, and the
     build of every CUDA kernel of the port (one nvcc per source, all
     started together);
  2. full width, the main path: configs/kitti_models/GLENet_VR.yaml, one
     warm-up predict that captures the (ids, queries) of its merge-resolve
     calls, then 3 requests of B = 2 synthetic KITTI-like scenes of 32768
     points (random seeded weights, default dtypes), launches counted from
     0 over those requests;
  3. full width, the train step: the same detector trained with
     adam_onecycle over a full run's schedule (80 epochs x 928 iterations),
     B = BATCH_SIZE_PER_GPU = 4 synthetic training scenes with Car gt boxes
     and label variances, the train voxel budget; one warm-up step that
     captures its merge-resolve calls, then 3 timed steps, launches counted
     from 0 over those steps.  Per step: ms, every loss term, grad_norm,
     launches (4), peak memory; checks finite losses, changed parameters
     and BN running stats, and the LR / b1 of the one-cycle schedule;
  4. the CLIs, [cli]: a synthetic tree in KITTI's layout (16 train and 4
     val frames of 120k points over 360 degrees, 10-18 labelled cars each,
     KITTI's calibration, road planes) through the port's
     create_kitti_infos, with label variances written into its infos and
     gt database; then `python -m glenet_tpu_torch.tools.train` in process
     on GLENet_VR.yaml at full width, B = 4, 2 epochs x 2 steps, and a
     resume for a third epoch with --bn_refresh 2; then
     `glenet_tpu_torch.tools.test` on the newest checkpoint over the val
     frames.  Checks 3 checkpoints, the resumed step, a bit-exact reload,
     finite losses, 4 merge-resolve launches per train step and per
     predict, result.pkl and every Car_3d/*_R40 AP key, and the host
     library built from native/host_ops.cpp against its numpy versions on
     the tree.  Prints data ms and step ms per step (against the in-memory
     train steps of phase 3), peak memory, s/frame and the evaluation's
     own time;
  5. the label-uncertainty generator, [cvae]: (a) configs/cvae/exp_gen.yaml
     at full width (B = 64 crops of 512 points, LATENT_DIM 8) on a
     synthetic gt database of KITTI's train-split size (14357 Car + 1297
     Van crops), fold 0 of 10: one warm-up and 20 timed train steps (data
     ms split into crop loads / occlusion / the rest of the item,
     collation, copy; step ms; loss terms; grad_norm; lr / b1; peak
     memory), then one prediction pass over the val fold, and the
     projected wall time of the whole 10-fold run; (b) end to end on the
     [cli] tree: `glenet_tpu_torch.tools.cvae_train --folds 2 --passes 30
     --epochs 2 --inject` in process, the variance map and the _wconf
     infos checked, GLENet-VR trained on them through the train CLI (1
     epoch x 2 steps, B = 4, launches counted from 0 over it), and the
     analysis (in process and through `tools.cvae_analysis`) of fold 0's
     passes; (c) one Waymo train step and prediction pass
     (configs/cvae/waymo_exp_gen.yaml, 5-dim crops); (d) the card against
     the CPU: one train step (loss terms, gradients, BN stats, parameters
     after adam_onecycle) and one `sample`, same weights and eps;
  6. kernel check: every kernel equals its plain PyTorch version on
     adversarial cases (with the merge-resolve kernel's count of tiles on
     its wide-window path) and on the captured calls of the predict, of
     the train step and of a full-width GLENet-C predict; per call the
     kernel's device time (torch.profiler), back-to-back, host and cold-L2
     times, the plain version's time, and
     torch.searchsorted's device and back-to-back times.  It runs after the
     main paths because a torch.profiler session leaves host overhead
     behind in the process, which slows every later step;
  7. GPU against CPU: the toy two-stage GLENet-VR topology, same seeded
     weights and points, f32 on both sides with TF32 off: a predict, and a
     train step with fixed RoI targets and DP_RATIO 0 (loss terms,
     gradients, BN running stats);
  8. trained weights into the port, [weights] (the launches of (a), (b)
     and (d) are counted from 0 just before each and read just after):
     (a) configs/kitti_models/GLENet_VR_vq.yaml (voxel-query RoI pooling)
     at full width with a synthetic reference (pcdet) state dict converted
     by the port's converter, which must consume every key: 3 predicts at
     B = 2 and 3 train steps at B = 4 (ms, peak memory, 4 merge-resolve
     launches per call), the host syncs of one more train step, and the
     vq pooling's ms per level against corner pooling on the same RoIs and
     levels; (b) voxel_rcnn_car.yaml (plain Voxel R-CNN): one predict and
     one train step; (c) after phase 7, the card against the CPU on the toy
     config in vq mode, as phase 7; (d) a reference .pth through
     `glenet_tpu_torch.tools.convert_weights`, then `tools.test --ckpt` on
     the [cli] tree, in process;
  9. the paper's single-stage detectors, [single] (launches counted from 0
     just before and read just after each call): (a) GLENet_S.yaml and
     GLENet_C.yaml at full width with seeded weights, each a warm-up
     predict (GLENet-C's captures its merge-resolve calls for phase 6),
     3 predicts at B = 2 at the published thresholds and 3 at zero
     thresholds (every NMS_PRE_MAXSIZE candidate live; random weights keep
     no box at the published ones), then 3 train steps at B = 4 as phase
     3 (losses finite, parameters and BN stats moved, the one-cycle
     schedule); (b) second.yaml (3 classes): one predict, one train step;
     (c) after phase 7, the card against the CPU on the toy topology as
     GLENet-C at zero thresholds: a predict (voxels, final labels and
     valid flags equal; BEV map, dense-head outputs, final boxes and
     scores within phase 7's tolerances) and a train step (as phase 7);
     (d) a synthetic reference GLENet-C .pth through convert_weights, then
     `tools.test --ckpt` on the [cli] tree;
 10. GLENet-S on Waymo, [waymo] (launches counted from 0 just before and
     read just after each call): (a) configs/waymo_models/GLENet_S.yaml at
     full width (5 point features, the 1504 x 1504 x 40 grid, budgets
     80000 / 90000, 188 x 188 x 2 anchors) with seeded weights on
     synthetic Waymo scenes of 170000 points over 360 degrees: a warm-up
     predict that captures its merge-resolve calls for phase 6, 3 predicts
     at B = 2 at the published thresholds and 1 at zero thresholds, then 3
     train steps at B = 4 as phase 3 (Waymo's schedule: 30 epochs x 7905
     iterations); (b) a synthetic tree in Waymo's processed layout (3
     sequences x 6 frames) through the port's create_waymo_gt_database,
     `tools.train` (B = 4, 1 epoch x 2 steps over every train frame, then
     a resume for a second epoch) and `tools.test` with the Waymo
     evaluation, printing every AP / APH key, data ms and step ms; (c)
     configs/waymo_models/second.yaml: one predict and one train step; (d)
     a port train state after 2 steps written as a glenet_tpu .msgpack,
     read back bit for bit, and the train CLI auto-resuming from it (count,
     lr and b1 checked); (e) after phase 7, the card against the CPU on the
     toy topology as Waymo's GLENet-S (a predict) and with SE-SSD's head,
     ATSS and MATCH_HEIGHT (a train step), as phase 7, except that at a
     ReLU input the two devices put on opposite sides of 0 (at most 4,
     each within 1e-4 of its BN's largest |output| on both; a larger flip
     fails) the CPU run takes the card's side; (f) the Waymo
     evaluation on the card against its CPU run, timed at 300 frames and
     projected to the val split's ~40 k; (g) configs/waymo_models/
     pointpillar_1x.yaml at full width (468 x 468 pillars of 0.32 m, a
     150000-pillar budget, 1.31 M anchors per scene) with seeded weights: a
     warm-up and a timed predict at B = 2, a warm-up and a timed train step
     at B = 2 (ms, pillars against the budget, anchors, peak memory, no
     merge-resolve launch); phase 6 adds the 4 captured calls of a Waymo
     predict and of a Waymo train step;
 11. KITTI's three-class detectors, [three_class] (launches counted from
     0 just before and read just after each call): (a) second_multihead.yaml,
     second_iou.yaml and pointpillar.yaml at full width with seeded weights:
     a warm-up predict, 3 predicts at B = 2 at the published thresholds and
     1 at zero thresholds (detections per class), a warm-up and 2 train
     steps at B = 4 on scenes holding Cars, Pedestrians and Cyclists at
     KITTI's label ratios (ms, loss terms, active sites against the level
     caps or pillars against the voxel budget, merge-resolve launches: 4
     per call for SECOND, 0 for PointPillars, peak memory; losses finite,
     parameters and BN stats moved); (b) phase 6 adds the 4 captured calls
     of the SECOND-IoU predict and train step; (c) after phase 7, the card
     against the CPU on the toy topology as each family (a predict, and a
     train step with SECOND-IoU's RoI targets fixed), as phase 7; (d) a
     synthetic three-class tree (8 train + 4 val frames of 120k points)
     through create_kitti_infos, then for pointpillar_newaugs.yaml and
     pointpillar_pyramid_aug.yaml `tools.train` (B = 4, 1 epoch x 2
     steps) with each yaml's augmentation queue and `tools.test` with the
     three-class KITTI evaluation, printing data ms per batch and its parts
     and the boxes gt sampling pasted per class (a class with none fails),
     then second_iou.yaml through convert_weights and `tools.test --ckpt`;
     (e) `tools.demo` over 2 scans of the tree with (d)'s checkpoint: the
     JSON lines and the HTML scenes;
 12. PV-RCNN, [pv_rcnn] (launches counted from 0 just before and read
     just after each call but the warm-up predicts): (a)
     configs/kitti_models/pv_rcnn.yaml at full width with seeded weights
     on B = 2 synthetic KITTI-like scenes: a warm-up predict that captures
     its merge-resolve calls for phase 6, 3 predicts at the published
     thresholds and 1 at zero thresholds, then a warm-up train step (also
     captured) and 2 timed ones at B = 2 (BATCH_SIZE_PER_GPU) on
     three-class scenes; per call ms, active sites against the four level
     caps, keypoints (distinct against valid points, the rest repeated),
     empty balls per source and radius, 4 merge-resolve launches, peak
     memory and every loss term (point_loss_cls included); losses finite,
     parameters and BN stats moved; (b) configs/waymo_models/pv_rcnn.yaml
     on synthetic Waymo scenes of 170000 points: a warm-up predict, 1
     predict and 1 at zero thresholds, 1 train step at B = 2, with the
     same prints; (c) after phase 7, the card against the CPU on the toy
     topology as PV-RCNN (tiny_pvrcnn_raw), f32 with TF32 off: a predict
     (keypoint indices, every ball query's indices and empty flags, final
     labels and valid flags equal, the first differing keypoint or ball
     printed with its distances if not; floats as phase 7) and a train
     step with fixed RoI targets and DP_RATIO 0, as phase 7 with [waymo]
     (e)'s ReLU alignment; (d)
     pv_rcnn.yaml through `tools.train` (B = 2, 1 epoch x 2 steps) on the
     [three_class] tree and `tools.test` with Car, Pedestrian and Cyclist
     AP keys (data ms and step ms), then a synthetic reference PV-RCNN
     .pth through convert_weights (the stage-2 keys left unconsumed) and
     `tools.test --ckpt`; phase 6 adds the 4 captured calls of the KITTI
     PV-RCNN predict and train step;
 13. the convergence harness, [convergence] (launches counted from 0 just
     before and read just after each tool's run, and per predict and per
     train-mode forward): glenet_tpu_torch.tools.convergence_ap on
     pointpillar.yaml at its full 700 steps (the last printed loss below
     the first) and on GLENet_VR.yaml for 20 steps with 2 held-out scenes;
     tools.stage2_recovery for 5 steps from that run's checkpoint (every
     stage-1 tensor equal to its checkpointed value times prod(1 - lr_t *
     0.01) within 1e-6 relative: AdamW's decay alone); tools.
     convergence_waymo on configs/waymo_models/GLENet_S.yaml for 10 steps
     and a 5-step frozen-BN tail, with its active-site lines;
     convergence_ap on pointrcnn.yaml for 10 steps.  Per run the card, ms
     per step, peak memory, final loss and AP (printed, not gated); checks
     finite losses, the evaluators' keys and 4 merge-resolve launches per
     call on the sparse families (0 on PointPillars and PointRCNN);
 14. PartA2 and PartA2-free, [parta2] (launches counted from 0 just
     before and read just after each call but the warm-up predicts): (a)
     configs/kitti_models/PartA2.yaml at full width (UNetV2 sparse at all
     four levels: 7 merge-resolve launches per call) with seeded weights
     on B = 2 synthetic KITTI-like scenes of 32768 points (test budget
     40000): a warm-up predict that captures its merge-resolve calls for
     phase 6, 3 predicts at the published thresholds and 1 at zero
     thresholds, then a warm-up train step (also captured) and 3 timed ones
     at B = 4 (train budget 16000) on three-class scenes; per call ms,
     active sites against the four level caps, valid proposals,
     detections per class, 7 merge-resolve launches, peak memory and every
     loss term (the part head's and the RCNN's included); losses finite,
     parameters and BN stats moved; (b) PartA2_free.yaml the same way;
     (c) configs/waymo_models/PartA2.yaml on synthetic Waymo scenes of
     170000 points: a warm-up, 2 predicts and 1 at zero thresholds, a
     warm-up and 2 train steps at B = 2; (d) PartA2.yaml through
     `tools.train` (B = 4, 1 epoch x 2 steps) on the [three_class] tree
     and `tools.test` with Car, Pedestrian and Cyclist AP keys; (e) after
     phase 7, the card against the CPU on the toy topology as PartA2 and
     as PartA2-free (tiny_parta2_raw), as phase 7 with [waymo] (e)'s ReLU
     alignment in the train step; phase 6 adds the 7
     captured calls of the KITTI PartA2 predict and train step;
 15. PointRCNN, [pointrcnn] (launches counted from 0 just before and read
     just after each call but the warm-up predicts: 0, PointRCNN has no
     sparse level): (a) configs/kitti_models/pointrcnn.yaml at full width
     (PointNet2MSG on 16384 points: 4096 / 1024 / 256 / 64 centres;
     PointHeadBox; PointRCNNHead over 512 pooled points per roi) with
     seeded weights: a warm-up predict, 3 predicts at B = 2 at the
     published thresholds and 1 at zero thresholds, a warm-up and 2 train
     steps at B = 2 on three-class scenes; per call ms, FPS ms (CUDA
     events around each farthest_point_sample), valid proposals,
     detections per class, every loss term, peak memory; losses finite,
     parameters and BN stats moved; (b) pointrcnn_iou.yaml: a warm-up, a
     predict and one at zero thresholds, one train step at B = 3; (c)
     pointrcnn.yaml through `tools.train` (B = 2, 1 epoch x 2 steps) on the
     [three_class] tree and `tools.test` with Car, Pedestrian and Cyclist AP
     keys; (d) after phase 7, the card against the CPU on the toy two-stage
     PointRCNN (tiny_pointrcnn_raw), f32 with TF32 off: a predict and a
     train step with fixed RoI targets, as phase 7, the CPU taking the
     card's side of each ReLU kink within rounding of 0 and of each FPS,
     ball-query or three-nn decision at a near tie (relative gap within
     1e-5; any other difference fails; point_decisions);
 16. CenterPoint and the CenterHead RPNs, [centerpoint] (launches counted
     from 0 just before and read just after each call but the warm-ups):
     (a) configs/waymo_models/centerpoint.yaml at full width
     (VoxelResBackBone8x on the 1504 x 1504 x 40 grid, budgets 80000 /
     90000, a CenterHead over the 188 x 188 map, top 500 cells, nms_gpu)
     with seeded weights on synthetic Waymo scenes of 170000 points: a
     warm-up predict that captures its merge-resolve calls for phase 6, 3
     predicts at B = 2, then phase 3's train steps at B = 4 (ms, every
     loss term, grad_norm, lr / b1, active sites against the caps, 4
     merge-resolve launches per call, peak memory; losses finite,
     parameters and BN stats moved); (b) centerpoint_without_resnet.yaml,
     centerpoint_pillar_1x.yaml, centerpoint_dyn_pillar_1x.yaml (dynamic
     voxels, DynamicPillarVFE), voxel_rcnn_with_centerhead_dyn_voxel.yaml
     (DynamicMeanVFE, CenterHead proposals into VoxelRCNNHead) and
     pv_rcnn_with_centerhead_rpn.yaml: one predict at B = 2 and one train
     step each (4 launches per call, 0 on the pillar configs); (c)
     centerpoint.yaml through `tools.train` (B = 4, 1 epoch x 2 steps) and
     `tools.test` with the three-class Waymo evaluation on [waymo]'s tree;
     (d) `tools.convergence_waymo` on its default yaml, centerpoint.yaml,
     for 10 steps and a 5-step frozen-BN tail; (e) after phase 7, the card
     against the CPU on the toy topology as CenterPoint
     (tiny_centerpoint_raw): a predict and a train step, as phase 7 with
     [waymo] (e)'s ReLU alignment; phase 6 adds the 4 captured calls of
     the CenterPoint predict and train step;
 17. PV-RCNN++, [pvrcnn_plusplus] (launches counted from 0 just before and
     read just after each call but the warm-up predict): (a)
     configs/waymo_models/pv_rcnn_plusplus.yaml at full width
     (VoxelBackBone8x on the 1504 x 1504 x 40 grid, budgets 80000 / 90000,
     CenterHead proposals, 4096 SPC keypoints, VectorPool over bev,
     x_conv3, x_conv4 and raw_points with RoI-filtered neighbours,
     RoI-grid VectorPool) with seeded weights on synthetic Waymo scenes of
     170000 points: a warm-up predict that captures its merge-resolve
     calls for phase 6, 2 predicts at B = 2, a warm-up train step (also
     captured) and 2 timed ones at B = 2; per call ms, active sites
     against the caps, keypoints against the SPC mask and the valid
     points, per source the points left by the RoI filter, per VectorPool
     group the share of empty sub-voxels, 4 merge-resolve launches, peak
     memory and every loss term with grad_norm; losses finite, parameters
     and BN stats moved; the host syncs of one more predict and step; the
     first predict's neighbour searches on the card against the CPU on a
     subset of queries (picks of another point only within the expanded
     distance's rounding); (b) pv_rcnn_plusplus_resnet.yaml: one predict
     and one train step; (c) pv_rcnn_plusplus.yaml through `tools.train`
     (B = 2, 1 epoch x 2 steps) and `tools.test` on [waymo]'s tree; (d)
     `tools.convergence_waymo` on pv_rcnn_plusplus.yaml for 10 steps and a
     5-step frozen-BN tail; (e) after phase 7, the card against the CPU on
     the toy topology as PV-RCNN++ (tiny_pvpp_raw): a predict and a train
     step with fixed RoI targets, the CPU taking the card's FPS picks and
     VectorPool neighbours at near ties and the card's side of ReLU
     kinks; phase 6 adds the 4 captured calls of the predict and train
     step;
 18. CaDDN, [caddn] (merge-resolve launches counted from 0 just before
     and read just after each call but the warm-ups: 0, no voxels and no
     sparse level): (a) configs/kitti_models/CaDDN.yaml at full width
     (DDNLite, 80 LID bins, images padded to 376 x 1248, the 280 x 376 x
     25 grid of voxel centres sampled from the (80, 94, 312, 64) frustum
     volume through its bf16 copy, Conv2DCollapse from 1600 channels,
     BaseBEVBackbone [10, 10, 10], AnchorHeadSingle, nms_gpu) with seeded
     weights on synthetic KITTI-like camera batches: a warm-up predict,
     N_REQUESTS predicts at B = 2, a warm-up train step and 2 timed ones
     at B = 4; per call ms, every loss term with grad_norm, peak memory,
     the share of voxel centres in the image, the host syncs of one more
     predict and step; losses finite, parameters and BN stats moved; (b)
     CaDDN_deeplab.yaml (DDNDeepLabV3, ResNet-101): a predict at B = 2 and
     a train step at the largest of 4, 2, 1 that fits; (c) CaDDN.yaml
     through `tools.train` (B = 4, 1 epoch x 2 steps) and `tools.test`
     with the KITTI evaluation on a synthetic tree with image_2 / depth_2
     PNGs; (d) `tools.convergence_caddn` for 10 steps; (e) after phase 7,
     the card against the CPU on the toy CaDDN, f32 with TF32 off and the
     bf16 gather: a predict and a train step, the CPU taking the card's
     side of ReLU kinks and of bf16 ties of the gather, each within its
     bound;
 19. nuScenes, Lyft and Pandaset, [nuscenes] (launches counted from 0
     just before and read just after each call but the warm-ups): (a) the
     run-time config nuscenes_centerpoint (config.run_cfg_dict:
     centerpoint.yaml's model over nuscenes_dataset.yaml, the 10 nuScenes
     classes in one CenterHead group; VoxelResBackBone8x on the 1024 x
     1024 x 40 grid, budgets 60000 / 60000) at full width with seeded
     weights on synthetic nuScenes scenes (a key frame and 9 sweeps of
     34000 points with their time lags, capped at 262144): a warm-up
     predict that captures its merge-resolve calls for phase 6, N_REQUESTS
     predicts at B = 2, a warm-up train step (also captured) and
     TRAIN_STEPS timed ones at B = 4 (ms, loss terms, active sites against
     the caps, 4 launches per call, peak memory, host syncs), then the
     config through `tools.train` (B = 4, 2 epochs x 2 steps) and
     `tools.test` with the NDS on a 12-frame synthetic nuScenes tree, data
     ms per batch split into sweeps, gt sampling, world augmentations and
     the rest; (b) lyft_second_multihead (second_multihead.yaml's model
     with the sin/cos box coder over lyft_dataset.yaml; 1600 x 1600 x 40):
     a predict at B = 2 (captured for phase 6) and a train step at B = 4,
     then the CLIs on an 8-frame Lyft tree with the Lyft mAP, its 3D IoUs
     on the card; (c) pandaset_second (second.yaml's model over
     pandaset_dataset.yaml; 2800 x 1600 x 40, 170000 points a frame):
     `tools.train` for 2 steps at B = 4 and `tools.test` with the
     KITTI-format AP; (d) the option pieces on the card against the CPU:
     nms_normal over 4096 boxes, soft_nms in both modes over 1024, MLP,
     PreviousResidualDecoder and the sin/cos encode / decode; (e) after
     phase 7, a toy detector with UPSAMPLE_STRIDES [0.5, 1, 2]
     (fractional_raw) on the card against the CPU, a predict and a train
     step as phase 7; phase 6 adds the 4 captured calls of the nuScenes
     predict and train step and of the Lyft predict;
 20. training across processes, [parallel] (after the main paths, in
     the [cli] block): (a) GLENet_VR.yaml at full width, B = 2 per rank on
     two gloo ranks spawned on cuda:0 (NCCL is tried first with two ranks
     on the one card and its refusal printed), rank 1 built from other
     weights than rank 0's until put_replicated; one data-parallel step
     on phase 3's training scenes against the one-process B = 4 step on
     the same scenes and start weights, both in f32 with TF32 off: every
     integer output (anchor targets, proposals, sampled RoIs,
     reg_valid_mask, merge-resolve tables) equal on the rank's rows, loss
     terms, gradients, parameters and BN stats within phase 7's bounds,
     BN buffers bit-equal across the ranks; then one step in the default
     dtypes per rank, launches counted from 0 just before and read just
     after: step ms, the gradient all-reduce's ms and bytes, the other
     all-reduces' count and ms, 4 merge-resolve launches, peak memory;
     rank 0's captured calls against the plain version as phase 6; (b) the
     (data, model) mesh (1, 2): one step with half of every large kernel
     on each rank, against the same reference (or the collective gloo
     lacks on CUDA tensors, printed); (c) `tools.train` through
     --coordinator_address / --num_processes 1 / --process_id 0 (NCCL) on
     the [cli] tree, 1 epoch x 2 steps with --eval_after_train: the
     checkpoint and the AP keys;
 21. the x-block gather-GEMM kernel, [xblock] (csrc/xblock_gemm.cu, after
     phase 6): the kernel against its plain version
     (ops/sparse.py::gather_gemm_xblocks_plain) on synthetic tables, Cin
     3 / 4 / 5 / 16 / 32 / 128 x Cout 16 / 32 / 64 at B = 1 and 4 (a
     ragged last tile), Cin 64 with Cout 128 and the float32 switch,
     tables with every tap missing, isolated sites, a full table and q at
     its last rows (hits past V read as zeros), an unaligned feature
     pointer, an odd Cout and a strided table; both autograd Functions'
     forward, d_features and d_weights against the plain composition;
     then the captured calls of a Waymo CenterPoint predict at B = 1 and a
     Waymo GLENet-S train step at B = 4 (full width, seeded weights): each
     against the plain version, the kernel's device and back-to-back ms,
     the plain version's ms and the byte bound, and the launches (11 a
     request, 9 a step).  Tolerance: both sides sum the same exact
     products (bf16 times bf16 fits float32) in float32, each in its own
     order, so they lie within 2 gamma_n S, S the sum of the products'
     magnitudes; the gap's norm besides within 2^-5 of the reference's.
     Besides, every warm-up predict or train step that captures
     merge-resolve calls for phase 6 (every sparse family of phases 2-20,
     the parallel ranks' step included) runs inside XBLOCK.checked: each
     of its kernel launches is held against the plain version as it
     happens, and their count against the x-block convs the model ran;
 22. one `{"kernels": [...]}` line; last line `{"ok": true, "device": ...}`.

Needs one CUDA device and the repository checkout around this file.
"""
from __future__ import annotations

import contextlib
import json
import math
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0


class LaunchCount:
    """Launches of the merge-resolve kernel (not of its plain version)
    since `n` was last set to 0.  The port counts them (`merge_launches`,
    glenet_tpu_torch/utils/trace.py) only while a profiler records, and the
    main paths here run without one, so `install` wraps the launch."""

    def __init__(self):
        self.n = 0

    def install(self):
        from glenet_tpu_torch.ops import merge_kernel
        real = merge_kernel._resolve_cuda

        def counted(*args, **kwargs):
            out = real(*args, **kwargs)
            self.n += 1
            return out

        merge_kernel._resolve_cuda = counted


LAUNCHES = LaunchCount()


class XBlockLaunches:
    """Launches of the x-block gather-GEMM kernel since `n` was last set to
    0.  The port counts them (`xblock_gemm_launches`) only while a profiler
    records, so `install` wraps the launch, ops/xblock_gemm.py's
    gather_gemm.  Inside `checked(what)` each launch is also held against
    the plain version (xblock_check), and the launches against the x-block
    convs the model ran: one per SubMConvBN or 3^3 SparseConvBN call, and
    one more per SubMConvBN whose input takes a gradient (its d_features
    in the backward)."""

    def __init__(self):
        self.n = 0
        self.window = None      # the label of the checked window
        self.first = 0          # n when that window opened
        self.worst = 0.0        # the worst gap ratio of a checked launch
        self.windows = {}       # label -> launches in that window
        self.installed = False

    def install(self):
        if self.installed:
            return
        from glenet_tpu_torch.ops import xblock_gemm
        real = xblock_gemm.gather_gemm

        def counted(features, q, tbl, weights, round_bf16):
            out = real(features, q, tbl, weights, round_bf16)
            self.n += 1
            if self.window is not None:
                self.worst = max(self.worst, xblock_check(
                    f'{self.window} launch {self.n - self.first}', features,
                    q, tbl, weights, f32=not round_bf16, got=out))
            return out

        xblock_gemm.gather_gemm = counted
        self.installed = True

    @contextlib.contextmanager
    def checked(self, what):
        import torch

        from glenet_tpu_torch.models.spconv_backbone import (SparseConvBN,
                                                             SubMConvBN)
        convs = [0]

        def pre(module, args):
            if isinstance(module, SubMConvBN):
                convs[0] += 1 + (torch.is_grad_enabled()
                                 and args[0].requires_grad)
            elif (isinstance(module, SparseConvBN)
                  and module.kernel_size == (3, 3, 3)):
                convs[0] += 1

        self.install()
        hook = torch.nn.modules.module.register_module_forward_pre_hook(pre)
        self.window, self.first = what, self.n
        try:
            yield
        finally:
            hook.remove()
            self.window = None
        n = self.n - self.first
        print(f'[xblock] {what}: {n} launches, each == plain within 2 '
              f'gamma_n S ({convs[0]} x-block contractions of the convs)')
        check(n == convs[0],
              f'xblock_gemm {what}: {n} launches for {convs[0]} x-block '
              f'contractions of the convs')
        self.windows[what] = n


XBLOCK = XBlockLaunches()


def capture_calls(fn, what):
    """bench_merge.capture_calls (the merge-resolve calls of fn(), which
    phase 6 checks) inside XBLOCK.checked(what): each x-block kernel
    launch of fn() held against its plain version, their count against the
    convs fn() ran."""
    from glenet_tpu_torch import bench_merge
    with XBLOCK.checked(what):
        return bench_merge.capture_calls(fn)
N_REQUESTS, BATCH, N_POINTS = 3, 2, 32768
TRAIN_STEPS = 3
# the CLI phase's synthetic KITTI-layout tree and batch
CLI_TRAIN, CLI_VAL, CLI_POINTS, CLI_BATCH = 16, 4, 120_000, 4
KITTI_VAL_FRAMES = 3769
# the CVAE phase: KITTI's train-split gt database as OpenPCDet counts it
# (Car and Van, both taken with ENABLE_SIMILAR_TYPE), fold 0 of 10
CVAE_CARS, CVAE_VANS, CVAE_FOLDS, CVAE_PASSES = 14357, 1297, 10, 30
CVAE_STEPS = 20
WAYMO_CROPS = 640

# Toy two-stage GLENet-VR topology (MeanVFE -> VoxelBackBone8x ->
# BaseBEVBackbone -> AnchorHeadSingle -> VoxelRCNNKLLabelIoUHead), the
# model the port's CPU parity tests hold against glenet_tpu, on KITTI's z
# range so the BEV fold has depth 2 as at full width.
TINY_RANGE = (0, -8, -3, 16, 8, 1)
TINY_CFG = {
    'CLASS_NAMES': ['Car'],
    'DATA_CONFIG': {
        'POINT_CLOUD_RANGE': list(TINY_RANGE),
        'DATA_PROCESSOR': [{
            'NAME': 'transform_points_to_voxels',
            'VOXEL_SIZE': [0.5, 0.5, 0.1],
            'MAX_POINTS_PER_VOXEL': 5,
            'MAX_NUMBER_OF_VOXELS': {'train': 512, 'test': 512}}],
    },
    'MODEL': {
        'NAME': 'VoxelRCNN',
        'VFE': {'NAME': 'MeanVFE'},
        'BACKBONE_3D': {'NAME': 'VoxelBackBone8x'},
        'MAP_TO_BEV': {'NAME': 'HeightCompression', 'NUM_BEV_FEATURES': 256},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [2, 2],
                        'LAYER_STRIDES': [1, 2], 'NUM_FILTERS': [32, 64],
                        'UPSAMPLE_STRIDES': [1, 2],
                        'NUM_UPSAMPLE_FILTERS': [32, 32]},
        'DENSE_HEAD': {
            'NAME': 'AnchorHeadSingle', 'CLASS_AGNOSTIC': False,
            'USE_DIRECTION_CLASSIFIER': True, 'DIR_OFFSET': 0.78539,
            'DIR_LIMIT_OFFSET': 0.0, 'NUM_DIR_BINS': 2,
            'ANCHOR_GENERATOR_CONFIG': [{
                'class_name': 'Car', 'anchor_sizes': [[3.9, 1.6, 1.56]],
                'anchor_rotations': [0, 1.57],
                'anchor_bottom_heights': [-1.0], 'align_center': False,
                'feature_map_stride': 8, 'matched_threshold': 0.6,
                'unmatched_threshold': 0.45}],
            'TARGET_ASSIGNER_CONFIG': {'BOX_CODER': 'ResidualCoder'},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'cls_weight': 1.0, 'loc_weight': 2.0, 'dir_weight': 0.2,
                'code_weights': [1.0] * 7}},
        },
        'ROI_HEAD': {
            'NAME': 'VoxelRCNNKLLabelIoUHead', 'CLASS_AGNOSTIC': True,
            'SHARED_FC': [32, 32], 'CLS_FC': [32], 'REG_FC': [32],
            'DP_RATIO': 0.3,
            'NMS_CONFIG': {
                'TRAIN': {'NMS_TYPE': 'nms_gpu', 'NMS_PRE_MAXSIZE': 512,
                          'NMS_POST_MAXSIZE': 64, 'NMS_THRESH': 0.8},
                'TEST': {'NMS_TYPE': 'nms_gpu', 'NMS_PRE_MAXSIZE': 256,
                         'NMS_POST_MAXSIZE': 32, 'NMS_THRESH': 0.7,
                         'SCORE_THRESH': 0.0}},
            'ROI_GRID_POOL': {
                'FEATURES_SOURCE': ['x_conv2', 'x_conv3', 'x_conv4'],
                'GRID_SIZE': 4,
                'POOL_LAYERS': {'x_conv2': {'MLPS': [[16, 16]]},
                                'x_conv3': {'MLPS': [[16, 16]]},
                                'x_conv4': {'MLPS': [[16, 16]]}}},
            'TARGET_CONFIG': {
                'BOX_CODER': 'ResidualCoder', 'ROI_PER_IMAGE': 32,
                'FG_RATIO': 0.5, 'SAMPLE_ROI_BY_EACH_CLASS': True,
                'CLS_SCORE_TYPE': 'roi_iou', 'CLS_FG_THRESH': 0.75,
                'CLS_BG_THRESH': 0.25, 'CLS_BG_THRESH_LO': 0.1,
                'HARD_BG_RATIO': 0.8, 'REG_FG_THRESH': 0.55},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'rcnn_cls_weight': 1.0, 'rcnn_reg_weight': 1.0,
                'rcnn_corner_weight': 1.0, 'code_weights': [1.0] * 7}},
        },
        'POST_PROCESSING': {
            'SCORE_THRESH': 0.1,
            'NMS_CONFIG': {'MULTI_CLASSES_NMS': False,
                           'NMS_TYPE': 'new_nms_gpu', 'NMS_THRESH': 0.1,
                           'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 32}},
    },
    'OPTIMIZATION': {
        'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': 1, 'OPTIMIZER': 'adam_onecycle',
        'LR': 0.003, 'WEIGHT_DECAY': 0.01, 'MOMS': [0.95, 0.85],
        'PCT_START': 0.4, 'DIV_FACTOR': 10, 'GRAD_NORM_CLIP': 10},
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def tiny_batch(seed, b=2, n_points=1024, features=4):
    """Uniform toy points in TINY_RANGE; a 5th (elongation) column, drawn
    last, when features=5."""
    import numpy as np
    x0, y0, z0, x1, y1, z1 = TINY_RANGE
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n_points, features), np.float32)
    pts[..., 0] = rng.uniform(x0, x1, (b, n_points))
    pts[..., 1] = rng.uniform(y0, y1, (b, n_points))
    pts[..., 2] = rng.uniform(z0 + 0.1, z1 - 0.1, (b, n_points))
    pts[..., 3] = rng.uniform(0, 1, (b, n_points))
    if features == 5:
        pts[..., 4] = rng.uniform(0, 1, (b, n_points))
    return pts


def n_features(cfg):
    enc = cfg.DATA_CONFIG.get('POINT_FEATURE_ENCODING', None)
    return 4 if enc is None else len(enc['used_feature_list'])


def phase_setup(kernels):
    import torch

    from glenet_tpu_torch.ops import cuda_lib
    from glenet_tpu_torch.utils.cuda_timing import card_line
    line = card_line()
    print(f'[setup] card: {line}')
    print(f'[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'device {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    logs = cuda_lib.build_all(kernels, verbose=True)
    print(f'[setup] built {len(kernels)} kernel(s) in '
          f'{time.perf_counter() - t0:.2f} s')
    for name, log in logs.items():
        for ln in log.splitlines():
            if 'registers' in ln or 'spill' in ln:
                print(f'[setup] {name}: {ln.strip()}')
    return line


def adversarial_merge_cases():
    import torch
    g = torch.Generator().manual_seed(SEED)

    def srt(t, dim=-1):
        return torch.sort(t, dim=dim).values.to(torch.int32)

    def rand(lo, hi, shape):
        return srt(torch.randint(lo, hi, shape, generator=g))

    cases = {}
    ids = rand(0, 5000, (2, 700))
    cases['random'] = (ids, rand(-10, 5100, (2, 9, 900)))
    cases['all_sentinel'] = (torch.full((2, 512), 1000, dtype=torch.int32),
                             rand(0, 1001, (2, 3, 600)))
    ids = rand(10_000, 20_000, (1, 4000))
    cases['below_table'] = (ids, rand(0, 12_000, (1, 9, 3000)))
    ids = rand(0, 90_000_000, (2, 5000))
    cases['negative_raw'] = (ids, rand(-2_000_000, 90_000_100, (2, 9, 5000)))
    v = (1 << 20) - 1
    ids = rand(0, 1 << 26, (1, v))
    cases['v_near_2^20'] = (ids, rand(-5, (1 << 26) + 5, (1, 9, 200_000)))
    # windows far wider than the kernel's shared buffer
    ids = rand(0, 1 << 26, (2, 1_000_000))
    cases['wide_windows'] = (ids, rand(-5, (1 << 26) + 5, (2, 3, 3000)))
    # ragged last tile (Vq not a multiple of the kernel's tile)
    ids = rand(0, 20_000, (2, 5000))
    cases['ragged_vq'] = (ids, rand(-3, 20_003, (2, 9, 5001)))
    cases['vq_1'] = (rand(0, 5000, (2, 700)), rand(-10, 5010, (2, 9, 1)))
    cases['v_1'] = (torch.tensor([[40], [7]], dtype=torch.int32),
                    rand(0, 50, (2, 3, 3000)))
    ids = rand(0, 1000, (2, 3000))
    eq = torch.stack([ids[:, 1500], ids[:, 1500] + 1, ids[:, 0] - 5,
                      ids[:, -1] + 7], dim=1)                     # (2, 4)
    cases['equal_queries'] = (ids, eq[:, :, None].expand(2, 4, 4100)
                              .contiguous())
    n_cells = 1_000_000
    ids = torch.cat([rand(0, n_cells, (2, 10_000)),
                     torch.full((2, 30_000), n_cells, dtype=torch.int32)], 1)
    cases['sentinel_runs'] = (ids, rand(-2, n_cells + 6, (2, 9, 40_000)))
    ids = rand(0, 50_000, (2, 8000))
    cases['past_table'] = (ids, rand(50_000, 1 << 30, (2, 9, 6000)))
    cases['below_all'] = (ids, rand(-(1 << 30), 0, (2, 9, 6000)))
    ids = rand(0, 200_000, (1, 50_000))
    cases['b1_g1'] = (ids, rand(-5, 200_005, (1, 1, 60_000)))
    return cases


def max_abs_err(got, ref):
    return max(int((a.long() - b.long()).abs().max()) for a, b in
               zip(got, ref))


def check_captured(captured, what, names=None):
    """Kernel == plain on the captured calls of one predict or train step
    (4 of VoxelBackBone8x, CALL_NAMES, unless `names` says otherwise);
    their summed times."""
    from glenet_tpu_torch.bench_merge import CALL_NAMES, fmt, measure_call
    from glenet_tpu_torch.ops import merge_kernel as mk
    from glenet_tpu_torch.utils import cuda_timing as ct
    names = names or CALL_NAMES
    check(len(captured) == len(names), f'expected {len(names)} table builds '
                                       f'per {what}, saw {len(captured)}')
    keys = ('ms', 'device_ms', 'host_ms', 'cold_ms', 'plain_ms',
            'library_ms', 'library_device_ms', 'bound_ms')
    tot = dict.fromkeys(keys, 0.0)
    bound_by = set()
    for name, (ids, q) in zip(names, captured):
        got, wide, glob = mk.resolve_sorted_queries_counted(ids, q)
        err = max_abs_err(got, mk.resolve_sorted_queries_plain(ids, q))
        check(err == 0, f'merge_resolve differs on captured {what} call '
                        f'{name}')
        r = measure_call(ids, q)
        r['plain_ms'] = ct.event_ms(
            lambda: mk.resolve_sorted_queries_plain(ids, q))
        bound_by.add(r['bound_by'])
        print(f'[kernel] merge_resolve {what} {name}: ids '
              f'{tuple(ids.shape)} queries {tuple(q.shape)} max_abs_err '
              f'{err}, wide tiles {wide} (global groups {glob}); kernel '
              f'device {fmt(r["device_ms"])} ms, back-to-back '
              f'{fmt(r["ms"])}, host {fmt(r["host_ms"])}, cold '
              f'{fmt(r["cold_ms"])}; plain {fmt(r["plain_ms"])}; '
              f'torch.searchsorted (pos only) device '
              f'{fmt(r["library_device_ms"])}, back-to-back '
              f'{fmt(r["library_ms"])}; bound {r["bound_ms"]:.4f} '
              f'({r["bound_by"]})')
        for k in keys:
            tot[k] = None if tot[k] is None or r[k] is None else tot[k] + r[k]
    print(f'[kernel] merge_resolve per {what} ({len(names)} calls): '
          + ', '.join(f'{k} {fmt(v)}' for k, v in tot.items()))
    return {'bound_by': '/'.join(sorted(bound_by)), **tot}


def phase_merge_check(captured, captured_train, captured_single):
    """Kernel == plain on adversarial and captured cases; times."""
    from glenet_tpu_torch.ops import merge_kernel as mk
    max_err, n_wide, n_global = 0, 0, 0
    for name, (ids, q) in adversarial_merge_cases().items():
        ids, q = ids.cuda(), q.cuda()
        got, wide, glob = mk.resolve_sorted_queries_counted(ids, q)
        err = max_abs_err(got, mk.resolve_sorted_queries_plain(ids, q))
        print(f'[kernel] merge_resolve {name}: ids {tuple(ids.shape)} '
              f'queries {tuple(q.shape)} max_abs_err {err}, tiles on the '
              f'wide-window path {wide} (query groups from global memory '
              f'{glob})')
        check(err == 0, f'merge_resolve differs from its plain version on '
                        f'{name}')
        max_err = max(max_err, err)
        n_wide, n_global = n_wide + wide, n_global + glob
    check(n_wide > 0 and n_global > 0,
          'the adversarial cases missed a path of the kernel')
    return {'max_abs_err': max_err, **check_captured(captured, 'predict'),
            'train': check_captured(captured_train, 'train step'),
            'single': check_captured(captured_single, 'GLENet-C predict')}


XBLOCK_U = 2.0 ** -24        # float32's unit roundoff
# the gap's norm against the reference's: a gradient summed in bf16 in
# another order lies within ~2^-8 of it; a zeroed, halved or sign-flipped
# one is 0.5 to 2 of it away
XBLOCK_REL = 2.0 ** -5


def xblock_tables(seed, b, v, grid=(160, 160, 12), density=0.3,
                  sentinel=0.1):
    """(ids, mask) of `b` samples on the card: v slots, the first
    v (1 - sentinel) holding active cells drawn at `density` from the first
    cells of the grid (whole x rows, so taps hit), the rest the sentinel."""
    import torch
    g = torch.Generator().manual_seed(seed)
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    n_act = int(v * (1 - sentinel))
    span = min(n_cells, max(n_act, int(n_act / density)))
    ids = torch.full((b, v), n_cells, dtype=torch.int32)
    for i in range(b):
        ids[i, :n_act] = torch.randperm(span, generator=g)[:n_act].sort(
        ).values.to(torch.int32)
    return ids.cuda(), (ids < n_cells).cuda()


def xblock_bound(n, s, u=XBLOCK_U):
    """Two sums of the same n products, each in its own order, lie within
    2 gamma_n S of each other (gamma_n = n u / (1 - n u), S the sum of the
    products' magnitudes, u the unit roundoff of the sums): the tolerance
    of the kernel against its plain version.  With bf16 operands the
    products are exact in float32 (8-bit significands); with float32 ones
    each is rounded once: n + 1 terms."""
    gamma = (n + 1) * u / (1 - (n + 1) * u)
    return 2 * gamma * s


def xblock_compare(what, got, ref, s, n, u=XBLOCK_U, round_u=0.0):
    """|got - ref| <= xblock_bound(n, s, u) everywhere (plus, where both
    sums are then rounded to a unit roundoff round_u, round_u (|got| +
    |ref|)), and the gap's norm within XBLOCK_REL of the reference's ->
    the worst ratio of the gap to (n + 1) u S."""
    gap = (got - ref).abs()
    bound = xblock_bound(n, s, u) + round_u * (got.abs() + ref.abs())
    bad = int((gap > bound).sum())
    check(bad == 0, f'xblock_gemm {what}: {bad} elements past 2 gamma_n S '
                    f'(worst gap {float(gap.max()):.3e})')
    rel = float(gap.norm()) / max(float(ref.norm()), 1e-30)
    check(rel <= XBLOCK_REL, f'xblock_gemm {what}: |gap| {rel:.3e} of '
                             f'|reference|')
    scale = (n + 1) * u * s
    live = scale > 0
    check(bool((gap[~live] == 0).all()),
          f'xblock_gemm {what}: nonzero where every product is zero')
    return float((gap[live] / scale[live]).max()) if live.any() else 0.0


def xblock_check(what, f, q, tbl, w, f32=False, got=None):
    """The kernel against the plain version on one call, both in the bf16
    operands of the main path (or float32 with f32); `got`, the kernel's
    output, if it has already run."""
    import torch

    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.ops import xblock_gemm as xg
    saved = sparse.GATHER_COMPUTE_DTYPE
    sparse.GATHER_COMPUTE_DTYPE = None if f32 else torch.bfloat16
    try:
        if got is None:
            got = xg.gather_gemm(f, q, tbl, w, not f32)
        ref = sparse.gather_gemm_xblocks_plain(f, q, tbl, w)
        s = sparse.gather_gemm_xblocks_plain(f.abs(), q, tbl, w.abs())
    finally:
        sparse.GATHER_COMPUTE_DTYPE = saved
    torch.cuda.synchronize()
    check(got.dtype == torch.float32 and got.shape == ref.shape,
          f'xblock_gemm {what}: {got.dtype} {tuple(got.shape)}')
    return xblock_compare(what, got, ref, s, 27 * f.shape[-1])


def xblock_adversarial():
    """The kernel against its plain version on synthetic tables: every
    Cin of the families but 64 (3, 4 and 5 of conv_input, 16, 32, 128)
    times Cout 16 / 32 / 64 at B = 1 and 4, Cin 64 in the edge cases.
    Returns the worst gap ratio."""
    import torch

    from glenet_tpu_torch.ops import sparse
    worst, n = 0.0, 0
    grid = (160, 160, 12)
    gen = torch.Generator().manual_seed(SEED + 23)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    for b in (1, 4):
        for cin in (3, 4, 5, 16, 32, 128):
            for cout in (16, 32, 64):
                v = 3001 if cin <= 5 else 2048    # a ragged last tile too
                ids, mask = xblock_tables(SEED + cin + cout + b, b, v, grid)
                q, tbl = sparse.subm_xblock_table_b(ids, mask, grid)
                r = xblock_check(f'B={b} Cin={cin} Cout={cout}',
                                 rand(b, v, cin), q, tbl,
                                 rand(27, cin, cout, scale=0.1))
                worst, n = max(worst, r), n + 1
    ids, mask = xblock_tables(SEED + 1, 2, 4000, grid)
    q, tbl = sparse.subm_xblock_table_b(ids, mask, grid)
    f, w = rand(2, 4000, 32), rand(27, 32, 32, scale=0.1)
    # every tap missing: the sums are exactly zero
    zero = sparse._xblock_contract(f, q, torch.zeros_like(tbl), w)
    check(bool((zero == 0).all()), 'xblock_gemm: nonzero output with no '
                                   'hit')
    cases = {
        # the f32 switch, at the widths of the UNetV2 merge convs' backward
        'f32 Cin=64 Cout=128': (rand(2, 4000, 64), q, tbl,
                                rand(27, 64, 128, scale=0.1), True),
        'f32 Cin=128 Cout=64': (rand(2, 4000, 128), q, tbl,
                                rand(27, 128, 64, scale=0.1), True),
        'bf16 Cin=64 Cout=128': (rand(2, 4000, 64), q, tbl,
                                 rand(27, 64, 128, scale=0.1), False),
        'f32 Cin=5 Cout=16': (rand(2, 4000, 5), q, tbl,
                              rand(27, 5, 16, scale=0.1), True),
        # a feature pointer off 16 bytes: the 4-byte gather
        'unaligned features': (torch.empty(2 * 4000 * 32 + 1, device='cuda')
                               [1:].copy_(f.reshape(-1)).view(2, 4000, 32),
                               q, tbl, w, False),
        # odd Cout: the scalar stores of the epilogue
        'Cout=3': (f, q, tbl, rand(27, 32, 3, scale=0.1), False),
    }
    # sparse sites: almost every neighbour missing
    ids, mask = xblock_tables(SEED + 2, 2, 4000, grid, density=0.002)
    cases['isolated sites'] = (f, *sparse.subm_xblock_table_b(ids, mask,
                                                              grid), w, False)
    # a full table (no sentinel slot), and q at its last rows with random
    # bits, so that a hit's rank points past V: those rows read as zero
    ids, mask = xblock_tables(SEED + 3, 2, 4000, grid, sentinel=0.0)
    qf, tf = sparse.subm_xblock_table_b(ids, mask, grid)
    cases['full table'] = (f, qf, tf, w, False)
    qe = (4000 - 1 - torch.randint(0, 3, qf.shape, generator=gen)).to(
        torch.int32).cuda()
    te = torch.randint(0, 32, qf.shape, generator=gen).to(torch.int32).cuda()
    cases['q at the last rows'] = (f, qe, te, w, False)
    # a strided table: 16 -> 32 channels into a coarser grid
    ids, mask = xblock_tables(SEED + 4, 2, 4000, grid)
    sites = [sparse.strided_output_sites(ids[i], mask[i], grid, 3, 2, 1,
                                         3000) for i in range(2)]
    oi = torch.stack([s_[0] for s_ in sites])
    om = torch.stack([s_[1] for s_ in sites])
    qs, ts = sparse.strided_xblock_table_b(ids, mask, oi, om, grid, 2, 1)
    cases['strided 16 -> 32'] = (rand(2, 4000, 16), qs, ts,
                                 rand(27, 16, 32, scale=0.1), False)
    for what, (f_, q_, t_, w_, f32) in cases.items():
        worst = max(worst, xblock_check(what, f_, q_, t_, w_, f32))
        n += 1
    print(f'[xblock] kernel == plain within 2 gamma_n S on {n} synthetic '
          f'cases and an all-miss table (exact zeros); worst gap '
          f'{worst:.3f} of (n + 1) u S')
    return worst


def xblock_grads():
    """Both autograd Functions on the card against the plain composition,
    same inputs.  The submanifold one against the plain version of its own
    backward (d_features the contraction of g with the flipped taps,
    d_weights per_tap^T g of bf16 operands); the strided one against
    autograd of the plain composition, whose d_features sums bf16 rows with
    index_add_ (atomics, in no fixed order): its bound takes bf16's unit
    roundoff and its count of adds; its d_weights are float32 sums rounded
    to bf16 (the weights' operand dtype), one rounding more on each side.
    S from the same computations on the magnitudes; every gap's norm is
    besides within XBLOCK_REL of the reference's, which a zeroed, halved
    or sign-flipped gradient is not."""
    import torch

    from glenet_tpu_torch.ops import sparse
    gen = torch.Generator().manual_seed(SEED + 29)
    grid = (160, 160, 12)
    ids, mask = xblock_tables(SEED + 5, 2, 4000, grid)
    sites = [sparse.strided_output_sites(ids[i], mask[i], grid, 3, 2, 1,
                                         3000) for i in range(2)]
    oi = torch.stack([s_[0] for s_ in sites])
    om = torch.stack([s_[1] for s_ in sites])
    tables = {'subm': sparse.subm_xblock_table_b(ids, mask, grid),
              'strided': sparse.strided_xblock_table_b(ids, mask, oi, om,
                                                       grid, 2, 1)}

    def autograd(fn, f, q, tbl, w, g):
        f, w = f.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(f, q, tbl, w)
        out.backward(g)
        return out.detach(), f.grad, w.grad

    def subm_plain(f, q, tbl, w, g):
        per_tap = sparse._xblock_per_tap_b(f, q, tbl)
        dw = sparse._contract('bgvk,bvo->gko', per_tap, g.to(per_tap.dtype))
        return (sparse.gather_gemm_xblocks_plain(f, q, tbl, w),
                sparse.gather_gemm_xblocks_plain(g, q, tbl,
                                                 sparse.flip_tap_weights(w)),
                dw.reshape(w.shape))

    worst = 0.0
    for kind, (q, tbl) in tables.items():
        for cin, cout in ((16, 32), (32, 16)):
            f = torch.randn(2, 4000, cin, generator=gen).cuda()
            w = (torch.randn(27, cin, cout, generator=gen) * 0.1).cuda()
            g = torch.randn(2, q.shape[2], cout, generator=gen).cuda()
            if kind == 'subm':
                got = autograd(sparse.subm_gather_gemm_xblocks_b, f, q, tbl,
                               w, g)
                ref = subm_plain(f, q, tbl, w, g)
                mag = subm_plain(f.abs(), q, tbl, w.abs(), g.abs())
                u_df, round_dw = XBLOCK_U, 0.0
            else:
                got = autograd(sparse.gather_gemm_xblocks_b, f, q, tbl, w, g)
                plain = sparse.gather_gemm_xblocks_plain
                ref = autograd(plain, f, q, tbl, w, g)
                mag = autograd(plain, f.abs(), q, tbl, w.abs(), g.abs())
                u_df = round_dw = 2.0 ** -8
            # the bf16 scatter adds at most 27 reads and 2 shifted copies
            # into an element
            n_df = 27 * cout if kind == 'subm' else 29
            torch.cuda.synchronize()
            tag = f'{kind} Cin={cin} Cout={cout}'
            worst = max(worst,
                        xblock_compare(f'{tag} out', got[0], ref[0], mag[0],
                                       27 * cin),
                        xblock_compare(f'{tag} d_features', got[1], ref[1],
                                       mag[1], n_df, u_df),
                        xblock_compare(f'{tag} d_weights', got[2], ref[2],
                                       mag[2], 2 * q.shape[2],
                                       round_u=round_dw))
    print(f'[xblock] both autograd Functions (subm, strided) == the plain '
          f'composition: out, d_features, d_weights within 2 gamma_n S '
          f'and within {XBLOCK_REL} of the reference in norm; '
          f'worst gap {worst:.3f} of (n + 1) u S')
    return worst


def capture_xblock(fn):
    """Run fn() and record the (features, q, tbl, weights) of each x-block
    contraction it makes -> (calls, kernel launches, fn's result)."""
    from glenet_tpu_torch.ops import sparse
    XBLOCK.install()
    calls, real = [], sparse._xblock_contract

    def recorder(features, q, tbl, weights):
        calls.append((features.detach(), q, tbl, weights.detach()))
        return real(features, q, tbl, weights)

    sparse._xblock_contract = recorder
    before = XBLOCK.n
    try:
        out = fn()
    finally:
        sparse._xblock_contract = real
    return calls, XBLOCK.n - before, out


def xblock_bytes(f, q, w):
    """Bytes the contraction needs: the features, q and tbl, the weights
    read once and the float32 output written once."""
    b, v, cin = f.shape
    return 4 * (b * v * cin + 2 * q.numel() + w.numel()
                + b * q.shape[2] * w.shape[2])


def xblock_times(what, calls):
    """Kernel against plain on each captured call, and their times: the
    kernel's device time (torch.profiler), back to back (CUDA events), the
    plain version's, and the byte bound at 3.35 TB/s.  Returns the sums."""
    from glenet_tpu_torch.bench_merge import fmt
    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.ops import xblock_gemm as xg
    from glenet_tpu_torch.utils import cuda_timing as ct
    tot = dict.fromkeys(('device_ms', 'ms', 'plain_ms', 'bound_ms'), 0.0)
    worst = 0.0
    for i, (f, q, tbl, w) in enumerate(calls):
        worst = max(worst, xblock_check(f'{what} call {i}', f, q, tbl, w))
        r = {'device_ms': ct.device_ms(
                 lambda: xg.gather_gemm(f, q, tbl, w, True), 'xblock_gemm'),
             'ms': ct.event_ms(lambda: xg.gather_gemm(f, q, tbl, w, True),
                               iters=50, warmup=5),
             'plain_ms': ct.event_ms(
                 lambda: sparse.gather_gemm_xblocks_plain(f, q, tbl, w),
                 iters=5, warmup=1),
             'bound_ms': xblock_bytes(f, q, w) / 3.35e12 * 1e3}
        print(f'[xblock] {what} call {i}: features {tuple(f.shape)} -> '
              f'{tuple(q.shape)} x {w.shape[2]}; kernel device '
              f'{fmt(r["device_ms"])} ms, back-to-back {fmt(r["ms"])}; plain '
              f'{fmt(r["plain_ms"])}; bound {r["bound_ms"]:.4f} (bytes)')
        for k in tot:
            tot[k] = None if tot[k] is None or r[k] is None else tot[k] + r[k]
    print(f'[xblock] {what}, {len(calls)} calls: '
          + ', '.join(f'{k} {fmt(v)}' for k, v in tot.items())
          + f'; worst gap {worst:.3f} of (n + 1) u S')
    return tot


XBLOCK_LAUNCHES = {'predict': 11, 'step': 9}


def phase_xblock():
    """[xblock]: the x-block gather-GEMM kernel against its plain version
    (ops/sparse.py gather_gemm_xblocks_plain) on the card: synthetic
    tables over every Cin / Cout / B the families use and the edge cases,
    both autograd Functions' gradients, then the captured calls of a Waymo
    CenterPoint predict at B = 1 and a Waymo GLENet-S train step at B = 4
    (full width, seeded weights), with their launches and times."""
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import (batches_for,
                                                  seeded_detector,
                                                  waymo_scene_batches)
    worst = max(xblock_adversarial(), xblock_grads())
    cfg = cfg_from_yaml_file(str(ROOT /
                                 'configs/waymo_models/centerpoint.yaml'))
    det = seeded_detector(cfg, 'cuda', SEED + 31)
    batch = waymo_scene_batches(1, SEED + 37, 1)[0]
    with torch.no_grad():
        det.predict(batch)                              # warm-up
        calls, n_predict, _ = capture_xblock(lambda: det.predict(batch))
    predict = xblock_times('CenterPoint predict, B = 1', calls)
    del det, calls
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/waymo_models/GLENet_S.yaml'))
    det = seeded_detector(cfg, 'cuda', SEED + 41)
    _, state, train_step = build_training(cfg, det)
    batches = batches_for(cfg, 2, SEED + 43, 4, train=True)
    state, _ = train_step(state, batches[0])            # warm-up
    calls, n_step, _ = capture_xblock(lambda: train_step(state, batches[1]))
    step = xblock_times('GLENet-S train step, B = 4', calls)
    del det, calls, state
    torch.cuda.empty_cache()
    print(f'[xblock] launches: {n_predict} a CenterPoint request, {n_step} a '
          f'GLENet-S train step')
    check((n_predict, n_step) == (XBLOCK_LAUNCHES['predict'],
                                  XBLOCK_LAUNCHES['step']),
          f'xblock_gemm launches {n_predict} / {n_step}, expected '
          f'{XBLOCK_LAUNCHES}')
    return {'worst_gap': worst, 'launches_predict': n_predict,
            'launches_step': n_step,
            **{f'predict_{k}': v for k, v in predict.items()},
            **{f'step_{k}': v for k, v in step.items()}}


def phase_gpu_vs_cpu(raw=TINY_CFG, tag='gpu-vs-cpu', align_points=False,
                     align_neighbours=False):
    """Tiny two-stage topology on the card and on the port's CPU path.
    With align_points (PointRCNN) the card runs first and the CPU run takes
    the card's FPS, ball-query and three-nn decisions where they differ at
    a near tie (point_decisions; any other difference fails); with
    align_neighbours (PV-RCNN++) likewise the VectorPool neighbours within
    the expanded distance's rounding (neighbour_decisions)."""
    import torch

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.models import spconv_backbone
    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.utils.synthetic import seeded_detector
    cfg = Cfg(raw)
    saved = (sparse.GATHER_COMPUTE_DTYPE, spconv_backbone.DENSE_MXU_DTYPE,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    sparse.GATHER_COMPUTE_DTYPE = None
    spconv_backbone.DENSE_MXU_DTYPE = None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pts = torch.from_numpy(tiny_batch(SEED + 7,
                                          features=n_features(cfg)))
        mask = torch.ones(pts.shape[:2], dtype=torch.bool)
        outs, calls, decisions, neighbours = {}, {}, None, None
        card_first = align_points or align_neighbours
        for dev in ('cuda', 'cpu') if card_first else ('cpu', 'cuda'):
            det = seeded_detector(cfg, dev, SEED + 3)
            calls[dev], undo = record_ball_queries()
            undos = [undo]
            if align_points:
                decisions, undo = point_decisions(decisions)
                undos.append(undo)
            if align_neighbours:
                neighbours, undo = neighbour_decisions(neighbours)
                undos.append(undo)
            try:
                with torch.no_grad():
                    full = det.net(pts.to(dev), mask.to(dev))
                    pred = det.finalize(full)
            finally:
                for undo in undos:
                    undo()
            outs[dev] = (full, pred)
    finally:
        (sparse.GATHER_COMPUTE_DTYPE, spconv_backbone.DENSE_MXU_DTYPE,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    (fc, pc), (fg, pg) = outs['cpu'], outs['cuda']
    if 'pfe' in fc and not align_neighbours:
        check_point_decisions(fc, fg, calls, tag)
    # f32 on both devices, convolutions and sums in another order:
    # features rtol 1e-3 / atol 1e-4, final boxes and scores atol 1e-3
    exact = [('final_valid', pc['final_valid'], pg['final_valid']),
             ('final_labels', pc['final_labels'], pg['final_labels'])]
    if 'vox' in fc:
        exact.append(('voxel_coords', fc['vox']['voxel_coords'],
                      fg['vox']['voxel_coords']))
    if 'proposals' in fc:
        exact.append(('roi_valid', fc['proposals']['roi_valid'],
                      fg['proposals']['roi_valid']))
    for name, a, b in exact:
        check(torch.equal(a, b.cpu()), f'GPU and CPU differ in {name}')
    # PointPillars has no 3D backbone: its canvas feeds the dense head
    close = [('bev_features', fc['backbone_3d']['bev_features'],
              fg['backbone_3d']['bev_features'], 1e-3, 1e-4)] \
        if 'backbone_3d' in fc else []
    close += [('final_boxes', pc['final_boxes'], pg['final_boxes'], 0, 1e-3),
              ('final_scores', pc['final_scores'], pg['final_scores'], 0,
               1e-3)]
    if 'pfe' in fc:
        close.append(('point_cls_preds', fc['pfe']['point_cls_preds'],
                      fg['pfe']['point_cls_preds'], 1e-3, 1e-4))
    if 'point_head' in fc:
        close += [(k, fc['point_head'][k], fg['point_head'][k], 1e-3, 1e-4)
                  for k in ('point_cls_preds', 'point_box_preds')]
    if 'rcnn' in fc:
        close.append(('rcnn_reg', fc['rcnn']['rcnn_reg'],
                      fg['rcnn']['rcnn_reg'], 1e-3, 1e-4))
        if 'no_reg_loss' in fc['rcnn']:   # SECONDHead scores the rois
            close.append(('rcnn_cls', fc['rcnn']['rcnn_cls'],
                          fg['rcnn']['rcnn_cls'], 1e-3, 1e-4))
    elif 'dense_head' in fc:
        close += [(k, fc['dense_head'][k], fg['dense_head'][k], 1e-3, 1e-4)
                  for k in sorted(fc['dense_head'])]
    for name, a, b, rtol, atol in close:
        err = float((a - b.cpu()).abs().max())
        ok = torch.allclose(a, b.cpu().to(a.dtype), rtol=rtol, atol=atol)
        print(f'[{tag}] {name}: max_abs_err {err:.3e} '
              f'(rtol {rtol}, atol {atol})')
        check(ok, f'GPU and CPU differ in {name}')
    n_valid = int(pc['final_valid'].sum())
    print(f'[{tag}] tiny {cfg.MODEL.NAME} predict: integer outputs equal, '
          f'{n_valid} valid final boxes'
          + (f'; of {decisions["calls"]} FPS / ball-query / three-nn calls '
             f'{decisions["adopted"]} took the card\'s decisions at a near '
             f'tie (largest relative gap {decisions["largest"]:.2e}, bound '
             f'{NEAR_TIE})' if align_points else '')
          + (f'; VectorPool neighbours: {neighbours["flips"]} of '
             f'{neighbours["slots"]} valid slots picked another point on '
             f'the card ({neighbours["adopted"]} of {neighbours["calls"]} '
             f'calls took the card\'s picks; largest d^2 gap '
             f'{neighbours["largest"]:.3f} of the rounding bound)'
             if align_neighbours else ''))


def tiny_train_batch(cfg, train_proposals=False, perturb=None):
    """The toy training batch: tiny_batch's points, gt boxes off the first
    4 valid proposals of each sample of a CPU predict (with
    train_proposals of a train-mode forward without gt boxes: PointRCNN's
    point boxes move with the BN mode) by `perturb` (a function of the
    (n, 7) boxes; by default 0.15 m in x), with their classes (so the RoI
    targets hold foreground), label variances in [0.02, 0.3), and fixed
    RoI targets sampled once on the CPU."""
    import numpy as np
    import torch

    from glenet_tpu_torch.utils.synthetic import seeded_detector
    pts = torch.from_numpy(tiny_batch(SEED + 7, features=n_features(cfg)))
    b = pts.shape[0]
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    det = seeded_detector(cfg, 'cpu', SEED + 3)
    gt = torch.zeros((b, 8, 8))
    gt_mask = torch.zeros((b, 8), dtype=torch.bool)
    with torch.no_grad():
        prop = (det.net(pts, mask, train=True, gt_boxes=gt, gt_mask=gt_mask,
                        generator=torch.Generator().manual_seed(SEED))
                if train_proposals else det.net(pts, mask))['proposals']
    det = seeded_detector(cfg, 'cpu', SEED + 3)      # BN stats as drawn
    for i in range(b):
        idx = torch.nonzero(prop['roi_valid'][i]).flatten()[:4]
        boxes = prop['rois'][i, idx].clone()
        if perturb is None:
            boxes[:, 0] += 0.15
        else:
            boxes = perturb(boxes)
        gt[i, :len(idx), :7] = boxes
        gt[i, :len(idx), 7] = prop['roi_labels'][i, idx].float()
        gt_mask[i, :len(idx)] = True
    unc = np.random.RandomState(SEED + 11).uniform(0.02, 0.3, (b, 8, 7))
    batch = {'points': pts, 'points_mask': mask, 'gt_boxes': gt,
             'gt_mask': gt_mask,
             'gt_uncertainty': torch.from_numpy(unc.astype(np.float32))}
    with torch.no_grad():
        out = det.net(pts, mask, train=True, gt_boxes=gt, gt_mask=gt_mask,
                      gt_uncertainty=batch['gt_uncertainty'],
                      generator=torch.Generator().manual_seed(SEED))
    batch['roi_targets'] = out['roi_targets']
    return batch


def relu_signs(net, recorded=None, rel=1e-4):
    """Hooks on every MaskedBatchNorm of `net` (each feeds a ReLU).  With
    recorded=None they record the BN outputs per module; given another
    run's record they keep this run's outputs on the record's side of 0
    where the two differ (a shift of that element's value to the
    record's, the gradient path unchanged) and count those elements.  Only
    an element whose two values both lie within `rel` of the module's
    largest recorded |output| may be shifted: any other flip fails.
    Returns (the record or the count dict, the hook handles)."""
    import torch

    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    out = {} if recorded is None else {'flipped': 0, 'largest': 0.0}

    def hook(name):
        def fn(_mod, _inp, y):
            if recorded is None:
                out.setdefault(name, []).append(y.detach().cpu())
                return None
            ref = recorded[name].pop(0).to(y.device)
            flip = (y > 0) != (ref > 0)
            if not bool(flip.any()):
                return None
            eps = rel * float(ref.abs().max())
            size = float(torch.maximum(y.detach().abs(),
                                       ref.abs())[flip].max())
            check(size <= eps, f'{name}: a ReLU input lies on the other '
                               f'side of 0 on the card than on the CPU at '
                               f'|value| {size:.3e}, beyond rounding '
                               f'({eps:.3e})')
            out['flipped'] += int(flip.sum())
            out['largest'] = max(out['largest'], size / eps)
            return y + torch.where(flip, ref - y, 0.0).detach()
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in
               net.named_modules() if isinstance(m, MaskedBatchNorm)]
    return out, handles


def phase_gpu_vs_cpu_train(raw=TINY_CFG, tag='gpu-vs-cpu',
                           make_batch=tiny_train_batch, align_relu=False,
                           align_points=False, align_neighbours=False):
    """One toy train step (in two-stage configs fixed RoI targets and
    DP_RATIO 0) on the card and on the port's CPU path.  With align_relu:
    a ReLU input within rounding of 0 can land on the other side of the
    kink on the other device (the devices' f32 sums differ by ~1e-5
    relative), and its mask then moves whole BN channels' gradients; the
    CPU run takes the card's side at such elements, each within 1e-4 of
    its module's largest |output| on both devices, the relative agreement
    the loss terms are held to (relu_signs; at most 4 of them; a larger
    flip fails), so both compute one branch.  With align_points the CPU
    run also takes the card's FPS, ball-query and three-nn decisions at
    near ties (point_decisions), with align_neighbours its VectorPool
    neighbours within rounding (neighbour_decisions)."""
    import copy

    import torch

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.models import spconv_backbone
    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.train import optim, state as st
    from glenet_tpu_torch.utils.synthetic import seeded_detector
    raw = copy.deepcopy(raw)
    if 'ROI_HEAD' in raw['MODEL']:
        raw['MODEL']['ROI_HEAD']['DP_RATIO'] = 0.0
    cfg = Cfg(raw)
    saved = (sparse.GATHER_COMPUTE_DTYPE, spconv_backbone.DENSE_MXU_DTYPE,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    sparse.GATHER_COMPUTE_DTYPE = None
    spconv_backbone.DENSE_MXU_DTYPE = None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch = make_batch(cfg)
        n_fg = int(batch['roi_targets']['reg_valid_mask'].sum()
                   if 'roi_targets' in batch else batch['gt_mask'].sum())
        check(n_fg > 0, 'the toy targets hold no foreground')
        runs, signs, hooks, decisions, neighbours = {}, None, [], None, None
        # with align_relu, align_points or align_neighbours the card runs
        # first: the CPU takes its side
        card_first = align_relu or align_points or align_neighbours
        for dev in ('cuda', 'cpu') if card_first else ('cpu', 'cuda'):
            det = seeded_detector(cfg, dev, SEED + 3)
            tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
            state = st.create_train_state(det, tx)
            if align_relu:
                signs, hooks = relu_signs(det.net, signs)
            undos = []
            if align_points:
                decisions, undo = point_decisions(decisions)
                undos.append(undo)
            if align_neighbours:
                neighbours, undo = neighbour_decisions(neighbours)
                undos.append(undo)
            bt = {k: (v.to(dev) if torch.is_tensor(v)
                      else {kk: vv.to(dev) for kk, vv in v.items()})
                  for k, v in batch.items()}
            try:
                state, metrics = st.make_train_step(det, tx)(state, bt)
            finally:
                for undo in undos:
                    undo()
            for h in hooks:
                h.remove()
            runs[dev] = (metrics, det.net, tx)
    finally:
        (sparse.GATHER_COMPUTE_DTYPE, spconv_backbone.DENSE_MXU_DTYPE,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    (mc, nc, tx), (mg, ng, _) = runs['cpu'], runs['cuda']
    if align_relu:
        check(signs['flipped'] <= 4, f'{signs["flipped"]} ReLU inputs on '
                                     f'the other side of 0 on the card '
                                     f'than on the CPU')
    # f32 on both devices, TF32 off.  Loss terms rtol 1e-4.  Gradients:
    # atomics in the backward of the row gathers and the corner gathers
    # (index_add_ / scatter-add) and the strided convs, and cuDNN's
    # convolution backward, sum in another order: per parameter max |diff|
    # <= 1e-3 * max |grad| + 1e-6.  BN running stats rtol 1e-4 / atol 1e-5.
    # Parameters after one Adam step: each element moves by about
    # lr * sign(grad), so an element whose gradient is at rounding level may
    # move either way: max |diff| <= 2 lr + 1e-6.
    for k, v in mc.items():
        err = abs(float(mg[k].cpu()) - float(v))
        check(err <= 1e-4 * abs(float(v)) + 1e-6,
              f'GPU and CPU differ in {k}: {float(mg[k])} vs {float(v)}')
    print(f'[{tag}] train step loss terms: ' + ', '.join(
        f'{k} {float(v):.6f}' for k, v in sorted(mc.items())))
    worst = 0.0
    gpu_params = dict(ng.named_parameters())
    for name, p in nc.named_parameters():
        g_c = p.grad if p.grad is not None else torch.zeros_like(p)
        pg = gpu_params[name]
        g_g = (pg.grad if pg.grad is not None else torch.zeros_like(pg)).cpu()
        err = float((g_c - g_g).abs().max())
        tol = 1e-3 * float(g_c.abs().max()) + 1e-6
        check(err <= tol, f'GPU and CPU gradients differ in {name}: '
                          f'{err:.3e} > {tol:.3e}')
        worst = max(worst, err / tol)
        step_err = float((p.detach() - pg.detach().cpu()).abs().max())
        lr = tx.hyperparams(0)[0]
        check(step_err <= 2 * lr + 1e-6,
              f'GPU and CPU parameters differ after the step in {name}')
    gpu_bufs = dict(ng.named_buffers())
    for name, buf in nc.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            check(torch.allclose(buf, gpu_bufs[name].cpu(), rtol=1e-4,
                                 atol=1e-5),
                  f'GPU and CPU BN running stats differ in {name}')
    print(f'[{tag}] tiny {cfg.MODEL.NAME} train step: {n_fg} foreground '
          f'RoIs or gt boxes; loss terms within rtol 1e-4, every gradient '
          f'within its tolerance (worst at {worst:.2f} of it'
          + (f'; ReLU inputs the CPU took on the card\'s side of 0: '
             f'{signs["flipped"]}, the largest at {signs["largest"]:.2f} '
             f'of rounding' if align_relu else '')
          + (f'; FPS / ball-query / three-nn decisions the CPU took from '
             f'the card at a near tie: {decisions["adopted"]} of '
             f'{decisions["calls"]} calls' if align_points else '')
          + (f'; VectorPool neighbour slots that picked another point on '
             f'the card: {neighbours["flips"]} of {neighbours["slots"]}'
             if align_neighbours else '')
          + '), BN running stats and the parameters after adam_onecycle '
          'agree')


def prepare_full_width():
    """GLENet_VR.yaml at full width on the card: seeded detector, the
    requests' scenes, and one warm-up predict that captures the inputs of
    the four merge-resolve calls."""
    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.utils.synthetic import scene_batches, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    det = seeded_detector(cfg, 'cuda', SEED)
    batches = scene_batches(N_REQUESTS + 1, SEED, BATCH)
    t0 = time.perf_counter()
    captured = capture_calls(lambda: det.predict(batches[0]),
                             'full-width GLENet-VR predict')[0]
    print(f'[kernel] warm-up full-width predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    return cfg, det, batches[1:], captured


def watch_sites(det, sites):
    """Record the active sites of each backbone level of every forward in
    `sites`; returns the hook's handle."""
    def record(_mod, _inp, out):
        ms = out['multi_scale']
        sites.update({
            'x_conv1': ms['x_conv1']['mask'].sum(1),
            'x_conv2': ms['x_conv2']['mask'].sum(1),
            'x_conv3': ms['x_conv3']['mask'].sum(1),
            'x_conv4': ms['x_conv4']['occ'].flatten(1).sum(1)})

    return det.net.backbone_3d.register_forward_hook(record)


def sites_line(sites, caps):
    """'x_conv1 [n, ...]/cap, ...': active sites per sample against the
    level caps of the sparse levels."""
    return ', '.join(
        f'{k} {sites[k].tolist()}' + (f'/{caps[i]}' if i < 3 else '')
        for i, k in enumerate(('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')))


def phase_full_width(det, batches, tag='full', label='GLENet-VR',
                     min_valid=0, n_points=N_POINTS):
    """The main path: one predict per batch, merge-resolve launches counted
    from 0 just before and read just after; each sample must keep at least
    `min_valid` final boxes."""
    import torch

    from glenet_tpu_torch.ops import sparse
    caps = sparse.level_caps(det.max_voxels_test)
    k = int(det.model_cfg.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    sites = {}

    def record_proposals(_mod, _inp, out):
        sites['proposals'] = out['proposals']['roi_valid'].sum(1)

    hooks = [watch_sites(det, sites)]
    if det.net.roi_head is not None:
        hooks.append(det.net.register_forward_hook(record_proposals))
    times, per_request = [], []
    LAUNCHES.n = 0
    for r, batch in enumerate(batches):
        before = LAUNCHES.n
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = det.predict(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        per_request.append((pred, LAUNCHES.n - before,
                            torch.cuda.max_memory_allocated(), dict(sites)))
    launches = LAUNCHES.n
    for h in hooks:
        h.remove()
    for r, (pred, n_launch, mem, st) in enumerate(per_request):
        for key, shape in (('final_boxes', (BATCH, k, 7)),
                           ('final_scores', (BATCH, k))):
            check(tuple(pred[key].shape) == shape,
                  f'{key} shape {tuple(pred[key].shape)}')
            check(bool(torch.isfinite(pred[key]).all()), f'{key} not finite')
        check(n_launch == 4, f'{label} request {r}: {n_launch} merge-resolve '
                             f'launches, expected 4')
        check(int(pred['final_valid'].sum(1).min()) >= min_valid,
              f'{label} request {r}: fewer than {min_valid} final boxes')
        lvl = sites_line(st, caps)
        prop = (f'valid proposals {st["proposals"].tolist()}; '
                if 'proposals' in st else '')
        print(f'[{tag}] {label} request {r}: {times[r]:.1f} ms; active sites '
              f'{lvl}; {prop}valid final boxes '
              f'{pred["final_valid"].sum(1).tolist()}; merge_resolve '
              f'launches {n_launch}; max_memory_allocated '
              f'{mem / 2**30:.2f} GiB')
    print(f'[{tag}] {label} predict B={BATCH} x {n_points} points: '
          f'mean {sum(times) / len(times):.1f} ms over {len(times)} requests')
    return launches


def onecycle_expected(opt_cfg, n_total, count):
    """(lr, b1) of the update after `count` updates, written out from the
    fastai OneCycle schedule: cosine from LR / DIV_FACTOR up to LR and b1
    from MOMS[0] down to MOMS[1] over PCT_START of the steps, then back."""
    import math
    lr_max, div = float(opt_cfg.LR), float(opt_cfg.DIV_FACTOR)
    m0, m1 = (float(m) for m in opt_cfg.MOMS)
    split = int(n_total * float(opt_cfg.PCT_START))

    def cos(a, b, pct):
        return b + (a - b) / 2 * (math.cos(math.pi * pct) + 1)

    if count < split:
        pct = count / split
        return cos(lr_max / div, lr_max, pct), cos(m0, m1, pct)
    pct = min((count - split) / (n_total - split), 1.0)
    return cos(lr_max, lr_max / div / 1e4, pct), cos(m1, m0, pct)


def phase_train(cfg, det, tag='train', label='GLENet-VR', n_points=N_POINTS):
    """The train step at full width: a warm-up step that captures the
    merge-resolve calls, then TRAIN_STEPS timed steps with the launches
    counted from 0 just before and read just after."""
    import math

    import torch

    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.profile_train import (build_training, total_steps,
                                                train_frames)
    from glenet_tpu_torch.utils.synthetic import batches_for
    opt_cfg = cfg.OPTIMIZATION
    caps = sparse.level_caps(det.max_voxels_train)
    b = int(opt_cfg.BATCH_SIZE_PER_GPU)
    n_total = total_steps(opt_cfg, train_frames(cfg))
    tx, state, train_step = build_training(cfg, det)
    batches = batches_for(cfg, TRAIN_STEPS + 1, SEED + 1, b, train=True)
    n_gt = batches[0]['gt_mask'].sum(1).tolist()
    t0 = time.perf_counter()
    captured, (state, metrics) = capture_calls(
        lambda: train_step(state, batches[0]), f'{label} train step')
    print(f'[{tag}] {label} train step, B={b} x {n_points} points, train '
          f'voxel budget {det.max_voxels_train}, gt boxes {n_gt}, '
          f'adam_onecycle total_steps {n_total} ({opt_cfg.NUM_EPOCHS} epochs x '
          f'{n_total // int(opt_cfg.NUM_EPOCHS)} iterations); warm-up step '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms, loss '
          f'{float(metrics["loss"]):.4f}')
    params = {n: p.detach().clone() for n, p in det.net.named_parameters()}
    stats = {n: t.clone() for n, t in det.net.named_buffers()
             if n.endswith(('running_mean', 'running_var'))}
    times, sites = [], {}
    hook = watch_sites(det, sites)
    LAUNCHES.n = 0
    for i, batch in enumerate(batches[1:]):
        before = LAUNCHES.n
        count = state.opt_state['count']
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        n_launch = LAUNCHES.n - before
        peak = torch.cuda.max_memory_allocated()
        vals = {k: float(v) for k, v in metrics.items()}
        for k, v in vals.items():
            check(math.isfinite(v), f'train step {i}: {k} = {v}')
        check(n_launch == 4, f'train step {i}: {n_launch} merge-resolve '
                             f'launches, expected 4')
        lr, b1 = state.opt_state['hyperparams']
        lr_x, b1_x = onecycle_expected(opt_cfg, n_total, count)
        check(abs(lr - lr_x) <= 1e-9 * lr_x and abs(b1 - b1_x) <= 1e-9,
              f'train step {i}: lr {lr}, b1 {b1}; the schedule gives '
              f'{lr_x}, {b1_x}')
        print(f'[{tag}] {label} step {i}: {times[-1]:.1f} ms; ' + ', '.join(
            f'{k} {v:.5f}' for k, v in sorted(vals.items()))
            + f'; lr {lr:.6e}, b1 {b1:.6f} (update {count + 1}); '
              f'active sites {sites_line(sites, caps)}; merge_resolve '
              f'launches {n_launch}; max_memory_allocated '
              f'{peak / 2**30:.2f} GiB')
    launches = LAUNCHES.n
    hook.remove()
    # adam_onecycle moves every parameter except one that is zero with zero
    # gradients (weight decay keeps it at zero)
    still = [n for n, p in det.net.named_parameters()
             if torch.equal(p.detach(), params[n])]
    stuck = [n for n, p in det.net.named_parameters() if n in still and (
        bool(p.detach().any()) or (p.grad is not None and bool(p.grad.any())))]
    check(not stuck, f'parameters unchanged by {TRAIN_STEPS} steps: {stuck}')
    bufs = dict(det.net.named_buffers())
    same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
    check(not same, f'BN running stats unchanged by {TRAIN_STEPS} steps: '
                    f'{same}')
    print(f'[{tag}] {label} {TRAIN_STEPS} steps: mean '
          f'{sum(times) / len(times):.1f} ms; {len(params) - len(still)} '
          f'of {len(params)} parameter '
          f'tensors changed (unchanged, zero with zero gradients: {still}), '
          f'all {len(stats)} BN running-stat tensors changed; lr and b1 on '
          f'the one-cycle schedule')
    return launches, captured, times


def count_launches(obj, attr, counts):
    """Shadow obj.attr (a train-step factory or a predict method) so that
    each call it makes appends its merge-resolve launches to `counts`;
    returns an undo function."""
    real = getattr(obj, attr)

    def counted(fn):
        def call(*args, **kwargs):
            before = LAUNCHES.n
            out = fn(*args, **kwargs)
            counts.append(LAUNCHES.n - before)
            return out
        return call

    if attr == 'make_train_step':
        setattr(obj, attr, lambda *a, **k: counted(real(*a, **k)))
    else:
        setattr(obj, attr, counted(real))
    return lambda: setattr(obj, attr, real)


_TIMED = []                               # inner seconds of the open calls


def time_calls(obj, attr, totals, key):
    """Shadow obj.attr so that totals[key] adds the host seconds of its
    calls, less those of other shadowed calls made inside them, and
    totals[key + ' n'] counts them; returns an undo function."""
    raw = vars(obj)[attr]                 # a staticmethod stays one
    real = getattr(obj, attr)

    def call(*args, **kwargs):
        _TIMED.append(0.0)
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            totals[key] = totals.get(key, 0.0) + dt - _TIMED.pop()
            totals[key + ' n'] = totals.get(key + ' n', 0) + 1
            if _TIMED:
                _TIMED[-1] += dt

    setattr(obj, attr,
            staticmethod(call) if isinstance(raw, staticmethod) else call)
    return lambda: setattr(obj, attr, raw)


def synthetic_detections(gt_annos, rng, n_false=20):
    """Detections for KITTI annos: each labelled object jittered by one of
    several offsets (IoU levels), and `n_false` false positives per frame,
    all with random scores."""
    import numpy as np
    dts = []
    for g in gt_annos:
        keep = g['name'] != 'DontCare'
        n, k = int(keep.sum()), int(keep.sum()) + n_false
        sigma = rng.choice([0.05, 0.2, 0.5], n)[:, None]
        loc = np.concatenate([g['location'][keep] + rng.normal(0, 1, (n, 3))
                              * sigma,
                              np.stack([rng.uniform(-20, 20, n_false),
                                        np.full(n_false, 1.6),
                                        rng.uniform(5, 70, n_false)], 1)])
        dims = np.concatenate([g['dimensions'][keep],
                               np.tile([3.9, 1.56, 1.6], (n_false, 1))])
        ry = np.concatenate([g['rotation_y'][keep] + rng.normal(0, 0.1, n),
                             rng.uniform(-np.pi, np.pi, n_false)])
        x1 = rng.uniform(0, 1100, n_false)
        y1 = rng.uniform(150, 250, n_false)
        bbox = np.concatenate([g['bbox'][keep] + rng.normal(0, 4, (n, 4)),
                               np.stack([x1, y1, x1 + 60, y1 + 45], 1)])
        dts.append({'name': np.array(['Car'] * k), 'bbox': bbox,
                    'location': loc, 'dimensions': dims, 'rotation_y': ry,
                    'alpha': ry + rng.normal(0, 0.1, k),
                    'truncated': np.zeros(k), 'occluded': np.zeros(k),
                    'score': rng.uniform(0, 1, k)})
    return dts


def phase_eval(root, cfg):
    """The KITTI evaluation on the card: against its CPU run on the tree's
    20 labelled frames with synthetic detections, then timed at the size of
    KITTI's val split (3769 frames, the 20 repeated), in parts: clean_data
    (host), the rotated BEV / 3D overlaps (card), and the rest (the
    matcher's two stages per cell on the card, the curves)."""
    import pickle

    import numpy as np
    import torch

    from glenet_tpu_torch.eval import kitti_eval as ke
    gt = []
    for split in ('train', 'val'):
        with open(root / f'kitti_infos_{split}.pkl', 'rb') as f:
            gt += [info['annos'] for info in pickle.load(f)]
    dt = synthetic_detections(gt, np.random.RandomState(SEED))
    (s_gpu, r_gpu), (s_cpu, r_cpu) = (
        ke.get_official_eval_result(gt, dt, cfg.CLASS_NAMES, device=d)
        for d in ('cuda', 'cpu'))
    err = max(abs(r_gpu[k] - r_cpu[k]) for k in r_cpu)
    check(set(r_gpu) == set(r_cpu) and err <= 1e-3 and s_gpu == s_cpu,
          f'KITTI evaluation differs between the card and the CPU ({err})')
    moderate = r_gpu['Car_3d/moderate_R40']
    check(0 < moderate < 100, f'Car_3d/moderate_R40 {moderate}')
    print(f'[eval] KITTI evaluation of {len(gt)} frames with synthetic '
          f'detections: card equals CPU (every AP within {err:.1e}, result '
          f'strings equal), Car_3d/moderate_R40 {moderate:.2f}')

    reps = -(-KITTI_VAL_FRAMES // len(gt))
    gt, dt = (gt * reps)[:KITTI_VAL_FRAMES], (dt * reps)[:KITTI_VAL_FRAMES]
    times = {}
    for name, fn in (
            ('clean_data', lambda: [ke.clean_data(g, d, 0, diff)
                                    for _ in range(6) for diff in range(3)
                                    for g, d in zip(gt, dt)]),
            ('overlaps', lambda: [ke.frame_overlaps(gt, dt, m, 'cuda')
                                  for m in range(3)]),
            ('evaluation', lambda: ke.get_official_eval_result(
                gt, dt, cfg.CLASS_NAMES, device='cuda'))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    rest = times['evaluation'] - times['overlaps'] - times['clean_data']
    n_gt = sum(len(a['name']) for a in gt)
    n_dt = sum(len(a['name']) for a in dt)
    print(f'[eval] KITTI evaluation at the size of the val split, '
          f'{len(gt)} frames ({n_gt} labels, {n_dt} detections): '
          f'{times["evaluation"]:.3f} s = clean_data for the 18 cells '
          f'{times["clean_data"]:.3f} s (host) + rotated overlaps of the 3 '
          f'metrics {times["overlaps"]:.3f} s (card) + the matcher\'s 2 '
          f'stages x 18 cells and the curves {rest:.3f} s')


def check_host_library(root):
    """The host library is the one built from native/host_ops.cpp, and it
    equals its numpy versions on the tree's boxes and points."""
    import pickle

    import numpy as np

    from glenet_tpu_torch.ops import host_ops
    lib = host_ops.load()
    check(host_ops.SOURCE == ROOT / 'native' / 'host_ops.cpp'
          and lib._name == str(host_ops.library_path()),
          f'host library {lib._name} is not the one built from '
          f'{host_ops.SOURCE}')
    with open(root / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    boxes = np.concatenate([i['annos']['gt_boxes_lidar'] for i in infos])
    n_pts, t_lib, t_np, n_inside = 0, 0.0, 0.0, 0
    for info in infos[:4]:
        pts = np.fromfile(str(root / 'training/velodyne' /
                              f"{info['point_cloud']['lidar_idx']}.bin"),
                          np.float32).reshape(-1, 4)
        t0 = time.perf_counter()
        got = host_ops.points_in_rboxes(pts, boxes)
        t1 = time.perf_counter()
        ref = host_ops.points_in_rboxes_plain(pts, boxes)
        t_lib, t_np = t_lib + t1 - t0, t_np + time.perf_counter() - t1
        check(np.array_equal(got, ref), 'points_in_rboxes differs from its '
                                        'numpy version')
        n_pts, n_inside = n_pts + len(pts), n_inside + int(got.sum())
    rng = np.random.RandomState(SEED)
    many = np.concatenate([boxes, boxes + rng.uniform(-3, 3, boxes.shape)
                           * [1, 1, 0, 0, 0, 0, 1]]).astype(np.float32)
    got = host_ops.rbox_collision(many, many)
    check(np.array_equal(got, host_ops.rbox_collision_plain(many, many)),
          'rbox_collision differs from its numpy version')
    print(f'[cli] host library {Path(lib._name).name} (built from '
          f'native/host_ops.cpp): points_in_rboxes equals numpy on '
          f'{n_pts} points x {len(boxes)} boxes ({n_inside} inside; '
          f'{1e3 * t_lib:.1f} ms against numpy {1e3 * t_np:.1f} ms); '
          f'rbox_collision equals numpy on {len(many)}^2 pairs '
          f'({int(got.sum())} overlapping)')


def phase_cli(in_memory_ms, tmp):
    """The train and test CLIs end to end on a synthetic KITTI-layout tree
    at full width, written under `tmp`; merge-resolve launches counted from
    0 just before and read just after.  Returns the launches and the
    tree's root."""
    import math
    import pickle

    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets import augmentor
    from glenet_tpu_torch.datasets.kitti_dataset import (KittiDataset,
                                                         create_kitti_infos)
    from glenet_tpu_torch.models.detectors import Detector, build_detector
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.train import checkpoint as ck
    from glenet_tpu_torch.train import state as state_lib
    from glenet_tpu_torch.utils import synthetic
    cfg_file = str(ROOT / 'configs/kitti_models/GLENet_VR.yaml')
    cfg = cfg_from_yaml_file(cfg_file)
    root, out = tmp / 'kitti', tmp / 'out'
    t0 = time.perf_counter()
    synthetic.write_kitti_tree(root, CLI_TRAIN, CLI_VAL, seed=SEED,
                               n_points=CLI_POINTS)
    t1 = time.perf_counter()
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    synthetic.add_label_variances(root, seed=SEED)
    t2 = time.perf_counter()
    with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
        n_db = len(pickle.load(f)['Car'])
    print(f'[cli] synthetic KITTI tree: {CLI_TRAIN} train + {CLI_VAL} val '
          f'frames of {CLI_POINTS} points written in {t1 - t0:.1f} s; '
          f'create_kitti_infos and label variances {t2 - t1:.1f} s, '
          f'{n_db} Car objects in the gt database')
    check_host_library(root)

    common = ['--cfg_file', cfg_file, '--data_path', str(root),
              '--output_dir', str(out), '--batch_size', str(CLI_BATCH),
              '--max_steps_per_epoch', '2']
    step_launches, predict_launches, data = [], [], {}
    undo = [count_launches(state_lib, 'make_train_step', step_launches),
            count_launches(Detector, 'predict', predict_launches)]
    timers = [time_calls(KittiDataset, '__getitem__', data, 'items'),
              time_calls(augmentor.DataAugmentor, '__call__', data,
                         'augment'),
              time_calls(augmentor.DataBaseSampler, '__call__', data,
                         'gt_sampling'),
              time_calls(KittiDataset, 'collate_batch', data, 'collate'),
              time_calls(train_cli, 'to_device', data, 'copy')]
    LAUNCHES.n = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        first = train_cli.main(common + ['--epochs', '2'])
        resumed = train_cli.main(common + ['--epochs', '3',
                                           '--bn_refresh', '2'])
        peak = torch.cuda.max_memory_allocated()
        for u in timers:
            u()
        results = test_cli.main(common[:8])
    finally:
        for u in undo + timers:
            u()
    launches = LAUNCHES.n

    ckpts = sorted(p.name for p in (out / 'ckpt').iterdir())
    check(ckpts == [f'checkpoint_epoch_{e}.pth' for e in range(3)],
          f'checkpoints written: {ckpts}')
    check(first['start_step'] == 0 and resumed['start_step'] == 4,
          f'the resumed run started at step {resumed["start_step"]}')
    steps = first['steps'] + resumed['steps']
    check([r['it'] for r in steps] == list(range(1, 7)),
          f'steps {[r["it"] for r in steps]}')
    for r in steps:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'CLI step {r["it"]}: not finite: {bad}')
    check(step_launches == [4] * 6, f'merge-resolve launches per CLI '
                                    f'train step: {step_launches}')
    # parameters and BN stats loaded from the first run's last
    # checkpoint equal those it saved
    fresh = build_detector(cfg, device='cuda')
    fresh.net.load_state_dict(ck.load_checkpoint(
        out / 'ckpt' / 'checkpoint_epoch_1.pth')['model_state'])
    saved = first['detector'].net.state_dict()
    diff = [k for k, v in fresh.net.state_dict().items()
            if not torch.equal(v, saved[k])]
    check(not diff, f'reloaded tensors differ: {diff[:5]}')
    for r in steps:
        print(f'[cli] train step {r["it"]} (epoch {r["epoch"]}): data '
              f'{r["data_ms"]:.1f} ms, step {r["step_ms"]:.1f} ms, loss '
              f'{r["loss"]:.4f}, rcnn_loss_reg {r["rcnn_loss_reg"]:.4f}, '
              f'grad_norm {r["grad_norm"]:.3f}, lr {r["lr"]:.3e}')
    warm = [r for r in steps if r['it'] not in (1, 5)]
    data_ms = sum(r['data_ms'] for r in warm) / len(warm)
    step_ms = sum(r['step_ms'] for r in warm) / len(warm)
    mem_ms = sum(in_memory_ms) / len(in_memory_ms)
    print(f'[cli] train through the CLI, B={CLI_BATCH}: 3 checkpoints, '
          f'resumed at step {resumed["start_step"]}, reload bit-exact '
          f'({len(saved)} tensors), merge_resolve launches per step '
          f'{step_launches}; mean over the steps after each run\'s first: '
          f'data {data_ms:.1f} ms, step {step_ms:.1f} ms against the '
          f'in-memory train step {mem_ms:.1f} ms (phase [train]); '
          f'max_memory_allocated {peak / 2**30:.2f} GiB')
    n = data['collate n']
    ms = {k: 1e3 * data[k] / n for k in ('items', 'augment', 'gt_sampling',
                                          'collate', 'copy')}
    print(f'[cli] data per batch of {CLI_BATCH}, host ms (mean over {n} '
          f'batches of the train split, 2 of them the BN refresh\'s): '
          f'items {ms["items"] + ms["augment"] + ms["gt_sampling"]:.1f} = '
          f'gt sampling {ms["gt_sampling"]:.1f} + world flip / rotation / '
          f'scaling {ms["augment"]:.1f} + loading, FOV crop, range masks '
          f'and padding {ms["items"]:.1f}; '
          f'collation {ms["collate"]:.1f}; copy to the card '
          f'{ms["copy"]:.1f}')

    (path, res), = results.items()
    result_pkl = out / 'eval' / 'epoch_2' / 'result.pkl'
    check(path.endswith('checkpoint_epoch_2.pth') and result_pkl.exists(),
          f'test CLI evaluated {path}; result.pkl missing')
    check(res['frames'] == CLI_VAL, f'{res["frames"]} frames evaluated')
    keys = [f'Car_3d/{d}_R40' for d in ('easy', 'moderate', 'hard')]
    check(all(k in res['ap'] and np.isfinite(res['ap'][k]) for k in keys),
          f'AP keys missing: {sorted(res["ap"])}')
    check(predict_launches == [4] * math.ceil(CLI_VAL / CLI_BATCH),
          f'merge-resolve launches per CLI predict: {predict_launches}')
    print(f'[cli] test CLI on {Path(path).name}: {res["frames"]} val '
          f'frames, {res["sec_per_frame"]:.4f} s/frame (predicts and '
          f'prediction dicts), KITTI evaluation {res["eval_sec"]:.3f} s '
          f'(overlaps and matcher on the card); merge_resolve launches '
          f'per predict {predict_launches}; result.pkl written; '
          + ', '.join(f'{k} {res["ap"][k]:.2f}' for k in keys)
          + ' (random weights: only the keys are checked)')
    phase_eval(root, cfg)
    return launches, root


CVAE_DATA_PARTS = {'_load_points': 'load', 'occlude_aug': 'occlusion',
                   '__getitem__': 'rest', 'collate': 'collate'}


def cvae_batch_ms(parts, n_batches):
    """Host ms per batch of each timed part of the crop dataset."""
    return {k: 1e3 * parts.get(k, 0.0) / n_batches
            for k in CVAE_DATA_PARTS.values()}


def phase_cvae_full(tmp):
    """configs/cvae/exp_gen.yaml at full width on a synthetic gt database
    of KITTI's train-split size, fold 0 of 10: a warm-up and CVAE_STEPS
    timed train steps, one prediction pass over the val fold, and the
    projected wall time of the whole K-fold run.  Returns (cfg, the
    warm-up batch) for the GPU-against-CPU check."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import Cfg, cfg_from_yaml_file
    from glenet_tpu_torch.cvae import dataset as cds
    from glenet_tpu_torch.cvae import pipeline
    from glenet_tpu_torch.train import optim
    from glenet_tpu_torch.utils import synthetic
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/cvae/exp_gen.yaml'))
    root = tmp / 'cvae_crops'
    t0 = time.perf_counter()
    db = synthetic.write_crop_database(root, CVAE_CARS, CVAE_VANS, seed=SEED)
    n_pts = np.array([i['num_points_in_gt'] for v in db.values() for i in v])
    data_cfg = Cfg(dict(cfg.DATA_CONFIG, FOLD_IDX=0, NUM_FOLDS=CVAE_FOLDS))
    train_ds = cds.KittiGtDataset(data_cfg, training=True, root_path=root)
    val_ds = cds.KittiGtDataset(data_cfg, training=False, root_path=root)
    train_ds.rng = np.random.RandomState(SEED)
    val_ds.rng = np.random.RandomState(SEED + 1)
    print(f'[cvae] synthetic gt database: {len(db["Car"])} Car + '
          f'{len(db["Van"])} Van crops written in '
          f'{time.perf_counter() - t0:.1f} s, points per crop median '
          f'{int(np.median(n_pts))}, mean {n_pts.mean():.0f}, '
          f'{(n_pts > 1000).mean():.3f} of them above 1000; fold 0 of '
          f'{CVAE_FOLDS}: train {len(train_ds)} '
          f'({len(train_ds.dense_gt_infos)} dense donors), val '
          f'{len(val_ds)}')

    opt = cfg.OPTIMIZATION
    b, epochs = int(opt.BATCH_SIZE_PER_GPU), int(opt.NUM_EPOCHS)
    steps_per_epoch = len(train_ds) // b
    gen = pipeline.build_generator(cfg.MODEL, 'cuda', seed=SEED)
    tx, _ = optim.build_optimizer(opt, steps_per_epoch * epochs)
    opt_state = tx.init(list(gen.parameters()))
    step = pipeline.make_cvae_train_step(gen, cfg.MODEL, tx)
    generator = torch.Generator(device='cuda').manual_seed(SEED)
    anneal = min(1 / epochs, 1.0)         # the first epoch's KL weight
    train_ds.linear_anneal = anneal
    batches = train_ds.iter_batches(b, seed=SEED * 10000)
    parts = {}
    undo = [time_calls(cds.KittiGtDataset, a, parts, k)
            for a, k in CVAE_DATA_PARTS.items()]
    try:
        t0 = time.perf_counter()
        first = next(batches)
        step(opt_state, pipeline.to_device(first, 'cuda'), generator, anneal)
        torch.cuda.synchronize()
        print(f'[cvae] B={b} x {first["points"].shape[1]} points x '
              f'{first["points"].shape[2]} features, LATENT_DIM '
              f'{cfg.MODEL.LATENT_DIM}, '
              f'{sum(p.numel() for p in gen.parameters())} parameters; '
              f'adam_onecycle over {epochs} epochs x {steps_per_epoch} '
              f'steps; warm-up batch and step '
              f'{1e3 * (time.perf_counter() - t0):.1f} ms')
        params = {n: p.detach().clone() for n, p in gen.named_parameters()}
        stats = {n: t.clone() for n, t in gen.named_buffers()}
        parts.clear()
        recs = []
        for i in range(CVAE_STEPS):
            count = opt_state['count']
            t0 = time.perf_counter()
            batch = next(batches)
            t1 = time.perf_counter()
            tb = pipeline.to_device(batch, 'cuda')
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            metrics = step(opt_state, tb, generator, anneal)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            vals = {k: float(v) for k, v in metrics.items()}
            for k, v in vals.items():
                check(math.isfinite(v), f'CVAE step {i}: {k} = {v}')
            lr, b1 = opt_state['hyperparams']
            recs.append((1e3 * (t1 - t0), 1e3 * (t2 - t1), 1e3 * (t3 - t2)))
            print(f'[cvae] step {i}: data {recs[-1][0]:.1f} ms, copy '
                  f'{recs[-1][1]:.2f} ms, step {recs[-1][2]:.2f} ms; '
                  + ', '.join(f'{k} {v:.5f}' for k, v in sorted(vals.items()))
                  + f'; lr {lr:.6e}, b1 {b1:.6f} (update {count + 1}); '
                    f'max_memory_allocated '
                    f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
        ms = cvae_batch_ms(parts, CVAE_STEPS)
        n_occ = parts.get('occlusion n', 0)
        moved = [n for n, p in gen.named_parameters()
                 if not torch.equal(p.detach(), params[n])]
        check(len(moved) == len(params),
              f'CVAE parameters unchanged by {CVAE_STEPS} steps: '
              f'{sorted(set(params) - set(moved))}')
        bufs = dict(gen.named_buffers())
        same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
        check(not same, f'CVAE BN running stats unchanged: {same}')
        data_ms = sum(r[0] for r in recs) / len(recs)
        copy_ms = sum(r[1] for r in recs) / len(recs)
        step_ms = sum(r[2] for r in recs) / len(recs)
        print(f'[cvae] {CVAE_STEPS} steps: mean data {data_ms:.1f} ms per '
              f'batch of {b} (host: crop loads {ms["load"]:.1f}, occlusion '
              f'{ms["occlusion"]:.1f} over {n_occ / CVAE_STEPS:.1f} crops '
              f'(range views, convex hulls, calib and plane files), the '
              f'rest of the item {ms["rest"]:.1f}, collation '
              f'{ms["collate"]:.1f}), copy {copy_ms:.2f} ms, step '
              f'{step_ms:.2f} ms; all {len(params)} parameter tensors and '
              f'{len(stats)} BN stat tensors changed')

        parts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_pass = pipeline.predict_samples(gen, val_ds, cfg.MODEL,
                                            n_passes=1, batch_size=b,
                                            seed=SEED)
        pass_s = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    preds = np.stack([v['pred_box'] for v in per_pass[0].values()])
    check(preds.shape == (len(val_ds), 7) and np.isfinite(preds).all(),
          f'prediction pass: {preds.shape}, finite {np.isfinite(preds).all()}')
    n_val_batches = math.ceil(len(val_ds) / b)
    pms = cvae_batch_ms(parts, 1)
    print(f'[cvae] prediction pass over the val fold: {len(val_ds)} crops, '
          f'{n_val_batches} batches, {1e3 * pass_s:.1f} ms (host: crop loads '
          f'{pms["load"]:.1f} ms, items {pms["rest"]:.1f} ms, collation '
          f'{pms["collate"]:.1f} ms; the rest, copies and samples on the '
          f'card, {1e3 * pass_s - sum(pms.values()):.1f} ms)')
    per_step = data_ms + copy_ms + step_ms
    train_s = CVAE_FOLDS * epochs * steps_per_epoch * per_step / 1e3
    passes_s = CVAE_FOLDS * CVAE_PASSES * pass_s
    print(f'[cvae] projection, not a measurement: the whole {CVAE_FOLDS}-fold '
          f'run at these times would take {CVAE_FOLDS} folds x {epochs} '
          f'epochs x {steps_per_epoch} steps x {per_step:.1f} ms = '
          f'{train_s / 3600:.2f} h of training (data '
          f'{data_ms / per_step:.3f} of it) + '
          f'{CVAE_FOLDS} x {CVAE_PASSES} passes x {pass_s:.2f} s = '
          f'{passes_s / 3600:.2f} h of prediction, '
          f'{(train_s + passes_s) / 3600:.2f} h in all; cut in this run: '
          f'{CVAE_STEPS} of the steps, 1 of the passes, 1 of the folds')
    return cfg, first


def phase_cvae_cli(root, tmp):
    """The CVAE CLI end to end on the [cli] tree, GLENet-VR trained through
    the train CLI on the infos it writes, and the analysis of fold 0's
    passes.  Merge-resolve launches counted from 0 just before the
    detector training and read just after; returns them."""
    import math
    import pickle

    import numpy as np
    import torch

    from glenet_tpu_torch.cvae import analysis, pipeline
    from glenet_tpu_torch.tools import cvae_analysis, cvae_train
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.train import state as state_lib
    out = tmp / 'cvae_out'
    captured = []
    real_predict = pipeline.predict_samples

    def predict(*args, **kwargs):
        captured.append(real_predict(*args, **kwargs))
        return captured[-1]

    pipeline.predict_samples = predict
    t0 = time.perf_counter()
    try:
        unc = cvae_train.main([
            '--cfg_file', str(ROOT / 'configs/cvae/exp_gen.yaml'),
            '--data_path', str(root), '--folds', '2', '--passes',
            str(CVAE_PASSES), '--epochs', '2', '--output_dir', str(out),
            '--inject'])
    finally:
        pipeline.predict_samples = real_predict
    cli_s = time.perf_counter() - t0
    with open(out / 'un_v4.pkl', 'rb') as f:
        saved = pickle.load(f)
    with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
        cars = pickle.load(f)['Car']
    keys = [f"{i['image_idx']}_{i['gt_idx']}" for i in cars]
    check(set(saved) == set(unc) and set(keys) <= set(saved),
          f'un_v4.pkl misses {len(set(keys) - set(saved))} Car crops')
    vecs = np.stack([saved[k] for k in keys])
    check(vecs.shape == (len(keys), 7) and np.isfinite(vecs).all()
          and (vecs >= 0).all(), 'un_v4.pkl holds a negative or non-finite '
                                 'variance')
    with open(root / 'kitti_infos_train_wconf.pkl', 'rb') as f:
        wconf = pickle.load(f)
    n_other = 0
    for info in wconf:
        annos = info['annos']
        u, car = annos['uncertainty'], annos['name'] == 'Car'
        check(u.shape == (len(car), 7) and (u[car] >= 0).all()
              and (u[~car] == -1).all(),
              f'frame {info["image"]["image_idx"]}: bad uncertainty rows')
        n_other += int((~car).sum())
    check(n_other > 0, 'the _wconf infos hold no object of another class')
    print(f'[cvae] cvae_train --folds 2 --passes {CVAE_PASSES} --epochs 2 '
          f'--inject on the [cli] tree: {cli_s:.1f} s; un_v4.pkl covers all '
          f'{len(keys)} Car crops (variance per dim, mean '
          + ', '.join(f'{v:.4f}' for v in vecs.mean(0))
          + f'); kitti_infos_train_wconf.pkl: {len(wconf)} frames, '
            f'{n_other} rows of other classes at -1')

    step_launches, seen = [], []
    undo = count_launches(state_lib, 'make_train_step', step_launches)
    real_copy = train_cli.to_device

    def copy(batch, device):
        seen.append(batch)
        return real_copy(batch, device)

    train_cli.to_device = copy
    LAUNCHES.n = 0
    try:
        run = train_cli.main([
            '--cfg_file', str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'),
            '--data_path', str(root), '--output_dir', str(tmp / 'vr_wconf'),
            '--batch_size', str(CLI_BATCH), '--epochs', '1',
            '--max_steps_per_epoch', '2', '--set',
            'DATA_CONFIG.INFO_PATH.train', 'kitti_infos_train_wconf.pkl',
            'DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST:0.DB_INFO_PATH',
            'kitti_dbinfos_train_wconf.pkl'])
    finally:
        undo()
        train_cli.to_device = real_copy
    launches = LAUNCHES.n
    check(len(run['steps']) == 2 and step_launches == [4, 4],
          f'detector steps on the _wconf infos: {len(run["steps"])}, '
          f'merge-resolve launches {step_launches}')
    for r in run['steps']:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'detector step {r["it"]} on the _wconf infos: not '
                       f'finite: {bad}')
    known = {tuple(np.float32(v)) for v in saved.values()}
    rows = [tuple(u) for b in seen for u, m in zip(
        b['gt_uncertainty'].reshape(-1, 7), b['gt_mask'].reshape(-1)) if m]
    check(rows and all(r in known for r in rows),
          'a gt box of the detector batches carries a variance not in '
          'un_v4.pkl')
    print(f'[cvae] GLENet-VR through the train CLI on the _wconf infos '
          f'(--set DATA_CONFIG.INFO_PATH.train, ...AUG_CONFIG_LIST:0.'
          f'DB_INFO_PATH), B={CLI_BATCH}: ' + ', '.join(
              f'step {r["it"]} {r["step_ms"]:.1f} ms loss {r["loss"]:.4f} '
              f'rcnn_loss_reg {r["rcnn_loss_reg"]:.4f}' for r in run['steps'])
          + f'; {len(rows)} gt boxes, each with a variance from un_v4.pkl; '
            f'merge_resolve launches per step {step_launches}')

    fold0 = captured[0]
    check(len(fold0) == CVAE_PASSES, f'{len(fold0)} passes in fold 0')
    t0 = time.perf_counter()
    report = analysis.analyze(fold0)
    t1 = time.perf_counter()
    path = tmp / 'fold0_passes.pkl'
    with open(path, 'wb') as f:
        pickle.dump(fold0, f)
    via_cli = cvae_analysis.main([str(path)])
    check(np.isfinite(report['nll']) and 0 <= report['mean_iou'] <= 1
          and via_cli == report, f'analysis of fold 0: {report}, through '
                                 f'the CLI {via_cli}')
    print(f'[cvae] analysis of fold 0 ({CVAE_PASSES} passes, IoUs on the '
          f'card, {1e3 * (t1 - t0):.1f} ms): ' + json.dumps(report)
          + '; tools.cvae_analysis gives the same report')
    return launches


def phase_cvae_waymo(tmp):
    """One train step and one prediction pass of the Waymo configuration
    on a small synthetic database of 5-feature crops."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import Cfg, cfg_from_yaml_file
    from glenet_tpu_torch.cvae import dataset as cds
    from glenet_tpu_torch.cvae import pipeline
    from glenet_tpu_torch.train import optim
    from glenet_tpu_torch.utils import synthetic
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/cvae/waymo_exp_gen.yaml'))
    root = tmp / 'waymo_crops'
    synthetic.write_crop_database(root, WAYMO_CROPS, seed=SEED + 2,
                                  waymo=True)
    data_cfg = Cfg(dict(cfg.DATA_CONFIG, FOLD_IDX=0))
    train_ds = cds.WaymoGtDataset(data_cfg, training=True, root_path=root)
    val_ds = cds.WaymoGtDataset(data_cfg, training=False, root_path=root)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    gen = pipeline.build_generator(cfg.MODEL, 'cuda', seed=SEED)
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
    opt_state = tx.init(list(gen.parameters()))
    batch = next(train_ds.iter_batches(b, seed=SEED))
    check(batch['points'].shape == (b, 512, 5), f'Waymo batch '
                                                f'{batch["points"].shape}')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = pipeline.make_cvae_train_step(gen, cfg.MODEL, tx)(
        opt_state, pipeline.to_device(batch, 'cuda'),
        torch.Generator(device='cuda').manual_seed(SEED), 1.0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vals = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in vals.values()), f'Waymo step {vals}')
    per_pass = pipeline.predict_samples(gen, val_ds, cfg.MODEL, n_passes=1,
                                        batch_size=b, seed=SEED)
    t2 = time.perf_counter()
    preds = np.stack([v['pred_box'] for v in per_pass[0].values()])
    check(preds.shape == (len(val_ds), 7) and np.isfinite(preds).all(),
          f'Waymo pass {preds.shape}')
    key = next(iter(per_pass[0]))
    check('#' in key, f'Waymo key {key}')
    print(f'[cvae] Waymo (waymo_exp_gen.yaml, 5 features, {WAYMO_CROPS} '
          f'crops, fold 0 of 5): train step B={b} {1e3 * (t1 - t0):.1f} ms '
          f'(first call), loss {vals["loss"]:.4f}, grad_norm '
          f'{vals["grad_norm"]:.3f}; a pass over {len(val_ds)} val crops '
          f'{1e3 * (t2 - t1):.1f} ms; keys like {key}')


def phase_cvae_gpu_vs_cpu(cfg, batch):
    """One full-width CVAE train step and one `sample` on the card and on
    the port's CPU path: same seeded weights, the same fixed eps, f32 with
    TF32 off."""
    import re

    import torch

    from glenet_tpu_torch.cvae import model as cm
    from glenet_tpu_torch.cvae import pipeline
    from glenet_tpu_torch.train import optim
    b, latent = batch['points'].shape[0], int(cfg.MODEL.LATENT_DIM)
    eps = torch.randn((b, latent), generator=torch.Generator().manual_seed(
        SEED + 21))
    saved = (cm.draw_eps, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    cm.draw_eps = lambda shape, generator, device: eps.to(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        for dev in ('cpu', 'cuda'):
            gen = pipeline.build_generator(cfg.MODEL, dev, seed=SEED + 5)
            with torch.no_grad():
                sampled = gen.sample(torch.from_numpy(batch['points']).to(dev))
            tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 1000)
            opt_state = tx.init(list(gen.parameters()))
            metrics = pipeline.make_cvae_train_step(gen, cfg.MODEL, tx)(
                opt_state, pipeline.to_device(batch, dev), None, 0.5)
            runs[dev] = ({k: float(v) for k, v in metrics.items()}, gen,
                         sampled.cpu(), tx)
    finally:
        (cm.draw_eps, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    (mc, gc, sc, tx), (mg, gg, sg, _) = runs['cpu'], runs['cuda']
    # f32 on both devices, sums in another order.  Loss terms rtol 1e-4.
    # Gradients: max |diff| <= 1e-3 max |grad| + 1e-6 per tensor, except
    # the biases a batch-moment BN follows (the PointNets' Dense biases,
    # fc1, fc2, SimPointNetFeat's last BN bias), whose exact gradient is 0
    # and whose computed one is rounding noise: both below 1e-4 of their
    # encoder's largest gradient.  BN stats rtol 1e-4 / atol 1e-5.
    # Parameters after the first Adam step, lr u(c g) with u(x) = x / (|x|
    # + 1e-8), g the gradient, c the clip factor: 1e-6 |p| + 1e-7 + lr
    # |u(c_cpu g_cpu) - u(c_gpu g_gpu)|, the gap of the two devices' own
    # first steps.  Sample: 1e-4 of its largest |value|.
    for k, v in mc.items():
        check(abs(mg[k] - v) <= 1e-4 * abs(v) + 1e-6,
              f'CVAE GPU and CPU differ in {k}: {mg[k]} vs {v}')
    grads_c = {n: p.grad for n, p in gc.named_parameters()}
    grads_g = {n: p.grad.cpu() for n, p in gg.named_parameters()}
    enc_max = {}
    for n, g in grads_c.items():
        e = n.split('.')[0]
        enc_max[e] = max(enc_max.get(e, 0.0), float(g.abs().max()))
    zero = re.compile(r'(PointNetFeat_0\.Dense_\d|fc1|fc2)\.bias$'
                      r'|SimPointNetFeat_0\.BatchNorm_2\.bias$')
    worst, n_zero = 0.0, 0
    for n, g in grads_c.items():
        if zero.search(n):
            n_zero += 1
            lim = 1e-4 * enc_max[n.split('.')[0]]
            check(float(g.abs().max()) <= lim
                  and float(grads_g[n].abs().max()) <= lim,
                  f'CVAE zero-gradient bias {n} above {lim:.3e}')
            continue
        err = float((g - grads_g[n]).abs().max())
        tol = 1e-3 * float(g.abs().max()) + 1e-6
        check(err <= tol, f'CVAE GPU and CPU gradients differ in {n}: '
                          f'{err:.3e} > {tol:.3e}')
        worst = max(worst, err / tol)
    check(n_zero == 12, f'{n_zero} zero-gradient biases')
    bufs_g = dict(gg.named_buffers())
    for n, t in gc.named_buffers():
        check(torch.allclose(t, bufs_g[n].cpu(), rtol=1e-4, atol=1e-5),
              f'CVAE GPU and CPU BN stats differ in {n}')
    lr = tx.hyperparams(0)[0]
    max_norm = float(cfg.OPTIMIZATION.GRAD_NORM_CLIP)

    def first_step(g, norm):
        g = min(1.0, max_norm / norm) * g.double()
        return g / (g.abs() + 1e-8)

    params_g = dict(gg.named_parameters())
    for n, p in gc.named_parameters():
        gap = (first_step(grads_c[n], mc['grad_norm'])
               - first_step(grads_g[n], mg['grad_norm'])).abs()
        bound = 1e-6 * p.detach().double().abs() + 1e-7 + lr * gap
        check(bool(((p.detach() - params_g[n].detach().cpu()).abs()
                    <= bound).all()),
              f'CVAE GPU and CPU parameters differ after the step in {n}')
    s_err = float((sc - sg).abs().max())
    check(s_err <= 1e-4 * float(sc.abs().max()),
          f'CVAE sample differs between GPU and CPU: {s_err:.3e}')
    print(f'[cvae] GPU against CPU, B={b} full width, TF32 off: loss terms '
          f'within rtol 1e-4 (' + ', '.join(
              f'{k} {v:.6f}' for k, v in sorted(mc.items()))
          + f'); gradients within 1e-3 of each tensor\'s largest (worst at '
            f'{worst:.3f} of it), the 12 zero-gradient biases below 1e-4 '
            f'of their encoder\'s largest; BN stats rtol 1e-4; parameters '
            f'after adam_onecycle within 1e-6 |p| + 1e-7 + lr |u(c_cpu '
            f'g_cpu) - u(c_gpu g_gpu)|; sample max_abs_err {s_err:.3e} '
            f'(limit 1e-4 of '
            f'{float(sc.abs().max()):.3f})')


def phase_cvae(tmp, cli_root):
    """[cvae]: (a) full width, (b) the CLI end to end, (c) Waymo, (d) the
    card against the CPU.  Returns the merge-resolve launches of (b)."""
    cfg, batch = phase_cvae_full(tmp)
    launches = phase_cvae_cli(cli_root, tmp)
    phase_cvae_waymo(tmp)
    phase_cvae_gpu_vs_cpu(cfg, batch)
    return launches


def vq_raw_cfg(raw):
    """A copy of the raw config dict in POOL_MODE voxel_query with the
    pool-layer settings of the repository's vq tests (4^3 query range, 0.8 m
    radius, 16 samples, max pooling)."""
    import copy
    raw = copy.deepcopy(raw)
    pool = raw['MODEL']['ROI_HEAD']['ROI_GRID_POOL']
    pool['POOL_MODE'] = 'voxel_query'
    for lay in pool['POOL_LAYERS'].values():
        lay.update(QUERY_RANGES=[[4, 4, 4]], POOL_RADIUS=[0.8], NSAMPLE=[16],
                   POOL_METHOD='max_pool')
    return raw


def convert_synthetic(cfg, seed):
    """A detector on the card with the weights of a synthetic reference
    state dict converted by the port's converter; checks that every key was
    consumed.  Returns (detector, number of keys)."""
    from glenet_tpu_torch.models.detectors import build_detector
    from glenet_tpu_torch.utils import jax_weights, synthetic
    from glenet_tpu_torch.utils import weight_converter as wc
    sd = {k: v.numpy() for k, v in
          synthetic.pcdet_state_dict(cfg, seed=seed).items()}
    det = build_detector(cfg, device='cuda')
    merged, report = wc.convert_full_model(
        cfg, sd, jax_weights.port_to_jax_variables(det.net))
    check(report['unconsumed'] == [] and report['converted'][-1] ==
          'roi_head', f'converter report {report}')
    jax_weights.load_jax_variables(det.net, merged)
    return det, len(sd)


def time_pooling(det, batch):
    """Per level of FEATURES_SOURCE: ms of the detector's voxel-query
    pooling against a corner-pooling head on the same RoIs and levels (one
    predict's proposals and backbone levels; CUDA events, no grad), and the
    taps each vq level scans."""
    import torch

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.models import roi_heads
    from glenet_tpu_torch.utils import cuda_timing as ct
    net = det.net
    seen = {}
    hook = net.backbone_3d.register_forward_hook(
        lambda _m, _i, out: seen.update(ms=out['multi_scale']))
    with torch.no_grad():
        rois = net(batch['points'], batch['points_mask'])['proposals']['rois']
    hook.remove()
    head = net.roi_head
    raw = dict(det.model_cfg.ROI_HEAD)
    raw['ROI_GRID_POOL'] = dict(raw['ROI_GRID_POOL'], POOL_MODE='corner')
    corner = roi_heads.VoxelRCNNHead(
        Cfg(raw), det.voxel_size, det.pc_range,
        net.backbone_3d.level_channels).cuda().eval()
    b, r = rois.shape[:2]
    g = head.grid
    pts = roi_heads.roi_grid_points(rois.reshape(b * r, -1), g).reshape(
        b, r * g ** 3, 3)
    out = {}
    with torch.no_grad():
        for src in head.sources:
            lvl = seen['ms'][src]
            vs = tuple(float(v) * lvl['stride'] for v in det.voxel_size)
            taps = len(getattr(head, f'pool_{src}').consts(
                vs, det.pc_range[:3], 'cuda')[0])
            out[src] = (ct.event_ms(lambda: head.pool_level(src, pts, lvl),
                                    iters=10, warmup=2),
                        ct.event_ms(lambda: corner.pool_level(src, pts, lvl),
                                    iters=10, warmup=2), taps)
    return pts.shape[1] * b, out


def phase_weights_vq(tmp):
    """GLENet_VR_vq.yaml at full width with converted synthetic reference
    weights: N_REQUESTS predicts at B = 2 and TRAIN_STEPS train steps at
    B = 4, launches counted from 0 just before and read just after each;
    host syncs of one more train step; vq against corner pooling per
    level.  Returns the launches."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_cvae import _syncs
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import scene_batches, train_batches
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/'
                                        'GLENet_VR_vq.yaml'))
    t0 = time.perf_counter()
    det, n_keys = convert_synthetic(cfg, SEED + 30)
    print(f'[weights] GLENet_VR_vq.yaml: synthetic reference state dict of '
          f'{n_keys} tensors converted by the port\'s converter, every key '
          f'consumed, loaded in {time.perf_counter() - t0:.2f} s')
    batches = scene_batches(N_REQUESTS + 1, SEED, BATCH)
    with torch.no_grad():
        det.predict(batches[0])                                # warm-up
    launches = 0
    p_times, per_call = [], []
    LAUNCHES.n = 0
    for batch in batches[1:]:
        before = LAUNCHES.n
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = det.predict(batch)
        torch.cuda.synchronize()
        p_times.append(1e3 * (time.perf_counter() - t0))
        per_call.append((pred, LAUNCHES.n - before,
                         torch.cuda.max_memory_allocated()))
    launches += LAUNCHES.n
    k = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    for i, (pred, n, mem) in enumerate(per_call):
        check(tuple(pred['final_boxes'].shape) == (BATCH, k, 7)
              and bool(torch.isfinite(pred['final_boxes']).all())
              and bool(torch.isfinite(pred['final_scores']).all()),
              f'vq predict {i}: outputs not finite or of the wrong shape')
        check(n == 4, f'vq predict {i}: {n} merge-resolve launches')
        print(f'[weights] vq predict {i}: {p_times[i]:.1f} ms; valid final '
              f'boxes {pred["final_valid"].sum(1).tolist()}; merge_resolve '
              f'launches {n}; max_memory_allocated {mem / 2**30:.2f} GiB')
    q, pools = time_pooling(det, batches[1])
    for src, (vq_ms, corner_ms, taps) in pools.items():
        print(f'[weights] pooling {src}, Q = {q} grid points (one predict\'s '
              f'proposals): voxel_query {vq_ms:.3f} ms ({taps} taps, '
              f'NSAMPLE 16) against corner {corner_ms:.3f} ms')

    tx, state, train_step = build_training(cfg, det)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatches = train_batches(TRAIN_STEPS + 2, SEED + 1, b)
    state, _ = train_step(state, tbatches[0])                  # warm-up
    torch.cuda.synchronize()
    times = []
    LAUNCHES.n = 0
    for i, batch in enumerate(tbatches[1:TRAIN_STEPS + 1]):
        before = LAUNCHES.n
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        n = LAUNCHES.n - before
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f'vq train step {i}: {vals}')
        check(n == 4, f'vq train step {i}: {n} merge-resolve launches')
        print(f'[weights] vq train step {i}, B={b}: {times[-1]:.1f} ms; loss '
              f'{vals["loss"]:.4f}, rcnn_loss_reg {vals["rcnn_loss_reg"]:.4f}'
              f', grad_norm {vals["grad_norm"]:.3f}; merge_resolve launches '
              f'{n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    launches += LAUNCHES.n
    syncs = _syncs(lambda: train_step(state, tbatches[-1]))
    bn = sum(v for k, v in syncs.items() if k.startswith('layers.py'))
    print(f'[weights] vq train step: {sum(syncs.values())} host syncs, '
          f'{bn} of them MaskedBatchNorm\'s count tensor (' + ', '.join(
              f'{k} x{v}' for k, v in syncs.most_common()) + ')')
    print(f'[weights] GLENet_VR_vq.yaml means: predict B={BATCH} '
          f'{sum(p_times) / len(p_times):.1f} ms over {len(p_times)} calls, '
          f'train step B={b} {sum(times) / len(times):.1f} ms over '
          f'{len(times)} steps')
    return launches


def predict_and_step(cfg_name, seed, models='kitti_models', launches=4,
                     cfg=None, capture=False):
    """`cfg_name` (or `cfg`, a config built at run time, named `cfg_name`)
    at full width, seeded weights: one predict at B = 2 and one train step
    at B = BATCH_SIZE_PER_GPU, launches counted from 0 just before and read
    just after each, `launches` per call; with capture the predict's
    merge-resolve calls are captured.  Returns a dict: det, cfg, pred,
    predict_ms, n_predict, vals (the step's metrics as floats), step_ms,
    n_step, b, predict_gib, step_gib (peak memory), captured."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import batches_for, seeded_detector
    if cfg is None:
        cfg = cfg_from_yaml_file(str(ROOT / 'configs' / models / cfg_name))
    det = seeded_detector(cfg, 'cuda', seed)
    batch = batches_for(cfg, 1, SEED + 2, BATCH)[0]
    LAUNCHES.n = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured, pred = (capture_calls(lambda: det.predict(batch),
                                    f'{cfg_name} predict') if capture
                      else (None, det.predict(batch)))
    torch.cuda.synchronize()
    predict_ms = 1e3 * (time.perf_counter() - t0)
    predict_gib = torch.cuda.max_memory_allocated() / 2**30
    n_predict = LAUNCHES.n
    check(n_predict == launches
          and bool(torch.isfinite(pred['final_boxes']).all())
          and bool(torch.isfinite(pred['final_scores']).all()),
          f'{cfg_name} predict: {n_predict} launches or outputs not finite')
    _, state, train_step = build_training(cfg, det)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatch = batches_for(cfg, 1, SEED + 3, b, train=True)[0]
    LAUNCHES.n = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = train_step(state, tbatch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    step_gib = torch.cuda.max_memory_allocated() / 2**30
    n_step = LAUNCHES.n
    vals = {k: float(v) for k, v in metrics.items()}
    check(n_step == launches and all(math.isfinite(v) for v in vals.values()),
          f'{cfg_name} train step: {n_step} launches, {vals}')
    return {'det': det, 'cfg': cfg, 'pred': pred, 'predict_ms': predict_ms,
            'n_predict': n_predict, 'vals': vals, 'step_ms': step_ms,
            'n_step': n_step, 'b': b, 'predict_gib': predict_gib,
            'step_gib': step_gib, 'captured': captured}


def phase_weights_plain():
    """voxel_rcnn_car.yaml (plain Voxel R-CNN) at full width, seeded
    weights: one predict at B = 2 and one train step at B = 4."""
    r = predict_and_step('voxel_rcnn_car.yaml', SEED + 40)
    vals = r['vals']
    check(not r['det'].net.roi_head.kl_label,
          'voxel_rcnn_car.yaml built a KL head')
    check('rcnn_loss_reg_src' not in vals, f'plain train step: {vals}')
    print(f'[weights] voxel_rcnn_car.yaml (plain head, nms_gpu): predict '
          f'B={BATCH} {r["predict_ms"]:.1f} ms (first call), valid final '
          f'boxes {r["pred"]["final_valid"].sum(1).tolist()}, merge_resolve '
          f'launches {r["n_predict"]}; train step B={r["b"]} '
          f'{r["step_ms"]:.1f} ms (first call), loss {vals["loss"]:.4f}, '
          f'smooth-L1 rcnn_loss_reg {vals["rcnn_loss_reg"]:.4f}, '
          f'merge_resolve launches {r["n_step"]}')
    return r['n_predict'] + r['n_step']


def phase_weights_cli(cli_root, tmp, cfg_name='GLENet_VR_vq.yaml',
                      tag='weights', seed=SEED + 50):
    """A synthetic reference .pth of `cfg_name` through the convert_weights
    CLI, then `tools.test --ckpt` on the tree at `cli_root`, in process;
    launches counted from 0 just before and read just after.  Every key is
    consumed but SECONDHead's and PV-RCNN's stage 2 (pfe.*, point_head.*,
    roi_head.*), which neither package converts."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.models.detectors import Detector
    from glenet_tpu_torch.tools import convert_weights
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.utils import synthetic
    cfg_file = str(ROOT / 'configs/kitti_models' / cfg_name)
    cfg = cfg_from_yaml_file(cfg_file)
    pth, out = tmp / f'pcdet_{cfg.TAG}.pth', tmp / f'weights_out_{cfg.TAG}'
    torch.save({'model_state': synthetic.pcdet_state_dict(cfg, seed),
                'epoch': 80}, pth)
    t0 = time.perf_counter()
    path, report = convert_weights.main([
        '--cfg_file', cfg_file, '--torch_ckpt', str(pth),
        '--output_dir', str(out / 'ckpt')])
    t1 = time.perf_counter()
    stage2 = {'SECONDHead': ('roi_head.',),
              'PVRCNNHead': ('pfe.', 'point_head.', 'roi_head.')}.get(
        cfg.MODEL.get('ROI_HEAD', {}).get('NAME'), ())
    left = report['unconsumed']
    check((all(k.startswith(stage2) for k in left)
           and {k.split('.')[0] + '.' for k in left} == set(stage2)
           if stage2 else left == [])
          and Path(path).name == 'checkpoint_epoch_80.pth',
          f'convert_weights: {path}, {report}')
    predicts = []
    undo = count_launches(Detector, 'predict', predicts)
    LAUNCHES.n = 0
    try:
        results = test_cli.main(['--cfg_file', cfg_file, '--data_path',
                                 str(cli_root), '--ckpt', path,
                                 '--output_dir', str(out), '--batch_size',
                                 str(CLI_BATCH)])
    finally:
        undo()
    launches = LAUNCHES.n
    (_, res), = results.items()
    keys = [f'Car_3d/{d}_R40' for d in ('easy', 'moderate', 'hard')]
    check(res['frames'] == CLI_VAL and predicts == [4] * math.ceil(
        CLI_VAL / CLI_BATCH) and all(np.isfinite(res['ap'][k]) for k in keys),
        f'test --ckpt: {res["frames"]} frames, launches {predicts}')
    consumed = ('every key consumed but the stage-2 ' + ', '.join(
        f'{p}* {sum(k.startswith(p) for k in left)}' for p in stage2)
        if stage2 else 'every key consumed')
    print(f'[{tag}] {cfg_name}: convert_weights ({len(report["converted"])} '
          f'subtrees, {consumed}) {t1 - t0:.2f} s -> '
          f'{Path(path).name}; test --ckpt on the tree: '
          f'{res["frames"]} val frames, '
          f'{res["sec_per_frame"]:.4f} s/frame, merge_resolve launches per '
          f'predict {predicts}; ' + ', '.join(
              f'{k} {res["ap"][k]:.2f}' for k in keys)
          + ' (synthetic weights: only the keys are checked)')
    return launches


def phase_weights(tmp, cli_root):
    """[weights]: GLENet_VR_vq.yaml with converted reference weights at
    full width, plain Voxel R-CNN, GPU against CPU in vq mode on the toy
    config, and convert_weights -> test --ckpt.  Returns the launches."""
    launches = phase_weights_vq(tmp)
    launches += phase_weights_plain()
    launches += phase_weights_cli(cli_root, tmp)
    return launches


SINGLE_CFGS = ('GLENet_S.yaml', 'GLENet_C.yaml')


def tiny_single_raw():
    """The toy topology as GLENet-C (SECONDNet: VoxelBackBone8xCiassd, SSFA,
    AnchorHeadKLLabelIoU with GLENet_C.yaml's PRE_CLS_THRESH, PRE_IOU_THRESH
    and POW; variance-voting final NMS) at zero score thresholds, so every
    candidate is live whatever the weights."""
    import copy
    raw = copy.deepcopy(TINY_CFG)
    m = raw['MODEL']
    del m['ROI_HEAD']
    m['NAME'] = 'SECONDNet'
    m['BACKBONE_3D'] = {'NAME': 'VoxelBackBone8xCiassd'}
    m['BACKBONE_2D'] = {'NAME': 'SSFA'}
    m['DENSE_HEAD'].update(NAME='AnchorHeadKLLabelIoU', PRE_CLS_THRESH=0.0,
                           PRE_IOU_THRESH=0.0, POW=4)
    m['DENSE_HEAD']['TARGET_ASSIGNER_CONFIG']['NAME'] = \
        'WeightedAxisAlignedTargetAssigner'
    m['POST_PROCESSING']['SCORE_THRESH'] = 0.0
    return raw


def tiny_single_batch(cfg):
    """tiny_batch's points (with the config's point features), 3 gt boxes
    per sample of the first anchor's size within 0.3 m of anchor centres
    (so they match), label variances in [0.02, 0.3)."""
    import numpy as np
    import torch

    from glenet_tpu_torch.models.detectors import build_detector
    pts = torch.from_numpy(tiny_batch(SEED + 7, features=n_features(cfg)))
    b = pts.shape[0]
    rng = np.random.RandomState(SEED + 12)
    anchors = build_detector(cfg, device='cpu').anchor_set.anchors
    centres = anchors[:, :, 0, :3].reshape(-1, 3)
    size = cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]['anchor_sizes'][0]
    gt = np.zeros((b, 8, 8), np.float32)
    for i in range(b):
        for j, c in enumerate(rng.choice(len(centres), 3, replace=False)):
            gt[i, j, :3] = centres[c]
            gt[i, j, :2] += rng.uniform(-0.3, 0.3, 2)
            gt[i, j, 3:] = [*size, rng.uniform(-1, 1), 1]
    gt_mask = np.zeros((b, 8), bool)
    gt_mask[:, :3] = True
    unc = rng.uniform(0.02, 0.3, (b, 8, 7)).astype(np.float32)
    return {'points': pts, 'points_mask': torch.ones(pts.shape[:2],
                                                     dtype=torch.bool),
            'gt_boxes': torch.from_numpy(gt),
            'gt_mask': torch.from_numpy(gt_mask),
            'gt_uncertainty': torch.from_numpy(unc)}


def phase_single_full(cfg_name, seed):
    """[single] (a): `cfg_name` at full width with seeded weights: a warm-up
    predict that captures the merge-resolve calls, N_REQUESTS predicts at
    the published thresholds and N_REQUESTS at zero thresholds (every
    NMS_PRE_MAXSIZE candidate live), then phase_train's steps.  Returns
    (launches, the captured calls)."""
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.utils.synthetic import scene_batches, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models' / cfg_name))
    det = seeded_detector(cfg, 'cuda', seed)
    batches = scene_batches(N_REQUESTS + 1, SEED, BATCH)
    t0 = time.perf_counter()
    captured = capture_calls(lambda: det.predict(batches[0]),
                             f'{cfg.TAG} predict')[0]
    print(f'[single] {cfg.TAG}: warm-up predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    launches = phase_full_width(det, batches[1:], 'single', cfg.TAG)
    post = det.model_cfg.POST_PROCESSING
    saved = {k: post[k] for k in ('SCORE_THRESH', 'POST_SCORE_THRESH')
             if k in post}
    post.update(dict.fromkeys(saved, 0.0))
    try:
        launches += phase_full_width(det, batches[1:], 'single',
                                     f'{cfg.TAG} at zero thresholds', 1)
    finally:
        post.update(saved)
    launches += phase_train(cfg, det, 'single', cfg.TAG)[0]
    del det
    torch.cuda.empty_cache()
    return launches, captured


def phase_single_second():
    """[single] (b): second.yaml (3 classes, AnchorHeadSingle, nms_gpu):
    one predict and one train step."""
    r = predict_and_step('second.yaml', SEED + 70)
    vals, labels = r['vals'], r['pred']['final_labels']
    check(r['det'].anchor_set.num_anchors_per_location == 6
          and int(labels.min()) >= 0 and int(labels.max()) <= 3
          and 'loc_loss_src' not in vals,
          f'second.yaml: labels {labels.unique().tolist()}, {vals}')
    print(f'[single] second.yaml (3 classes, nms_gpu): predict B={BATCH} '
          f'{r["predict_ms"]:.1f} ms (first call), valid final boxes '
          f'{r["pred"]["final_valid"].sum(1).tolist()}, labels '
          f'{labels.unique().tolist()}, merge_resolve launches '
          f'{r["n_predict"]}; train step B={r["b"]} {r["step_ms"]:.1f} ms '
          f'(first call), ' + ', '.join(f'{k} {v:.4f}' for k, v in
                                        sorted(vals.items()))
          + f', merge_resolve launches {r["n_step"]}')
    return r['n_predict'] + r['n_step']


def phase_single(tmp, cli_root):
    """[single]: GLENet-S and GLENet-C at full width, plain SECOND, and a
    synthetic GLENet-C .pth through convert_weights into test --ckpt.
    Returns (launches, the captured calls of GLENet-C's warm-up
    predict)."""
    launches, captured = 0, {}
    for i, name in enumerate(SINGLE_CFGS):
        n, captured[name] = phase_single_full(name, SEED + 60 + i)
        launches += n
    launches += phase_single_second()
    launches += phase_weights_cli(cli_root, tmp, 'GLENet_C.yaml', 'single',
                                  SEED + 80)
    return launches, captured['GLENet_C.yaml']


# ---------------------------------------------------------------------------
# [waymo]: GLENet-S on Waymo (configs/waymo_models/GLENet_S.yaml)
# ---------------------------------------------------------------------------

WAYMO_SEQ, WAYMO_FRAMES = 3, 6          # 2 train + 1 val sequences
WAYMO_BATCH = 4
WAYMO_EVAL_FRAMES = 300
WAYMO_VAL_FRAMES = 202 * 198            # Waymo's val split, ~40 k frames


def phase_waymo_full(seed):
    """(a): GLENet_S.yaml on Waymo at full width, seeded weights: a warm-up
    predict that captures the merge-resolve calls, N_REQUESTS predicts at
    B = 2 at the published thresholds and 1 at zero thresholds, then
    phase_train's steps at B = 4 on Waymo scenes.  Returns (launches, the
    captured predict calls, the captured train-step calls, step ms)."""
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.utils.synthetic import (WAYMO_N_POINTS,
                                                  seeded_detector,
                                                  waymo_scene_batches)
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/waymo_models/GLENet_S.yaml'))
    det = seeded_detector(cfg, 'cuda', seed)
    check(det.num_point_features == 5
          and tuple(det.grid_size) == (1504, 1504, 40)
          and det.anchor_set.anchors.shape[:3] == (188, 188, 2),
          f'Waymo GLENet-S built with {det.num_point_features} features, '
          f'grid {det.grid_size}')
    t0 = time.perf_counter()
    batches = waymo_scene_batches(N_REQUESTS + 1, SEED, BATCH)
    n_pts = [int(m.sum()) for b in batches for m in b['points_mask']]
    print(f'[waymo] {len(n_pts)} synthetic Waymo scenes, {min(n_pts)}-'
          f'{max(n_pts)} points in range each, made in '
          f'{time.perf_counter() - t0:.1f} s; level caps at the test budget '
          f'{sparse.level_caps(det.max_voxels_test)}, at the train budget '
          f'{sparse.level_caps(det.max_voxels_train)}')
    t0 = time.perf_counter()
    captured = capture_calls(lambda: det.predict(batches[0]),
                             'Waymo GLENet-S predict')[0]
    print(f'[waymo] GLENet-S Waymo: warm-up predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    label = 'GLENet-S Waymo'
    launches = phase_full_width(det, batches[1:], 'waymo', label,
                                n_points=WAYMO_N_POINTS)
    post = det.model_cfg.POST_PROCESSING
    saved = post.SCORE_THRESH
    post.SCORE_THRESH = 0.0
    try:
        launches += phase_full_width(det, batches[1:2], 'waymo',
                                     f'{label} at zero thresholds', 1,
                                     n_points=WAYMO_N_POINTS)
    finally:
        post.SCORE_THRESH = saved
    n, captured_train, step_ms = phase_train(cfg, det, 'waymo', label,
                                             n_points=WAYMO_N_POINTS)
    del det
    torch.cuda.empty_cache()
    return launches + n, captured, captured_train, step_ms


def phase_waymo_cli(tmp, in_memory_ms):
    """(b): a synthetic Waymo tree through the port's gt database, the
    train CLI (B = 4, 1 epoch x 2 steps, then a resume for a second epoch)
    and the test CLI with the Waymo evaluation.  Returns (launches, the
    tree's root)."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets import augmentor
    from glenet_tpu_torch.datasets.waymo_dataset import (
        WaymoDataset, create_waymo_gt_database)
    from glenet_tpu_torch.models.detectors import Detector
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.train import state as state_lib
    from glenet_tpu_torch.utils import synthetic
    cfg_file = str(ROOT / 'configs/waymo_models/GLENet_S.yaml')
    cfg = cfg_from_yaml_file(cfg_file)
    root, out = tmp / 'waymo', tmp / 'waymo_out'
    t0 = time.perf_counter()
    synthetic.write_waymo_tree(root, WAYMO_SEQ, WAYMO_FRAMES, seed=SEED)
    t1 = time.perf_counter()
    db = create_waymo_gt_database(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root)
    synthetic.add_waymo_db_variances(root)
    t2 = time.perf_counter()
    print(f'[waymo] synthetic tree in Waymo\'s processed layout: '
          f'{WAYMO_SEQ} sequences x {WAYMO_FRAMES} frames of '
          f'{synthetic.WAYMO_N_POINTS} points (x y z intensity elongation '
          f'NLZ) written in {t1 - t0:.1f} s; create_waymo_gt_database '
          f'{t2 - t1:.1f} s, {len(db["Vehicle"])} Vehicle crops')
    common = ['--cfg_file', cfg_file, '--data_path', str(root),
              '--output_dir', str(out), '--batch_size', str(WAYMO_BATCH),
              '--max_steps_per_epoch', '2']
    every_frame = ['--set', 'DATA_CONFIG.SAMPLED_INTERVAL.train', '1']
    step_launches, predict_launches, data, pasted = [], [], {}, []
    sample = augmentor.DataBaseSampler.__call__

    def count_pasted(self, data_dict):
        n0 = len(data_dict['gt_boxes'])
        out = sample(self, data_dict)
        pasted.append(len(out['gt_boxes']) - n0)
        return out

    augmentor.DataBaseSampler.__call__ = count_pasted
    undo = [count_launches(state_lib, 'make_train_step', step_launches),
            count_launches(Detector, 'predict', predict_launches)]
    timers = [time_calls(WaymoDataset, '__getitem__', data, 'items'),
              time_calls(augmentor.DataAugmentor, '__call__', data,
                         'augment'),
              time_calls(augmentor.DataBaseSampler, '__call__', data,
                         'gt_sampling'),
              time_calls(WaymoDataset, 'collate_batch', data, 'collate'),
              time_calls(train_cli, 'to_device', data, 'copy')]
    LAUNCHES.n = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        first = train_cli.main(common + ['--epochs', '1'] + every_frame)
        resumed = train_cli.main(common + ['--epochs', '2'] + every_frame)
        peak = torch.cuda.max_memory_allocated()
        for u in timers:
            u()
        results = test_cli.main(common[:8])
    finally:
        for u in undo + timers:
            u()
        augmentor.DataBaseSampler.__call__ = sample
    launches = LAUNCHES.n
    steps = first['steps'] + resumed['steps']
    check(resumed['start_step'] == 2
          and [r['it'] for r in steps] == [1, 2, 3, 4],
          f'Waymo CLI steps {[r["it"] for r in steps]}, resumed at '
          f'{resumed["start_step"]}')
    for r in steps:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'Waymo CLI step {r["it"]}: not finite: {bad}')
        print(f'[waymo] CLI train step {r["it"]} (epoch {r["epoch"]}): data '
              f'{r["data_ms"]:.1f} ms, step {r["step_ms"]:.1f} ms, loss '
              f'{r["loss"]:.4f}, loc_loss_src {r["loc_loss_src"]:.4f}, '
              f'grad_norm {r["grad_norm"]:.3f}, lr {r["lr"]:.3e}')
    check(step_launches == [4] * 4, f'merge-resolve launches per Waymo CLI '
                                    f'train step: {step_launches}')
    warm = [r for r in steps if r['it'] not in (1, 3)]
    n = data['collate n']
    check(sum(pasted) > 0, 'gt sampling pasted no box into any Waymo scene')
    print(f'[waymo] gt sampling (Vehicle:15, LIMIT_WHOLE_SCENE) pasted '
          f'{sum(pasted)} boxes into {sum(k > 0 for k in pasted)} of '
          f'{len(pasted)} scenes: {pasted}')
    ms = {k: 1e3 * data[k] / n for k in ('items', 'augment', 'gt_sampling',
                                          'collate', 'copy')}
    print(f'[waymo] train through the CLI, B={WAYMO_BATCH}: resumed at step '
          f'{resumed["start_step"]}; mean over the steps after each run\'s '
          f'first: data {sum(r["data_ms"] for r in warm) / len(warm):.1f} '
          f'ms, step {sum(r["step_ms"] for r in warm) / len(warm):.1f} ms '
          f'against the in-memory step '
          f'{sum(in_memory_ms) / len(in_memory_ms):.1f} ms; data per batch '
          f'(host ms, mean over {n} batches): items '
          f'{ms["items"] + ms["augment"] + ms["gt_sampling"]:.1f} = gt '
          f'sampling {ms["gt_sampling"]:.1f} + world augmentations '
          f'{ms["augment"]:.1f} + loading, NLZ mask, range mask, shuffle '
          f'and padding {ms["items"]:.1f}; collation {ms["collate"]:.1f}; '
          f'copy to the card {ms["copy"]:.1f}; max_memory_allocated '
          f'{peak / 2**30:.2f} GiB')
    (path, res), = results.items()
    keys = [f'OBJECT_TYPE_TYPE_VEHICLE_LEVEL_{lv}/{m}' for lv in (1, 2)
            for m in ('AP', 'APH')]
    check(path.endswith('checkpoint_epoch_1.pth')
          and res['frames'] == WAYMO_FRAMES
          and sorted(res['ap']) == sorted(keys)
          and all(np.isfinite(res['ap'][k]) for k in keys),
          f'Waymo test CLI: {path}, {res["frames"]} frames, {res["ap"]}')
    check(predict_launches == [4] * math.ceil(WAYMO_FRAMES / WAYMO_BATCH),
          f'merge-resolve launches per Waymo CLI predict: '
          f'{predict_launches}')
    print(f'[waymo] test CLI on {Path(path).name}: {res["frames"]} val '
          f'frames, {res["sec_per_frame"]:.4f} s/frame, Waymo evaluation '
          f'{res["eval_sec"]:.3f} s; merge_resolve launches per predict '
          f'{predict_launches}; ' + ', '.join(
              f'{k} {res["ap"][k]:.2f}' for k in keys)
          + ' (random weights: only the keys are checked)')
    return launches, root


def phase_waymo_second():
    """(c): configs/waymo_models/second.yaml (3 classes, AnchorHeadSingle):
    one predict and one train step on Waymo scenes."""
    r = predict_and_step('second.yaml', SEED + 90, 'waymo_models')
    vals, labels = r['vals'], r['pred']['final_labels']
    check(r['det'].num_point_features == 5
          and r['det'].anchor_set.num_anchors_per_location == 6
          and int(labels.max()) <= 3, f'Waymo second.yaml: {vals}')
    print(f'[waymo] second.yaml (Vehicle, Pedestrian, Cyclist): predict '
          f'B={BATCH} {r["predict_ms"]:.1f} ms (first call), valid final '
          f'boxes {r["pred"]["final_valid"].sum(1).tolist()}, merge_resolve '
          f'launches {r["n_predict"]}; train step B={r["b"]} '
          f'{r["step_ms"]:.1f} ms (first call), loss {vals["loss"]:.4f}, '
          f'merge_resolve launches {r["n_step"]}')
    return r['n_predict'] + r['n_step']


def phase_waymo_pointpillar():
    """(g): configs/waymo_models/pointpillar_1x.yaml at full width with
    seeded weights: a warm-up and a timed predict at B = 2, then a warm-up
    and a timed train step at B = BATCH_SIZE_PER_GPU = 2, on synthetic
    Waymo scenes; pillars against the 150000 budget, anchors, peak memory;
    no merge-resolve launch (pillars, no sparse backbone)."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import (seeded_detector,
                                                  waymo_scene_batches)
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/waymo_models/'
                                        'pointpillar_1x.yaml'))
    det = seeded_detector(cfg, 'cuda', SEED + 93)
    n_anchors = det.anchor_set.anchors.size // 7
    check(tuple(det.grid_size) == (468, 468, 1) and det.num_point_features
          == 5 and n_anchors == 468 * 468 * 6,
          f'Waymo PointPillars built with grid {det.grid_size}, '
          f'{n_anchors} anchors')
    pillars = []
    hook = det.net.map_to_bev.register_forward_hook(
        lambda _m, inp, _o: pillars.append(inp[2].sum(1).tolist()))
    budget = det.max_voxels_test
    batches = waymo_scene_batches(2, SEED + 94, BATCH)
    det.predict(batches[0])
    LAUNCHES.n = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = det.predict(batches[1])
    torch.cuda.synchronize()
    predict_ms = 1e3 * (time.perf_counter() - t0)
    n = LAUNCHES.n
    k = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    check(n == 0 and tuple(pred['final_boxes'].shape) == (BATCH, k, 7)
          and bool(torch.isfinite(pred['final_boxes']).all()),
          f'Waymo PointPillars predict: {n} launches, boxes '
          f'{tuple(pred["final_boxes"].shape)}')
    check(max(pillars[-1]) <= budget, f'pillars {pillars[-1]} > {budget}')
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    print(f'[waymo] pointpillar_1x.yaml predict B={BATCH}: {predict_ms:.1f} '
          f'ms; pillars {pillars[-1]}/{budget}; anchors {n_anchors} per '
          f'scene (top {nms.NMS_PRE_MAXSIZE} to nms_gpu); valid final boxes '
          f'{pred["final_valid"].sum(1).tolist()}; merge_resolve launches '
          f'{n}; max_memory_allocated '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    _, state, train_step = build_training(cfg, det)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatches = waymo_scene_batches(2, SEED + 95, b, train=True)
    state, _ = train_step(state, tbatches[0])
    LAUNCHES.n = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = train_step(state, tbatches[1])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    n_step = LAUNCHES.n
    hook.remove()
    vals = {key: float(v) for key, v in metrics.items()}
    check(n_step == 0 and all(math.isfinite(v) for v in vals.values()),
          f'Waymo PointPillars train step: {n_step} launches, {vals}')
    print(f'[waymo] pointpillar_1x.yaml train step B={b}: {step_ms:.1f} ms '
          f'(after a warm-up step); pillars {pillars[-1]}/'
          f'{det.max_voxels_train}; loss {vals["loss"]:.4f}, grad_norm '
          f'{vals["grad_norm"]:.4f}; merge_resolve launches {n_step}; '
          f'max_memory_allocated '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    del det, state
    torch.cuda.empty_cache()
    return n + n_step


def phase_waymo_msgpack(tmp, root):
    """(d): a port train state of Waymo's GLENet-S after 2 steps written as
    a glenet_tpu checkpoint (jax_weights.port_to_jax_variables and the
    inverse optimizer-state map); read back bit for bit; then the train
    CLI auto-resumes from it for a second epoch, and its count, lr and b1
    go on from the checkpoint's.  Returns the launches."""
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.train import checkpoint as ck
    from glenet_tpu_torch.train import jax_checkpoint as jc
    from glenet_tpu_torch.train import optim
    from glenet_tpu_torch.train import state as state_lib
    from glenet_tpu_torch.utils.synthetic import (seeded_detector,
                                                  waymo_scene_batches)
    cfg_file = str(ROOT / 'configs/waymo_models/GLENet_S.yaml')
    cfg = cfg_from_yaml_file(cfg_file)
    det = seeded_detector(cfg, 'cuda', SEED + 95)
    n_total = 4                 # the CLI run's 2 epochs x 2 steps
    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, n_total)
    ts = state_lib.create_train_state(det, tx)
    step = state_lib.make_train_step(det, tx)
    LAUNCHES.n = 0
    for batch in waymo_scene_batches(2, SEED + 96, WAYMO_BATCH, train=True):
        ts, _ = step(ts, batch)
    launches = LAUNCHES.n
    out = tmp / 'waymo_msgpack'
    t0 = time.perf_counter()
    path = jc.save_checkpoint(jc.checkpoint_state(ts, tx, 0, 2),
                              out / 'ckpt', 0)
    t1 = time.perf_counter()
    back = state_lib.create_train_state(
        seeded_detector(cfg, 'cuda', SEED + 97), tx)
    jc.restore_train_state(back, jc.load_checkpoint(path), tx)
    same = all(torch.equal(a, b) for a, b in zip(
        ts.opt_state['mu'] + ts.opt_state['nu'],
        back.opt_state['mu'] + back.opt_state['nu']))
    same &= all(torch.equal(v, back.net.state_dict()[k])
                for k, v in ts.net.state_dict().items())
    check(same and back.step == 2 and back.opt_state['count'] == 2,
          'the .msgpack round trip changed the train state')
    LAUNCHES.n = 0
    run = train_cli.main(['--cfg_file', cfg_file, '--data_path', str(root),
                          '--output_dir', str(out), '--batch_size',
                          str(WAYMO_BATCH), '--max_steps_per_epoch', '2',
                          '--epochs', '2', '--set',
                          'DATA_CONFIG.SAMPLED_INTERVAL.train', '1'])
    launches += LAUNCHES.n
    saved = ck.load_checkpoint(out / 'ckpt' / 'checkpoint_epoch_1.pth')
    lr, b1 = saved['optimizer_state']['hyperparams']
    lr_x, b1_x = tx.hyperparams(3)
    check(run['start_step'] == 2 and [r['it'] for r in run['steps']] == [3, 4]
          and saved['optimizer_state']['count'] == 4
          and abs(lr - lr_x) <= 1e-12 and abs(b1 - b1_x) <= 1e-12,
          f'resume from {path}: start {run["start_step"]}, count '
          f'{saved["optimizer_state"]["count"]}, lr {lr} / {lr_x}, b1 {b1} '
          f'/ {b1_x}')
    print(f'[waymo] .msgpack of a port train state after 2 steps '
          f'({Path(path).stat().st_size / 2**20:.1f} MiB, written in '
          f'{t1 - t0:.2f} s): read back bit for bit (parameters, BN stats, '
          f'Adam moments, count 2, step 2); the train CLI auto-resumed from '
          f'it at step {run["start_step"]}, trained steps '
          f'{[r["it"] for r in run["steps"]]} and wrote '
          f'checkpoint_epoch_1.pth at count '
          f'{saved["optimizer_state"]["count"]}, lr {lr:.6e}, b1 {b1:.6f} '
          f'(the schedule\'s 4th update)')
    del det, ts, back
    torch.cuda.empty_cache()
    return launches


def tiny_waymo_raw(sessd=False):
    """The toy single-stage topology as Waymo's GLENet-S (5 point features,
    one Vehicle class with Waymo's anchor, AnchorHeadKLLabel, variance
    voting at zero thresholds), or with sessd=True as SE-SSD's head with
    ATSS (TOPK 9) on 3D IoU (MATCH_HEIGHT)."""
    import copy
    raw = copy.deepcopy(TINY_CFG)
    raw['CLASS_NAMES'] = ['Vehicle']
    raw['DATA_CONFIG']['POINT_FEATURE_ENCODING'] = {
        'encoding_type': 'absolute_coordinates_encoding',
        'used_feature_list': ['x', 'y', 'z', 'intensity', 'elongation'],
        'src_feature_list': ['x', 'y', 'z', 'intensity', 'elongation']}
    m = raw['MODEL']
    del m['ROI_HEAD']
    m['NAME'] = 'SECONDNet'
    head = m['DENSE_HEAD']
    head['ANCHOR_GENERATOR_CONFIG'][0].update(
        class_name='Vehicle', anchor_sizes=[[4.7, 2.1, 1.7]],
        matched_threshold=0.55, unmatched_threshold=0.4)
    head['NAME'] = 'AnchorHeadKLLabel'
    head['TARGET_ASSIGNER_CONFIG']['NAME'] = \
        'WeightedAxisAlignedTargetAssigner'
    m['POST_PROCESSING']['SCORE_THRESH'] = 0.0
    if sessd:
        head['NAME'] = 'AnchorHeadSessd'
        head['TARGET_ASSIGNER_CONFIG'].update(
            NAME='ATSSTargetAssigner', TOPK=9, MATCH_HEIGHT=True)
    return raw


def waymo_eval_case(n_frames, rng):
    """Synthetic Waymo annos: per frame the Vehicle boxes of waymo_frame
    with random point counts (some of 5 or fewer: LEVEL_2 only) as gts,
    and as detections each gt jittered by one of three offsets plus 10
    false positives, with random scores."""
    import numpy as np

    from glenet_tpu_torch.utils.synthetic import waymo_frame
    gts, dets = [], []
    for _ in range(n_frames):
        _, boxes = waymo_frame(rng, n_points=1000)
        n = len(boxes)
        gts.append({'name': np.array(['Vehicle'] * n), 'boxes_lidar': boxes,
                    'num_points_in_gt': rng.randint(1, 400, n),
                    'difficulty': np.zeros(n, np.int64)})
        sigma = rng.choice([0.05, 0.2, 0.5], n)[:, None]
        jit = boxes + rng.normal(0, 1, (n, 7)) * sigma * [1, 1, 0.3, 0.2,
                                                          0.1, 0.1, 0.2]
        fp = boxes[rng.randint(n, size=10)] + [
            *rng.uniform(-30, 30, 2), 0, 0, 0, 0, 0]
        d = np.concatenate([jit, fp]).astype(np.float32)
        dets.append({'name': np.array(['Vehicle'] * len(d)),
                     'boxes_lidar': d, 'score': rng.uniform(0, 1, len(d))})
    return dets, gts


def phase_waymo_eval():
    """(f): the Waymo evaluation on the card against its CPU run, then its
    time at WAYMO_EVAL_FRAMES frames (IoUs on the card, matching on the
    host) projected to the val split's size."""
    import numpy as np
    import torch

    from glenet_tpu_torch.eval import waymo_eval as we
    dets, gts = waymo_eval_case(WAYMO_EVAL_FRAMES, np.random.RandomState(SEED))
    we.waymo_evaluation(dets[:2], gts[:2], ['Vehicle'], device='cuda')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_gpu, r_gpu = we.waymo_evaluation(dets, gts, ['Vehicle'], device='cuda')
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s_cpu, r_cpu = we.waymo_evaluation(dets, gts, ['Vehicle'], device='cpu')
    t2 = time.perf_counter()
    err = max(abs(r_gpu[k] - r_cpu[k]) for k in r_cpu)
    check(list(r_gpu) == list(r_cpu) and err <= 1e-3,
          f'Waymo evaluation differs between the card and the CPU ({err})')
    ap = r_gpu['OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/AP']
    check(0 < ap < 100, f'Waymo LEVEL_2 AP {ap}')
    frames = we.class_frames(dets, gts, 'Vehicle')
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    we.frame_ious([(d, g) for d, _, g, _ in frames], 'cuda')
    torch.cuda.synchronize()
    iou_s = time.perf_counter() - t3
    n_det = sum(len(d['name']) for d in dets)
    n_gt = sum(len(g['name']) for g in gts)
    print(f'[waymo] Waymo evaluation of {WAYMO_EVAL_FRAMES} frames ({n_gt} '
          f'Vehicle gts, {n_det} detections): card {t1 - t0:.3f} s, CPU '
          f'{t2 - t1:.3f} s, every AP / APH within {err:.1e}; on the card '
          f'the 3D IoUs of every frame take {iou_s:.3f} s, the Hungarian '
          f'matching per cutoff and the curves the rest; ' + ', '.join(
              f'{k} {v:.2f}' for k, v in r_gpu.items()))
    print(f'[waymo] projection, not a measurement: the val split\'s '
          f'{WAYMO_VAL_FRAMES} frames at this rate take '
          f'{(t1 - t0) * WAYMO_VAL_FRAMES / WAYMO_EVAL_FRAMES:.0f} s')


def phase_waymo(tmp):
    """[waymo]: (a) GLENet-S on Waymo at full width, (b) the CLIs on a
    synthetic Waymo tree, (c) second.yaml on Waymo, (g) pointpillar_1x.yaml
    on Waymo, (d) the .msgpack resume, (f) the Waymo evaluation on the
    card; (e), the card against
    the CPU, runs after the kernel check.  Returns (launches, the captured
    predict calls, the captured train-step calls)."""
    launches, captured, captured_train, step_ms = phase_waymo_full(SEED + 85)
    n, root = phase_waymo_cli(tmp, step_ms)
    launches += n
    launches += phase_waymo_second()
    launches += phase_waymo_pointpillar()
    launches += phase_waymo_msgpack(tmp, root)
    phase_waymo_eval()
    return launches, captured, captured_train


# ---------------------------------------------------------------------------
# [three_class]: KITTI's three-class detectors (second_multihead.yaml,
# second_iou.yaml, pointpillar.yaml and its augmentation variants)
# ---------------------------------------------------------------------------

THREE_CLASS_CFGS = ('second_multihead.yaml', 'second_iou.yaml',
                    'pointpillar.yaml')
THREE_CLASS_STEPS = 2
# the [three_class] CLI tree: train and val frames
TC_TRAIN, TC_VAL = 8, CLI_VAL
# second.yaml's anchors per class: (name, size, bottom, matched, unmatched)
KITTI_ANCHORS = (('Car', [3.9, 1.6, 1.56], -1.78, 0.6, 0.45),
                 ('Pedestrian', [0.8, 0.6, 1.73], -0.6, 0.5, 0.35),
                 ('Cyclist', [1.76, 0.6, 1.73], -0.6, 0.5, 0.35))


def tiny_three_class_raw(kind):
    """The toy topology with three classes (second.yaml's anchors) as
    SECOND-multihead ('multihead': AnchorHeadMulti with Car alone and
    Pedestrian with Cyclist in one head, per-class final NMS), SECOND-IoU
    ('iou': SECONDHead on the stride-8 map) or PointPillars ('pillar':
    0.5 x 0.5 x 4 m pillars of at most 4 points, two PFN layers, a
    stride-2 BEV backbone), at zero score thresholds."""
    import copy
    raw = copy.deepcopy(TINY_CFG)
    raw['CLASS_NAMES'] = [a[0] for a in KITTI_ANCHORS]
    m = raw['MODEL']
    head = m['DENSE_HEAD']
    head['ANCHOR_GENERATOR_CONFIG'] = [{
        'class_name': name, 'anchor_sizes': [size],
        'anchor_rotations': [0, 1.57], 'anchor_bottom_heights': [z],
        'align_center': False,
        'feature_map_stride': 2 if kind == 'pillar' else 8,
        'matched_threshold': hi, 'unmatched_threshold': lo}
        for name, size, z, hi, lo in KITTI_ANCHORS]
    m['POST_PROCESSING'].update(SCORE_THRESH=0.0)
    m['POST_PROCESSING']['NMS_CONFIG']['NMS_TYPE'] = 'nms_gpu'
    roi = m.pop('ROI_HEAD')
    m['NAME'] = 'SECONDNet'
    if kind == 'multihead':
        head.update(NAME='AnchorHeadMulti', SHARED_CONV_NUM_FILTER=16,
                    RPN_HEAD_CFGS=[{'HEAD_CLS_NAME': ['Car']},
                                   {'HEAD_CLS_NAME': ['Pedestrian',
                                                      'Cyclist']}])
        m['POST_PROCESSING']['NMS_CONFIG']['MULTI_CLASSES_NMS'] = True
    elif kind == 'iou':
        m['NAME'] = 'SECONDNetIoU'
        m['ROI_HEAD'] = {
            'NAME': 'SECONDHead', 'CLASS_AGNOSTIC': True,
            'SHARED_FC': [32, 32], 'IOU_FC': [32, 32], 'DP_RATIO': 0.3,
            'NMS_CONFIG': roi['NMS_CONFIG'],
            'ROI_GRID_POOL': {'GRID_SIZE': 4, 'IN_CHANNEL': 64,
                              'DOWNSAMPLE_RATIO': 8},
            'TARGET_CONFIG': roi['TARGET_CONFIG'],
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {'rcnn_iou_weight': 1.0,
                                             'code_weights': [1.0] * 7}}}
    else:
        proc = raw['DATA_CONFIG']['DATA_PROCESSOR'][0]
        proc.update(VOXEL_SIZE=[0.5, 0.5, 4.0], MAX_POINTS_PER_VOXEL=4)
        m['NAME'] = 'PointPillar'
        del m['BACKBONE_3D']
        m['VFE'] = {'NAME': 'PillarVFE', 'WITH_DISTANCE': False,
                    'USE_ABSLOTE_XYZ': True, 'USE_NORM': True,
                    'NUM_FILTERS': [16, 16]}
        m['MAP_TO_BEV'] = {'NAME': 'PointPillarScatter',
                           'NUM_BEV_FEATURES': 16}
        m['BACKBONE_2D'].update(LAYER_NUMS=[1, 1], LAYER_STRIDES=[2, 2],
                                NUM_FILTERS=[16, 32],
                                NUM_UPSAMPLE_FILTERS=[16, 16])
    return raw


def per_class(labels, valid, names):
    """'Car n, Pedestrian n, Cyclist n' over the valid boxes."""
    return ', '.join(f'{n} {int(((labels == i + 1) & valid).sum())}'
                     for i, n in enumerate(names))


def phase_three_class_full(cfg_name, seed, capture=False):
    """[three_class] (a): `cfg_name` at full width with seeded weights: a
    warm-up predict, N_REQUESTS predicts at B = 2 at the published
    thresholds and one at zero thresholds (random weights keep no box at
    the published ones), then a warm-up train step and THREE_CLASS_STEPS
    timed steps at B = 4 on three-class scenes; launches counted from 0
    just before and read just after each call.  With capture, the
    merge-resolve calls of the warm-up predict and step are returned for
    the kernel check.  Returns (launches, captured predict, captured
    step)."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.ops import sparse
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import batches_for, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models' / cfg_name))
    names = list(cfg.CLASS_NAMES)
    det = seeded_detector(cfg, 'cuda', seed)
    pillars = det.net.backbone_3d is None
    per_call = 0 if pillars else 4
    sites = {}

    def record_sites(_mod, inp, out):
        if pillars:                       # PointPillarScatter(f, coords, m)
            sites['pillars'] = inp[2].sum(1)
        else:
            ms = out['multi_scale']
            sites.update({k: ms[k]['mask'].sum(1) for k in
                          ('x_conv1', 'x_conv2', 'x_conv3')})

    hook = (det.net.map_to_bev if pillars else det.net.backbone_3d
            ).register_forward_hook(record_sites)

    def site_text(budget):
        if pillars:
            return f'pillars {sites["pillars"].tolist()}/{budget}'
        caps = sparse.level_caps(budget)
        return 'active sites ' + ', '.join(
            f'{k} {sites[k].tolist()}/{caps[i]}'
            for i, k in enumerate(('x_conv1', 'x_conv2', 'x_conv3')))

    batches = batches_for(cfg, N_REQUESTS + 1, SEED + 5, BATCH)
    t0 = time.perf_counter()
    captured, _ = capture_calls(lambda: det.predict(batches[0]),
                                f'{cfg.TAG} predict')
    print(f'[three_class] {cfg.TAG}: warm-up predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    check(len(captured) == per_call, f'{cfg.TAG}: {len(captured)} '
                                     f'merge-resolve calls per predict')
    post = det.model_cfg.POST_PROCESSING
    launches, times = 0, []
    for r, batch in enumerate(batches[1:] + batches[1:2]):
        zero = r == N_REQUESTS
        saved = post.SCORE_THRESH
        if zero:
            post.SCORE_THRESH = 0.0
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            pred = det.predict(batch)
            torch.cuda.synchronize()
        finally:
            post.SCORE_THRESH = saved
        ms = 1e3 * (time.perf_counter() - t0)
        n = LAUNCHES.n
        launches += n
        check(n == per_call, f'{cfg.TAG} predict {r}: {n} merge-resolve '
                             f'launches, expected {per_call}')
        k = int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
        for key, shape in (('final_boxes', (BATCH, k, 7)),
                           ('final_scores', (BATCH, k))):
            check(tuple(pred[key].shape) == shape
                  and bool(torch.isfinite(pred[key]).all()),
                  f'{cfg.TAG} predict {r}: {key} {tuple(pred[key].shape)} '
                  f'or not finite')
        labels, valid = pred['final_labels'], pred['final_valid']
        check(int(labels.min()) >= 0 and int(labels.max()) <= len(names),
              f'{cfg.TAG}: labels {labels.unique().tolist()}')
        if zero:
            check(int(valid.sum()) > 0, f'{cfg.TAG}: no box kept at zero '
                                        f'thresholds')
        else:
            times.append(ms)
        print(f'[three_class] {cfg.TAG} predict {r}'
              + (' at zero thresholds' if zero else '')
              + f': {ms:.1f} ms; {site_text(det.max_voxels_test)}; '
              f'detections {valid.sum(1).tolist()} ('
              f'{per_class(labels, valid, names)}); merge_resolve launches '
              f'{n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    print(f'[three_class] {cfg.TAG} predict B={BATCH} x {N_POINTS} points: '
          f'mean {sum(times) / len(times):.1f} ms over {len(times)} requests')

    _, state, train_step = build_training(cfg, det)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatches = batches_for(cfg, THREE_CLASS_STEPS + 1, SEED + 6, b,
                           train=True)
    gt_labels = tbatches[0]['gt_boxes'][..., 7][tbatches[0]['gt_mask']]
    t0 = time.perf_counter()
    captured_train, (state, _) = capture_calls(
        lambda: train_step(state, tbatches[0]), f'{cfg.TAG} train step')
    print(f'[three_class] {cfg.TAG} train step B={b}: gt boxes per class '
          + per_class(gt_labels, torch.ones_like(gt_labels, dtype=bool),
                      names)
          + f'; warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms')
    params = {n: p.detach().clone() for n, p in det.net.named_parameters()}
    stats = {n: t.clone() for n, t in det.net.named_buffers()
             if n.endswith(('running_mean', 'running_var'))}
    times = []
    for i, batch in enumerate(tbatches[1:]):
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        n = LAUNCHES.n
        launches += n
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f'{cfg.TAG} train step {i}: {vals}')
        check(n == per_call, f'{cfg.TAG} train step {i}: {n} merge-resolve '
                             f'launches, expected {per_call}')
        print(f'[three_class] {cfg.TAG} step {i}: {times[-1]:.1f} ms; '
              + ', '.join(f'{k} {v:.5f}' for k, v in sorted(vals.items()))
              + f'; {site_text(det.max_voxels_train)}; merge_resolve '
              f'launches {n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    hook.remove()
    still = [n for n, p in det.net.named_parameters()
             if torch.equal(p.detach(), params[n])]
    stuck = [n for n, p in det.net.named_parameters() if n in still and (
        bool(p.detach().any()) or (p.grad is not None and bool(p.grad.any())))]
    check(not stuck, f'{cfg.TAG}: parameters unchanged by the steps: '
                     f'{stuck}')
    bufs = dict(det.net.named_buffers())
    same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
    check(not same, f'{cfg.TAG}: BN running stats unchanged: {same}')
    print(f'[three_class] {cfg.TAG} {THREE_CLASS_STEPS} steps: mean '
          f'{sum(times) / len(times):.1f} ms; {len(params) - len(still)} '
          f'of {len(params)} parameter tensors and all {len(stats)} BN '
          f'running-stat tensors changed')
    del det
    torch.cuda.empty_cache()
    return launches, (captured if capture else None), (
        captured_train if capture else None)


def phase_three_class_cli(tmp):
    """[three_class] (d): a synthetic three-class tree; for
    pointpillar_newaugs.yaml and pointpillar_pyramid_aug.yaml
    `tools.train` (B = 4, 1 epoch x 2 steps) with each yaml's augmentation
    queue, then `tools.test` with the three-class KITTI evaluation; the
    boxes gt sampling pasted per class (each class must get some) and the
    data ms per batch split into its parts.  Then second_iou.yaml through
    convert_weights -> test --ckpt on the tree.  Launches counted from 0
    just before and read just after.  Returns (launches, the tree's root,
    a checkpoint written)."""
    import math
    import pickle

    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets import augmentor
    from glenet_tpu_torch.datasets.kitti_dataset import (KittiDataset,
                                                         create_kitti_infos)
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.utils import synthetic
    root = tmp / 'kitti_three_class'
    t0 = time.perf_counter()
    synthetic.write_kitti_tree(root, TC_TRAIN, TC_VAL, seed=SEED + 3,
                               n_points=CLI_POINTS, three_class=True)
    t1 = time.perf_counter()
    cfg0 = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/'
                                         'pointpillar_newaugs.yaml'))
    create_kitti_infos(cfg0.DATA_CONFIG, cfg0.CLASS_NAMES, root, root)
    with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
        db = pickle.load(f)
    print(f'[three_class] synthetic three-class KITTI tree: {TC_TRAIN} '
          f'train + {TC_VAL} val frames of {CLI_POINTS} points written in '
          f'{t1 - t0:.1f} s; create_kitti_infos '
          f'{time.perf_counter() - t1:.1f} s; gt database '
          + ', '.join(f'{c} {len(db.get(c, []))}' for c in cfg0.CLASS_NAMES))
    launches, ckpt = 0, None
    for name in ('pointpillar_newaugs.yaml', 'pointpillar_pyramid_aug.yaml'):
        cfg_file = str(ROOT / 'configs/kitti_models' / name)
        cfg = cfg_from_yaml_file(cfg_file)
        out = tmp / f'out_{cfg.TAG}'
        common = ['--cfg_file', cfg_file, '--data_path', str(root),
                  '--output_dir', str(out), '--batch_size', str(CLI_BATCH)]
        data, pasted = {}, []
        sample = augmentor.DataBaseSampler.__call__

        def count_pasted(self, data_dict, sample=sample, pasted=pasted):
            n0 = len(data_dict['gt_names'])
            res = sample(self, data_dict)
            pasted.append(res['gt_names'][n0:])
            return res

        augmentor.DataBaseSampler.__call__ = count_pasted
        timers = [time_calls(KittiDataset, '__getitem__', data, 'items'),
                  time_calls(augmentor.DataAugmentor, '__call__', data,
                             'augment'),
                  time_calls(augmentor.DataBaseSampler, '__call__', data,
                             'gt_sampling'),
                  time_calls(KittiDataset, 'collate_batch', data, 'collate'),
                  time_calls(train_cli, 'to_device', data, 'copy')]
        LAUNCHES.n = 0
        try:
            torch.cuda.reset_peak_memory_stats()
            run = train_cli.main(common + ['--epochs', '1',
                                           '--max_steps_per_epoch', '2'])
            peak = torch.cuda.max_memory_allocated()
            for u in timers:
                u()
            results = test_cli.main(common)
        finally:
            for u in timers:
                u()
            augmentor.DataBaseSampler.__call__ = sample
        launches += LAUNCHES.n
        check(LAUNCHES.n == 0, f'{name}: {LAUNCHES.n} merge-resolve '
                                f'launches (PointPillars has no sparse '
                                f'backbone)')
        for r in run['steps']:
            bad = [k for k, v in r.items() if isinstance(v, float)
                   and not math.isfinite(v)]
            check(not bad, f'{name} CLI step {r["it"]}: not finite: {bad}')
            print(f'[three_class] {cfg.TAG} CLI train step {r["it"]}: data '
                  f'{r["data_ms"]:.1f} ms, step {r["step_ms"]:.1f} ms, loss '
                  f'{r["loss"]:.4f}, loss_cls {r["loss_cls"]:.4f}, loss_loc '
                  f'{r["loss_loc"]:.4f}, grad_norm {r["grad_norm"]:.3f}')
        got = np.concatenate(pasted) if pasted else np.zeros(0, str)
        counts = {c: int((got == c).sum()) for c in cfg.CLASS_NAMES}
        check(all(counts.values()), f'{name}: gt sampling pasted per class '
                                    f'{counts}')
        n = data['collate n']
        ms = {k: 1e3 * data[k] / n for k in ('items', 'augment',
                                              'gt_sampling', 'collate',
                                              'copy')}
        augs = [a.NAME for a in cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST
                if a.NAME != 'gt_sampling' and a.NAME not in
                cfg.DATA_CONFIG.DATA_AUGMENTOR.DISABLE_AUG_LIST]
        print(f'[three_class] {cfg.TAG}: gt sampling pasted per class '
              f'{counts} into {len(pasted)} scenes; data per batch of '
              f'{CLI_BATCH}, host ms (mean over {n} batches): items '
              f'{ms["items"] + ms["augment"] + ms["gt_sampling"]:.1f} = gt '
              f'sampling {ms["gt_sampling"]:.1f} + {" / ".join(augs)} '
              f'{ms["augment"]:.1f} + loading, FOV crop, range masks and '
              f'padding {ms["items"]:.1f}; collation {ms["collate"]:.1f}; '
              f'copy to the card {ms["copy"]:.1f}; max_memory_allocated '
              f'{peak / 2**30:.2f} GiB')
        (path, res), = results.items()
        keys = [f'{c}_3d/moderate_R40' for c in cfg.CLASS_NAMES]
        check(res['frames'] == TC_VAL
              and all(np.isfinite(res['ap'][k]) for k in keys),
              f'{name} test CLI: {res["frames"]} frames, '
              f'{sorted(res["ap"])[:6]}')
        print(f'[three_class] {cfg.TAG} test CLI on {Path(path).name}: '
              f'{res["frames"]} val frames, {res["sec_per_frame"]:.4f} '
              f's/frame, KITTI evaluation {res["eval_sec"]:.3f} s; '
              + ', '.join(f'{k} {res["ap"][k]:.2f}' for k in keys)
              + ' (2 steps from random weights: only the keys are checked)')
        ckpt = ckpt or (path, cfg_file)
    launches += phase_weights_cli(root, tmp, 'second_iou.yaml',
                                  'three_class', SEED + 100)
    return launches, root, ckpt


def phase_three_class_demo(root, ckpt, tmp):
    """[three_class] (e): `tools.demo` over 2 .bin scans of the tree with a
    checkpoint of (d): one JSON line per scan and an HTML scene each."""
    import json as json_lib
    import shutil

    from glenet_tpu_torch.tools import demo
    path, cfg_file = ckpt
    scans = tmp / 'demo_scans'
    scans.mkdir()
    for fid in ('000000', '000001'):
        shutil.copy(root / 'training/velodyne' / f'{fid}.bin', scans)
    out, html = tmp / 'demo.jsonl', tmp / 'demo_html'
    t0 = time.perf_counter()
    records = demo.main(['--cfg_file', cfg_file, '--data_path', str(scans),
                         '--ckpt', path, '--output', str(out),
                         '--html_dir', str(html)])
    dt = time.perf_counter() - t0
    lines = [json_lib.loads(x) for x in out.read_text().splitlines()]
    check(lines == records and [r['frame'] for r in lines] == ['000000',
                                                               '000001'],
          f'demo records: {[r["frame"] for r in lines]}')
    for r in lines:
        check(sorted(r) == ['boxes_lidar', 'frame', 'labels', 'scores']
              and len(r['boxes_lidar']) == len(r['scores'])
              == len(r['labels']), f'demo record {r["frame"]}')
    page = (html / '000000.html').read_text()
    check('const DATA = ' in page and '<canvas' in page,
          'demo HTML scene malformed')
    print(f'[three_class] tools.demo on {Path(path).name} over 2 scans: '
          f'{dt:.2f} s; detections per scan '
          f'{[len(r["labels"]) for r in lines]}; 2 JSON lines and 2 HTML '
          f'scenes ({len(page) / 1e6:.2f} MB each) written')


def phase_three_class(tmp):
    """[three_class]: (a) the three configs at full width, (d) the CLIs
    with PointPillars' augmentation variants and SECOND-IoU's converted
    weights, (e) the demo.  (b) and (c) run after the main paths (kernel
    check, GPU against CPU).  Returns (launches, SECOND-IoU's captured
    predict and train step calls, the three-class tree's root)."""
    launches, captured = 0, {}
    for i, name in enumerate(THREE_CLASS_CFGS):
        n, pred, step = phase_three_class_full(name, SEED + 110 + i,
                                               capture=name ==
                                               'second_iou.yaml')
        launches += n
        if pred is not None:
            captured = {'predict': pred, 'step': step}
    n, root, ckpt = phase_three_class_cli(tmp)
    phase_three_class_demo(root, ckpt, tmp)
    return launches + n, captured, root


PV_RCNN_STEPS = 2


def tiny_pvrcnn_raw():
    """The toy topology as PV-RCNN: MODEL PVRCNN with AnchorHeadSingle,
    VoxelSetAbstraction (64 keypoints; the BEV map, x_conv1..4 and the raw
    points with two radii), PointHeadSimple (16) and PVRCNNHead (a 4^3
    grid pooled by one radius, FCs of 32), the final nms_gpu at zero score
    threshold."""
    import copy
    raw = copy.deepcopy(TINY_CFG)
    m = raw['MODEL']
    m['NAME'] = 'PVRCNN'

    def sa(radius, mlps=((8, 8),), nsample=(8,)):
        return {'MLPS': [list(x) for x in mlps], 'POOL_RADIUS': list(radius),
                'NSAMPLE': list(nsample)}

    m['PFE'] = {
        'NAME': 'VoxelSetAbstraction', 'POINT_SOURCE': 'raw_points',
        'NUM_KEYPOINTS': 64, 'NUM_OUTPUT_FEATURES': 32,
        'SAMPLE_METHOD': 'FPS',
        'FEATURES_SOURCE': ['bev', 'x_conv1', 'x_conv2', 'x_conv3',
                            'x_conv4', 'raw_points'],
        'SA_LAYER': {'raw_points': sa((0.4, 0.8), ((8, 8), (8, 8)), (8, 16)),
                     'x_conv1': sa((0.6,)), 'x_conv2': sa((1.0,)),
                     'x_conv3': sa((2.0,)), 'x_conv4': sa((4.0,))}}
    m['POINT_HEAD'] = {
        'NAME': 'PointHeadSimple', 'CLS_FC': [16], 'CLASS_AGNOSTIC': True,
        'USE_POINT_FEATURES_BEFORE_FUSION': True,
        'TARGET_CONFIG': {'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2]},
        'LOSS_CONFIG': {'LOSS_WEIGHTS': {'point_cls_weight': 1.0}}}
    roi = m['ROI_HEAD']
    roi.update(NAME='PVRCNNHead', ROI_GRID_POOL={
        'GRID_SIZE': 4, 'MLPS': [[8, 8]], 'POOL_RADIUS': [1.0],
        'NSAMPLE': [8], 'POOL_METHOD': 'max_pool'})
    roi['LOSS_CONFIG'] = {'CLS_LOSS': 'BinaryCrossEntropy',
                          'REG_LOSS': 'smooth-l1',
                          'CORNER_LOSS_REGULARIZATION': True,
                          'LOSS_WEIGHTS': roi['LOSS_CONFIG']['LOSS_WEIGHTS']}
    m['POST_PROCESSING'].update(SCORE_THRESH=0.0)
    m['POST_PROCESSING']['NMS_CONFIG']['NMS_TYPE'] = 'nms_gpu'
    return raw


def watch_pvrcnn(det):
    """Forward hooks recording, per call, the active sites of the four
    backbone levels, the keypoint indices of the PFE and, per
    StackSAModuleMSG and radius, the empty balls of each ball query.
    Returns (record, undo)."""
    from glenet_tpu_torch.models.pfe import StackSAModuleMSG
    from glenet_tpu_torch.ops import pointnet2 as pn2
    rec = {'sites': {}, 'keypoints': None, 'empty': []}
    current = [None]

    def sites(_mod, _inp, out):
        ms = out['multi_scale']
        rec['sites'] = {k: ms[k]['mask'].sum(1) for k in
                        ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')}

    def keypoints(_mod, _inp, out):
        rec['keypoints'] = out['keypoint_idx']

    hooks = [det.net.backbone_3d.register_forward_hook(sites),
             det.net.pfe.register_forward_hook(keypoints)]
    for name, mod in det.net.named_modules():
        if isinstance(mod, StackSAModuleMSG):
            hooks.append(mod.register_forward_pre_hook(
                lambda _m, _i, name=name: current.__setitem__(0, name)))
    real = pn2.ball_query

    def ball_query(radius, nsample, xyz, new_xyz, xyz_mask=None):
        idx, empty = real(radius, nsample, xyz, new_xyz, xyz_mask)
        rec['empty'].append((current[0], radius, empty))
        return idx, empty

    pn2.ball_query = ball_query

    def undo():
        pn2.ball_query = real
        for h in hooks:
            h.remove()
    return rec, undo


def pvrcnn_text(rec, budget, points_mask):
    """Active sites against the level caps, keypoints (distinct against the
    valid points; the rest repeat) and empty balls per source and radius
    over the call just recorded; clears the ball-query record."""
    from glenet_tpu_torch.ops import sparse
    caps = sparse.level_caps(budget)
    kp = rec['keypoints']
    distinct = [len(set(r.tolist())) for r in kp]
    n_valid = points_mask.sum(1).tolist()
    empty = ', '.join(f'{name.replace("pfe.", "")} r{r:g} '
                      f'{int(e.sum())}/{e.numel()}'
                      for name, r, e in rec['empty'])
    rec['empty'].clear()
    return ('active sites ' + ', '.join(
        f'{k} {v.tolist()}/{caps[i]}' for i, (k, v) in
        enumerate(rec['sites'].items()))
        + f'; keypoints {kp.shape[1]} per scene, distinct {distinct} of '
        f'{n_valid} valid points (repeated '
        f'{[kp.shape[1] - d for d in distinct]}); empty balls {empty}')


def phase_pv_rcnn_full(models, seed, n_predicts, n_steps, capture=False):
    """[pv_rcnn] (a) / (b): configs/<models>/pv_rcnn.yaml at full width
    with seeded weights: a warm-up predict, `n_predicts` predicts at B = 2
    at the published thresholds and one at zero thresholds, then a warm-up
    train step and `n_steps` timed ones at B = BATCH_SIZE_PER_GPU;
    launches counted from 0 just before and read just after each call but
    the warm-up predict, 4 per call.  Returns (launches, captured predict,
    captured step) (the captured calls with `capture`)."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import batches_for, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs' / models / 'pv_rcnn.yaml'))
    names = list(cfg.CLASS_NAMES)
    tag = f'{models.split("_")[0]} {cfg.TAG}'
    det = seeded_detector(cfg, 'cuda', seed)
    rec, undo = watch_pvrcnn(det)
    batches = batches_for(cfg, n_predicts + 1, SEED + 7, BATCH)
    t0 = time.perf_counter()
    captured, _ = capture_calls(lambda: det.predict(batches[0]),
                                f'{tag} predict')
    print(f'[pv_rcnn] {tag}: warm-up predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    rec['empty'].clear()
    check(len(captured) == 4, f'{tag}: {len(captured)} merge-resolve '
                              f'calls per predict')
    post = det.model_cfg.POST_PROCESSING
    launches, times = 0, []
    for r, batch in enumerate(batches[1:] + batches[1:2]):
        zero = r == n_predicts
        saved = post.SCORE_THRESH
        if zero:
            post.SCORE_THRESH = 0.0
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            pred = det.predict(batch)
            torch.cuda.synchronize()
        finally:
            post.SCORE_THRESH = saved
        ms = 1e3 * (time.perf_counter() - t0)
        n = LAUNCHES.n
        launches += n
        check(n == 4, f'{tag} predict {r}: {n} merge-resolve launches')
        k = int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
        for key, shape in (('final_boxes', (BATCH, k, 7)),
                           ('final_scores', (BATCH, k))):
            check(tuple(pred[key].shape) == shape
                  and bool(torch.isfinite(pred[key]).all()),
                  f'{tag} predict {r}: {key} {tuple(pred[key].shape)} or '
                  f'not finite')
        labels, valid = pred['final_labels'], pred['final_valid']
        check(int(labels.min()) >= 0 and int(labels.max()) <= len(names),
              f'{tag}: labels {labels.unique().tolist()}')
        if zero:
            check(int(valid.sum()) > 0, f'{tag}: no box kept at zero '
                                        f'thresholds')
        else:
            times.append(ms)
        print(f'[pv_rcnn] {tag} predict {r}'
              + (' at zero thresholds' if zero else '')
              + f': {ms:.1f} ms; '
              f'{pvrcnn_text(rec, det.max_voxels_test, batch["points_mask"])}'
              f'; detections {valid.sum(1).tolist()} ('
              f'{per_class(labels, valid, names)}); merge_resolve launches '
              f'{n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    print(f'[pv_rcnn] {tag} predict B={BATCH} x '
          f'{batches[1]["points"].shape[1]} points: mean '
          f'{sum(times) / len(times):.1f} ms over {len(times)} requests')

    _, state, train_step = build_training(cfg, det)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatches = batches_for(cfg, n_steps + 1, SEED + 8, b, train=True)
    gt_labels = tbatches[0]['gt_boxes'][..., 7][tbatches[0]['gt_mask']]
    params = {n: p.detach().clone() for n, p in det.net.named_parameters()}
    stats = {n: t.clone() for n, t in det.net.named_buffers()
             if n.endswith(('running_mean', 'running_var'))}
    times, captured_train = [], None
    for i, batch in enumerate(tbatches):
        label = 'warm-up step' if i == 0 else f'step {i - 1}'
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            captured_train, (state, metrics) = capture_calls(
                lambda: train_step(state, batch), f'{tag} train step')
        else:
            state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        n = LAUNCHES.n
        launches += n
        check(n == 4, f'{tag} train {label}: {n} merge-resolve launches')
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f'{tag} train {label}: {vals}')
        check(vals.get('point_loss_cls', 0) > 0,
              f'{tag} train {label}: no point_loss_cls in {vals}')
        print(f'[pv_rcnn] {tag} {label} B={b}: {times[-1]:.1f} ms; '
              + ', '.join(f'{k} {v:.5f}' for k, v in sorted(vals.items()))
              + '; ' + pvrcnn_text(rec, det.max_voxels_train,
                                   batch['points_mask'])
              + f'; merge_resolve launches {n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    undo()
    check(len(captured_train) == 4, f'{tag}: {len(captured_train)} '
                                    f'merge-resolve calls per train step')
    still = [n for n, p in det.net.named_parameters()
             if torch.equal(p.detach(), params[n])]
    stuck = [n for n, p in det.net.named_parameters() if n in still and (
        bool(p.detach().any()) or (p.grad is not None and bool(p.grad.any())))]
    check(not stuck, f'{tag}: parameters unchanged by the steps: {stuck}')
    bufs = dict(det.net.named_buffers())
    same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
    check(not same, f'{tag}: BN running stats unchanged: {same}')
    timed = times[1:] or times
    print(f'[pv_rcnn] {tag} train B={b}: gt boxes per class '
          + per_class(gt_labels, torch.ones_like(gt_labels, dtype=bool),
                      names)
          + f'; warm-up step {times[0]:.1f} ms, mean of {len(timed)} '
          f'{"timed" if times[1:] else "(warm-up)"} steps '
          f'{sum(timed) / len(timed):.1f} ms; {len(params) - len(still)} of '
          f'{len(params)} parameter tensors and all {len(stats)} BN '
          f'running-stat tensors changed')
    del det, state
    torch.cuda.empty_cache()
    return launches, (captured if capture else None), (
        captured_train if capture else None)


def record_ball_queries():
    """Wrap pointnet2.ball_query so that each call appends its inputs and
    outputs, on the CPU; returns (record, undo)."""
    from glenet_tpu_torch.ops import pointnet2 as pn2
    real, calls = pn2.ball_query, []

    def ball_query(radius, nsample, xyz, new_xyz, xyz_mask=None):
        idx, empty = real(radius, nsample, xyz, new_xyz, xyz_mask)
        calls.append((radius, xyz.detach().cpu(), new_xyz.detach().cpu(),
                      idx.cpu(), empty.cpu()))
        return idx, empty

    pn2.ball_query = ball_query
    return calls, lambda: setattr(pn2, 'ball_query', real)


def check_point_decisions(fc, fg, calls, tag):
    """The card's FPS keypoints and ball queries against the CPU's: equal,
    or the first differing keypoint (its two candidates' running minimum
    squared distances) or ball (the two differing points' squared
    distances against radius^2) is printed and the run fails."""
    import torch
    kc, kg = fc['pfe']['keypoint_idx'], fg['pfe']['keypoint_idx'].cpu()
    if not torch.equal(kc, kg):
        b, k = [int(v) for v in torch.nonzero(kc != kg)[0]]
        xyz = fc['pfe']['keypoints'][b, :k]
        pts = calls['cpu'][0][1][b] if calls['cpu'] else None
        if pts is not None:
            d = [float(((pts[i] - xyz) ** 2).sum(-1).min())
                 for i in (int(kc[b, k]), int(kg[b, k]))]
            print(f'[{tag}] FPS differs first at scene {b} keypoint {k}: '
                  f'CPU point {int(kc[b, k])} (min d^2 {d[0]:.9g}), card '
                  f'point {int(kg[b, k])} (min d^2 {d[1]:.9g})')
        check(False, f'GPU and CPU FPS keypoints differ at scene {b} '
                     f'keypoint {k}')
    check(len(calls['cpu']) == len(calls['cuda']) > 0,
          f'ball queries: {len(calls["cpu"])} on the CPU, '
          f'{len(calls["cuda"])} on the card')
    n_empty = 0
    for i, (c, g) in enumerate(zip(calls['cpu'], calls['cuda'])):
        r, xyz, q, idx_c, empty_c = c
        idx_g, empty_g = g[3], g[4]
        n_empty += int(empty_c.sum())
        if torch.equal(idx_c, idx_g) and torch.equal(empty_c, empty_g):
            continue
        bad = (idx_c != idx_g).any(-1) | (empty_c != empty_g)
        b, m = [int(v) for v in torch.nonzero(bad)[0]]
        s = int(torch.nonzero(idx_c[b, m] != idx_g[b, m])[0]) \
            if not torch.equal(idx_c[b, m], idx_g[b, m]) else 0
        pa, pb = int(idx_c[b, m, s]), int(idx_g[b, m, s])
        d = [float(((xyz[b, p] - q[b, m]) ** 2).sum()) for p in (pa, pb)]
        print(f'[{tag}] ball query {i} (radius {r}) differs first at scene '
              f'{b} query {m} slot {s}: CPU point {pa} (d^2 {d[0]:.9g}), '
              f'card point {pb} (d^2 {d[1]:.9g}), radius^2 '
              f'{float(torch.tensor(r, dtype=torch.float32) ** 2):.9g}')
        check(False, f'GPU and CPU ball queries differ (call {i})')
    print(f'[{tag}] FPS keypoints {tuple(kc.shape)} and '
          f'{len(calls["cpu"])} ball queries (indices and empty flags, '
          f'{n_empty} empty balls) equal on both devices')


def phase_pv_rcnn_cli(root, tmp):
    """[pv_rcnn] (d): pv_rcnn.yaml through `tools.train` (B = 2, 1 epoch x
    2 steps) on the synthetic three-class tree at `root` and `tools.test`
    with the three-class KITTI evaluation, then a synthetic reference .pth
    through convert_weights (the stage-2 keys left unconsumed) and
    `tools.test --ckpt`.  Launches counted from 0 just before and read
    just after.  Returns the launches."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    cfg_file = str(ROOT / 'configs/kitti_models/pv_rcnn.yaml')
    cfg = cfg_from_yaml_file(cfg_file)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    out = tmp / f'out_{cfg.TAG}'
    common = ['--cfg_file', cfg_file, '--data_path', str(root),
              '--output_dir', str(out), '--batch_size', str(b)]
    LAUNCHES.n = 0
    torch.cuda.reset_peak_memory_stats()
    run = train_cli.main(common + ['--epochs', '1',
                                   '--max_steps_per_epoch', '2'])
    peak = torch.cuda.max_memory_allocated()
    n_train = LAUNCHES.n
    check(n_train == 4 * 2, f'pv_rcnn CLI train: {n_train} merge-resolve '
                            f'launches over 2 steps')
    for r in run['steps']:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'pv_rcnn CLI step {r["it"]}: not finite: {bad}')
        check(r.get('point_loss_cls', 0) > 0,
              f'pv_rcnn CLI step {r["it"]}: {r}')
        print(f'[pv_rcnn] {cfg.TAG} CLI train step {r["it"]} B={b}: data '
              f'{r["data_ms"]:.1f} ms, step {r["step_ms"]:.1f} ms, loss '
              f'{r["loss"]:.4f}, point_loss_cls {r["point_loss_cls"]:.4f}, '
              f'rcnn_loss_cls {r["rcnn_loss_cls"]:.4f}, grad_norm '
              f'{r["grad_norm"]:.3f}; max_memory_allocated '
              f'{peak / 2**30:.2f} GiB')
    LAUNCHES.n = 0
    results = test_cli.main(common)
    n_test = LAUNCHES.n
    (path, res), = results.items()
    keys = [f'{c}_3d/moderate_R40' for c in cfg.CLASS_NAMES]
    check(res['frames'] == TC_VAL and n_test == 4 * math.ceil(TC_VAL / b)
          and all(np.isfinite(res['ap'][k]) for k in keys),
          f'pv_rcnn test CLI: {res["frames"]} frames, {n_test} launches, '
          f'{sorted(res["ap"])[:6]}')
    print(f'[pv_rcnn] {cfg.TAG} test CLI on {Path(path).name}: '
          f'{res["frames"]} val frames, {res["sec_per_frame"]:.4f} s/frame, '
          f'KITTI evaluation {res["eval_sec"]:.3f} s; '
          + ', '.join(f'{k} {res["ap"][k]:.2f}' for k in keys)
          + '; merge_resolve launches: train '
          f'{n_train}, test {n_test} (2 steps from random weights: only the '
          f'keys are checked)')
    return n_train + n_test + phase_weights_cli(root, tmp, 'pv_rcnn.yaml',
                                                'pv_rcnn', SEED + 130)


def phase_pv_rcnn(tmp, root):
    """[pv_rcnn]: (a) KITTI's pv_rcnn.yaml at full width, (b) Waymo's, (d)
    the CLIs and converted weights on the three-class tree at `root`.  (c)
    and the kernel check of the captured calls run after the main paths.
    Returns (launches, captured predict and train step calls)."""
    launches, pred, step = phase_pv_rcnn_full('kitti_models', SEED + 120,
                                              N_REQUESTS, PV_RCNN_STEPS,
                                              capture=True)
    n, _, _ = phase_pv_rcnn_full('waymo_models', SEED + 121, 1, 0)
    launches += n + phase_pv_rcnn_cli(root, tmp)
    return launches, {'predict': pred, 'step': step}


# ---------------------------------------------------------------------------
# [parta2]: PartA2 and PartA2-free (UNetV2 sparse at all four levels, its
# UR-block decoder with inverse convs, the intra-part point head, RoI-aware
# pooling and PartA2FCHead)
# ---------------------------------------------------------------------------

PARTA2_STEPS = 3
# UNetV2's merge-resolve calls in order: the x-block tables of its four
# levels and of its three 3^3 strided convs (conv_out and the inverse convs
# build row tables by searchsorted)
UNET_CALL_NAMES = ('subm L1', 'conv2_down', 'subm L2', 'conv3_down',
                   'subm L3', 'conv4_down', 'subm L4')
UNET_LAUNCHES = len(UNET_CALL_NAMES)


def tiny_parta2_raw(free=False):
    """The toy topology as PartA2 (tests/test_parta2.py's make_parta2_cfg
    on TINY_CFG's trunk): UNetV2, PointIntraPartOffsetHead without FCs,
    PartA2FCHead (4^3 RoI-aware grids, 32 features, FCs of 32 / 16); with
    `free` as PartA2-free (make_parta2_free_cfg): MODEL PointRCNN without
    BEV stages, the part head's box branch (PointResidualCoder, FCs of 16)
    as stage 1, DISABLE_PART.  Final nms_gpu at zero score threshold."""
    import copy
    raw = copy.deepcopy(TINY_CFG)
    m = raw['MODEL']
    m.update(NAME='PartA2Net', BACKBONE_3D={'NAME': 'UNetV2'})
    m['POINT_HEAD'] = {
        'NAME': 'PointIntraPartOffsetHead', 'CLS_FC': [], 'PART_FC': [],
        'CLASS_AGNOSTIC': True,
        'TARGET_CONFIG': {'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2]},
        'LOSS_CONFIG': {'LOSS_WEIGHTS': {'point_cls_weight': 1.0,
                                         'point_part_weight': 1.0}}}
    roi = m['ROI_HEAD']
    del roi['ROI_GRID_POOL']
    roi.update(NAME='PartA2FCHead', SHARED_FC=[32, 32], CLS_FC=[16],
               REG_FC=[16], SEG_MASK_SCORE_THRESH=0.3,
               ROI_AWARE_POOL={'POOL_SIZE': 4, 'NUM_FEATURES': 32,
                               'MAX_POINTS_PER_VOXEL': 128})
    roi['TARGET_CONFIG']['ROI_PER_IMAGE'] = 16
    roi['LOSS_CONFIG'] = {'CLS_LOSS': 'BinaryCrossEntropy',
                          'REG_LOSS': 'smooth-l1',
                          'CORNER_LOSS_REGULARIZATION': True,
                          'LOSS_WEIGHTS': roi['LOSS_CONFIG']['LOSS_WEIGHTS']}
    m['POST_PROCESSING'].update(SCORE_THRESH=0.0)
    m['POST_PROCESSING']['NMS_CONFIG']['NMS_TYPE'] = 'nms_gpu'
    if free:
        m['NAME'] = 'PointRCNN'
        for key in ('DENSE_HEAD', 'MAP_TO_BEV', 'BACKBONE_2D'):
            del m[key]
        m['POINT_HEAD'] = {
            'NAME': 'PointIntraPartOffsetHead', 'CLS_FC': [16],
            'PART_FC': [16], 'REG_FC': [16], 'CLASS_AGNOSTIC': False,
            'TARGET_CONFIG': {
                'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2],
                'BOX_CODER': 'PointResidualCoder',
                'BOX_CODER_CONFIG': {'use_mean_size': True,
                                     'mean_size': [[3.9, 1.6, 1.56]]}},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'point_cls_weight': 1.0, 'point_box_weight': 1.0,
                'point_part_weight': 1.0, 'code_weights': [1.0] * 8}}}
        roi.update(DISABLE_PART=True, SEG_MASK_SCORE_THRESH=0.0)
    return raw


def watch_unet(det):
    """A forward hook recording the active sites of UNetV2's four levels
    and the valid proposals of each call.  Returns (record, undo)."""
    rec = {}

    def sites(_mod, _inp, out):
        ms = out['multi_scale']
        rec['sites'] = {k: ms[k]['mask'].sum(1) for k in
                        ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')}

    def proposals(_mod, _inp, out):
        rec['proposals'] = out['proposals']['roi_valid'].sum(1)

    hooks = [det.net.backbone_3d.register_forward_hook(sites),
             det.net.register_forward_hook(proposals)]
    return rec, lambda: [h.remove() for h in hooks]


def unet_text(rec, budget):
    """Active sites of the four levels against their caps and the valid
    proposals of the call just recorded."""
    from glenet_tpu_torch.ops import sparse
    caps = sparse.level_caps(budget)
    return ('active sites ' + ', '.join(
        f'{k} {v.tolist()}/{caps[i]}' for i, (k, v) in
        enumerate(rec['sites'].items()))
        + f'; valid proposals {rec["proposals"].tolist()}')


def phase_parta2_full(models, cfg_name, seed, n_predicts, n_steps,
                      capture=False):
    """[parta2] (a) / (b) / (c): configs/<models>/<cfg_name> at full width
    with seeded weights: a warm-up predict, `n_predicts` predicts at B = 2
    at the published thresholds and one at zero thresholds, then a warm-up
    train step and `n_steps` timed ones at B = BATCH_SIZE_PER_GPU;
    launches counted from 0 just before and read just after each call but
    the warm-up predict, 7 per call.  Returns (launches, captured predict,
    captured step (both with `capture`), mean predict ms, mean step ms)."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import batches_for, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs' / models / cfg_name))
    names = list(cfg.CLASS_NAMES)
    tag = f'{models.split("_")[0]} {cfg.TAG}'
    det = seeded_detector(cfg, 'cuda', seed)
    rec, undo = watch_unet(det)
    batches = batches_for(cfg, n_predicts + 1, SEED + 9, BATCH)
    t0 = time.perf_counter()
    captured, _ = capture_calls(lambda: det.predict(batches[0]),
                                f'{tag} predict')
    print(f'[parta2] {tag}: warm-up predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    check(len(captured) == UNET_LAUNCHES, f'{tag}: {len(captured)} '
                                          f'merge-resolve calls per predict')
    post = det.model_cfg.POST_PROCESSING
    launches, times = 0, []
    for r, batch in enumerate(batches[1:] + batches[1:2]):
        zero = r == n_predicts
        saved = post.SCORE_THRESH
        if zero:
            post.SCORE_THRESH = 0.0
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            pred = det.predict(batch)
            torch.cuda.synchronize()
        finally:
            post.SCORE_THRESH = saved
        ms = 1e3 * (time.perf_counter() - t0)
        n = LAUNCHES.n
        launches += n
        check(n == UNET_LAUNCHES, f'{tag} predict {r}: {n} merge-resolve '
                                  f'launches')
        k = int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
        for key, shape in (('final_boxes', (BATCH, k, 7)),
                           ('final_scores', (BATCH, k))):
            check(tuple(pred[key].shape) == shape
                  and bool(torch.isfinite(pred[key]).all()),
                  f'{tag} predict {r}: {key} {tuple(pred[key].shape)} or '
                  f'not finite')
        labels, valid = pred['final_labels'], pred['final_valid']
        check(int(labels.min()) >= 0 and int(labels.max()) <= len(names),
              f'{tag}: labels {labels.unique().tolist()}')
        if zero:
            check(int(valid.sum()) > 0, f'{tag}: no box kept at zero '
                                        f'thresholds')
        else:
            times.append(ms)
        print(f'[parta2] {tag} predict {r}'
              + (' at zero thresholds' if zero else '')
              + f': {ms:.1f} ms; {unet_text(rec, det.max_voxels_test)}; '
              f'detections {valid.sum(1).tolist()} ('
              f'{per_class(labels, valid, names)}); merge_resolve launches '
              f'{n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    pred_ms = sum(times) / len(times)
    print(f'[parta2] {tag} predict B={BATCH} x '
          f'{batches[1]["points"].shape[1]} points: mean {pred_ms:.1f} ms '
          f'over {len(times)} requests')

    _, state, train_step = build_training(cfg, det)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatches = batches_for(cfg, n_steps + 1, SEED + 10, b, train=True)
    gt_labels = tbatches[0]['gt_boxes'][..., 7][tbatches[0]['gt_mask']]
    params = {n: p.detach().clone() for n, p in det.net.named_parameters()}
    stats = {n: t.clone() for n, t in det.net.named_buffers()
             if n.endswith(('running_mean', 'running_var'))}
    times, captured_train = [], None
    for i, batch in enumerate(tbatches):
        label = 'warm-up step' if i == 0 else f'step {i - 1}'
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            captured_train, (state, metrics) = capture_calls(
                lambda: train_step(state, batch), f'{tag} train step')
        else:
            state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        n = LAUNCHES.n
        launches += n
        check(n == UNET_LAUNCHES, f'{tag} train {label}: {n} merge-resolve '
                                  f'launches')
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f'{tag} train {label}: {vals}')
        check(vals.get('point_loss_part', 0) > 0
              and 'rcnn_loss_cls' in vals,
              f'{tag} train {label}: no part or RCNN loss in {vals}')
        print(f'[parta2] {tag} {label} B={b}: {times[-1]:.1f} ms; '
              + ', '.join(f'{k} {v:.5f}' for k, v in sorted(vals.items()))
              + f'; {unet_text(rec, det.max_voxels_train)}; merge_resolve '
              f'launches {n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    undo()
    check(len(captured_train) == UNET_LAUNCHES,
          f'{tag}: {len(captured_train)} merge-resolve calls per train step')
    still = [n for n, p in det.net.named_parameters()
             if torch.equal(p.detach(), params[n])]
    stuck = [n for n, p in det.net.named_parameters() if n in still and (
        bool(p.detach().any()) or (p.grad is not None and bool(p.grad.any())))]
    check(not stuck, f'{tag}: parameters unchanged by the steps: {stuck}')
    bufs = dict(det.net.named_buffers())
    same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
    check(not same, f'{tag}: BN running stats unchanged: {same}')
    timed = times[1:] or times
    step_ms = sum(timed) / len(timed)
    print(f'[parta2] {tag} train B={b}: gt boxes per class '
          + per_class(gt_labels, torch.ones_like(gt_labels, dtype=bool),
                      names)
          + f'; warm-up step {times[0]:.1f} ms, mean of {len(timed)} '
          f'{"timed" if times[1:] else "(warm-up)"} steps {step_ms:.1f} ms; '
          f'{len(params) - len(still)} of {len(params)} parameter tensors '
          f'and all {len(stats)} BN running-stat tensors changed')
    del det, state
    torch.cuda.empty_cache()
    return (launches, captured if capture else None,
            captured_train if capture else None, pred_ms, step_ms)


def phase_parta2_cli(root, tmp):
    """[parta2] (d): PartA2.yaml through `tools.train` (B = 4, 1 epoch x 2
    steps) on the synthetic three-class tree at `root` and `tools.test`
    with the three-class KITTI evaluation.  Launches counted from 0 just
    before and read just after each.  Returns the launches."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    cfg_file = str(ROOT / 'configs/kitti_models/PartA2.yaml')
    cfg = cfg_from_yaml_file(cfg_file)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    out = tmp / f'out_{cfg.TAG}'
    common = ['--cfg_file', cfg_file, '--data_path', str(root),
              '--output_dir', str(out), '--batch_size', str(b)]
    LAUNCHES.n = 0
    torch.cuda.reset_peak_memory_stats()
    run = train_cli.main(common + ['--epochs', '1',
                                   '--max_steps_per_epoch', '2'])
    peak = torch.cuda.max_memory_allocated()
    n_train = LAUNCHES.n
    check(n_train == UNET_LAUNCHES * 2, f'PartA2 CLI train: {n_train} '
                                        f'merge-resolve launches over 2 steps')
    for r in run['steps']:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'PartA2 CLI step {r["it"]}: not finite: {bad}')
        print(f'[parta2] {cfg.TAG} CLI train step {r["it"]} B={b}: data '
              f'{r["data_ms"]:.1f} ms, step {r["step_ms"]:.1f} ms, loss '
              f'{r["loss"]:.4f}, point_loss_cls {r["point_loss_cls"]:.4f}, '
              f'point_loss_part {r["point_loss_part"]:.4f}, rcnn_loss_cls '
              f'{r["rcnn_loss_cls"]:.4f}, grad_norm {r["grad_norm"]:.3f}; '
              f'max_memory_allocated {peak / 2**30:.2f} GiB')
    LAUNCHES.n = 0
    results = test_cli.main(common)
    n_test = LAUNCHES.n
    (path, res), = results.items()
    keys = [f'{c}_3d/moderate_R40' for c in cfg.CLASS_NAMES]
    check(res['frames'] == TC_VAL
          and n_test == UNET_LAUNCHES * math.ceil(TC_VAL / b)
          and all(np.isfinite(res['ap'][k]) for k in keys),
          f'PartA2 test CLI: {res["frames"]} frames, {n_test} launches, '
          f'{sorted(res["ap"])[:6]}')
    print(f'[parta2] {cfg.TAG} test CLI on {Path(path).name}: '
          f'{res["frames"]} val frames, {res["sec_per_frame"]:.4f} s/frame, '
          f'KITTI evaluation {res["eval_sec"]:.3f} s; '
          + ', '.join(f'{k} {res["ap"][k]:.2f}' for k in keys)
          + f'; merge_resolve launches: train {n_train}, test {n_test} (2 '
          f'steps from random weights: only the keys are checked)')
    return n_train + n_test


def phase_parta2(tmp, root):
    """[parta2]: (a) KITTI's PartA2.yaml and (b) PartA2_free.yaml at full
    width, (c) Waymo's PartA2.yaml, (d) the CLIs on the three-class tree
    at `root`.  (e) and the kernel check of the captured calls run after
    the main paths.  Returns (launches, captured predict and train step
    calls of (a), mean ms of each (a), (b), (c) predict and step)."""
    launches, pred, step, *ms = phase_parta2_full(
        'kitti_models', 'PartA2.yaml', SEED + 140, N_REQUESTS, PARTA2_STEPS,
        capture=True)
    times = {'PartA2': ms}
    n, _, _, *times['PartA2_free'] = phase_parta2_full(
        'kitti_models', 'PartA2_free.yaml', SEED + 141, N_REQUESTS,
        PARTA2_STEPS)
    launches += n
    n, _, _, *times['waymo_PartA2'] = phase_parta2_full(
        'waymo_models', 'PartA2.yaml', SEED + 142, 2, 2)
    launches += n + phase_parta2_cli(root, tmp)
    print('[parta2] mean predict / train step ms: ' + ', '.join(
        f'{k} {p:.1f} / {t:.1f}' for k, (p, t) in times.items()))
    return launches, {'predict': pred, 'step': step}, times


# ---------------------------------------------------------------------------
# [pointrcnn]: PointRCNN (PointNet2MSG, PointHeadBox, RoI point pooling and
# PointRCNNHead; no voxels, no sparse level: no merge-resolve launch)
# ---------------------------------------------------------------------------

POINTRCNN_STEPS = 2


def tiny_pointrcnn_raw():
    """tests/test_pointrcnn.py's toy two-stage PointRCNN
    (make_two_stage_cfg: TINY_POINTRCNN's PointNet2MSG of 128 / 32 / 16 / 8
    centres and FP widths 16-32, PointHeadBox with FCs of 32,
    PointRCNNHead pooling 32 points per roi, SA levels of 16 centres and
    group-all, FCs of 16, CLS_SCORE_TYPE cls), TINY_CFG's optimizer, the
    final nms_gpu at zero score threshold."""
    import copy
    sa = {'NPOINTS': [128, 32, 16, 8], 'RADIUS': [[0.5, 1.0]] * 4,
          'NSAMPLE': [[8, 16]] * 4,
          'MLPS': [[[8, 8], [8, 8]], [[8, 16], [8, 16]],
                   [[16, 16], [16, 16]], [[16, 32], [16, 32]]]}
    return {
        'CLASS_NAMES': ['Car'],
        'DATA_CONFIG': {
            'POINT_CLOUD_RANGE': [0, -8, -1.2, 16, 8, 1.2],
            'DATA_PROCESSOR': [{
                'NAME': 'transform_points_to_voxels',
                'VOXEL_SIZE': [0.5, 0.5, 0.1], 'MAX_POINTS_PER_VOXEL': 5,
                'MAX_NUMBER_OF_VOXELS': {'train': 512, 'test': 512}}]},
        'MODEL': {
            'NAME': 'PointRCNN',
            'BACKBONE_3D': {'NAME': 'PointNet2MSG', 'SA_CONFIG': sa,
                            'FP_MLPS': [[16, 16], [16, 16], [32, 32],
                                        [32, 32]]},
            'POINT_HEAD': {
                'NAME': 'PointHeadBox', 'CLS_FC': [32], 'REG_FC': [32],
                'CLASS_AGNOSTIC': False,
                'TARGET_CONFIG': {
                    'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2],
                    'BOX_CODER': 'PointResidualCoder',
                    'BOX_CODER_CONFIG': {'use_mean_size': True,
                                         'mean_size': [[3.9, 1.6, 1.56]]}},
                'LOSS_CONFIG': {'LOSS_WEIGHTS': {'point_cls_weight': 1.0,
                                                 'point_box_weight': 1.0}}},
            'ROI_HEAD': {
                'NAME': 'PointRCNNHead', 'CLASS_AGNOSTIC': True,
                'ROI_POINT_POOL': {'POOL_EXTRA_WIDTH': [0.0, 0.0, 0.0],
                                   'NUM_SAMPLED_POINTS': 32,
                                   'DEPTH_NORMALIZER': 70.0},
                'XYZ_UP_LAYER': [16, 16], 'CLS_FC': [16], 'REG_FC': [16],
                'DP_RATIO': 0.0, 'USE_BN': False,
                'SA_CONFIG': {'NPOINTS': [16, -1], 'RADIUS': [0.4, 100],
                              'NSAMPLE': [8, 8],
                              'MLPS': [[16, 16], [16, 32]]},
                'NMS_CONFIG': {
                    'TRAIN': {'NMS_TYPE': 'nms_gpu', 'NMS_PRE_MAXSIZE': 128,
                              'NMS_POST_MAXSIZE': 32, 'NMS_THRESH': 0.8},
                    'TEST': {'NMS_TYPE': 'nms_gpu', 'NMS_PRE_MAXSIZE': 128,
                             'NMS_POST_MAXSIZE': 16, 'NMS_THRESH': 0.85}},
                'TARGET_CONFIG': {
                    'BOX_CODER': 'ResidualCoder', 'ROI_PER_IMAGE': 16,
                    'FG_RATIO': 0.5, 'SAMPLE_ROI_BY_EACH_CLASS': True,
                    'CLS_SCORE_TYPE': 'cls', 'CLS_FG_THRESH': 0.6,
                    'CLS_BG_THRESH': 0.45, 'CLS_BG_THRESH_LO': 0.1,
                    'HARD_BG_RATIO': 0.8, 'REG_FG_THRESH': 0.55},
                'LOSS_CONFIG': {
                    'CLS_LOSS': 'BinaryCrossEntropy', 'REG_LOSS': 'smooth-l1',
                    'CORNER_LOSS_REGULARIZATION': True,
                    'LOSS_WEIGHTS': {'rcnn_cls_weight': 1.0,
                                     'rcnn_reg_weight': 1.0,
                                     'rcnn_corner_weight': 1.0,
                                     'code_weights': [1.0] * 7}}},
            'POST_PROCESSING': {
                'SCORE_THRESH': 0.0,
                'NMS_CONFIG': {'MULTI_CLASSES_NMS': False,
                               'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.1,
                               'NMS_PRE_MAXSIZE': 128,
                               'NMS_POST_MAXSIZE': 16}}},
        'OPTIMIZATION': copy.deepcopy(TINY_CFG['OPTIMIZATION']),
    }


NEAR_TIE = 1e-5     # relative: a decision two devices may take either way


def point_decisions(recorded=None):
    """Wrap the integer decisions of ops/pointnet2.py (FPS picks, ball
    queries, three-nn).  With recorded=None each call's outputs are
    recorded (on the CPU).  Given another run's record, each call's outputs
    are compared with the recorded call's; where they differ the first
    difference must be a near tie (FPS: the two candidates' running minimum
    squared distances; three-nn: the two neighbours' squared distances;
    ball query: a point within the radius on one side only lies within
    NEAR_TIE of radius^2), and the call then returns the recorded outputs,
    so both runs go on with one set of decisions (the count is 'adopted');
    any other difference fails.  Returns (the record or the counts, undo)."""
    import torch

    from glenet_tpu_torch.ops import pointnet2 as pn2
    real = {k: getattr(pn2, k) for k in ('farthest_point_sample',
                                         'ball_query', 'three_nn')}
    out = ({} if recorded is None
           else {'adopted': 0, 'calls': 0, 'largest': 0.0})
    queue = None if recorded is None else {k: list(v) for k, v in
                                           recorded.items()}

    def d2(a, b):
        return float(((a.double() - b.double()) ** 2).sum())

    def near(x, y, what):
        gap = abs(x - y) / max(abs(x), abs(y), 1e-30)
        check(gap <= NEAR_TIE, f'{what}: GPU and CPU differ beyond a near '
                               f'tie (relative gap {gap:.3e})')
        out['largest'] = max(out['largest'], gap)

    def wrap(name):
        def fn(*args):
            res = real[name](*args)
            cpu = (tuple(r.detach().cpu() for r in res)
                   if isinstance(res, tuple) else res.detach().cpu())
            if recorded is None:
                out.setdefault(name, []).append(cpu)
                return res
            ref = queue[name].pop(0)
            out['calls'] += 1
            # the decisions: FPS picks, ball-query indices and empty flags,
            # three-nn indices (its distances are floats, held downstream)
            if name == 'three_nn':
                same = torch.equal(cpu[1], ref[1])
            elif name == 'ball_query':
                same = torch.equal(cpu[0], ref[0]) and torch.equal(cpu[1],
                                                                   ref[1])
            else:
                same = torch.equal(cpu, ref)
            if same:
                return res
            if name == 'farthest_point_sample':
                xyz = args[0].detach().cpu()
                b, k = [int(v) for v in torch.nonzero(cpu != ref)[0]]
                taken = xyz[b, cpu[b, :k]]
                dist = [float(((xyz[b, p] - taken) ** 2).sum(-1).min())
                        for p in (int(cpu[b, k]), int(ref[b, k]))]
                near(*dist, f'FPS pick {k} of scene {b}')
            elif name == 'three_nn':
                unknown, known = args[0].detach().cpu(), args[1].detach().cpu()
                b, n, s = [int(v) for v in
                           torch.nonzero(cpu[1] != ref[1])[0]]
                near(d2(unknown[b, n], known[b, int(cpu[1][b, n, s])]),
                     d2(unknown[b, n], known[b, int(ref[1][b, n, s])]),
                     f'three-nn of point {n} of scene {b}')
            else:
                radius, _, xyz, new_xyz = args[:4]
                xyz, new_xyz = xyz.detach().cpu(), new_xyz.detach().cpu()
                r2 = float(torch.tensor(radius, dtype=torch.float32) ** 2)
                bad = (cpu[0] != ref[0]).any(-1) | (cpu[1] != ref[1])
                b, m = [int(v) for v in torch.nonzero(bad)[0]]
                sym = set(cpu[0][b, m].tolist()) ^ set(ref[0][b, m].tolist())
                gaps = [d2(xyz[b, p], new_xyz[b, m]) for p in sym]
                near(min(gaps, key=lambda g: abs(g - r2)), r2,
                     f'ball query {m} of scene {b} (radius {radius})')
            out['adopted'] += 1
            dev = (res[0] if isinstance(res, tuple) else res).device
            return (tuple(r.to(dev) for r in ref) if isinstance(ref, tuple)
                    else ref.to(dev))
        return fn

    for name in real:
        setattr(pn2, name, wrap(name))

    def undo():
        for name, fn in real.items():
            setattr(pn2, name, fn)
    return out, undo


def fps_timer():
    """CUDA events around each pointnet2.farthest_point_sample call (no
    synchronise); returns (read: the ms of the calls since the last read,
    after a synchronise; undo)."""
    import torch

    from glenet_tpu_torch.ops import pointnet2 as pn2
    real, pairs = pn2.farthest_point_sample, []

    def fps(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = real(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return res

    def read():
        torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in pairs)
        pairs.clear()
        return ms

    pn2.farthest_point_sample = fps
    return read, lambda: setattr(pn2, 'farthest_point_sample', real)


def phase_pointrcnn_full(cfg_name, seed, n_predicts, n_steps):
    """[pointrcnn] (a) / (b): configs/kitti_models/<cfg_name> at full width
    with seeded weights on synthetic scenes of NUM_POINTS (16384) points: a
    warm-up predict, `n_predicts` predicts at B = 2 at the published
    thresholds and one at zero thresholds, then a warm-up train step and
    `n_steps` timed ones at B = BATCH_SIZE_PER_GPU; per call ms, FPS ms
    (CUDA events), valid proposals, detections per class, loss terms,
    peak memory; merge-resolve launches counted from 0 just before and read
    just after each call: 0 (no sparse level).  Returns (mean predict ms,
    mean step ms, the launches)."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import batches_for, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models' / cfg_name))
    names = list(cfg.CLASS_NAMES)
    tag = cfg.TAG
    det = seeded_detector(cfg, 'cuda', seed)
    fps_ms, undo_fps = fps_timer()
    props = {}
    hook = det.net.register_forward_hook(
        lambda _m, _i, out: props.update(
            n=out['proposals']['roi_valid'].sum(1).tolist()
            if 'proposals' in out else None))
    launches, times = 0, []
    try:
        batches = batches_for(cfg, n_predicts + 1, SEED + 9, BATCH)
        n_pts = batches[0]['points'].shape[1]
        t0 = time.perf_counter()
        det.predict(batches[0])
        torch.cuda.synchronize()
        print(f'[pointrcnn] {tag}: warm-up predict '
              f'{1e3 * (time.perf_counter() - t0):.1f} ms')
        fps_ms()
        post = det.model_cfg.POST_PROCESSING
        for r, batch in enumerate(batches[1:] + batches[1:2]):
            zero = r == n_predicts
            saved = post.SCORE_THRESH
            if zero:
                post.SCORE_THRESH = 0.0
            LAUNCHES.n = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                pred = det.predict(batch)
                torch.cuda.synchronize()
            finally:
                post.SCORE_THRESH = saved
            ms = 1e3 * (time.perf_counter() - t0)
            n = LAUNCHES.n
            launches += n
            check(n == 0, f'{tag} predict {r}: {n} merge-resolve launches')
            k = int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
            for key, shape in (('final_boxes', (BATCH, k, 7)),
                               ('final_scores', (BATCH, k))):
                check(tuple(pred[key].shape) == shape
                      and bool(torch.isfinite(pred[key]).all()),
                      f'{tag} predict {r}: {key} {tuple(pred[key].shape)} '
                      f'or not finite')
            labels, valid = pred['final_labels'], pred['final_valid']
            check(int(labels.min()) >= 0 and int(labels.max()) <= len(names),
                  f'{tag}: labels {labels.unique().tolist()}')
            if zero:
                check(int(valid.sum()) > 0,
                      f'{tag}: no box kept at zero thresholds')
            else:
                times.append(ms)
            print(f'[pointrcnn] {tag} predict {r}'
                  + (' at zero thresholds' if zero else '')
                  + f' B={BATCH} x {n_pts} points: {ms:.1f} ms, of it FPS '
                  f'{fps_ms():.1f} ms (events); valid proposals '
                  f'{props["n"]}; detections {valid.sum(1).tolist()} ('
                  f'{per_class(labels, valid, names)}); merge_resolve '
                  f'launches {n}; max_memory_allocated '
                  f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
        pred_ms = sum(times) / len(times)

        _, state, train_step = build_training(cfg, det)
        b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
        tbatches = batches_for(cfg, n_steps + 1, SEED + 10, b, train=True)
        params = {n: p.detach().clone()
                  for n, p in det.net.named_parameters()}
        stats = {n: t.clone() for n, t in det.net.named_buffers()
                 if n.endswith(('running_mean', 'running_var'))}
        times = []
        for i, batch in enumerate(tbatches):
            label = 'warm-up step' if i == 0 else f'step {i - 1}'
            LAUNCHES.n = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            n = LAUNCHES.n
            launches += n
            check(n == 0, f'{tag} train {label}: {n} merge-resolve launches')
            vals = {k: float(v) for k, v in metrics.items()}
            check(all(math.isfinite(v) for v in vals.values())
                  and 'rcnn_loss_cls' in vals and vals['loss_cls'] > 0,
                  f'{tag} train {label}: {vals}')
            print(f'[pointrcnn] {tag} {label} B={b}: {times[-1]:.1f} ms, of '
                  f'it FPS {fps_ms():.1f} ms; '
                  + ', '.join(f'{k} {v:.5f}' for k, v in sorted(vals.items()))
                  + f'; valid proposals {props["n"]}; merge_resolve '
                  f'launches {n}; max_memory_allocated '
                  f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    finally:
        undo_fps()
        hook.remove()
    still = [n for n, p in det.net.named_parameters()
             if torch.equal(p.detach(), params[n])]
    stuck = [n for n, p in det.net.named_parameters() if n in still and (
        bool(p.detach().any()) or (p.grad is not None and bool(p.grad.any())))]
    check(not stuck, f'{tag}: parameters unchanged by the steps: {stuck}')
    bufs = dict(det.net.named_buffers())
    same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
    check(not same, f'{tag}: BN running stats unchanged: {same}')
    timed = times[1:] or times
    step_ms = sum(timed) / len(timed)
    print(f'[pointrcnn] {tag}: predict B={BATCH} mean {pred_ms:.1f} ms over '
          f'{n_predicts} requests; train B={b}: warm-up step '
          f'{times[0]:.1f} ms, mean of {len(timed)} '
          f'{"timed" if times[1:] else "(warm-up)"} steps {step_ms:.1f} ms; '
          f'{len(params) - len(still)} of {len(params)} parameter tensors and '
          f'all {len(stats)} BN running-stat tensors changed')
    del det, state
    torch.cuda.empty_cache()
    return pred_ms, step_ms, launches


def phase_pointrcnn_cli(root, tmp):
    """[pointrcnn] (c): pointrcnn.yaml through `tools.train` (B = 2, 1 epoch
    x 2 steps; sample_points draws 16384 of each frame's points) on the
    synthetic three-class tree at `root` and `tools.test` with the
    three-class KITTI evaluation; no merge-resolve launch.  Returns the
    launches."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    cfg_file = str(ROOT / 'configs/kitti_models/pointrcnn.yaml')
    cfg = cfg_from_yaml_file(cfg_file)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    out = tmp / f'out_{cfg.TAG}'
    common = ['--cfg_file', cfg_file, '--data_path', str(root),
              '--output_dir', str(out), '--batch_size', str(b)]
    LAUNCHES.n = 0
    torch.cuda.reset_peak_memory_stats()
    run = train_cli.main(common + ['--epochs', '1',
                                   '--max_steps_per_epoch', '2'])
    peak = torch.cuda.max_memory_allocated()
    n_train = LAUNCHES.n
    check(n_train == 0 and len(run['steps']) == 2,
          f'PointRCNN CLI train: {len(run["steps"])} steps, {n_train} '
          f'merge-resolve launches')
    for r in run['steps']:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'PointRCNN CLI step {r["it"]}: not finite: {bad}')
        print(f'[pointrcnn] {cfg.TAG} CLI train step {r["it"]} B={b}: data '
              f'{r["data_ms"]:.1f} ms, step {r["step_ms"]:.1f} ms, loss '
              f'{r["loss"]:.4f}, loss_cls {r["loss_cls"]:.4f}, loss_loc '
              f'{r["loss_loc"]:.4f}, rcnn_loss_cls {r["rcnn_loss_cls"]:.4f}, '
              f'grad_norm {r["grad_norm"]:.3f}; max_memory_allocated '
              f'{peak / 2**30:.2f} GiB')
    LAUNCHES.n = 0
    results = test_cli.main(common)
    n_test = LAUNCHES.n
    (path, res), = results.items()
    keys = [f'{c}_3d/moderate_R40' for c in cfg.CLASS_NAMES]
    check(res['frames'] == TC_VAL and n_test == 0
          and all(np.isfinite(res['ap'][k]) for k in keys),
          f'PointRCNN test CLI: {res["frames"]} frames, {n_test} launches, '
          f'{sorted(res["ap"])[:6]}')
    print(f'[pointrcnn] {cfg.TAG} test CLI on {Path(path).name}: '
          f'{res["frames"]} val frames, {res["sec_per_frame"]:.4f} s/frame, '
          f'KITTI evaluation {res["eval_sec"]:.3f} s; '
          + ', '.join(f'{k} {res["ap"][k]:.2f}' for k in keys)
          + f'; merge_resolve launches: train {n_train}, test {n_test} (2 '
          f'steps from random weights: only the keys are checked)')
    return n_train + n_test


def phase_pointrcnn(tmp, root):
    """[pointrcnn]: (a) pointrcnn.yaml at full width (predicts and steps at
    B = 2), (b) pointrcnn_iou.yaml (a predict and a step at B = 3), (c)
    the CLIs on the three-class tree at `root`.  (d) runs after the main
    paths.  Returns (launches, mean ms of each predict and step)."""
    pred_ms, step_ms, launches = phase_pointrcnn_full(
        'pointrcnn.yaml', SEED + 150, N_REQUESTS, POINTRCNN_STEPS)
    times = {'pointrcnn': (pred_ms, step_ms)}
    pred_ms, step_ms, n = phase_pointrcnn_full('pointrcnn_iou.yaml',
                                               SEED + 151, 1, 1)
    times['pointrcnn_iou'] = (pred_ms, step_ms)
    launches += n + phase_pointrcnn_cli(root, tmp)
    print('[pointrcnn] mean predict / train step ms: ' + ', '.join(
        f'{k} {p:.1f} / {t:.1f}' for k, (p, t) in times.items()))
    return launches, times


# ---------------------------------------------------------------------------
# [centerpoint]: CenterPoint and the CenterHead RPNs (VoxelResBackBone8x,
# dynamic voxels and the scatter VFEs, CenterHead targets, loss and decode)
# ---------------------------------------------------------------------------

# the other Waymo configs with a CenterHead and their merge-resolve
# launches per call (the pillar configs have no sparse level)
CENTERPOINT_OTHERS = (('centerpoint_without_resnet.yaml', 4),
                      ('centerpoint_pillar_1x.yaml', 0),
                      ('centerpoint_dyn_pillar_1x.yaml', 0),
                      ('voxel_rcnn_with_centerhead_dyn_voxel.yaml', 4),
                      ('pv_rcnn_with_centerhead_rpn.yaml', 4))
CONV_CENTERPOINT_STEPS, CONV_CENTERPOINT_TAIL = 10, 5
CENTER_SIZES = {1: (4.6, 2.0, 1.7), 2: (0.8, 0.8, 1.8), 3: (1.8, 0.6, 1.7)}


def tiny_centerpoint_raw():
    """The toy topology as Waymo's CenterPoint: 5 point features, Vehicle,
    Pedestrian and Cyclist, VoxelResBackBone8x, a CenterHead of 16 shared
    channels at stride 8 (without the conv biases before its BNs, whose
    exact gradient is 0: both devices would hold rounding noise there), top
    32 cells, nms_gpu at zero score threshold."""
    raw = tiny_waymo_raw()
    raw['CLASS_NAMES'] = ['Vehicle', 'Pedestrian', 'Cyclist']
    m = raw['MODEL']
    m['NAME'] = 'CenterPoint'
    m['BACKBONE_3D'] = {'NAME': 'VoxelResBackBone8x'}
    m['DENSE_HEAD'] = {
        'NAME': 'CenterHead', 'CLASS_AGNOSTIC': False,
        'CLASS_NAMES_EACH_HEAD': [raw['CLASS_NAMES']],
        'SHARED_CONV_CHANNEL': 16, 'USE_BIAS_BEFORE_NORM': False,
        'NUM_HM_CONV': 2,
        'TARGET_ASSIGNER_CONFIG': {'FEATURE_MAP_STRIDE': 8,
                                   'NUM_MAX_OBJS': 500,
                                   'GAUSSIAN_OVERLAP': 0.1, 'MIN_RADIUS': 2},
        'LOSS_CONFIG': {'LOSS_WEIGHTS': {'cls_weight': 1.0,
                                         'loc_weight': 2.0,
                                         'code_weights': [1.0] * 8}}}
    m['POST_PROCESSING'] = {
        'SCORE_THRESH': 0.0, 'MAX_OBJ_PER_SAMPLE': 32,
        'NMS_CONFIG': {'MULTI_CLASSES_NMS': False, 'NMS_TYPE': 'nms_gpu',
                       'NMS_THRESH': 0.7, 'NMS_PRE_MAXSIZE': 32,
                       'NMS_POST_MAXSIZE': 16}}
    return raw


def tiny_center_batch(cfg):
    """tiny_batch's points (5 features), a Vehicle, a Pedestrian and a
    Cyclist per sample at their sizes, label variances in [0.02, 0.3)."""
    import numpy as np
    import torch
    pts = torch.from_numpy(tiny_batch(SEED + 7, features=n_features(cfg)))
    b = pts.shape[0]
    rng = np.random.RandomState(SEED + 13)
    gt = np.zeros((b, 8, 8), np.float32)
    for i in range(b):
        for j, cls in enumerate((1, 2, 3)):
            dx, dy, dz = CENTER_SIZES[cls]
            gt[i, j] = [rng.uniform(2, 14), rng.uniform(-6, 6), -1.0, dx, dy,
                        dz, rng.uniform(-np.pi, np.pi), cls]
    gt_mask = np.zeros((b, 8), bool)
    gt_mask[:, :3] = True
    unc = rng.uniform(0.02, 0.3, (b, 8, 7)).astype(np.float32)
    return {'points': pts, 'points_mask': torch.ones(pts.shape[:2],
                                                     dtype=torch.bool),
            'gt_boxes': torch.from_numpy(gt),
            'gt_mask': torch.from_numpy(gt_mask),
            'gt_uncertainty': torch.from_numpy(unc)}


def phase_centerpoint_full(seed):
    """[centerpoint] (a): configs/waymo_models/centerpoint.yaml at full width
    (VoxelResBackBone8x on the 1504 x 1504 x 40 grid, test budget 90000,
    a 188 x 188 x 3 heatmap) with seeded weights on synthetic Waymo scenes
    of 170000 points: a warm-up predict that captures its merge-resolve
    calls, N_REQUESTS predicts at B = 2 (phase_full_width), then a warm-up
    train step (also captured) and TRAIN_STEPS timed ones at B = 4, the
    train budget 80000 (phase_train).  Returns (launches, captured predict
    calls, captured train-step calls, mean step ms)."""
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.utils.synthetic import (WAYMO_N_POINTS,
                                                  seeded_detector,
                                                  waymo_scene_batches)
    cfg = cfg_from_yaml_file(str(ROOT /
                                 'configs/waymo_models/centerpoint.yaml'))
    det = seeded_detector(cfg, 'cuda', seed)
    check(det.is_center_head and det.net.backbone_3d.residual
          and tuple(det.grid_size) == (1504, 1504, 40)
          and (det.max_voxels_train, det.max_voxels_test) == (80000, 90000),
          f'CenterPoint built with grid {det.grid_size}')
    batches = waymo_scene_batches(N_REQUESTS + 1, SEED + 160, BATCH)
    t0 = time.perf_counter()
    captured = capture_calls(lambda: det.predict(batches[0]),
                             'Waymo CenterPoint predict')[0]
    print(f'[centerpoint] CenterPoint: warm-up predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    launches = phase_full_width(det, batches[1:], 'centerpoint',
                                'CenterPoint', n_points=WAYMO_N_POINTS)
    n, captured_train, times = phase_train(cfg, det, 'centerpoint',
                                           'CenterPoint',
                                           n_points=WAYMO_N_POINTS)
    print_syncs(det, cfg, 'CenterPoint')
    del det
    torch.cuda.empty_cache()
    return launches + n, captured, captured_train, sum(times) / len(times)


def print_syncs(det, cfg, label, tag='centerpoint'):
    """The host syncs (by file:line) of one more predict and one more train
    step of `det`, outside the counted runs."""
    from glenet_tpu_torch.profile_cvae import _syncs
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import batches_for
    batch = batches_for(cfg, 1, SEED + 4, BATCH)[0]
    _, state, train_step = build_training(cfg, det)
    tbatch = batches_for(cfg, 1, SEED + 5,
                         int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU),
                         train=True)[0]
    for what, fn in (('predict', lambda: det.predict(batch)),
                     ('train step', lambda: train_step(state, tbatch))):
        syncs = _syncs(fn)
        print(f'[{tag}] {label} {what}: {sum(syncs.values())} host '
              f'syncs (' + ', '.join(f'{k} x{v}'
                                     for k, v in syncs.most_common()) + ')')


def phase_centerpoint_others():
    """[centerpoint] (b): the other five Waymo configs with a CenterHead at
    full width, seeded weights: one predict at B = 2 and one train step at
    B = BATCH_SIZE_PER_GPU each, launches counted from 0 just before and
    read just after each call (4, or 0 on the pillar configs).  Returns
    the launches."""
    import torch
    launches = 0
    for i, (name, expected) in enumerate(CENTERPOINT_OTHERS):
        r = predict_and_step(name, SEED + 161 + i, 'waymo_models', expected)
        launches += r['n_predict'] + r['n_step']
        check(r['vals']['loss_cls'] > 0 and r['vals']['loss_loc'] > 0,
              f'{name}: CenterHead losses {r["vals"]}')
        net = r['det'].net
        vfe = type(net.vfe).__name__
        if net.dynamic:
            print_syncs(r['det'], r['cfg'], r['cfg'].TAG)
        valid = r['pred']['final_valid'].sum(1).tolist()
        print(f'[centerpoint] {r["cfg"].TAG} ({vfe}, '
              f'{type(net.dense_head).__name__}): predict B={BATCH} '
              f'{r["predict_ms"]:.1f} ms, valid final boxes {valid}, peak '
              f'{r["predict_gib"]:.2f} GiB; train step B={r["b"]} '
              f'{r["step_ms"]:.1f} ms, peak {r["step_gib"]:.2f} GiB; '
              + ', '.join(f'{k} {v:.5f}' for k, v in sorted(r['vals'].items()))
              + f'; merge_resolve launches {r["n_predict"]} / '
              f'{r["n_step"]}')
        del r
        torch.cuda.empty_cache()
    return launches


def waymo_cli_round(tmp, in_memory_ms, cfg_name, tag, label, batch):
    """configs/waymo_models/<cfg_name> through `tools.train` (B = `batch`,
    1 epoch x 2 steps over every train frame) and `tools.test` with the
    three-class Waymo evaluation, on the synthetic Waymo tree [waymo] wrote
    (its gt database holds Vehicles; the Pedestrian and Cyclist groups
    sample none).  Launches counted from 0 just before and read just after
    each call, 4 per call.  Returns the launches."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.models.detectors import Detector
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.train import state as state_lib
    cfg_file = str(ROOT / 'configs/waymo_models' / cfg_name)
    common = ['--cfg_file', cfg_file, '--data_path', str(tmp / 'waymo'),
              '--output_dir', str(tmp / f'{Path(cfg_name).stem}_out'),
              '--batch_size', str(batch), '--max_steps_per_epoch', '2']
    step_launches, predict_launches = [], []
    undo = [count_launches(state_lib, 'make_train_step', step_launches),
            count_launches(Detector, 'predict', predict_launches)]
    LAUNCHES.n = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        run = train_cli.main(common + ['--epochs', '1', '--set',
                                       'DATA_CONFIG.SAMPLED_INTERVAL.train',
                                       '1'])
        peak = torch.cuda.max_memory_allocated()
        results = test_cli.main(common[:8])
    finally:
        for u in undo:
            u()
    launches = LAUNCHES.n
    check([r['it'] for r in run['steps']] == [1, 2]
          and step_launches == [4, 4],
          f'{label} CLI steps {[r["it"] for r in run["steps"]]}, '
          f'launches per step {step_launches}')
    for r in run['steps']:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'{label} CLI step {r["it"]}: not finite: {bad}')
        losses = ', '.join(f'{k} {r[k]:.4f}' for k in sorted(r)
                           if 'loss' in k)
        print(f'[{tag}] CLI train step {r["it"]} B={batch}: data '
              f'{r["data_ms"]:.1f} ms, step {r["step_ms"]:.1f} ms (in '
              f'memory {in_memory_ms:.1f} ms), {losses}, grad_norm '
              f'{r["grad_norm"]:.3f}; max_memory_allocated '
              f'{peak / 2**30:.2f} GiB')
    (path, res), = results.items()
    keys = [f'OBJECT_TYPE_TYPE_{c}_LEVEL_{lv}/{m}'
            for c in ('VEHICLE', 'PEDESTRIAN', 'CYCLIST') for lv in (1, 2)
            for m in ('AP', 'APH')]
    check(res['frames'] == WAYMO_FRAMES and sorted(res['ap']) == sorted(keys)
          and all(np.isfinite(res['ap'][k]) for k in keys)
          and predict_launches == [4] * math.ceil(WAYMO_FRAMES / batch),
          f'{label} test CLI: {res["frames"]} frames, '
          f'{sorted(res["ap"])}, launches per predict {predict_launches}')
    print(f'[{tag}] test CLI on {Path(path).name}: {res["frames"]} '
          f'val frames, {res["sec_per_frame"]:.4f} s/frame, Waymo '
          f'evaluation {res["eval_sec"]:.3f} s; merge_resolve launches per '
          f'predict {predict_launches}; ' + ', '.join(
              f'{k} {res["ap"][k]:.2f}' for k in keys[:2])
          + ' (2 steps from random weights: only the keys are checked)')
    return launches


def phase_centerpoint_cli(tmp, in_memory_ms):
    """[centerpoint] (c): centerpoint.yaml through the CLIs at B = 4 on
    [waymo]'s tree (waymo_cli_round).  Returns the launches."""
    return waymo_cli_round(tmp, in_memory_ms, 'centerpoint.yaml',
                           'centerpoint', 'CenterPoint', WAYMO_BATCH)


def phase_centerpoint_harness(tmp):
    """[centerpoint] (d): tools.convergence_waymo on its default yaml,
    centerpoint.yaml, for CONV_CENTERPOINT_STEPS steps and a
    CONV_CENTERPOINT_TAIL-step frozen-BN tail, as [convergence] cuts
    Waymo: 4 merge-resolve launches per train-mode forward and per
    predict, its active-site lines, finite losses and the AP / APH keys
    (printed, not gated).  Returns the launches."""
    import math
    import tempfile

    from glenet_tpu_torch.tools import convergence_waymo as cw
    saved_tmp = tempfile.tempdir
    tempfile.tempdir = str(tmp)
    try:
        entry, text, launches, per_call = run_tool(
            'centerpoint_waymo', cw.main,
            [str(CONV_CENTERPOINT_STEPS), '1e-3', cw.DEFAULT_YAML,
             str(CONV_CENTERPOINT_TAIL), '--out',
             str(tmp / 'convergence_centerpoint.json')])
    finally:
        tempfile.tempdir = saved_tmp
    check_launches('centerpoint_waymo', per_call, 4)
    losses = printed_losses(text)
    check(text.count('active sites max=') == 4
          and all(math.isfinite(v) for v in losses)
          and math.isfinite(entry['final_loss'])
          and entry['Vehicle_L1_AP'] is not None
          and entry['Vehicle_L1_APH'] is not None,
          f'centerpoint_waymo harness: {entry}')
    conv_line(f'centerpoint_waymo {CONV_CENTERPOINT_STEPS} + '
              f'{CONV_CENTERPOINT_TAIL} frozen-BN steps', entry,
              ('Vehicle_L1_AP', 'Vehicle_L1_APH'))
    return launches


def phase_centerpoint(tmp):
    """[centerpoint]: (a) centerpoint.yaml at full width, (b) the other
    five configs, (c) the CLIs on [waymo]'s tree, (d) a short harness run.
    (e) the card against the CPU on tiny_centerpoint_raw and the kernel
    check of (a)'s captured calls run after the main paths.  Returns
    (launches, captured predict calls, captured train-step calls)."""
    launches, captured, captured_train, step_ms = phase_centerpoint_full(
        SEED + 160)
    launches += phase_centerpoint_others()
    launches += phase_centerpoint_cli(tmp, step_ms)
    launches += phase_centerpoint_harness(tmp)
    return launches, captured, captured_train


# ---------------------------------------------------------------------------
# [pvrcnn_plusplus]: PV-RCNN++ (CenterHead proposals before the keypoints,
# SPC keypoints, VectorPool aggregation with RoI-filtered neighbours,
# PointHeadSimple, PVRCNNHead with RoI-grid VectorPool)
# ---------------------------------------------------------------------------

PVPP_PREDICTS, PVPP_STEPS = 2, 2
# queries per scene and neighbour search held card against CPU at full width
PVPP_FLIP_QUERIES = 1024
CONV_PVPP_STEPS, CONV_PVPP_TAIL = 10, 5


def pvpp_gt_from_rois(boxes):
    """The toy gt boxes off their proposals in every code, by 3% of the
    box's size in the centre and the size and 0.05 rad in the heading: a
    CenterHead proposal decodes its own regression, so a gt equal to it in
    a code puts the L1 loss on its kink; relative offsets keep the RoI IoU
    above REG_FG_THRESH whatever the random head's box sizes."""
    boxes = boxes.clone()
    boxes[:, :3] += 0.03 * boxes[:, 3:6]
    boxes[:, 3:6] *= 1.03
    boxes[:, 6] += 0.05
    return boxes


def tiny_pvpp_raw():
    """The toy topology as PV-RCNN++ (tests/test_pvrcnn_plusplus.py's
    make_pvpp_cfg on TINY_CFG's trunk): a CenterHead RPN (32 shared
    channels, top 64 cells), 64 SPC keypoints (1.6 m), VectorPool over
    bev, x_conv3, x_conv4 and raw_points (two groups of 2^3 sub-voxels,
    0.4 / 0.8 m, RoI filters 2.4 / 4.0 / 6.4 m), PointHeadSimple (16),
    PVRCNNHead with a 3^3 RoI grid pooled by VectorPool random choice (two
    groups of 3^3, 0.8 / 1.6 m, 32 neighbours), FCs of 32, nms_gpu at zero
    score threshold."""
    import copy
    raw = copy.deepcopy(TINY_CFG)
    m = raw['MODEL']
    m['NAME'] = 'PVRCNNPlusPlus'
    m['DENSE_HEAD'] = {
        'NAME': 'CenterHead', 'CLASS_AGNOSTIC': False,
        'CLASS_NAMES_EACH_HEAD': [['Car']], 'SHARED_CONV_CHANNEL': 32,
        'TARGET_ASSIGNER_CONFIG': {'FEATURE_MAP_STRIDE': 8,
                                   'NUM_MAX_OBJS': 100,
                                   'GAUSSIAN_OVERLAP': 0.1, 'MIN_RADIUS': 2},
        'LOSS_CONFIG': {'LOSS_WEIGHTS': {'cls_weight': 1.0,
                                         'loc_weight': 2.0,
                                         'code_weights': [1.0] * 8}},
        'POST_PROCESSING': {'SCORE_THRESH': 0.0, 'MAX_OBJ_PER_SAMPLE': 64}}

    def vp(reduced, radius, **extra):
        return {'NAME': 'VectorPoolAggregationModuleMSG', 'NUM_GROUPS': 2,
                'LOCAL_AGGREGATION_TYPE': 'local_interpolation',
                'NUM_REDUCED_CHANNELS': reduced,
                'NUM_CHANNELS_OF_LOCAL_AGGREGATION': 8,
                'MSG_POST_MLPS': [16], 'FILTER_NEIGHBOR_WITH_ROI': True,
                'RADIUS_OF_NEIGHBOR_WITH_ROI': radius,
                'GROUP_CFG_0': {'NUM_LOCAL_VOXEL': [2, 2, 2],
                                'MAX_NEIGHBOR_DISTANCE': 0.4,
                                'NEIGHBOR_NSAMPLE': -1, 'POST_MLPS': [8, 8]},
                'GROUP_CFG_1': {'NUM_LOCAL_VOXEL': [2, 2, 2],
                                'MAX_NEIGHBOR_DISTANCE': 0.8,
                                'NEIGHBOR_NSAMPLE': -1, 'POST_MLPS': [8, 8]},
                **extra}

    m['PFE'] = {
        'NAME': 'VoxelSetAbstraction', 'POINT_SOURCE': 'raw_points',
        'NUM_KEYPOINTS': 64, 'NUM_OUTPUT_FEATURES': 32,
        'SAMPLE_METHOD': 'SPC',
        'SPC_SAMPLING': {'NUM_SECTORS': 6, 'SAMPLE_RADIUS_WITH_ROI': 1.6},
        'FEATURES_SOURCE': ['bev', 'x_conv3', 'x_conv4', 'raw_points'],
        'SA_LAYER': {'raw_points': vp(1, 2.4),
                     'x_conv3': vp(16, 4.0, DOWNSAMPLE_FACTOR=4),
                     'x_conv4': vp(16, 6.4, DOWNSAMPLE_FACTOR=8)}}
    m['POINT_HEAD'] = {
        'NAME': 'PointHeadSimple', 'CLS_FC': [16], 'CLASS_AGNOSTIC': True,
        'USE_POINT_FEATURES_BEFORE_FUSION': True,
        'TARGET_CONFIG': {'GT_EXTRA_WIDTH': [0.2, 0.2, 0.2]},
        'LOSS_CONFIG': {'LOSS_WEIGHTS': {'point_cls_weight': 1.0}}}
    roi = m['ROI_HEAD']
    group = {'NUM_LOCAL_VOXEL': [3, 3, 3], 'NEIGHBOR_NSAMPLE': 32,
             'POST_MLPS': [8, 8]}
    roi.update(NAME='PVRCNNHead', ROI_GRID_POOL={
        'GRID_SIZE': 3, 'NAME': 'VectorPoolAggregationModuleMSG',
        'NUM_GROUPS': 2, 'LOCAL_AGGREGATION_TYPE': 'voxel_random_choice',
        'NUM_REDUCED_CHANNELS': 16, 'NUM_CHANNELS_OF_LOCAL_AGGREGATION': 8,
        'MSG_POST_MLPS': [16],
        'GROUP_CFG_0': dict(group, MAX_NEIGHBOR_DISTANCE=0.8),
        'GROUP_CFG_1': dict(group, MAX_NEIGHBOR_DISTANCE=1.6)})
    roi['NMS_CONFIG']['TRAIN'].update(NMS_PRE_MAXSIZE=64, NMS_POST_MAXSIZE=32)
    roi['NMS_CONFIG']['TEST'].update(NMS_PRE_MAXSIZE=64, NMS_POST_MAXSIZE=32)
    roi['LOSS_CONFIG'] = {'CLS_LOSS': 'BinaryCrossEntropy',
                          'REG_LOSS': 'smooth-l1',
                          'CORNER_LOSS_REGULARIZATION': True,
                          'LOSS_WEIGHTS': roi['LOSS_CONFIG']['LOSS_WEIGHTS']}
    m['POST_PROCESSING'].update(SCORE_THRESH=0.0)
    m['POST_PROCESSING']['NMS_CONFIG'].update(
        NMS_TYPE='nms_gpu', NMS_THRESH=0.7, NMS_PRE_MAXSIZE=32,
        NMS_POST_MAXSIZE=16)
    return raw


def flip_bound(q2, sa2, sb2):
    """Two devices may order two candidates of a query differently only
    where their squared distances lie within the rounding of the expanded
    formula |q|^2 + |s|^2 - 2 q.s on both: each side's f32 result is within
    ~3.5 ulp of |q|^2 + |s|^2, so this bound is 8 x 2^-24 x (2 |q|^2 +
    |s_a|^2 + |s_b|^2)."""
    return 8.0 * 2.0 ** -24 * (2.0 * q2 + sa2 + sb2)


def neighbour_flips(query, support, ref, got, what):
    """The three-nn picks of vector_pool.three_nn_within on two devices
    (ref and got: (dist, idx, valid), on the CPU) for the same query
    (B, Q, 3) and support (B, N, 3): valid flags equal (the in-range tests
    are exact), and wherever a slot picks another point both candidates'
    exact squared distances lie within flip_bound.  Returns (flipped
    slots, compared slots, the largest gap over its bound)."""
    import torch
    check(torch.equal(ref[2], got[2]), f'{what}: valid neighbour flags '
                                       f'differ between the devices')
    diff = (ref[1] != got[1]) & ref[2]
    worst = 0.0
    for b, q, s in torch.nonzero(diff).tolist():
        qq = query[b, q].double()
        pa = support[b, int(ref[1][b, q, s])].double()
        pb = support[b, int(got[1][b, q, s])].double()
        da, db = float(((qq - pa) ** 2).sum()), float(((qq - pb) ** 2).sum())
        bound = flip_bound(float((qq ** 2).sum()), float((pa ** 2).sum()),
                           float((pb ** 2).sum()))
        check(abs(da - db) <= bound,
              f'{what}: scene {b} query {q} slot {s} picks point '
              f'{int(ref[1][b, q, s])} (d^2 {da:.9g}) on one device and '
              f'{int(got[1][b, q, s])} (d^2 {db:.9g}) on the other, beyond '
              f'the rounding bound {bound:.3e}')
        worst = max(worst, abs(da - db) / bound)
    return int(diff.sum()), int(ref[2].sum()), worst


def neighbour_decisions(recorded=None):
    """Wrap vector_pool.three_nn_within.  With recorded=None each call's
    (query, support) and outputs are recorded (on the CPU).  Given another
    run's record, each call's picks are held against the recorded call's
    (neighbour_flips); a call that differs returns the recorded outputs,
    so both runs go on with one set of neighbours ('adopted').  Returns
    (the record or the counts, undo)."""
    from glenet_tpu_torch.models import vector_pool
    real = vector_pool.three_nn_within
    out = ([] if recorded is None
           else {'adopted': 0, 'calls': 0, 'flips': 0, 'slots': 0,
                 'largest': 0.0})
    queue = None if recorded is None else list(recorded)

    def wrapped(query, support, support_mask, rmax, neighbor_type=0):
        res = real(query, support, support_mask, rmax, neighbor_type)
        cpu = tuple(r.cpu() for r in res)
        if recorded is None:
            out.append((query.cpu(), support.cpu(), cpu))
            return res
        q, sup, ref = queue.pop(0)
        n, slots, worst = neighbour_flips(q, sup, ref, cpu,
                                          f'toy three-nn (rmax {rmax:g})')
        out['calls'] += 1
        out['flips'] += n
        out['slots'] += slots
        out['largest'] = max(out['largest'], worst)
        if n == 0:
            return res
        out['adopted'] += 1
        return tuple(r.to(query.device) for r in ref)

    vector_pool.three_nn_within = wrapped
    return out, lambda: setattr(vector_pool, 'three_nn_within', real)


def watch_pvpp(det):
    """Hooks recording, per call, the active sites of the four backbone
    levels, the keypoint indices, each roi mask (SPC's and the neighbour
    filters': points in and kept), per VectorPool group the share of
    sub-voxel centres without a neighbour (interpolation) or of empty
    sub-voxels (RoI-grid pooling), and the three-nn calls of the first
    recorded predict (for the flip count).  Returns (record, undo)."""
    from glenet_tpu_torch.models import vector_pool
    from glenet_tpu_torch.models.vector_pool import VectorPoolAggregation
    rec = {'sites': {}, 'keypoints': None, 'masks': [], 'empty': [],
           'nn_calls': None, 'three_nn': vector_pool.three_nn_within}
    current = [None]

    def sites(_mod, _inp, out):
        ms = out['multi_scale']
        rec['sites'] = {k: ms[k]['mask'].sum(1) for k in
                        ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')}

    def keypoints(_mod, _inp, out):
        rec['keypoints'] = out['keypoint_idx']

    hooks = [det.net.backbone_3d.register_forward_hook(sites),
             det.net.pfe.register_forward_hook(keypoints)]
    for name, mod in det.net.named_modules():
        if isinstance(mod, VectorPoolAggregation):
            hooks.append(mod.register_forward_pre_hook(
                lambda _m, _i, name=name: current.__setitem__(0, name)))
    real = {k: getattr(vector_pool, k) for k in (
        'sample_points_with_roi_mask', 'three_nn_within', 'pool_into_grids')}

    def roi_mask(points, points_mask, rois, roi_valid, radius):
        keep = real['sample_points_with_roi_mask'](points, points_mask, rois,
                                                   roi_valid, radius)
        rec['masks'].append((radius, points_mask.sum(1), keep.sum(1)))
        return keep

    def three_nn(query, support, support_mask, rmax, neighbor_type=0):
        res = real['three_nn_within'](query, support, support_mask, rmax,
                                      neighbor_type)
        rec['empty'].append((current[0], (~res[2][..., 0]).float().mean()))
        if rec['nn_calls'] is not None:
            rec['nn_calls'].append((rmax, neighbor_type, query, support,
                                    support_mask, res))
        return res

    def pool(*args, **kwargs):
        out = real['pool_into_grids'](*args, **kwargs)
        rec['empty'].append((current[0],
                             (~(out != 0).any(-1)).float().mean()))
        return out

    vector_pool.sample_points_with_roi_mask = roi_mask
    vector_pool.three_nn_within = three_nn
    vector_pool.pool_into_grids = pool

    def undo():
        for k, fn in real.items():
            setattr(vector_pool, k, fn)
        for h in hooks:
            h.remove()
    return rec, undo


def pvpp_text(rec, budget):
    """Active sites against the level caps, keypoints (distinct of those
    the SPC mask kept), the roi masks and the empty shares over the call
    just recorded; clears the per-call records."""
    from glenet_tpu_torch.ops import sparse
    caps = sparse.level_caps(budget)
    kp = rec['keypoints']
    distinct = [len(set(r.tolist())) for r in kp]
    (_, valid, spc), *filters = rec['masks']
    names = ('raw_points', 'x_conv3', 'x_conv4')
    masks = '; '.join(f'{n} (within {r:g} m of a roi) {k.tolist()} of '
                      f'{v.tolist()}' for n, (r, v, k) in zip(names, filters))
    empty = ', '.join(f'{n.replace("pfe.", "").replace("roi_head.", "")} '
                      f'{float(e):.3f}' for n, e in rec['empty'])
    rec['masks'].clear()
    rec['empty'].clear()
    return ('active sites ' + ', '.join(
        f'{k} {v.tolist()}/{caps[i]}' for i, (k, v) in
        enumerate(rec['sites'].items()))
        + f'; keypoints {kp.shape[1]} per scene, distinct {distinct}, '
        f'from the SPC mask\'s {spc.tolist()} of {valid.tolist()} valid '
        f'points; kept neighbours {masks}; empty sub-voxel share {empty}')


def check_full_width_flips(calls, tag, three_nn):
    """The card's VectorPool neighbour searches of one full-width predict
    against the CPU's (`three_nn`, vector_pool.three_nn_within unwatched)
    on every (Q // PVPP_FLIP_QUERIES)-th query of each scene, same inputs
    (neighbour_flips).  Prints per call the flips and the largest gap over
    its bound; returns the flipped and compared slots."""
    import torch
    total, slots = 0, 0
    for i, (rmax, kind, query, support, mask, res) in enumerate(calls):
        stride = max(1, query.shape[1] // PVPP_FLIP_QUERIES)
        sel = torch.arange(0, query.shape[1], stride,
                           device=query.device)[:PVPP_FLIP_QUERIES]
        q = query[:, sel].cpu()
        ref = tuple(r[:, sel].cpu() for r in res)
        t0 = time.perf_counter()
        got = three_nn(q, support.cpu(), mask.cpu(), rmax, kind)
        n, s, worst = neighbour_flips(q, support.cpu(), ref, got,
                                      f'full-width three-nn call {i}')
        total, slots = total + n, slots + s
        print(f'[{tag}] full-width three-nn call {i} (rmax {rmax:g}, '
              f'support {tuple(support.shape)}, {int(mask.sum())} valid): '
              f'{q.shape[1]} queries per scene on the card and the CPU '
              f'({time.perf_counter() - t0:.1f} s), {n} of {s} valid slots '
              f'pick another point, largest d^2 gap {worst:.3f} of the '
              f'rounding bound')
    return total, slots


def phase_pvpp_full(cfg_name, seed, n_predicts, n_steps, warmup=True,
                    flips=False):
    """[pvrcnn_plusplus] (a) / (b): configs/waymo_models/<cfg_name> at full
    width with seeded weights on synthetic Waymo scenes of 170000 points:
    with `warmup` a warm-up predict and a warm-up train step that capture
    their merge-resolve calls, `n_predicts` predicts at B = 2 and
    `n_steps` train steps at B = BATCH_SIZE_PER_GPU (2), launches counted
    from 0 just before and read just after each call, 4 per call; with
    `flips` the first predict's neighbour searches are held against the
    CPU (check_full_width_flips).  Returns (launches, captured predict,
    captured step, mean step ms, the detector and its config)."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import batches_for, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/waymo_models' / cfg_name))
    tag = cfg.TAG
    det = seeded_detector(cfg, 'cuda', seed)
    check(det.net.pvpp and tuple(det.grid_size) == (1504, 1504, 40)
          and (det.max_voxels_train, det.max_voxels_test) == (80000, 90000),
          f'{tag} built with grid {det.grid_size}')
    rec, undo = watch_pvpp(det)
    batches = batches_for(cfg, n_predicts + int(warmup), SEED + 170, BATCH)
    captured = None
    if warmup:
        t0 = time.perf_counter()
        captured, _ = capture_calls(lambda: det.predict(batches[0]),
                                    f'{tag} predict')
        print(f'[pvrcnn_plusplus] {tag}: warm-up predict '
              f'{1e3 * (time.perf_counter() - t0):.1f} ms')
        check(len(captured) == 4, f'{tag}: {len(captured)} merge-resolve '
                                  f'calls per predict')
        rec['masks'].clear()
        rec['empty'].clear()
    launches, times = 0, []
    k = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    for r, batch in enumerate(batches[int(warmup):]):
        if flips and r == 0:
            rec['nn_calls'] = []
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = det.predict(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        n = LAUNCHES.n
        launches += n
        check(n == 4, f'{tag} predict {r}: {n} merge-resolve launches')
        for key, shape in (('final_boxes', (BATCH, k, 7)),
                           ('final_scores', (BATCH, k))):
            check(tuple(pred[key].shape) == shape
                  and bool(torch.isfinite(pred[key]).all()),
                  f'{tag} predict {r}: {key} {tuple(pred[key].shape)} or '
                  f'not finite')
        print(f'[pvrcnn_plusplus] {tag} predict {r} B={BATCH}: '
              f'{times[-1]:.1f} ms; {pvpp_text(rec, det.max_voxels_test)}; '
              f'valid final boxes {pred["final_valid"].sum(1).tolist()}; '
              f'merge_resolve launches {n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
        if rec['nn_calls']:
            calls, rec['nn_calls'] = rec['nn_calls'], None
            n_flip, n_slot = check_full_width_flips(calls, 'pvrcnn_plusplus',
                                                    rec['three_nn'])
            print(f'[pvrcnn_plusplus] {tag} full-width neighbour flips: '
                  f'{n_flip} of {n_slot} valid slots over {len(calls)} '
                  f'calls, each within the rounding bound')
            del calls
    print(f'[pvrcnn_plusplus] {tag} predict B={BATCH} x '
          f'{batches[-1]["points"].shape[1]} points: mean '
          f'{sum(times) / len(times):.1f} ms over {len(times)} requests')

    _, state, train_step = build_training(cfg, det)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatches = batches_for(cfg, n_steps + int(warmup), SEED + 171, b,
                           train=True)
    params = {n: p.detach().clone() for n, p in det.net.named_parameters()}
    stats = {n: t.clone() for n, t in det.net.named_buffers()
             if n.endswith(('running_mean', 'running_var'))}
    step_times, captured_train = [], None
    for i, batch in enumerate(tbatches):
        label = 'warm-up step' if warmup and i == 0 else \
            f'step {i - int(warmup)}'
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if warmup and i == 0:
            captured_train, (state, metrics) = capture_calls(
                lambda: train_step(state, batch), f'{tag} train step')
        else:
            state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_times.append(1e3 * (time.perf_counter() - t0))
        n = LAUNCHES.n
        launches += n
        check(n == 4, f'{tag} train {label}: {n} merge-resolve launches')
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in vals.values())
              and {'point_loss_cls', 'rcnn_loss_cls', 'rcnn_loss_reg'}
              <= set(vals), f'{tag} train {label}: {vals}')
        print(f'[pvrcnn_plusplus] {tag} {label} B={b}: '
              f'{step_times[-1]:.1f} ms; '
              + ', '.join(f'{k} {v:.5f}' for k, v in sorted(vals.items()))
              + f'; {pvpp_text(rec, det.max_voxels_train)}; merge_resolve '
              f'launches {n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    undo()
    if warmup:
        check(len(captured_train) == 4, f'{tag}: {len(captured_train)} '
                                        f'merge-resolve calls per step')
    still = [n for n, p in det.net.named_parameters()
             if torch.equal(p.detach(), params[n])]
    stuck = [n for n, p in det.net.named_parameters() if n in still and (
        bool(p.detach().any()) or (p.grad is not None and bool(p.grad.any())))]
    check(not stuck, f'{tag}: parameters unchanged by the steps: {stuck}')
    bufs = dict(det.net.named_buffers())
    same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
    check(not same, f'{tag}: BN running stats unchanged: {same}')
    timed = step_times[int(warmup):]
    print(f'[pvrcnn_plusplus] {tag} train B={b}: '
          + (f'warm-up step {step_times[0]:.1f} ms, ' if warmup else '')
          + f'mean of {len(timed)} steps {sum(timed) / len(timed):.1f} ms; '
          f'{len(params) - len(still)} of {len(params)} parameter tensors '
          f'and all {len(stats)} BN running-stat tensors changed')
    return (launches, captured, captured_train, sum(timed) / len(timed),
            det, cfg)


def phase_pvpp_harness(tmp):
    """[pvrcnn_plusplus] (d): tools.convergence_waymo on
    pv_rcnn_plusplus.yaml for CONV_PVPP_STEPS steps and a
    CONV_PVPP_TAIL-step frozen-BN tail, as [convergence] cuts Waymo: 4
    merge-resolve launches per train-mode forward and per predict, its
    active-site lines, finite losses and the AP / APH keys (printed, not
    gated).  Returns the launches."""
    import math
    import tempfile

    from glenet_tpu_torch.tools import convergence_waymo as cw
    saved_tmp = tempfile.tempdir
    tempfile.tempdir = str(tmp)
    try:
        entry, text, launches, per_call = run_tool(
            'pv_rcnn_plusplus_waymo', cw.main,
            [str(CONV_PVPP_STEPS), '1e-3',
             'configs/waymo_models/pv_rcnn_plusplus.yaml',
             str(CONV_PVPP_TAIL), '--out',
             str(tmp / 'convergence_pvpp.json')])
    finally:
        tempfile.tempdir = saved_tmp
    check_launches('pv_rcnn_plusplus_waymo', per_call, 4)
    losses = printed_losses(text)
    check(text.count('active sites max=') == 4
          and all(math.isfinite(v) for v in losses)
          and math.isfinite(entry['final_loss'])
          and entry['Vehicle_L1_AP'] is not None
          and entry['Vehicle_L1_APH'] is not None,
          f'pv_rcnn_plusplus_waymo harness: {entry}')
    conv_line(f'pv_rcnn_plusplus_waymo {CONV_PVPP_STEPS} + {CONV_PVPP_TAIL} '
              f'frozen-BN steps', entry, ('Vehicle_L1_AP', 'Vehicle_L1_APH'))
    return launches


def phase_pvrcnn_plusplus(tmp):
    """[pvrcnn_plusplus]: (a) pv_rcnn_plusplus.yaml at full width, with its
    host syncs and the card's neighbour searches against the CPU's; (b)
    pv_rcnn_plusplus_resnet.yaml; (c) the CLIs on [waymo]'s tree; (d) a
    short harness run.  (e) the card against the CPU on tiny_pvpp_raw and
    the kernel check of (a)'s captured calls run after the main paths.
    Returns (launches, captured predict calls, captured train-step
    calls)."""
    import torch
    launches, captured, captured_train, step_ms, det, cfg = phase_pvpp_full(
        'pv_rcnn_plusplus.yaml', SEED + 172, PVPP_PREDICTS, PVPP_STEPS,
        flips=True)
    print_syncs(det, cfg, 'PV-RCNN++', 'pvrcnn_plusplus')
    del det
    torch.cuda.empty_cache()
    n, _, _, _, det, _ = phase_pvpp_full('pv_rcnn_plusplus_resnet.yaml',
                                         SEED + 173, 1, 1, warmup=False)
    del det
    torch.cuda.empty_cache()
    launches += n
    launches += waymo_cli_round(tmp, step_ms, 'pv_rcnn_plusplus.yaml',
                                'pvrcnn_plusplus', 'PV-RCNN++', BATCH)
    launches += phase_pvpp_harness(tmp)
    return launches, captured, captured_train


# ---------------------------------------------------------------------------
# [convergence]: the synthetic convergence harness
# (glenet_tpu_torch/tools/convergence_ap.py, convergence_waymo.py,
# stage2_recovery.py)
# ---------------------------------------------------------------------------

CONV_PILLAR_STEPS = 700                  # PointPillars' full harness run
CONV_VR_STEPS, CONV_VR_HOLDOUT, CONV_VR_TEST_BUDGET = 20, 2, 40000
CONV_STAGE2_STEPS = 5
CONV_WAYMO_STEPS, CONV_WAYMO_TAIL = 10, 5
CONV_POINTRCNN_STEPS = 10


class _Tee:
    """Write to stdout and keep a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return ''.join(self.parts)


def run_tool(tag, main, argv):
    """One harness tool's main(argv) as a user runs it, its output shown
    with a [convergence] prefix; launches counted from 0 just before and
    read just after, per predict and per train-mode forward (loss_fn: the
    steps and the BN refresh).  Returns (its result, its output, the
    launches, {'predict': [...], 'loss_fn': [...]} per call)."""
    import contextlib

    from glenet_tpu_torch.models.detectors import Detector
    per_call = {'predict': [], 'loss_fn': []}
    undo = [count_launches(Detector, name, calls)
            for name, calls in per_call.items()]
    tee = _Tee(sys.stdout)
    LAUNCHES.n = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            result = main(argv)
    finally:
        for u in undo:
            u()
    n = LAUNCHES.n
    text = tee.text()
    print(f'[convergence] {tag}: {time.perf_counter() - t0:.1f} s of '
          f'command time; merge_resolve launches {n} over '
          f'{len(per_call["loss_fn"])} train-mode forwards and '
          f'{len(per_call["predict"])} predicts')
    return result, text, n, per_call


def printed_losses(text):
    """The losses of the one-cycle `step i:` lines of a harness run."""
    import re
    return [float(v) for v in re.findall(r'^step \d+: loss=(\S+) ', text,
                                         re.M)]


def check_launches(tag, per_call, expected):
    for name, calls in per_call.items():
        check(calls and all(c == expected for c in calls),
              f'{tag}: merge_resolve launches per {name} {calls}, expected '
              f'{expected}')


def conv_line(tag, entry, keys):
    print(f'[convergence] {tag}: card {entry["device"]}; '
          f'{entry["ms_per_step"]} ms per step; peak {entry["peak_gib"]} '
          f'GiB; final loss {entry["final_loss"]:.4f}; ' + ', '.join(
              f'{k} {entry[k]}' for k in keys))


def phase_convergence(tmp):
    """[convergence]: (a) PointPillars (pointpillar.yaml) through the
    harness at its full 700 steps; (b) GLENet-VR for CONV_VR_STEPS steps
    with CONV_VR_HOLDOUT held-out scenes, whose checkpoint feeds (c) a
    CONV_STAGE2_STEPS-step stage2_recovery, after which every stage-1
    tensor must equal its checkpointed value times prod(1 - lr_t * 0.01),
    AdamW's decay alone, within 1e-6 relative; (d) Waymo GLENet-S for
    CONV_WAYMO_STEPS steps and a CONV_WAYMO_TAIL-step frozen-BN tail, with
    its active-site lines; (e) PointRCNN (pointrcnn.yaml) for
    CONV_POINTRCNN_STEPS steps.  Results go to a file in `tmp`, dumps to
    `tmp`.  Checks finite losses, the last loss below the first
    (PointPillars), 4 merge-resolve launches per train-mode forward and per
    predict on the sparse families (0 on PointPillars and PointRCNN) and
    the evaluators' keys; the AP is printed, not gated.  Returns the
    launches."""
    import math
    import tempfile

    import numpy as np
    import torch

    from glenet_tpu_torch.tools import convergence_ap as ca
    from glenet_tpu_torch.tools import convergence_waymo as cw
    from glenet_tpu_torch.tools import stage2_recovery as s2
    from glenet_tpu_torch.train import checkpoint
    out = str(tmp / 'convergence.json')
    saved_tmp = tempfile.tempdir
    tempfile.tempdir = str(tmp)
    try:
        entry, text, launches, per_call = run_tool(
            'pointpillar', ca.main,
            [str(CONV_PILLAR_STEPS), '1e-3',
             'configs/kitti_models/pointpillar.yaml', '--out', out])
        losses = printed_losses(text)
        check_launches('pointpillar', per_call, 0)
        check(all(math.isfinite(v) for v in losses)
              and math.isfinite(entry['final_loss']) and losses[-1] <
              losses[0], f'pointpillar harness losses {losses}')
        check(entry['Car_3d_moderate_R40'] is not None
              and entry['Car_bev_moderate_R40'] is not None,
              f'pointpillar: KITTI AP keys missing: {entry}')
        conv_line(f'pointpillar {CONV_PILLAR_STEPS} steps (losses '
                  f'{losses[0]:.3f} -> {losses[-1]:.3f})', entry,
                  ('Car_3d_moderate_R40', 'Car_bev_moderate_R40'))

        entry, _, n, per_call = run_tool(
            'GLENet_VR', ca.main,
            [str(CONV_VR_STEPS), '1e-3',
             'configs/kitti_models/GLENet_VR.yaml', str(CONV_VR_TEST_BUDGET),
             str(CONV_VR_HOLDOUT), '--out', out])
        launches += n
        check_launches('GLENet_VR', per_call, 4)
        check(math.isfinite(entry['final_loss'])
              and entry['val_Car_3d_moderate_R40'] is not None
              and entry['Car_3d_moderate_R40'] is not None,
              f'GLENet_VR harness: {entry}')
        conv_line(f'GLENet_VR {CONV_VR_STEPS} steps, {CONV_VR_HOLDOUT} '
                  f'held out', entry, ('Car_3d_moderate_R40',
                                       'Car_bev_moderate_R40',
                                       'val_Car_3d_moderate_R40'))

        ckpt = checkpoint.load_checkpoint(checkpoint.find_latest_checkpoint(
            s2.checkpoint_sources()[0]))['model_state']
        (entry, det), _, n, per_call = run_tool(
            'stage2_recovery', s2.main,
            [str(CONV_STAGE2_STEPS), '1e-3', '--out', out])
        launches += n
        check_launches('stage2_recovery', per_call, 4)
        check(math.isfinite(entry['final_loss'])
              and entry['Car_3d_moderate_R40'] is not None,
              f'stage2_recovery: {entry}')
        lr = ca.harness_optimizer(CONV_STAGE2_STEPS, 1e-3).lr
        decay = float(np.prod([1.0 - lr(t) * ca.WEIGHT_DECAY
                               for t in range(CONV_STAGE2_STEPS)]))
        worst, n_stage1, moved = 0.0, 0, []
        for name, p in det.net.named_parameters():
            if name.startswith(s2.STAGE2):
                if not torch.equal(p.detach().cpu(), ckpt[name]):
                    moved.append(name)
                continue
            want = ckpt[name].double() * decay
            err = (p.detach().cpu().double() - want).abs()
            check(bool((err <= 1e-6 * want.abs()).all()),
                  f'stage2_recovery moved {name} beyond the decay')
            worst = max(worst, float((err / want.abs().clamp_min(1e-30))
                                     .max()))
            n_stage1 += 1
        check(moved, 'stage2_recovery left the RoI head as checkpointed')
        conv_line(f'stage2_recovery {CONV_STAGE2_STEPS} steps (stage 1: '
                  f'{n_stage1} tensors = checkpoint x {decay:.9f}, worst '
                  f'relative error {worst:.2e}; {len(moved)} RoI-head '
                  f'tensors moved)', entry,
                  ('Car_3d_moderate_R40', 'Car_bev_moderate_R40'))
        del det
        torch.cuda.empty_cache()

        entry, text, n, per_call = run_tool(
            'GLENet_S_waymo', cw.main,
            [str(CONV_WAYMO_STEPS), '1e-3',
             'configs/waymo_models/GLENet_S.yaml', str(CONV_WAYMO_TAIL),
             '--out', out])
        launches += n
        check_launches('GLENet_S_waymo', per_call, 4)
        check(text.count('active sites max=') == 4
              and math.isfinite(entry['final_loss'])
              and entry['Vehicle_L1_AP'] is not None
              and entry['Vehicle_L1_APH'] is not None,
              f'GLENet_S_waymo harness: {entry}')
        conv_line(f'GLENet_S_waymo {CONV_WAYMO_STEPS} + {CONV_WAYMO_TAIL} '
                  f'frozen-BN steps', entry,
                  ('Vehicle_L1_AP', 'Vehicle_L1_APH'))

        entry, text, n, per_call = run_tool(
            'pointrcnn', ca.main,
            [str(CONV_POINTRCNN_STEPS), '1e-3',
             'configs/kitti_models/pointrcnn.yaml', '--out', out])
        launches += n
        check_launches('pointrcnn', per_call, 0)
        losses = printed_losses(text)
        check(all(math.isfinite(v) for v in losses)
              and math.isfinite(entry['final_loss'])
              and entry['Car_3d_moderate_R40'] is not None,
              f'pointrcnn harness: {entry}')
        conv_line(f'pointrcnn {CONV_POINTRCNN_STEPS} steps', entry,
                  ('Car_3d_moderate_R40', 'Car_bev_moderate_R40'))
    finally:
        tempfile.tempdir = saved_tmp
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# [caddn]: CaDDN, the camera-only family (the depth-distribution image VFE,
# frustum-to-voxel sampling, Conv2DCollapse, the depth loss)
# ---------------------------------------------------------------------------

CADDN_STEPS = 2
CADDN_TRAIN, CADDN_VAL = 8, 4             # the CLI tree's frames
CONV_CADDN_STEPS = 10

# tests/test_caddn.py's toy CaDDN (DDNLite, 12 LID bins, a 16 x 20 x 8 grid,
# one BEV level), the topology the port's CPU parity tests hold against
# glenet_tpu
TINY_CADDN = {
    'CLASS_NAMES': ['Car'],
    'DATA_CONFIG': {
        'POINT_CLOUD_RANGE': [2, -8, -3.0, 14.8, 8, 1.0],
        'DATA_PROCESSOR': [{'NAME': 'calculate_grid_size',
                            'VOXEL_SIZE': [0.8, 0.8, 0.5]}]},
    'MODEL': {
        'NAME': 'CaDDN',
        'VFE': {'NAME': 'ImageVFE', 'FFN': {
            'NAME': 'DepthFFN', 'DDN': {'NAME': 'DDNLite', 'ARGS': {}},
            'CHANNEL_REDUCE': {'in_channels': 64, 'out_channels': 16,
                               'kernel_size': 1, 'stride': 1,
                               'bias': False},
            'DISCRETIZE': {'mode': 'LID', 'num_bins': 12,
                           'depth_min': 2.0, 'depth_max': 14.8},
            'LOSS': {'NAME': 'DDNLoss', 'ARGS': {
                'weight': 3.0, 'alpha': 0.25, 'gamma': 2.0,
                'fg_weight': 13, 'bg_weight': 1}}},
            'F2V': {'NAME': 'FrustumToVoxel'}},
        'MAP_TO_BEV': {'NAME': 'Conv2DCollapse', 'NUM_BEV_FEATURES': 16},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [2],
                        'LAYER_STRIDES': [2], 'NUM_FILTERS': [32],
                        'UPSAMPLE_STRIDES': [1],
                        'NUM_UPSAMPLE_FILTERS': [32]},
        'DENSE_HEAD': {
            'NAME': 'AnchorHeadSingle', 'CLASS_AGNOSTIC': False,
            'USE_DIRECTION_CLASSIFIER': True, 'DIR_OFFSET': 0.78539,
            'DIR_LIMIT_OFFSET': 0.0, 'NUM_DIR_BINS': 2,
            'ANCHOR_GENERATOR_CONFIG': [{
                'class_name': 'Car', 'anchor_sizes': [[3.9, 1.6, 1.56]],
                'anchor_rotations': [0, 1.57],
                'anchor_bottom_heights': [-1.78], 'align_center': False,
                'feature_map_stride': 2, 'matched_threshold': 0.6,
                'unmatched_threshold': 0.45}],
            'TARGET_ASSIGNER_CONFIG': {
                'NAME': 'AxisAlignedTargetAssigner', 'POS_FRACTION': -1.0,
                'SAMPLE_SIZE': 512, 'NORM_BY_NUM_EXAMPLES': False,
                'MATCH_HEIGHT': False, 'BOX_CODER': 'ResidualCoder'},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {
                'cls_weight': 1.0, 'loc_weight': 2.0, 'dir_weight': 0.2,
                'code_weights': [1.0] * 7}}},
        'POST_PROCESSING': {
            'SCORE_THRESH': 0.0,
            'NMS_CONFIG': {'MULTI_CLASSES_NMS': False,
                           'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.01,
                           'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 16}},
    },
    'OPTIMIZATION': {
        'BATCH_SIZE_PER_GPU': 2, 'NUM_EPOCHS': 1, 'OPTIMIZER': 'adam_onecycle',
        'LR': 0.003, 'WEIGHT_DECAY': 0.01, 'MOMS': [0.95, 0.85],
        'PCT_START': 0.4, 'DIV_FACTOR': 10, 'GRAD_NORM_CLIP': 10},
}


def tiny_camera_batch(seed, b=2, h=32, w=48):
    """tests/test_caddn.py's make_camera_batch as tensors: random images, a
    pinhole camera looking along lidar x, two Cars per sample, depth maps
    in the grid's range, one 2-D box per gt."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    l2c = np.array([[0., -1., 0., 0.], [0., 0., -1., 0.], [1., 0., 0., 0.],
                    [0., 0., 0., 1.]], np.float32)
    c2i = np.array([[30., 0., w / 2, 0.], [0., 30., h / 2, 0.],
                    [0., 0., 1., 0.]], np.float32)
    images = rng.rand(b, h, w, 3).astype(np.float32)
    gt = np.zeros((b, 4, 8), np.float32)
    gt_mask = np.zeros((b, 4), bool)
    for k in range(b):
        for g in range(2):
            gt[k, g] = [rng.uniform(5, 12), rng.uniform(-4, 4), -1.0, 3.9,
                        1.6, 1.56, rng.uniform(-0.5, 0.5), 1]
            gt_mask[k, g] = True
    depth = rng.uniform(2.0, 14.0, (b, h // 4, w // 4)).astype(np.float32)
    boxes2d = np.zeros((b, 4, 4), np.float32)
    boxes2d[:, :2] = [2, 2, 8, 6]
    arrays = {'points': np.zeros((b, 1, 4), np.float32),
              'points_mask': np.zeros((b, 1), bool), 'images': images,
              'trans_lidar_to_cam': np.tile(l2c, (b, 1, 1)),
              'trans_cam_to_img': np.tile(c2i, (b, 1, 1)),
              'image_shape': np.tile(np.array([h, w], np.int32), (b, 1)),
              'gt_boxes': gt, 'gt_mask': gt_mask,
              'gt_uncertainty': np.ones((b, 4, 7), np.float32),
              'depth_maps': depth, 'gt_boxes2d': boxes2d,
              'gt_boxes2d_mask': gt_mask}
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def camera_share(det, batch):
    """Per sample, the share of voxel centres that project into the image
    (in front of the camera, inside image_shape) and into the frustum
    volume (also inside the depth bins)."""
    import torch

    from glenet_tpu_torch.models.image_vfe import frustum_coords
    vfe = det.net.vfe
    out = []
    with torch.no_grad():
        for i in range(batch['images'].shape[0]):
            # the depth network's stride 4: pixel v is feature row
            # v / 4 - 0.5
            c = frustum_coords(vfe.centers, batch['trans_lidar_to_cam'][i],
                               batch['trans_cam_to_img'][i], vfe.disc,
                               vfe.num_bins, 4.0, 4.0)
            ih, iw = (int(x) for x in batch['image_shape'][i])
            v, u = (c[:, 1] + 0.5) * 4, (c[:, 2] + 0.5) * 4
            img = (c[:, 0] > -10) & (u >= 0) & (u < iw) & (v >= 0) & (v < ih)
            vol = img & (c[:, 0] >= 0) & (c[:, 0] <= vfe.num_bins - 1)
            out.append((float(img.float().mean()), float(vol.float().mean())))
    return out


def caddn_syncs(fn):
    """Host syncs of one call, by file:line."""
    from glenet_tpu_torch.profile_cvae import _syncs
    syncs = _syncs(fn)
    return (f'{sum(syncs.values())} host syncs ('
            + ', '.join(f'{k} x{v}' for k, v in syncs.most_common(6)) + ')')


def phase_caddn_full():
    """[caddn] (a): CaDDN.yaml at full width (DDNLite, 80 LID bins, images
    padded to 376 x 1248, the 280 x 376 x 25 grid, BaseBEVBackbone [10,
    10, 10], AnchorHeadSingle, nms_gpu) with seeded weights on synthetic
    KITTI-like camera batches: a warm-up predict, N_REQUESTS predicts at
    B = 2, a warm-up train step and CADDN_STEPS timed ones at B = 4; per
    call ms, loss terms with grad_norm, peak memory, the share of voxel
    centres in the image; the host syncs of one more predict and step;
    merge-resolve launches counted from 0 just before and read just after
    each call: 0.  Returns (launches, mean predict ms, mean step ms)."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import batches_for, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/CaDDN.yaml'))
    names = list(cfg.CLASS_NAMES)
    det = seeded_detector(cfg, 'cuda', SEED + 160)
    batches = batches_for(cfg, N_REQUESTS + 1, SEED + 161, BATCH)
    t0 = time.perf_counter()
    det.predict(batches[0])
    torch.cuda.synchronize()
    print(f'[caddn] CaDDN: grid {tuple(det.grid_size)}, images '
          f'{tuple(batches[0]["images"].shape[1:3])}; warm-up predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    launches, times = 0, []
    k = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    for r, batch in enumerate(batches[1:]):
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = det.predict(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        n = LAUNCHES.n
        launches += n
        peak = torch.cuda.max_memory_allocated()
        check(n == 0, f'CaDDN predict {r}: {n} merge-resolve launches')
        for key, shape in (('final_boxes', (BATCH, k, 7)),
                           ('final_scores', (BATCH, k))):
            check(tuple(pred[key].shape) == shape
                  and bool(torch.isfinite(pred[key]).all()),
                  f'CaDDN predict {r}: {key} {tuple(pred[key].shape)} or '
                  f'not finite')
        share = camera_share(det, batch)
        check(all(0 < img < 1 for img, _ in share),
              f'CaDDN: voxel centres in the image {share}')
        print(f'[caddn] CaDDN predict {r} B={BATCH}: {times[-1]:.1f} ms; '
              f'detections {pred["final_valid"].sum(1).tolist()} ('
              f'{per_class(pred["final_labels"], pred["final_valid"], names)}'
              f'); voxel centres in the image / in the frustum volume '
              + ', '.join(f'{a:.4f} / {b:.4f}' for a, b in share)
              + f'; merge_resolve launches {n}; max_memory_allocated '
              f'{peak / 2**30:.2f} GiB')
    pred_ms = sum(times) / len(times)
    # seeded weights score every anchor near the class prior, under the
    # published SCORE_THRESH: one more predict at 0 keeps boxes
    post = det.model_cfg.POST_PROCESSING
    saved, post.SCORE_THRESH = post.SCORE_THRESH, 0.0
    LAUNCHES.n = 0
    try:
        pred = det.predict(batches[1])
    finally:
        post.SCORE_THRESH = saved
    launches += LAUNCHES.n
    check(LAUNCHES.n == 0 and int(pred['final_valid'].sum(1).min()) > 0,
          f'CaDDN predict at zero thresholds: {LAUNCHES.n} launches, '
          f'detections {pred["final_valid"].sum(1).tolist()}')
    print(f'[caddn] CaDDN predict at zero thresholds: detections '
          f'{pred["final_valid"].sum(1).tolist()} ('
          f'{per_class(pred["final_labels"], pred["final_valid"], names)})')

    _, state, train_step = build_training(cfg, det)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tbatches = batches_for(cfg, CADDN_STEPS + 1, SEED + 162, b, train=True)
    params = {n: p.detach().clone() for n, p in det.net.named_parameters()}
    stats = {n: t.clone() for n, t in det.net.named_buffers()
             if n.endswith(('running_mean', 'running_var'))}
    times = []
    for i, batch in enumerate(tbatches):
        label = 'warm-up step' if i == 0 else f'step {i - 1}'
        LAUNCHES.n = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        n = LAUNCHES.n
        launches += n
        vals = {key: float(v) for key, v in metrics.items()}
        check(n == 0, f'CaDDN train {label}: {n} merge-resolve launches')
        check(all(math.isfinite(v) for v in vals.values())
              and vals['loss_depth'] > 0 and vals['loss_cls'] > 0,
              f'CaDDN train {label}: {vals}')
        print(f'[caddn] CaDDN {label} B={b}: {times[-1]:.1f} ms; '
              + ', '.join(f'{key} {v:.5f}' for key, v in sorted(vals.items()))
              + f'; gt boxes {batch["gt_mask"].sum(1).tolist()}; '
              f'merge_resolve launches {n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    still = [n for n, p in det.net.named_parameters()
             if torch.equal(p.detach(), params[n])]
    stuck = [n for n, p in det.net.named_parameters() if n in still and (
        bool(p.detach().any()) or (p.grad is not None and bool(p.grad.any())))]
    check(not stuck, f'CaDDN: parameters unchanged by the steps: {stuck}')
    bufs = dict(det.net.named_buffers())
    same = [n for n, t in stats.items() if torch.equal(bufs[n], t)]
    check(not same, f'CaDDN: BN running stats unchanged: {same}')
    step_ms = sum(times[1:]) / len(times[1:])
    print(f'[caddn] CaDDN predict B={BATCH} mean {pred_ms:.1f} ms over '
          f'{N_REQUESTS} requests; train B={b} mean {step_ms:.1f} ms over '
          f'{CADDN_STEPS} steps (warm-up {times[0]:.1f}); '
          f'{len(params) - len(still)} of {len(params)} parameter tensors '
          f'and all {len(stats)} BN running-stat tensors changed')
    print(f'[caddn] CaDDN predict: ' + caddn_syncs(
        lambda: det.predict(batches[1])))
    print(f'[caddn] CaDDN train step: ' + caddn_syncs(
        lambda: train_step(state, tbatches[1])))
    del det, state
    torch.cuda.empty_cache()
    return launches, pred_ms, step_ms


def phase_caddn_deeplab():
    """[caddn] (b): CaDDN_deeplab.yaml (DDNDeepLabV3, ResNet-101 at output
    stride 8, its 256 -> 64 channel_reduce): one predict at B = 2, then a
    train step at the largest of BATCH_SIZE_PER_GPU (4), 2 and 1 that
    fits.  Returns (launches, predict ms, step ms, the step's batch)."""
    import math

    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import batches_for, seeded_detector
    cfg = cfg_from_yaml_file(str(ROOT /
                                 'configs/kitti_models/CaDDN_deeplab.yaml'))
    det = seeded_detector(cfg, 'cuda', SEED + 163)
    batches = batches_for(cfg, 2, SEED + 164, BATCH)
    det.predict(batches[0])
    LAUNCHES.n = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = det.predict(batches[1])
    torch.cuda.synchronize()
    pred_ms = 1e3 * (time.perf_counter() - t0)
    launches = LAUNCHES.n
    check(launches == 0 and bool(torch.isfinite(pred['final_boxes']).all()),
          f'CaDDN-DeepLab predict: {launches} launches or boxes not finite')
    print(f'[caddn] CaDDN-DeepLab (ResNet-101) predict B={BATCH}: '
          f'{pred_ms:.1f} ms (after a warm-up); detections '
          f'{pred["final_valid"].sum(1).tolist()}; merge_resolve launches '
          f'{launches}; max_memory_allocated '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    _, state, train_step = build_training(cfg, det)
    for b in (int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), 2, 1):
        batch = batches_for(cfg, 1, SEED + 165, b, train=True)[0]
        torch.cuda.reset_peak_memory_stats()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            LAUNCHES.n = 0
            state, metrics = train_step(state, batch)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            print(f'[caddn] CaDDN-DeepLab train step B={b}: out of memory')
            for p in det.net.parameters():
                p.grad = None
            torch.cuda.empty_cache()
            continue
        step_ms = 1e3 * (time.perf_counter() - t0)
        n = LAUNCHES.n
        launches += n
        vals = {key: float(v) for key, v in metrics.items()}
        check(n == 0 and all(math.isfinite(v) for v in vals.values()),
              f'CaDDN-DeepLab train step B={b}: {n} launches, {vals}')
        print(f'[caddn] CaDDN-DeepLab train step B={b} (the largest of 4, '
              f'2, 1 that fits; its first, so with cuDNN\'s warm-up): '
              f'{step_ms:.1f} ms; ' + ', '.join(
                  f'{key} {v:.5f}' for key, v in sorted(vals.items()))
              + f'; merge_resolve launches {n}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
        break
    else:
        check(False, 'CaDDN-DeepLab: no train step fits, not even at B = 1')
    del det, state
    torch.cuda.empty_cache()
    return launches, pred_ms, step_ms, b


def phase_caddn_cli(tmp):
    """[caddn] (c): a synthetic three-class tree in KITTI's layout with
    image_2 / depth_2 PNGs (CADDN_TRAIN + CADDN_VAL frames of 120000
    points), its infos, then CaDDN.yaml through `tools.train` (B = 4, 1
    epoch x 2 steps; random_image_flip; the PNGs read by the port's own
    codec) and `tools.test` with the three-class KITTI evaluation.
    Returns the launches."""
    import math

    import numpy as np
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.datasets.kitti_dataset import create_kitti_infos
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.utils import synthetic
    cfg_file = str(ROOT / 'configs/kitti_models/CaDDN.yaml')
    cfg = cfg_from_yaml_file(cfg_file)
    t0 = time.perf_counter()
    root = synthetic.write_kitti_tree(tmp / 'caddn_kitti', CADDN_TRAIN,
                                      CADDN_VAL, seed=SEED + 166,
                                      x_range=(6.0, 46.0),
                                      three_class=True, camera=True)
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    print(f'[caddn] camera tree ({CADDN_TRAIN} + {CADDN_VAL} frames, PNGs '
          f'written by utils/png.py) and its infos in '
          f'{time.perf_counter() - t0:.1f} s')
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    out = tmp / 'out_caddn'
    common = ['--cfg_file', cfg_file, '--data_path', str(root),
              '--output_dir', str(out), '--batch_size', str(b)]
    LAUNCHES.n = 0
    torch.cuda.reset_peak_memory_stats()
    run = train_cli.main(common + ['--epochs', '1',
                                   '--max_steps_per_epoch', '2'])
    n_train = LAUNCHES.n
    check(n_train == 0 and len(run['steps']) == 2,
          f'CaDDN CLI train: {len(run["steps"])} steps, {n_train} launches')
    for r in run['steps']:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad and r['loss_depth'] > 0,
              f'CaDDN CLI step {r["it"]}: not finite: {bad}')
        print(f'[caddn] CaDDN CLI train step {r["it"]} B={b}: data '
              f'{r["data_ms"]:.1f} ms (PNG decode, flip, padding, '
              f'collation, copy), step {r["step_ms"]:.1f} ms, loss '
              f'{r["loss"]:.4f}, loss_depth {r["loss_depth"]:.4f}, '
              f'grad_norm {r["grad_norm"]:.3f}; max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    LAUNCHES.n = 0
    results = test_cli.main(common)
    n_test = LAUNCHES.n
    (path, res), = results.items()
    keys = [f'{c}_3d/moderate_R40' for c in cfg.CLASS_NAMES]
    check(res['frames'] == CADDN_VAL and n_test == 0
          and all(np.isfinite(res['ap'][k]) for k in keys),
          f'CaDDN test CLI: {res["frames"]} frames, {n_test} launches')
    print(f'[caddn] CaDDN test CLI on {Path(path).name}: {res["frames"]} '
          f'val frames, {res["sec_per_frame"]:.4f} s/frame, KITTI '
          f'evaluation {res["eval_sec"]:.3f} s; ' + ', '.join(
              f'{k} {res["ap"][k]:.2f}' for k in keys)
          + f'; merge_resolve launches: train {n_train}, test {n_test}')
    return n_train + n_test


def phase_caddn_harness(tmp):
    """[caddn] (d): tools.convergence_caddn for CONV_CADDN_STEPS steps:
    no merge-resolve launch, finite losses, the AP keys (printed, not
    gated).  Returns the launches."""
    import math
    import tempfile

    from glenet_tpu_torch.tools import convergence_caddn as cc
    saved_tmp = tempfile.tempdir
    tempfile.tempdir = str(tmp)
    try:
        entry, text, launches, per_call = run_tool(
            'caddn', cc.main, [str(CONV_CADDN_STEPS), '1e-3', '--out',
                               str(tmp / 'convergence_caddn.json')])
    finally:
        tempfile.tempdir = saved_tmp
    check_launches('caddn', per_call, 0)
    check(all(math.isfinite(v) for v in printed_losses(text))
          and math.isfinite(entry['final_loss'])
          and entry['Car_3d_moderate_R40'] is not None,
          f'caddn harness: {entry}')
    conv_line(f'caddn {CONV_CADDN_STEPS} steps', entry,
              ('Car_3d_moderate_R40', 'Car_bev_moderate_R40', 'depth_top1'))
    return launches


def phase_caddn(tmp):
    """[caddn]: (a) CaDDN.yaml at full width, (b) CaDDN_deeplab.yaml, (c)
    the CLIs on a camera tree, (d) a short harness run.  (e), the card
    against the CPU, runs after the main paths.  Returns (launches, {call:
    ms})."""
    launches, pred_ms, step_ms = phase_caddn_full()
    n, dl_pred, dl_step, dl_b = phase_caddn_deeplab()
    launches += n + phase_caddn_cli(tmp) + phase_caddn_harness(tmp)
    print(f'[caddn] mean ms: CaDDN predict {pred_ms:.1f}, step {step_ms:.1f};'
          f' CaDDN-DeepLab predict {dl_pred:.1f}, step (B={dl_b}) '
          f'{dl_step:.1f}; merge_resolve launches over the phase {launches}')
    return launches


def phase_caddn_gpu_vs_cpu(tag='caddn] [gpu-vs-cpu'):
    """[caddn] (e): the toy CaDDN (TINY_CADDN, tiny_camera_batch) on the
    card and on the CPU, f32 with TF32 off in cuBLAS and cuDNN, the
    production bf16 gather on both: a predict and a train step, the card
    first.  A frustum value within f32 rounding of a bf16 rounding
    boundary may round the other way: a voxel feature may then differ by
    one bf16 ulp (<= 2^-7 relative) of the frustum values it samples, and
    the CPU takes the card's voxel features where they differ beyond f32
    rounding, each within that bound (any other difference fails); at a
    ReLU kink within rounding of 0 the CPU takes the card's side
    (relu_signs).  Then as phase_gpu_vs_cpu / _train: the dense head's
    outputs and the depth logits within 1e-3; the final NMS (its scores
    within ~1e-6 of each other under seeded weights) of the card's
    dense-head outputs on both devices, its masks and labels equal, boxes
    and scores within 1e-3; loss terms within rtol 1e-4, gradients within
    1e-3 of their largest, BN stats rtol 1e-4, the parameters after
    adam_onecycle within 2 lr."""
    import torch

    from glenet_tpu_torch.config import Cfg
    from glenet_tpu_torch.models import image_vfe
    from glenet_tpu_torch.train import optim, state as st
    from glenet_tpu_torch.utils.synthetic import seeded_detector
    cfg = Cfg(TINY_CADDN)
    batch = tiny_camera_batch(SEED + 7)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32, image_vfe.trilinear_sample)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    real = image_vfe.trilinear_sample
    record = {'vols': []}

    def sample(volume, coords, *args, **kw):
        record['vols'].append((volume.detach(), coords))
        return real(volume, coords, *args, **kw)

    image_vfe.trilinear_sample = sample
    ties = {'n': 0, 'largest': 0.0}

    def vox_hook(ref):
        def fn(_mod, _inp, out):
            y = out['voxel_features']
            bound = torch.stack([real(v.abs(), c) for v, c in
                                 record['vols']]).reshape(y.shape)
            r = ref.to(y.device)
            diff = (y - r).abs().detach()
            f32 = 1e-5 * bound + 1e-7
            tie = diff > f32
            check(bool((diff <= f32 + 2.0 ** -7 * bound).all()),
                  f'{tag}: voxel features differ beyond a bf16 tie')
            ties['n'] += int(tie.sum())
            ties['largest'] = max(ties['largest'], float(
                (diff / (2.0 ** -7 * bound + 1e-30))[tie].max())
                if bool(tie.any()) else 0.0)
            return dict(out, voxel_features=y + torch.where(
                tie, r - y, 0.0).detach())
        return fn

    runs, signs, vox = [], None, {}
    try:
        for i, dev in enumerate(('cuda', 'cpu')):    # the card first
            bt = {k: v.to(dev) for k, v in batch.items()}
            det = seeded_detector(cfg, dev, SEED + 3)
            hooks = []
            for mode in ('predict', 'train'):
                record['vols'] = []
                if i == 1:
                    hooks.append(det.net.vfe.register_forward_hook(
                        vox_hook(vox[mode])))
                else:
                    hooks.append(det.net.vfe.register_forward_hook(
                        lambda _m, _i, out, mode=mode: vox.__setitem__(
                            mode, out['voxel_features'].detach().cpu())))
                if mode == 'predict':
                    with torch.no_grad():
                        full = det.net(None, None, camera=bt)
                        pred = det.finalize(full)
                else:
                    tx, _ = optim.build_optimizer(cfg.OPTIMIZATION, 100)
                    state = st.create_train_state(det, tx)
                    signs, bn_hooks = relu_signs(det.net, signs)
                    hooks += bn_hooks
                    state, metrics = st.make_train_step(det, tx)(state, bt)
                for h in hooks:
                    h.remove()
                hooks = []
            runs.append((full, pred, metrics, det.net, tx))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         image_vfe.trilinear_sample) = saved
    (fg, pg, mg, ng, _), (fc, pc, mc, nc, tx) = runs
    # seeded weights score the toy's anchors within ~1e-6 of each other,
    # so the final NMS (NMS_THRESH 0.01) is held on the same inputs: the
    # CPU's finalize of the card's dense-head outputs
    with torch.no_grad():
        pc = det.finalize({'dense_head': {k: v.cpu() for k, v in
                                          fg['dense_head'].items()}})
    for name in ('final_valid', 'final_labels'):
        check(torch.equal(pc[name], pg[name].cpu()),
              f'GPU and CPU differ in {name}')
    close = [(k, fc['dense_head'][k], fg['dense_head'][k])
             for k in sorted(fc['dense_head'])]
    close += [('depth_logits', fc['depth_logits'], fg['depth_logits']),
              ('final_boxes', pc['final_boxes'], pg['final_boxes']),
              ('final_scores', pc['final_scores'], pg['final_scores'])]
    for name, a, b in close:
        err = float((a - b.cpu()).abs().max())
        check(torch.allclose(a, b.cpu(), rtol=1e-3, atol=1e-4),
              f'GPU and CPU differ in {name}')
        print(f'[{tag}] {name}: max_abs_err {err:.3e} (rtol 1e-3, atol '
              f'1e-4)')
    for k, v in mc.items():
        check(abs(float(mg[k].cpu()) - float(v)) <= 1e-4 * abs(float(v))
              + 1e-6, f'GPU and CPU differ in {k}: {float(mg[k])} vs '
                      f'{float(v)}')
    worst = 0.0
    gpu_params = dict(ng.named_parameters())
    lr = tx.hyperparams(0)[0]
    for name, p in nc.named_parameters():
        g_c = p.grad if p.grad is not None else torch.zeros_like(p)
        pg_ = gpu_params[name]
        g_g = (pg_.grad if pg_.grad is not None
               else torch.zeros_like(pg_)).cpu()
        err = float((g_c - g_g).abs().max())
        tol = 1e-3 * float(g_c.abs().max()) + 1e-6
        check(err <= tol, f'GPU and CPU gradients differ in {name}: '
                          f'{err:.3e} > {tol:.3e}')
        worst = max(worst, err / tol)
        check(float((p.detach() - pg_.detach().cpu()).abs().max())
              <= 2 * lr + 1e-6, f'GPU and CPU parameters differ after the '
                                f'step in {name}')
    gpu_bufs = dict(ng.named_buffers())
    for name, buf in nc.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            check(torch.allclose(buf, gpu_bufs[name].cpu(), rtol=1e-4,
                                 atol=1e-5),
                  f'GPU and CPU BN running stats differ in {name}')
    print(f'[{tag}] tiny CaDDN: predict integer outputs equal, '
          f'{int(pc["final_valid"].sum())} valid final boxes; train step '
          f'loss terms within rtol 1e-4 (' + ', '.join(
              f'{k} {float(v):.6f}' for k, v in sorted(mc.items()))
          + f'), every gradient within its tolerance (worst at {worst:.2f} '
          f'of it), BN stats and parameters after adam_onecycle agree; '
          f'voxel features the CPU took from the card at a bf16 tie: '
          f'{ties["n"]} (largest at {ties["largest"]:.2f} of one ulp); '
          f'ReLU inputs taken on the card\'s side of 0: {signs["flipped"]}')


# ---------------------------------------------------------------------------
# [nuscenes]: the nuScenes, Lyft and Pandaset datasets and the option pieces
# their models use (sin/cos box coder, fractional upsample strides,
# PreviousResidualDecoder, nms_normal, soft_nms, MLP)
# ---------------------------------------------------------------------------

# the CLI trees: frames of train and val, batch, epochs x steps
NUSC_CLI = (8, 4, 4, 2, 2)
LYFT_CLI = (4, 4, 4, 1, 1)
PANDASET_CLI = (8, 4, 4, 1, 2)
NUSC_KEYS = ('NDS', 'mAP', 'mATE', 'mASE', 'mAOE', 'car_AP_2.0')
LYFT_KEYS = ('mAP', 'car_mAP', 'pedestrian_mAP', 'bicycle_mAP')
PANDASET_KEYS = ('Car_3d/moderate_R40', 'Pedestrian_3d/moderate_R40',
                 'Cyclist_3d/moderate_R40')


def phase_nuscenes_full(seed):
    """[nuscenes] (a): the nuScenes CenterPoint run-time config
    (config.run_cfg_dict('nuscenes_centerpoint'): centerpoint.yaml's model
    over nuscenes_dataset.yaml, 10 classes in one CenterHead group) at full
    width (VoxelResBackBone8x on the 1024 x 1024 x 40 grid, budgets 60000 /
    60000, a 128 x 128 x 10 heatmap) with seeded weights on synthetic
    nuScenes scenes (a key frame and 9 sweeps of 34000 points, capped at
    262144): a warm-up predict that captures its merge-resolve calls,
    N_REQUESTS predicts at B = 2, a warm-up train step (also captured) and
    TRAIN_STEPS timed ones at B = 4, then the host syncs of one more of
    each.  Returns (launches, captured predict calls, captured train-step
    calls, step ms)."""
    import torch

    from glenet_tpu_torch.config import Cfg, run_cfg_dict
    from glenet_tpu_torch.utils import synthetic
    cfg = Cfg(run_cfg_dict('nuscenes_centerpoint'))
    det = synthetic.seeded_detector(cfg, 'cuda', seed)
    check(det.is_center_head and det.net.backbone_3d.residual
          and tuple(det.grid_size) == (1024, 1024, 40)
          and (det.max_voxels_train, det.max_voxels_test) == (60000, 60000)
          and det.net.dense_head.hm_1.weight.shape[0] == 10,
          f'nuScenes CenterPoint built with grid {det.grid_size}')
    n_max = int(cfg.DATA_CONFIG.MAX_POINTS_PER_SCENE)
    t0 = time.perf_counter()
    batches = synthetic.batches_for(cfg, N_REQUESTS + 1, SEED + 170, BATCH)
    n_in = batches[1]['points_mask'].sum(1).tolist()
    print(f'[nuscenes] {N_REQUESTS + 1} batches of B={BATCH} synthetic '
          f'nuScenes scenes (key frame + 9 sweeps of '
          f'{synthetic.NUSC_SWEEP_POINTS} points, points in range {n_in} '
          f'of the {n_max} cap) made in {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    captured = capture_calls(lambda: det.predict(batches[0]),
                             'nuScenes CenterPoint predict')[0]
    print(f'[nuscenes] nuScenes CenterPoint: warm-up predict '
          f'{1e3 * (time.perf_counter() - t0):.1f} ms')
    launches = phase_full_width(det, batches[1:], 'nuscenes',
                                'nuScenes CenterPoint', n_points=n_max)
    n, captured_train, times = phase_train(cfg, det, 'nuscenes',
                                           'nuScenes CenterPoint',
                                           n_points=n_max)
    print_syncs(det, cfg, 'nuScenes CenterPoint', tag='nuscenes')
    del det
    torch.cuda.empty_cache()
    return launches + n, captured, captured_train, times


def slice_cli_round(tmp, name, label, tree, plan, keys, in_memory_ms=None):
    """The run-time config `name` through `tools.train` (B, epochs x steps
    of `plan` = (train frames, val frames, B, epochs, steps)) and
    `tools.test` at score threshold 0 (random weights score few boxes above
    the published one) over the tree `tree(root)` writes: data ms per
    batch split into gt sampling, world augmentations, sweeps (the point
    files and their transforms) and the rest of the items, collation and
    the copy; step ms; the detections evaluated, the evaluation's keys
    `keys` and its seconds; 4 merge-resolve launches per train step and
    per predict.  Returns the launches."""
    import math
    import pickle

    import numpy as np
    import torch

    from glenet_tpu_torch.config import write_run_cfg
    from glenet_tpu_torch.datasets import augmentor
    from glenet_tpu_torch.datasets.nuscenes_dataset import NuScenesDataset
    from glenet_tpu_torch.datasets.pandaset_dataset import PandasetDataset
    from glenet_tpu_torch.datasets.waymo_dataset import WaymoDataset
    from glenet_tpu_torch.models.detectors import Detector
    from glenet_tpu_torch.tools import test as test_cli
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.train import state as state_lib
    n_train, n_val, b, epochs, steps = plan
    root = tmp / name
    t0 = time.perf_counter()
    tree(root)
    cfg_file = write_run_cfg(name, tmp / f'{name}.yaml', root)
    print(f'[nuscenes] {label}: synthetic tree of {n_train} + {n_val} '
          f'frames written in {time.perf_counter() - t0:.1f} s')
    common = ['--cfg_file', str(cfg_file), '--output_dir',
              str(tmp / f'{name}_out'), '--batch_size', str(b)]
    step_launches, predict_launches, data = [], [], {}
    sweeps_cls = (PandasetDataset if name == 'pandaset_second'
                  else NuScenesDataset)
    undo = [count_launches(state_lib, 'make_train_step', step_launches),
            count_launches(Detector, 'predict', predict_launches)]
    timers = [time_calls(NuScenesDataset, '__getitem__', data, 'items'),
              time_calls(sweeps_cls, 'get_lidar_with_sweeps', data,
                         'sweeps'),
              time_calls(augmentor.DataAugmentor, '__call__', data,
                         'augment'),
              time_calls(augmentor.DataBaseSampler, '__call__', data,
                         'gt_sampling'),
              time_calls(WaymoDataset, 'collate_batch', data, 'collate'),
              time_calls(train_cli, 'to_device', data, 'copy')]
    LAUNCHES.n = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        run = train_cli.main(common + ['--epochs', str(epochs),
                                       '--max_steps_per_epoch', str(steps)])
        peak = torch.cuda.max_memory_allocated()
        for u in timers:
            u()
        # random weights score few boxes above the published threshold
        results = test_cli.main(common + [
            '--set', 'MODEL.POST_PROCESSING.SCORE_THRESH', '0.0'])
    finally:
        for u in undo + timers:
            u()
    launches = LAUNCHES.n
    its = [r['it'] for r in run['steps']]
    check(its == list(range(1, epochs * steps + 1))
          and step_launches == [4] * len(its),
          f'{label} CLI steps {its}, launches per step {step_launches}')
    for r in run['steps']:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f'{label} CLI step {r["it"]}: not finite: {bad}')
        losses = ', '.join(f'{k} {r[k]:.4f}' for k in sorted(r)
                           if 'loss' in k)
        print(f'[nuscenes] {label} CLI train step {r["it"]} (epoch '
              f'{r["epoch"]}) B={b}: data {r["data_ms"]:.1f} ms, step '
              f'{r["step_ms"]:.1f} ms, {losses}, grad_norm '
              f'{r["grad_norm"]:.3f}')
    n = data['collate n']
    ms = {k: 1e3 * data.get(k, 0.0) / n for k in (
        'items', 'sweeps', 'augment', 'gt_sampling', 'collate', 'copy')}
    against = ('' if in_memory_ms is None else
               f' against the in-memory step '
               f'{sum(in_memory_ms) / len(in_memory_ms):.1f} ms')
    print(f'[nuscenes] {label} train through the CLI, B={b}: mean data '
          f'{sum(r["data_ms"] for r in run["steps"]) / len(its):.1f} ms, '
          f'step {sum(r["step_ms"] for r in run["steps"]) / len(its):.1f} '
          f'ms{against}; data per batch (host ms, mean over {n} batches): '
          f'items {ms["items"] + ms["sweeps"] + ms["augment"] + ms["gt_sampling"]:.1f} '
          f'= sweeps {ms["sweeps"]:.1f} + gt sampling '
          f'{ms["gt_sampling"]:.1f} + world augmentations '
          f'{ms["augment"]:.1f} + class filter, range mask, shuffle and '
          f'padding {ms["items"]:.1f}; collation {ms["collate"]:.1f}; copy '
          f'to the card {ms["copy"]:.1f}; max_memory_allocated '
          f'{peak / 2**30:.2f} GiB')
    (path, res), = results.items()
    with open(Path(path).parents[1] / 'eval' / f'epoch_{epochs - 1}'
              / 'result.pkl', 'rb') as f:
        n_det = sum(len(a['score']) for a in pickle.load(f))
    check(res['frames'] == n_val and n_det > 0
          and all(np.isfinite(res['ap'][k]) for k in keys)
          and predict_launches == [4] * math.ceil(n_val / b),
          f'{label} test CLI: {res["frames"]} frames, {sorted(res["ap"])}, '
          f'launches per predict {predict_launches}')
    print(f'[nuscenes] {label} test CLI on {Path(path).name} at score '
          f'threshold 0: {res["frames"]} val frames, {n_det} detections, '
          f'{res["sec_per_frame"]:.4f} s/frame, evaluation '
          f'{res["eval_sec"]:.3f} s; merge_resolve launches per '
          f'predict {predict_launches}; ' + ', '.join(
              f'{k} {res["ap"][k]:.3f}' for k in keys)
          + ' (random weights: only the keys are checked)')
    return launches


def phase_nuscenes_cli(tmp, in_memory_ms):
    """[nuscenes] (a) continued: the nuScenes CenterPoint config through the
    CLIs on a 12-frame tree (NUSC_CLI), NDS from the test CLI."""
    from glenet_tpu_torch.utils import synthetic
    n_train, n_val = NUSC_CLI[:2]
    return slice_cli_round(
        tmp, 'nuscenes_centerpoint', 'nuScenes CenterPoint',
        lambda root: synthetic.write_nuscenes_tree(root, n_train, n_val,
                                                   seed=SEED + 171),
        NUSC_CLI, NUSC_KEYS, in_memory_ms)


def phase_lyft(tmp):
    """[nuscenes] (b): the Lyft run-time config (second_multihead.yaml's
    model with the sin/cos coder over lyft_dataset.yaml; car, pedestrian,
    bicycle; the 1600 x 1600 x 40 grid, budget 80000) at full width with
    seeded weights on synthetic Lyft scenes (5 sweeps of 72000 points, 40
    beams x 1800): one first-call predict at B = 2 that captures its
    merge-resolve calls and one train
    step at B = 4, 4 launches each; then the CLIs on a Lyft tree (LYFT_CLI)
    with the Lyft mAP, its 3D IoUs on the card.  Returns (launches,
    captured predict calls)."""
    import torch

    from glenet_tpu_torch.config import Cfg, run_cfg_dict
    from glenet_tpu_torch.utils import synthetic
    cfg = Cfg(run_cfg_dict('lyft_second_multihead'))
    r = predict_and_step('lyft_second_multihead', SEED + 172, cfg=cfg,
                         capture=True)
    det = r['det']
    check(det.box_coder.code_size == 8 and det.box_coder.encode_angle_by_sincos
          and tuple(det.grid_size) == (1600, 1600, 40)
          and det.net.dense_head.head0_conv_box.weight.shape[0] == 16,
          f'Lyft SECOND-multihead built with grid {det.grid_size}, coder '
          f'{det.box_coder}')
    check(r['vals']['loss_loc'] > 0 and r['vals']['loss_dir'] > 0,
          f'Lyft losses {r["vals"]}')
    valid = r['pred']['final_valid'].sum(1).tolist()
    print(f'[nuscenes] Lyft SECOND-multihead (sin/cos coder, code size 8): '
          f'predict B={BATCH} {r["predict_ms"]:.1f} ms (first call, '
          f'captured), valid final boxes '
          f'{valid}, peak {r["predict_gib"]:.2f} GiB; train step '
          f'B={r["b"]} {r["step_ms"]:.1f} ms (first call), peak '
          f'{r["step_gib"]:.2f} GiB; '
          + ', '.join(f'{k} {v:.5f}' for k, v in sorted(r['vals'].items()))
          + f'; merge_resolve launches {r["n_predict"]} / {r["n_step"]}')
    launches = r['n_predict'] + r['n_step']
    captured = r['captured']
    del r, det
    torch.cuda.empty_cache()
    n_train, n_val = LYFT_CLI[:2]
    launches += slice_cli_round(
        tmp, 'lyft_second_multihead', 'Lyft SECOND-multihead',
        lambda root: synthetic.write_nuscenes_tree(root, n_train, n_val,
                                                   seed=SEED + 173,
                                                   lyft=True),
        LYFT_CLI, LYFT_KEYS)
    return launches, captured


def phase_pandaset(tmp):
    """[nuscenes] (c): the Pandaset run-time config (second.yaml's model
    over pandaset_dataset.yaml, the 2800 x 1600 x 40 grid) through the
    CLIs on a Pandaset tree (PANDASET_CLI, 170000 points a frame) with the
    KITTI-format AP.  Returns the launches."""
    from glenet_tpu_torch.utils import synthetic
    n_train, n_val = PANDASET_CLI[:2]
    return slice_cli_round(
        tmp, 'pandaset_second', 'Pandaset SECOND',
        lambda root: synthetic.write_pandaset_tree(root, n_train, n_val,
                                                   seed=SEED + 174),
        PANDASET_CLI, PANDASET_KEYS)


def fractional_raw():
    """The toy topology as a single-stage SECOND with a three-level
    BaseBEVBackbone of UPSAMPLE_STRIDES [0.5, 1, 2] (as OpenPCDet's
    cbgs_pp_multihead.yaml): levels at strides 1, 2, 4 of the 4 x 4 BEV
    map, each brought to its stride 2 (the 0.5 one by a 2 x 2 conv of
    stride 2), anchors at feature_map_stride 16."""
    import copy
    raw = copy.deepcopy(TINY_CFG)
    m = raw['MODEL']
    del m['ROI_HEAD']
    m['NAME'] = 'SECONDNet'
    m['BACKBONE_2D'] = {'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [1, 1, 1],
                        'LAYER_STRIDES': [1, 2, 2],
                        'NUM_FILTERS': [32, 32, 64],
                        'UPSAMPLE_STRIDES': [0.5, 1, 2],
                        'NUM_UPSAMPLE_FILTERS': [16, 16, 16]}
    m['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'][0]['feature_map_stride'] = 16
    m['POST_PROCESSING']['SCORE_THRESH'] = 0.0
    return raw


def _pieces_boxes(seed, n, spread):
    """Car-sized boxes within +-spread m and scores, one in 9 tied."""
    import numpy as np
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform([2.5, 1.2, 1.2], [4.5, 2.0, 1.8], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    s = rng.uniform(0, 1, n).astype(np.float32)
    s[::9] = s[4]
    return b, s


def phase_nuscenes_pieces():
    """[nuscenes] (d): the option pieces on the card against the CPU:
    nms_normal over 4096 boxes; soft_nms (gaussian and linear) over 1024,
    with the CPU's IoU matrix (the rounds alone: indices exact, scores
    within 1e-6) and with its own (indices exact, scores within 1e-5); MLP
    (masked, train-mode BN) within 1e-5; PreviousResidualDecoder and the
    sin/cos coder's encode / decode within 1e-5; each op's ms on the
    card."""
    import numpy as np
    import torch

    from glenet_tpu_torch.models.layers import MLP
    from glenet_tpu_torch.ops import iou3d, nms
    from glenet_tpu_torch.utils import box_coder
    from glenet_tpu_torch.utils.cuda_timing import event_ms
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        b, s = _pieces_boxes(SEED + 175, 4096, 60.0)
        cpu = nms.nms_normal(torch.from_numpy(b), torch.from_numpy(s), 0.2,
                             pre_max=4096, post_max=500,
                             score_threshold=0.1)
        tb, ts = torch.from_numpy(b).cuda(), torch.from_numpy(s).cuda()
        gpu = nms.nms_normal(tb, ts, 0.2, pre_max=4096, post_max=500,
                             score_threshold=0.1)
        check(torch.equal(cpu[1], gpu[1].cpu())
              and torch.equal(cpu[0][cpu[1]], gpu[0].cpu()[cpu[1]]),
              'nms_normal: card and CPU keep other boxes')
        ms = event_ms(lambda: nms.nms_normal(tb, ts, 0.2, pre_max=4096,
                                             post_max=500,
                                             score_threshold=0.1), 5, 1)
        print(f'[nuscenes] [gpu-vs-cpu] nms_normal over 4096 boxes: '
              f'{int(cpu[1].sum())} keeps equal; {ms:.2f} ms on the card')
        b, s = _pieces_boxes(SEED + 176, 1024, 10.0)
        tb, ts = torch.from_numpy(b).cuda(), torch.from_numpy(s).cuda()
        real = iou3d.boxes_iou_bev_blocked
        for mode in ('gaussian', 'linear'):
            kw = dict(score_threshold=0.1, soft_sigma=0.3, soft_mode=mode,
                      pre_max=1024, post_max=256)
            ref = nms.soft_nms(torch.from_numpy(b), torch.from_numpy(s), **kw)
            for fed in (True, False):
                if fed:
                    iou3d.boxes_iou_bev_blocked = lambda x, y: real(
                        x.cpu(), y.cpu()).to(x.device)
                try:
                    got = [t.cpu() for t in nms.soft_nms(tb, ts, **kw)]
                finally:
                    iou3d.boxes_iou_bev_blocked = real
                err = float((got[2] - ref[2]).abs().max())
                check(torch.equal(got[0], ref[0])
                      and torch.equal(got[1], ref[1])
                      and err <= (1e-6 if fed else 1e-5),
                      f'soft_nms {mode} ({"CPU IoUs" if fed else "own IoUs"})'
                      f': card and CPU differ (scores {err:.2e})')
                print(f'[nuscenes] [gpu-vs-cpu] soft_nms {mode} over 1024 '
                      f'boxes, {"the CPU's" if fed else "its own"} IoUs: '
                      f'{int(ref[1].sum())} keeps, indices equal, scores '
                      f'max_abs_err {err:.2e}')
            ms = event_ms(lambda: nms.soft_nms(tb, ts, **kw), 3, 1)
            print(f'[nuscenes] soft_nms {mode}: {ms:.2f} ms on the card '
                  f'(256 rounds)')
        rng = np.random.RandomState(SEED + 177)
        x = torch.from_numpy((rng.randn(3, 4000, 64) * 2).astype(np.float32))
        mask = torch.from_numpy(rng.rand(3, 4000) > 0.3)
        torch.manual_seed(SEED + 177)
        m_cpu = MLP(64, (128, 64))
        m_gpu = MLP(64, (128, 64)).cuda()
        m_gpu.load_state_dict(m_cpu.state_dict())
        with torch.no_grad():
            ref = m_cpu(x, mask=mask, train=True)
            got = m_gpu(x.cuda(), mask=mask.cuda(), train=True).cpu()
        err = float((got - ref).abs().max())
        stats = max(float((a.cpu() - b_).abs().max()) for a, b_ in zip(
            m_gpu.buffers(), m_cpu.buffers()))
        check(err <= 1e-5 * max(1.0, float(ref.abs().max())) and stats <= 1e-5,
              f'MLP: card and CPU differ by {err:.2e} (BN stats {stats:.2e})')
        anchors, enc = _pieces_boxes(SEED + 178, 4096, 50.0)[0], \
            rng.uniform(-0.5, 0.5, (4096, 8)).astype(np.float32)
        boxes = _pieces_boxes(SEED + 179, 4096, 50.0)[0]
        coder = box_coder.build_box_coder('ResidualCoder',
                                          encode_angle_by_sincos=True)
        prev = box_coder.build_box_coder('PreviousResidualDecoder')
        errs = {}
        for what, fn, args in (
                ('sin/cos encode', coder.encode, (boxes, anchors)),
                ('sin/cos decode', coder.decode, (enc, anchors)),
                ('PreviousResidualDecoder', prev.decode,
                 (enc[:, :7], anchors))):
            ref = fn(*(torch.from_numpy(a) for a in args))
            got = fn(*(torch.from_numpy(a).cuda() for a in args)).cpu()
            errs[what] = float((got - ref).abs().max())
            check(errs[what] <= 1e-5, f'{what}: card and CPU differ by '
                                      f'{errs[what]:.2e}')
        print(f'[nuscenes] [gpu-vs-cpu] MLP 64 -> 128 -> 64 over 3 x 4000 '
              f'masked rows, train-mode BN: max_abs_err {err:.2e}, BN stats '
              f'{stats:.2e}; ' + ', '.join(f'{k} {v:.2e}'
                                          for k, v in errs.items())
              + ' (4096 boxes each)')
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def phase_nuscenes(tmp):
    """[nuscenes]: (a) the nuScenes CenterPoint config at full width and
    through the CLIs, (b) Lyft SECOND-multihead with the sin/cos coder, (c)
    Pandaset SECOND through the CLIs, (d) the option pieces card against
    CPU.  The fractional-stride toy detector's card-against-CPU predict and
    step run after the main paths.  Returns (launches, captured nuScenes
    predict calls, captured train-step calls, captured Lyft predict
    calls)."""
    t0 = time.perf_counter()
    launches, captured, captured_train, step_ms = phase_nuscenes_full(
        SEED + 170)
    launches += phase_nuscenes_cli(tmp, step_ms)
    n, captured_lyft = phase_lyft(tmp)
    launches += n + phase_pandaset(tmp)
    phase_nuscenes_pieces()
    print(f'[nuscenes] phase {time.perf_counter() - t0:.1f} s, '
          f'{launches} merge-resolve launches')
    return launches, captured, captured_train, captured_lyft


# ---------------------------------------------------------------------------
# [parallel]: training across processes on the one card
# ---------------------------------------------------------------------------

PAR_B, PAR_SEED = 2, SEED + 190      # scenes per rank; the start weights


class pinned_f32:
    """f32 gathers and dense levels, TF32 off and no RoI-head dropout
    (phase 7's setting), for the steps that are compared: they take the
    reference's RoI targets, and with fed targets the dropout would draw
    where the sampling's draws left the generator."""

    def __init__(self, det):
        self.head = det.net.roi_head

    def __enter__(self):
        import torch
        self.dp_ratio, self.head.dp_ratio = self.head.dp_ratio, 0.0

        from glenet_tpu_torch.models import spconv_backbone
        from glenet_tpu_torch.ops import sparse
        self.saved = (sparse.GATHER_COMPUTE_DTYPE,
                      spconv_backbone.DENSE_MXU_DTYPE,
                      torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        sparse.GATHER_COMPUTE_DTYPE = spconv_backbone.DENSE_MXU_DTYPE = None
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        from glenet_tpu_torch.models import spconv_backbone
        from glenet_tpu_torch.ops import sparse
        (sparse.GATHER_COMPUTE_DTYPE, spconv_backbone.DENSE_MXU_DTYPE,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved
        self.head.dp_ratio = self.dp_ratio


def kink_record(net, rel=1e-4):
    """Hooks on every MaskedBatchNorm of `net` (each feeds a ReLU) keeping,
    per call, the elements of its output within `rel` of its largest
    |output| (and not exactly 0): their flat indices and values, and the
    bound.  Returns (the record, the hook handles)."""
    import torch

    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    rec = {}

    def hook(name):
        def fn(_mod, _inp, y):
            flat = y.detach().reshape(-1)
            eps = rel * float(flat.abs().max())
            idx = torch.nonzero((flat.abs() <= eps) & (flat != 0))[:, 0]
            rec.setdefault(name, []).append(
                (idx.cpu(), flat[idx].cpu(), eps))
        return fn

    return rec, [m.register_forward_hook(hook(n)) for n, m in
                 net.named_modules() if isinstance(m, MaskedBatchNorm)]


def kink_align(net, record, block):
    """relu_signs for a rank of the data-parallel step, from kink_record's
    sparse record of the one-process step: where this run's BN output and
    the record's lie on opposite sides of 0, both within the record's
    bound, this run takes the record's value (a shift by less than
    rounding, the gradient path unchanged), so both differentiate one
    branch of each ReLU.  The rank holds the block-th block of the
    record's rows.  Returns (a dict counting the shifted elements, the
    hook handles)."""
    import torch

    from glenet_tpu_torch.models.layers import MaskedBatchNorm
    calls = {k: list(v) for k, v in record.items()}
    seen = {'flipped': 0}

    def hook(name):
        def fn(_mod, _inp, y):
            idx, val, eps = calls[name].pop(0)
            size = y.numel()
            lo = block * size
            keep = (idx >= lo) & (idx < lo + size)
            idx = (idx[keep] - lo).to(y.device)
            val = val[keep].to(y.device)
            flat = y.reshape(-1)
            got = flat[idx]
            flip = ((got > 0) != (val > 0)) & (got.abs() <= eps)
            if not bool(flip.any()):
                return None
            seen['flipped'] += int(flip.sum())
            shift = torch.zeros_like(flat)
            shift[idx[flip]] = (val - got)[flip]
            return y + shift.reshape(y.shape).detach()
        return fn

    return seen, [m.register_forward_hook(hook(n)) for n, m in
                  net.named_modules() if isinstance(m, MaskedBatchNorm)]


def par_step(det, train_step, state, batch):
    """One step recording its integer decisions: each sample's anchor
    targets, the train forward's proposals and RoI targets, every
    merge-resolve table.  Returns (state, metrics, decisions on the CPU,
    the RoI targets on the CPU)."""
    import torch

    from glenet_tpu_torch.ops import merge_kernel as mk
    rec = {'merge': [], 'anchor': [], 'out': {}}
    real = (det.assign_targets, mk.resolve_sorted_queries, det.net.forward)

    def assign(*a):
        t = real[0](*a)
        rec['anchor'].append(t.box_cls_labels)
        return t

    def merge(ids, q):
        t = real[1](ids, q)
        rec['merge'].append(t)
        return t

    def forward(*a, **k):
        out = real[2](*a, **k)
        rec['out'] = {
            'reg_valid_mask': out['roi_targets']['reg_valid_mask'],
            'roi_labels': out['roi_targets']['roi_labels']}
        if 'proposals' in out:            # not computed with fed targets
            rec['out'].update(
                roi_valid=out['proposals']['roi_valid'],
                proposal_labels=out['proposals']['roi_labels'])
        rec['targets'] = {k: v.detach().cpu()
                          for k, v in out['roi_targets'].items()}
        return out

    det.assign_targets, mk.resolve_sorted_queries = assign, merge
    det.net.forward = forward
    try:
        state, metrics = train_step(state, batch)
    finally:
        del det.assign_targets, det.net.forward
        mk.resolve_sorted_queries = real[1]
    dec = {f'merge{i}.{j}': t for i, call in enumerate(rec['merge'])
           for j, t in enumerate(call)}
    dec['anchor.box_cls_labels'] = torch.stack(rec['anchor'])
    dec.update(rec['out'])
    return (state, metrics, {k: v.long().cpu() for k, v in dec.items()},
            rec['targets'])


def par_snapshot(det, metrics, decisions):
    return {'metrics': {k: float(v) for k, v in metrics.items()},
            'params': {k: p.detach().cpu() for k, p in
                       det.net.named_parameters()},
            'grads': {k: p.grad.detach().cpu() for k, p in
                      det.net.named_parameters() if p.grad is not None},
            'buffers': {k: b.cpu() for k, b in det.net.named_buffers()},
            'decisions': decisions}


def par_compare(tag, got, ref, rows, lr):
    """Phase 7's bounds: loss terms rtol 1e-4 (+1e-6), each gradient
    1e-3 of its largest element (+1e-6), parameters after the step 2 lr
    (+1e-6), BN running stats rtol 1e-4 / atol 1e-5; first the integer
    decisions, exactly on the rank's rows.  Returns the worst gradient
    error as a share of its bound."""
    import torch
    bad = {k: int((v != ref['decisions'][k][rows]).sum())
           for k, v in got['decisions'].items()
           if not torch.equal(v, ref['decisions'][k][rows])}
    check(not bad, f'{tag}: integer outputs differ (elements): {bad}')
    for k, v in ref['metrics'].items():
        err = abs(got['metrics'][k] - v)
        check(err <= 1e-4 * abs(v) + 1e-6,
              f'{tag}: {k} {got["metrics"][k]} against {v}')
    worst = 0.0
    for k, g_ref in ref['grads'].items():
        tol = 1e-3 * float(g_ref.abs().max()) + 1e-6
        err = float((got['grads'][k] - g_ref).abs().max())
        check(err <= tol, f'{tag}: gradient of {k} off by {err:.3e} > '
                          f'{tol:.3e}')
        worst = max(worst, err / tol)
        step = float((got['params'][k] - ref['params'][k]).abs().max())
        check(step <= 2 * lr + 1e-6, f'{tag}: {k} after the step')
    for k, b in ref['buffers'].items():
        check(torch.allclose(got['buffers'][k], b, rtol=1e-4, atol=1e-5),
              f'{tag}: BN running stats {k}')
    return worst


def _nccl_probe(rank, port, out):
    """Two NCCL ranks on cuda:0: NCCL is expected to refuse them."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from glenet_tpu_torch.parallel import distributed
    msg = 'ran'
    try:
        distributed.initialize(f'127.0.0.1:{port}', 2, rank, 'cuda',
                               backend='nccl', timeout_s=60)
        t = torch.ones(1, device='cuda')
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f'ran: all_reduce gave {float(t)}'
    except Exception as e:        # noqa: BLE001 - the refusal is the result
        msg = f'{type(e).__name__}: {e}'
    Path(out, f'nccl{rank}.txt').write_text(msg)


def _parallel_rank(rank, world, port, tmp):
    """One gloo rank on cuda:0: (a) the data-parallel step at B = PAR_B in
    f32, compared with the one-process step on the whole global batch
    (tmp/ref.pt), then the step again in the default dtypes, timed; (b)
    the (1, 2) (data, model) step, compared.  Writes its results to
    tmp."""
    import torch
    sys.path.insert(0, str(ROOT))
    from glenet_tpu_torch.parallel import distributed
    from glenet_tpu_torch.parallel import mesh as mesh_lib
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.utils.synthetic import seeded_detector
    LAUNCHES.install()
    XBLOCK.install()
    distributed.initialize(f'127.0.0.1:{port}', world, rank, 'cuda',
                           backend='gloo', timeout_s=300)
    payload = torch.load(Path(tmp) / 'payload.pt', weights_only=False)
    ref = torch.load(Path(tmp) / 'ref.pt', weights_only=False)
    cfg = payload['cfg']
    batch = {k: v.cuda() for k, v in payload['batch'].items()}
    res = {'errors': []}

    def compared(tag, det, train_step, state, local, rows, block,
                 after=None):
        """The step in f32 on the reference's RoI targets for the rows (the
        block-th block of its rows), its ReLU kinks on the reference's
        side, checked against the reference (after `after(state)`, when
        given)."""
        local = dict(local, roi_targets={
            k: v[rows].cuda() for k, v in ref['roi_targets'].items()})
        signs, hooks = kink_align(det.net, ref['kinks'], block)
        try:
            with pinned_f32(det):
                state, metrics, dec, _ = par_step(det, train_step, state,
                                                  local)
        finally:
            for h in hooks:
                h.remove()
        if after is not None:
            after(state)
        got = par_snapshot(det, metrics, dec)
        try:
            worst = par_compare(f'{tag} rank {rank}', got, ref, rows,
                                ref['lr'])
        except SmokeFailure as e:
            res['errors'].append(str(e))
            worst = float('nan')
        return state, {'buffers': got['buffers'], 'worst': worst,
                       'flipped': signs['flipped']}

    # (a) ('data',) mesh of the 2 ranks; rank 1 starts from other weights
    # until put_replicated
    det = seeded_detector(cfg, 'cuda', PAR_SEED + rank)
    tx, state, _ = build_training(cfg, det)
    mesh = mesh_lib.make_mesh('cuda')
    mesh_lib.put_replicated(state)
    step = mesh_lib.make_dp_train_step(det, tx, mesh)
    local = mesh_lib.shard_batch(batch, mesh)
    state, res['a'] = compared('(a)', det, step, state, local,
                               slice(rank * PAR_B, (rank + 1) * PAR_B), rank)
    # the main path: the step in the default dtypes, launches from 0
    calls = {'n': 0, 'ms': 0.0}
    real = distributed.all_reduce_sum

    def counted(t, group):
        calls['n'] += 1
        t0 = time.perf_counter()
        out = real(t, group)
        calls['ms'] += 1e3 * (time.perf_counter() - t0)
        return out

    distributed.all_reduce_sum = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.n = 0
    t0 = time.perf_counter()
    captured, (state, metrics) = capture_calls(lambda: step(state, local),
                                               f'parallel rank {rank} step')
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    launches = LAUNCHES.n
    distributed.all_reduce_sum = real
    # the gradient all-reduce's glenet::grad_allreduce span, in one more
    # step under the profiler
    grad_ms = span_ms(lambda: step(state, local), 'grad_allreduce')
    res['timed'] = {
        'step_ms': step_ms, 'launches': launches, 'grad_ms': grad_ms,
        'grad_bytes': step.stats['grad_bytes'],
        'collectives': calls['n'],
        'other_ms': calls['ms'] - grad_ms,
        'peak': torch.cuda.max_memory_allocated(),
        'loss': float(metrics['loss'])}
    t = res['timed']
    print(f'[parallel] (a) rank {rank} of {world}, B={PAR_B} on cuda:0, '
          f'gloo, default dtypes: step {step_ms:.1f} ms, gradient '
          f'all-reduce {t["grad_ms"]:.1f} ms for '
          f'{t["grad_bytes"] / 2**20:.1f} MiB, {t["collectives"] - 2} other '
          f'all-reduces (BN moments, loss normalizers, metrics) '
          f'{t["other_ms"]:.1f} ms host time, merge_resolve launches '
          f'{launches}, max_memory_allocated {t["peak"] / 2**30:.2f} GiB, '
          f'loss {t["loss"]:.4f}', flush=True)
    if rank == 0:
        res['kernel'] = check_captured(captured, 'parallel rank 0 step')
    del det, state, step
    torch.cuda.empty_cache()

    # (b) (data, model) mesh (1, 2): each rank stores half of the kernels
    det = seeded_detector(cfg, 'cuda', PAR_SEED + rank)
    tx, state, _ = build_training(cfg, det)
    mesh2 = mesh_lib.make_mesh_2d(2, 'cuda')
    mesh_lib.put_replicated(state)
    step = mesh_lib.make_dp_tp_train_step(det, tx, mesh2)
    step.shard(state)
    LAUNCHES.n = 0
    try:
        state, res['b'] = compared('(b)', det, step, state, batch,
                                   slice(None), 0, after=step.gather)
    except RuntimeError as e:
        if 'backend failed' not in str(e):
            raise
        res['b'] = {'skipped': str(e).splitlines()[0]}
    else:
        res['b'].update(launches=LAUNCHES.n, sharded=len(step.sharded))
    torch.save(res, Path(tmp) / f'rank{rank}.pt')
    distributed.shutdown()


def span_ms(fn, name):
    """Host milliseconds of the port's spans `name` (utils/trace.py) in
    one call of fn under a torch.profiler session."""
    import torch
    from glenet_tpu_torch.utils import trace
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return 1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.name == trace.PREFIX + name)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def par_spawn(fn, args, nprocs, deadline_s):
    """Start `nprocs` spawned processes of fn(rank, *args); join within
    deadline_s or kill them and fail."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method='spawn')
    t_end = time.perf_counter() + deadline_s
    while not ctx.join(timeout=5):
        if time.perf_counter() > t_end:
            for p in ctx.processes:
                p.kill()
            raise SmokeFailure(f'{fn.__name__}: not done in {deadline_s} s')


def phase_parallel(cli_root, tmp):
    """[parallel]: (a) two gloo ranks on the one card, the data-parallel
    GLENet-VR step at full width against the one-process step on the
    global batch; (b) the (1, 2) (data, model) step against the same; (c)
    tools.train through the multi-host flags.  Returns the merge-resolve
    launches and rank 0's kernel check."""
    import torch

    from glenet_tpu_torch.config import cfg_from_yaml_file
    from glenet_tpu_torch.parallel.distributed import get_dist_info
    from glenet_tpu_torch.profile_train import build_training
    from glenet_tpu_torch.tools import train as train_cli
    from glenet_tpu_torch.utils.synthetic import batches_for, seeded_detector
    t_start = time.perf_counter()
    work = tmp / 'parallel'
    work.mkdir()
    cfg = cfg_from_yaml_file(str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'))
    world = 2
    batch = batches_for(cfg, 1, SEED + 1, world * PAR_B, train=True)[0]
    # the one-process step on the global batch from rank 0's start weights;
    # its gt boxes 0.15 m off the first 4 train-mode proposals of each
    # scene (a throwaway forward: it moves the BN stats), so the sampled
    # RoIs hold foreground
    det = seeded_detector(cfg, 'cuda', PAR_SEED)
    gt = torch.zeros_like(batch['gt_boxes'])
    with torch.no_grad():
        prop = det.net(batch['points'], batch['points_mask'], train=True,
                       gt_boxes=gt, gt_mask=gt[..., 7] > 0,
                       generator=torch.Generator('cuda').manual_seed(SEED)
                       )['proposals']
    det = seeded_detector(cfg, 'cuda', PAR_SEED)
    for i in range(world * PAR_B):
        idx = torch.nonzero(prop['roi_valid'][i]).flatten()[:4]
        gt[i, :len(idx), :7] = prop['rois'][i, idx]
        gt[i, :len(idx), 0] += 0.15
        gt[i, :len(idx), 7] = 1
    batch = dict(batch, gt_boxes=gt, gt_mask=gt[..., 7] > 0)
    torch.save({'cfg': cfg, 'batch': {k: v.cpu() for k, v in batch.items()}},
               work / 'payload.pt')
    tx, state, train_step = build_training(cfg, det)
    kinks, hooks = kink_record(det.net)
    with pinned_f32(det):
        state, metrics, dec, targets = par_step(det, train_step, state,
                                                batch)
    for h in hooks:
        h.remove()
    ref = dict(par_snapshot(det, metrics, dec), lr=tx.hyperparams(0)[0],
               roi_targets=targets, kinks=kinks)
    torch.save(ref, work / 'ref.pt')
    print(f'[parallel] one-process reference step, B={world * PAR_B} at '
          f'full width (f32, TF32 off): loss {ref["metrics"]["loss"]:.5f}, '
          f'grad_norm {ref["metrics"]["grad_norm"]:.5f}, '
          f'{int(ref["decisions"]["reg_valid_mask"].sum())} foreground '
          f'RoIs', flush=True)
    check(bool(ref['decisions']['reg_valid_mask'].any()),
          'the reference step sampled no foreground RoI')
    del det, state, train_step, batch
    torch.cuda.empty_cache()

    par_spawn(_nccl_probe, (free_port(), str(work)), 2, 120)
    for r in range(2):
        print(f'[parallel] NCCL with 2 ranks on cuda:0, rank {r}: '
              f'{Path(work, f"nccl{r}.txt").read_text()[:300]}')

    par_spawn(_parallel_rank, (world, free_port(), str(work)), world, 900)
    ranks = [torch.load(work / f'rank{r}.pt', weights_only=False)
             for r in range(world)]
    launches = 0
    for r, res in enumerate(ranks):
        check(not res['errors'], f'rank {r}: {res["errors"]}')
        check(res['timed']['launches'] == 4,
              f'(a) rank {r}: {res["timed"]["launches"]} merge-resolve '
              f'launches, expected 4')
        launches += res['timed']['launches']
        print(f'[parallel] (a) rank {r} against the one-process step: loss '
              f'terms, gradients (worst at {res["a"]["worst"]:.2f} of the '
              f'bound), parameters and BN stats within phase 7\'s bounds, '
              f'the anchor targets and merge-resolve tables equal on its '
              f'rows; ReLU inputs taken on the reference\'s side of 0: '
              f'{res["a"]["flipped"]}')
    for k, v in ranks[0]['a']['buffers'].items():
        check(torch.equal(v, ranks[1]['a']['buffers'][k]),
              f'(a) BN buffer {k} differs across the ranks')
    t = ranks[0]['timed']
    print(f'[parallel] (a) BN buffers bit-equal across the ranks; rank 0\'s '
          f'gradient all-reduce {t["grad_ms"]:.1f} ms of its '
          f'{t["step_ms"]:.1f} ms step '
          f'({100 * t["grad_ms"] / t["step_ms"]:.1f} %), the other '
          f'all-reduces {t["other_ms"]:.1f} ms '
          f'({100 * t["other_ms"] / t["step_ms"]:.1f} %)')
    if 'skipped' in ranks[0]['b']:
        print(f'[parallel] (b) the (1, 2) mesh does not run on the card: '
              f'{ranks[0]["b"]["skipped"]}')
    else:
        for r, res in enumerate(ranks):
            check(res['b']['launches'] == 4, f'(b) rank {r}: '
                  f'{res["b"]["launches"]} merge-resolve launches')
            launches += res['b']['launches']
            print(f'[parallel] (b) (data, model) mesh (1, 2), rank {r}: '
                  f'{res["b"]["sharded"]} kernels stored as halves; against '
                  f'the one-process step within phase 7\'s bounds (worst '
                  f'gradient at {res["b"]["worst"]:.2f} of its bound), '
                  f'integer outputs equal; ReLU inputs taken on the '
                  f'reference\'s side of 0: {res["b"]["flipped"]}')

    # (c) the train CLI through the multi-host flags: NCCL, world 1
    out = work / 'cli'
    LAUNCHES.n = 0
    run = train_cli.main([
        '--cfg_file', str(ROOT / 'configs/kitti_models/GLENet_VR.yaml'),
        '--data_path', str(cli_root), '--output_dir', str(out),
        '--batch_size', str(CLI_BATCH), '--epochs', '1',
        '--max_steps_per_epoch', '2', '--eval_after_train',
        '--coordinator_address', f'127.0.0.1:{free_port()}',
        '--num_processes', '1', '--process_id', '0'])
    launches_cli = LAUNCHES.n
    check(get_dist_info() == (0, 1), 'the CLI left its process group')
    ckpts = sorted(p.name for p in (out / 'ckpt').iterdir())
    check(ckpts == ['checkpoint_epoch_0.pth'], f'checkpoints {ckpts}')
    check(all(math.isfinite(s['loss']) for s in run['steps'])
          and len(run['steps']) == 2, 'CLI steps')
    keys = [f'Car_3d/{d}_R40' for d in ('easy', 'moderate', 'hard')]
    check(all(k in run['eval']['ap'] for k in keys),
          f'AP keys missing: {sorted(run["eval"]["ap"])}')
    check(launches_cli == 4 * (2 + math.ceil(CLI_VAL / CLI_BATCH)),
          f'(c) {launches_cli} merge-resolve launches')
    print(f'[parallel] (c) tools.train --coordinator_address --num_processes '
          f'1 --process_id 0 (NCCL): 2 steps, loss '
          f'{run["steps"][-1]["loss"]:.4f}, checkpoint_epoch_0.pth, '
          f'{run["eval"]["frames"]} val frames evaluated, '
          + ', '.join(f'{k} {run["eval"]["ap"][k]:.2f}' for k in keys)
          + f'; merge_resolve launches {launches_cli}')
    print(f'[parallel] phase {time.perf_counter() - t_start:.1f} s, '
          f'{launches + launches_cli} merge-resolve launches')
    return launches + launches_cli, ranks[0]['kernel']


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if not (ROOT / 'glenet_tpu_torch').is_dir():
        print('chip_smoke: run from a checkout of the repository',
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    LAUNCHES.install()
    XBLOCK.install()
    t_start = time.perf_counter()
    try:
        card = phase_setup(['merge_resolve', 'xblock_gemm'])
        cfg, det, batches, captured = prepare_full_width()
        launches = phase_full_width(det, batches)
        launches_train, captured_train, train_ms = phase_train(cfg, det)
        with tempfile.TemporaryDirectory(prefix='glenet_smoke_') as tmp:
            launches_cli, cli_root = phase_cli(train_ms, Path(tmp))
            launches_cvae = phase_cvae(Path(tmp), cli_root)
            launches_weights = phase_weights(Path(tmp), cli_root)
            launches_single, captured_single = phase_single(Path(tmp),
                                                            cli_root)
            launches_waymo, captured_waymo, captured_waymo_train = \
                phase_waymo(Path(tmp))
            launches_three, captured_three, tc_root = phase_three_class(
                Path(tmp))
            launches_pv, captured_pv = phase_pv_rcnn(Path(tmp), tc_root)
            launches_conv = phase_convergence(Path(tmp))
            launches_parta2, captured_parta2, _ = phase_parta2(Path(tmp),
                                                               tc_root)
            launches_pointrcnn, _ = phase_pointrcnn(Path(tmp), tc_root)
            launches_center, captured_center, captured_center_train = \
                phase_centerpoint(Path(tmp))
            launches_pvpp, captured_pvpp, captured_pvpp_train = \
                phase_pvrcnn_plusplus(Path(tmp))
            launches_caddn = phase_caddn(Path(tmp))
            launches_nusc, captured_nusc, captured_nusc_train, \
                captured_lyft = phase_nuscenes(Path(tmp))
            launches_par, par = phase_parallel(cli_root, Path(tmp))
        merge = phase_merge_check(captured, captured_train, captured_single)
        xblock = phase_xblock()
        waymo = check_captured(captured_waymo, 'Waymo GLENet-S predict')
        waymo_train = check_captured(captured_waymo_train,
                                     'Waymo GLENet-S train step')
        three = check_captured(captured_three['predict'],
                               'SECOND-IoU predict')
        three_train = check_captured(captured_three['step'],
                                     'SECOND-IoU train step')
        pv = check_captured(captured_pv['predict'], 'PV-RCNN predict')
        pv_train = check_captured(captured_pv['step'],
                                  'PV-RCNN train step')
        parta2 = check_captured(captured_parta2['predict'], 'PartA2 predict',
                                UNET_CALL_NAMES)
        parta2_train = check_captured(captured_parta2['step'],
                                      'PartA2 train step', UNET_CALL_NAMES)
        center = check_captured(captured_center, 'CenterPoint predict')
        center_train = check_captured(captured_center_train,
                                      'CenterPoint train step')
        pvpp = check_captured(captured_pvpp, 'PV-RCNN++ predict')
        pvpp_train = check_captured(captured_pvpp_train,
                                    'PV-RCNN++ train step')
        nusc = check_captured(captured_nusc, 'nuScenes CenterPoint predict')
        nusc_train = check_captured(captured_nusc_train,
                                    'nuScenes CenterPoint train step')
        lyft = check_captured(captured_lyft, 'Lyft SECOND-multihead predict')
        phase_gpu_vs_cpu()
        phase_gpu_vs_cpu_train()
        vq = vq_raw_cfg(TINY_CFG)
        phase_gpu_vs_cpu(vq, 'weights] [gpu-vs-cpu vq')
        phase_gpu_vs_cpu_train(vq, 'weights] [gpu-vs-cpu vq')
        single = tiny_single_raw()
        phase_gpu_vs_cpu(single, 'single] [gpu-vs-cpu')
        phase_gpu_vs_cpu_train(single, 'single] [gpu-vs-cpu',
                               tiny_single_batch)
        phase_gpu_vs_cpu(tiny_waymo_raw(), 'waymo] [gpu-vs-cpu')
        phase_gpu_vs_cpu_train(tiny_waymo_raw(sessd=True),
                               'waymo] [gpu-vs-cpu sessd atss height',
                               tiny_single_batch, align_relu=True)
        for kind in ('multihead', 'iou', 'pillar'):
            raw = tiny_three_class_raw(kind)
            tag = f'three_class] [gpu-vs-cpu {kind}'
            phase_gpu_vs_cpu(raw, tag)
            phase_gpu_vs_cpu_train(raw, tag, tiny_train_batch if kind == 'iou'
                                   else tiny_single_batch)
        pv_raw = tiny_pvrcnn_raw()
        phase_gpu_vs_cpu(pv_raw, 'pv_rcnn] [gpu-vs-cpu')
        # a ReLU input within f32 rounding of 0 (reg_fc_bn0's, 1e-6 of its
        # largest |output|, on the card) flips and moves the head's
        # gradients: the CPU takes the card's side there, as [waymo]'s
        phase_gpu_vs_cpu_train(pv_raw, 'pv_rcnn] [gpu-vs-cpu',
                               align_relu=True)
        # the decoder's ReLU outputs tie at 0 in RoI-aware max pooling, so
        # one ReLU input within rounding of 0 moves a pooled cell's
        # gradient to another point: the CPU takes the card's side of the
        # kink, as [waymo]'s
        for free in (False, True):
            raw = tiny_parta2_raw(free)
            tag = f'parta2] [gpu-vs-cpu {"free" if free else "PartA2"}'
            phase_gpu_vs_cpu(raw, tag)
            phase_gpu_vs_cpu_train(raw, tag, align_relu=True)
        # the RoI head's FPS and ball queries run on pooled xyz that the
        # devices rotate into the roi frames with other roundings: the CPU
        # takes the card's decision at a near tie, as at a ReLU kink
        phase_gpu_vs_cpu(tiny_pointrcnn_raw(), 'pointrcnn] [gpu-vs-cpu',
                         align_points=True)
        phase_gpu_vs_cpu_train(
            tiny_pointrcnn_raw(), 'pointrcnn] [gpu-vs-cpu',
            lambda cfg: tiny_train_batch(cfg, train_proposals=True),
            align_relu=True, align_points=True)
        # the residual blocks and the small BEV map's BNs put ReLU inputs
        # within rounding of 0, as [waymo]'s: the CPU takes the card's side
        phase_gpu_vs_cpu(tiny_centerpoint_raw(), 'centerpoint] [gpu-vs-cpu')
        phase_gpu_vs_cpu_train(tiny_centerpoint_raw(),
                               'centerpoint] [gpu-vs-cpu', tiny_center_batch,
                               align_relu=True)
        # the keypoints' FPS and the VectorPool neighbours are decisions:
        # the CPU takes the card's at a near tie, as [pointrcnn]'s
        tag = 'pvrcnn_plusplus] [gpu-vs-cpu'
        phase_gpu_vs_cpu(tiny_pvpp_raw(), tag, align_points=True,
                         align_neighbours=True)
        phase_gpu_vs_cpu_train(
            tiny_pvpp_raw(), tag,
            lambda cfg: tiny_train_batch(cfg, train_proposals=True,
                                         perturb=pvpp_gt_from_rois),
            align_relu=True, align_points=True, align_neighbours=True)
        phase_caddn_gpu_vs_cpu()
        tag = 'nuscenes] [gpu-vs-cpu fractional strides'
        phase_gpu_vs_cpu(fractional_raw(), tag)
        phase_gpu_vs_cpu_train(fractional_raw(), tag, tiny_single_batch)
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {type(e).__name__}: {e}',
              file=sys.stderr)
        return 1
    train, single = merge['train'], merge['single']
    kernels = [{
        'name': 'merge_resolve', 'route': 'cuda',
        'source': 'glenet_tpu_torch/csrc/merge_resolve.cu',
        'replaces': 'glenet_tpu/ops/merge_kernel.py:95',
        'launches': (launches + launches_train + launches_cli + launches_cvae
                     + launches_weights + launches_single + launches_waymo
                     + launches_three + launches_pv + launches_conv
                     + launches_parta2 + launches_pointrcnn
                     + launches_center + launches_pvpp + launches_caddn
                     + launches_nusc + launches_par),
        'max_abs_err': merge['max_abs_err'],
        'ms': merge['ms'], 'plain_ms': merge['plain_ms'],
        'bound_ms': merge['bound_ms'], 'bound_by': merge['bound_by'],
        'library_ms': merge['library_ms'], 'device_ms': merge['device_ms'],
        'library_device_ms': merge['library_device_ms'],
        'cold_ms': merge['cold_ms'], 'host_ms': merge['host_ms'],
        'launches_predict': launches, 'launches_train': launches_train,
        'launches_cli': launches_cli, 'launches_cvae': launches_cvae,
        'launches_weights': launches_weights,
        'launches_single': launches_single,
        'launches_waymo': launches_waymo,
        'launches_three_class': launches_three,
        'launches_pv_rcnn': launches_pv,
        'launches_convergence': launches_conv,
        'launches_parta2': launches_parta2,
        'launches_pointrcnn': launches_pointrcnn,
        'launches_centerpoint': launches_center,
        'launches_pvrcnn_plusplus': launches_pvpp,
        'launches_caddn': launches_caddn,
        'launches_nuscenes': launches_nusc,
        'launches_parallel': launches_par,
        'train_ms': train['ms'], 'train_device_ms': train['device_ms'],
        'train_plain_ms': train['plain_ms'],
        'train_bound_ms': train['bound_ms'],
        'train_bound_by': train['bound_by'],
        'train_library_ms': train['library_ms'],
        'train_library_device_ms': train['library_device_ms'],
        'single_ms': single['ms'], 'single_device_ms': single['device_ms'],
        'single_plain_ms': single['plain_ms'],
        'single_bound_ms': single['bound_ms'],
        'single_library_ms': single['library_ms'],
        'waymo_ms': waymo['ms'], 'waymo_device_ms': waymo['device_ms'],
        'waymo_host_ms': waymo['host_ms'], 'waymo_cold_ms': waymo['cold_ms'],
        'waymo_plain_ms': waymo['plain_ms'],
        'waymo_bound_ms': waymo['bound_ms'],
        'waymo_bound_by': waymo['bound_by'],
        'waymo_library_ms': waymo['library_ms'],
        'waymo_library_device_ms': waymo['library_device_ms'],
        'waymo_train_ms': waymo_train['ms'],
        'waymo_train_device_ms': waymo_train['device_ms'],
        'waymo_train_host_ms': waymo_train['host_ms'],
        'waymo_train_cold_ms': waymo_train['cold_ms'],
        'waymo_train_plain_ms': waymo_train['plain_ms'],
        'waymo_train_bound_ms': waymo_train['bound_ms'],
        'waymo_train_bound_by': waymo_train['bound_by'],
        'waymo_train_library_ms': waymo_train['library_ms'],
        'waymo_train_library_device_ms': waymo_train['library_device_ms'],
        **{f'{pre}_{k}': r[k] for pre, r in (('second_iou', three),
                                             ('second_iou_train',
                                              three_train),
                                             ('pv_rcnn', pv),
                                             ('pv_rcnn_train', pv_train),
                                             ('parta2', parta2),
                                             ('parta2_train', parta2_train),
                                             ('centerpoint', center),
                                             ('centerpoint_train',
                                              center_train),
                                             ('pv_rcnn_plusplus', pvpp),
                                             ('pv_rcnn_plusplus_train',
                                              pvpp_train),
                                             ('nuscenes', nusc),
                                             ('nuscenes_train', nusc_train),
                                             ('lyft', lyft),
                                             ('parallel_rank0_train', par))
           for k in ('ms', 'device_ms', 'host_ms', 'cold_ms', 'plain_ms',
                     'bound_ms', 'bound_by', 'library_ms',
                     'library_device_ms')}}, {
        'name': 'xblock_gemm', 'route': 'cuda',
        'source': 'glenet_tpu_torch/csrc/xblock_gemm.cu', 'replaces': None,
        'launches': XBLOCK.n, 'checked_launches': XBLOCK.windows,
        'checked_worst_gap': XBLOCK.worst, **xblock}]
    print(f'[done] all phases passed in {time.perf_counter() - t_start:.1f} '
          f's; kernel times are per predict (sum of its 4 calls), train_* '
          f'per train step (sum of its 4 calls); launches are counted over '
          f'the {N_REQUESTS} predicts, the {TRAIN_STEPS} train steps, the '
          f'CLI phase (6 train steps, 2 BN-refresh forwards, 1 predict), '
          f'the CVAE phase\'s detector training (2 train steps) and the '
          f'weights phase ({N_REQUESTS} vq predicts, {TRAIN_STEPS} vq train '
          f'steps, 1 plain predict, 1 plain train step, 1 predict of test '
          f'--ckpt) and the single-stage phase (GLENet-S and GLENet-C: '
          f'{2 * N_REQUESTS} predicts and {TRAIN_STEPS} train steps each; '
          f'SECOND: 1 predict, 1 train step; 1 predict of test --ckpt) '
          f'and the Waymo phase (GLENet-S: {N_REQUESTS + 1} predicts, '
          f'{TRAIN_STEPS} train steps; the CLIs: 4 train steps, 2 '
          f'predicts; second.yaml: 1 predict, 1 train step; the .msgpack '
          f'resume: 4 train steps) and the three-class phase '
          f'(second_multihead.yaml and second_iou.yaml: {N_REQUESTS + 1} '
          f'predicts and {THREE_CLASS_STEPS} train steps each; '
          f'pointpillar.yaml and its CLIs: none; second_iou.yaml test '
          f'--ckpt: 1 predict) and the PV-RCNN phase (KITTI: '
          f'{N_REQUESTS + 1} predicts, {PV_RCNN_STEPS + 1} train steps; '
          f'Waymo: 2 predicts, 1 train step; the CLIs: 2 train steps, '
          f'{math.ceil(TC_VAL / 2)} predicts; test --ckpt: 1 predict) and '
          f'the convergence phase (GLENet-VR: {CONV_VR_STEPS} steps, 8 '
          f'BN-refresh forwards, 9 predicts; stage 2: '
          f'{CONV_STAGE2_STEPS} steps, 8 BN-refresh forwards, 8 predicts; '
          f'Waymo GLENet-S: {CONV_WAYMO_STEPS + CONV_WAYMO_TAIL} steps, 8 '
          f'BN-refresh forwards, 8 predicts; PointPillars, Waymo '
          f'PointPillars and PointRCNN: none) and the PartA2 phase (KITTI PartA2 and '
          f'PartA2-free: {N_REQUESTS + 1} predicts and {PARTA2_STEPS + 1} '
          f'train steps each; Waymo PartA2: 3 predicts, 3 train steps; the '
          f'CLIs: 2 train steps, {math.ceil(TC_VAL / 4)} predicts; '
          f'{UNET_LAUNCHES} launches per call) and the PointRCNN phase '
          f'(none: no sparse level, checked per call) and the CenterPoint '
          f'phase (centerpoint.yaml: {N_REQUESTS} predicts, '
          f'{TRAIN_STEPS} train steps; centerpoint_without_resnet.yaml '
          f'and the two CenterHead-RPN configs: 1 predict and 1 train step '
          f'each; the pillar configs: none; the CLIs: 2 train steps, '
          f'{math.ceil(WAYMO_FRAMES / WAYMO_BATCH)} predicts; the harness: '
          f'{CONV_CENTERPOINT_STEPS + CONV_CENTERPOINT_TAIL} steps, its '
          f'BN-refresh forwards and predicts) and the PV-RCNN++ phase '
          f'(pv_rcnn_plusplus.yaml: {PVPP_PREDICTS} predicts, '
          f'{PVPP_STEPS + 1} train steps; the resnet yaml: 1 predict, 1 train '
          f'step; the CLIs: 2 train steps, '
          f'{math.ceil(WAYMO_FRAMES / BATCH)} predicts; the harness: '
          f'{CONV_PVPP_STEPS + CONV_PVPP_TAIL} steps, its BN-refresh '
          f'forwards and predicts) and the CaDDN phase (none: no voxels, no '
          f'sparse level, checked per call over {N_REQUESTS} predicts and '
          f'{CADDN_STEPS + 1} steps of CaDDN.yaml, a predict and a step of '
          f'CaDDN_deeplab.yaml, the CLIs and {CONV_CADDN_STEPS} harness '
          f'steps) and the nuScenes phase (nuScenes CenterPoint: '
          f'{N_REQUESTS} predicts, {TRAIN_STEPS} train steps, '
          f'{NUSC_CLI[3] * NUSC_CLI[4]} CLI steps and '
          f'{math.ceil(NUSC_CLI[1] / NUSC_CLI[2])} test predicts; Lyft: 1 '
          f'predict, 1 train step, {LYFT_CLI[3] * LYFT_CLI[4]} CLI step, '
          f'{math.ceil(LYFT_CLI[1] / LYFT_CLI[2])} test predict; Pandaset: '
          f'{PANDASET_CLI[3] * PANDASET_CLI[4]} CLI steps, '
          f'{math.ceil(PANDASET_CLI[1] / PANDASET_CLI[2])} test predict); '
          f'single_* per GLENet-C predict, waymo_* per '
          f'Waymo GLENet-S predict, waymo_train_* per Waymo train step, '
          f'second_iou_* per SECOND-IoU predict, second_iou_train_* per '
          f'SECOND-IoU train step, pv_rcnn_* per KITTI PV-RCNN predict, '
          f'pv_rcnn_train_* per KITTI PV-RCNN train step, parta2_* per '
          f'KITTI PartA2 predict (sum of its {UNET_LAUNCHES} calls), '
          f'parta2_train_* per KITTI PartA2 train step, centerpoint_* per '
          f'Waymo CenterPoint predict, centerpoint_train_* per Waymo '
          f'CenterPoint train step, pv_rcnn_plusplus_* per Waymo PV-RCNN++ '
          f'predict and pv_rcnn_plusplus_train_* per Waymo PV-RCNN++ train '
          f'step (B = 2), nuscenes_* per nuScenes CenterPoint predict (B = '
          f'2), nuscenes_train_* per nuScenes CenterPoint train step (B = 4) '
          f'and lyft_* per Lyft SECOND-multihead predict (B = 2); the '
          f'parallel phase: (a) 1 timed step on each of 2 ranks, (b) 1 '
          f'step on each of 2 ranks (when run), (c) 2 CLI steps and '
          f'{math.ceil(CLI_VAL / CLI_BATCH)} predict; '
          f'parallel_rank0_train_* per rank 0 step of (a) (B = {PAR_B}); '
          f'xblock_gemm: predict_* per Waymo CenterPoint request (B = 1, '
          f'its {XBLOCK_LAUNCHES["predict"]} calls), step_* per Waymo '
          f'GLENet-S train step (B = 4, its {XBLOCK_LAUNCHES["step"]} '
          f'calls), launches over the main process, checked_launches '
          f'those of each checked warm-up (every one held against the '
          f'plain version; the parallel ranks print their own)')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
