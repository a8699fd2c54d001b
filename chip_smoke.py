#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every kernel.

    python3 chip_smoke.py

Runs the flagship Graph-DETR4D config
(detr4d_res50_deform_pe_testaug_2subset_12e: 12 cameras at 640x1600,
ResNet-50 + DCNv2, 900 queries, 6 decoder layers, bf16) with seeded random
weights, serving (also with the int8 DCN table) and training, then the
LiDAR detector ObjDGCNN (served, and differentiated) and the rotated 3D
IoU, and prints one JSON line per phase:

  1. build    nvcc for every kernel source, all started together;
  2. kernels  each kernel against its plain PyTorch version at the main
              path's shapes, fp32 (TF32 off, max abs error <= 1e-4) and
              bf16 (error <= 2e-2 of the output's max magnitude), with
              samples outside the image and both DCN strides (K2, the
              fused conv, with weights at the init scale 1 / sqrt(9 Cin));
              kernel time, plain time and the bound (least time for the
              bytes moved or the operations done; K2 also times the bare
              bf16 contraction in cuBLAS, `gemm_ref_ms`, which the old
              two-stage route paid on top of its sampling kernel). The
              backward kernels of K1 / K2 are
              held to torch.autograd.grad of the plain versions (fp32: 1e-4
              of the gradient's magnitude where that exceeds 1, since the
              location gradients carry a factor W from the sampling
              position; position gradients of samples within 1e-4 px of
              an integer coordinate, where the bilinear derivative jumps,
              are left out and counted); K5 (focal loss) within 1e-5
              relative; K4
              (assignment) identical, on random costs, planted ties and
              nan / inf entries, num_valid from 0 to 128, timed with the
              Dijkstra steps of its longest problem and ns per step; at
              H-DETR's one2many shape (768 x 1,800) identical at
              num_valid 200 and scipy's optimum at 768; after phase train
              also on that step's own cost matrices (row
              hungarian_train_costs); K5 the same way on that step's
              own inputs (row focal_loss_train_inputs), its loss bitwise
              equal over two calls;
  3. serve    serve.Engine answers 4 requests from synthetic_batch; time
              per request (CUDA events), peak memory, cam_overflow, valid
              detections and the launch counters (K1 6 and K2 forward 9
              per request), counted from 0 just before the requests;
              then one more request split into stages by CUDA events, and
              a torch.profiler trace of one: device busy share, top
              kernels (phase "breakdown");
     stream   serve.Engine.infer_stream: 4 requests of one stream, each the
              6 new cameras of a frame (launches a request K1 6, K2 9),
              timed beside serve's; the stream cache filled to max_streams
              (its bytes and the peak), one more stream evicting the least
              recently used, reset_stream; in fp32 a stream's second request
              against infer on the concatenated 12 cameras, every decoder
              layer as in phase plain;
     tta      parallel/step.py's build_tta_eval_step, fp32: two identical
              copies equal one forward, two different copies (own images and
              calibrations) the mean of their forwards' head outputs, within
              1e-5, and its decode that mean's; then 4 bf16 two-copy
              requests timed (K1 12, K2 18 a request);
     serve_mp the MP config (detr4d_res50_deform_pe_mp_testaug_2subset_12e,
              seeded random weights): 4 requests (K1 12 a request: the
              centre and the 7,200-row neighbour call of each layer; K2 9);
              mp_plain: its fp32 kernel and plain routes as phase plain, the
              plain route replaying the kernel route's reference points and
              query graphs, its own differing rows counted (each a
              near-tie), a free-running plain route within 1e-2;
     variants the plain head with DETR3D's attention (detr4d_res50: K1 6 a
              request, one head of 256 channels, 4 levels) and with
              DETR3D-v2's (K1 6): one request each and the fp32 kernels vs
              plain check of phase plain;
  4. plain    the same weights in fp32, once through the kernels and once
              through their plain versions (launch counts 6 / 9, then
              0 / 0): logits and boxes of decoder layers 0-1 agree within
              1e-4, of every layer within 1e-3;
  5. train    train.Trainer at full width (batch 1, 40 GT boxes, grid mask
              and dropout on): 1 warm-up step, then 5 timed steps (CUDA
              events), loss and grad_norm per step, peak memory, and the
              launch counts per step (K1 fwd 6 / bwd 6, K2 fwd 9 / bwd 9,
              K5 1, K4 1); the frozen stem stays bit-identical and a
              main-group weight moves; then one step split into stages and
              a torch.profiler trace of one (phase "train_breakdown");
  6. train_plain  one fp32 step (dropout 0, grid mask off) through the
              kernels and one through the plain versions from the same
              weights: launches (6, 6, 9, 9, 1, 1) then all 0, loss and
              per-layer losses within 1e-5 relative, grad_norm within 5e-4,
              and every layer's assignment identical (or, where rounding of
              the two routes' costs picks another optimum, the same summed
              cost within 1e-5).
     data     the data pipeline, checkpoints and CLIs at full width: a
              nuScenes-layout fixture (data/fixture.py: 4 samples, 6
              current + 6 previous cameras of JPEGs at 900x1600, 5-40 GT
              boxes) written with the installed encoder; tools.train.main
              on the flagship (photometric, ida and rot aug, grid mask,
              dropout, bf16) for 3 steps with checkpoints at 2 and 3, one
              step profiled, then resumed to step 4: launches per step as
              phase train's, the restored weights, AdamW, schedule and
              generator bit-equal to the saved ones, the resumed step's
              loss bit-equal to the in-memory trainer's on the same batch,
              that step's update within 1e-2 of the in-memory step's in
              norm over all weights and within 1e-1 in every tensor (over
              that tensor's own update), and two restore faults planted
              in the same step (AdamW's step count off by one; one small
              tensor's moments zeroed) each breaking a bound;
              tools.test.main from the checkpoint directory, from a
              reference-layout .pth (answers identical) and with
              --format-nusc / --out (K1 6, K2 9 a request, cam_overflow 0,
              mAP / NDS printed without a limit), one --tta-resizes
              1.0,0.95,1.05 request (K1 18, K2 27) whose copies'
              calibrations equal _tta_ida's composition; the native
              loader against the python path where it builds (mean
              |difference| < 0.06); host ms a sample, H2D ms and bytes,
              forward ms, steps and samples a second, the train CLI's
              device idle share.

  7. serve_int8  the flagship with backbone.dcn_gather=int8 answers the
              same 4 requests from the same weights: time per request, peak
              memory, launches per request exactly K3 7, K2 forward 2,
              K1 6 (the int8 table applies only to DCN inputs above 1536
              padded pixels), and, reported without a limit, the box drift
              against the exact path's answer as the port's
              tools/int8_box_bound.py::box_drift defines it (top-300 selection churn, max |d| of centre, size, yaw,
              velocity and score over the boxes both select), beside the
              drift of the same int8 convs through their plain version
              (quantize, column tile, cuBLAS matmul) after the timed
              requests, and the fused route's drift from that one;
  8. lidar    ObjDGCNN at the JAX module's full width (128 x 128 pillars, 64
              pillar channels, 900 queries, width 256, 6 layers, k 16), batch
              1, through serve.LidarEngine: 4 requests, each a seeded
              synthetic cloud of ~300,000 points x 5 features (clusters on a
              ground plane, ~10% outside the range, a masked padded tail);
              time per request, peak memory, valid detections, launches per
              request K6 1 + 1 and K1 6;
  9. lidar_plain  the same weights, kernels vs plain versions: launches
              (1, 1, 6) then 0, logits and boxes of layers 0-1 within 1e-4,
              of every layer within 1e-3;
 10. iou      core/iou3d.bbox_overlaps_3d (K7) on the lidar answer: the 900
              final-layer boxes against themselves and the 300 decoded boxes
              against 128 ground-truth-like boxes, against the plain version
              within 1e-5; 2 launches.
 11. lidar_grad  the lidar phase's weights and first cloud in fp32: the
              detr3d loss of the head's outputs against 40 synthetic boxes
              and its backward, once through the kernels (launches exactly
              K6 features 1, scatter 1, scatter backward 1, K1 forward 6,
              K1 backward 6, K4 1, K5 1) and once through the plain
              versions, the plain route reusing the kernel route's k-NN
              sets: loss within 1e-5 relative, the pillar layers'
              gradients (pfn, pfn_norm) and the global gradient norm
              within 5e-4 (train_plain's tolerances), pfn's weight gradient
              finite and nonzero.
 12. hdetr    H-DETR (h_detr4d_res50_deform_pe_testaug_2subset_12e: the
              flagship plus a one2many group of 1,800 queries under a
              block-diagonal self-attention mask), bf16: 2 requests through
              serve.Engine (K1 6, K2 9 a request, cam_overflow 0 at K =
              1,350 a camera); in fp32 its one2one outputs against the
              flagship's given the same weights and the first 900 query
              rows, within phase plain's bounds with the camera gate's
              projection zeroed (with the seeded gate reported only: the
              gate's (B, Q, N) -> (B, N, Q) view mixes queries); 1 + 2
              Trainer steps with 40 GT (a step: K1 6 / 6, K2 9 / 9, K4 2,
              K5 2: the one2one and the one2many set loss); one fp32 step
              kernels vs plain as train_plain (phase hdetr_train_plain,
              both groups' assignments); ms a request and a step, peaks.
 13. camaware the four camera-aware configs (DepthNet, the camconv gate,
              scale_pred), bf16, on one batch of a fixture through the
              pipeline (real intrinsics, ida_scale, and depth_factors from
              scale_aware_resize): one request each (K1 6, K2 9,
              cam_overflow 0), fp32 kernels vs plain on camaware_fpe and
              camconvfpe (phase plain's bounds), one bf16 TrainStep step on
              camaware_pe_aug and simpleda (finite; K1 6 / 6, K2 9 / 9, K4
              1, K5 1), cam_coord_channels' ms and peak bytes at full
              width, and the ResNet-18 student served once (K1 6, K2 0).
 14. http     the flagship exported by tools/export_model.py (float, and
              --uint8-input --streaming), each verified on the card, served
              in process by tools/serve.py on port 0: float /infer (K1 6,
              K2 9 a request), uint8 /infer on the streaming artifact (K1
              6, K2 18: the halves encoded separately), /infer_stream of 6
              new cameras (K1 6, K2 9), /reset_stream; HTTP answers
              bit-equal to in-process Engine.infer; the bench client at
              concurrency 1 and 2 on each route (p50 / p90 / p99,
              throughput, payload MB); concurrent answers bit-equal to
              serial ones; a float body refused by the uint8 artifact
              with 400 and the server serving on; /healthz's served equal
              to the inference requests answered.
 15. backbones  VoVNet V-99-eSE under the flagship's head
              (detr4d_vovnet_deform, 12 x 640x1600), bf16: 3 requests (K1
              6, K2 0: no DCN; cam_overflow 0), its backbone and neck
              profiled (device busy share, kernels launched, top kernels),
              fp32 kernels vs plain with the kernel route's reference
              points replayed (phase plain's bounds; free running within
              1e-2), one train step (K1 6 / 6, K4 1, K5 1); detr4d_vovnet
              (the plain head, DETR3D attention) one request; the
              MobileNetV2 student (12 x 320x800) one request and one step.
 16. distill  teacher -> student distillation (train/distill_step.py),
              bf16: 3 steps of mixdistill_r50_r18_cls_reg_img (R50-DCN
              teacher, R18 student, 12 x 320x800; instance, MixDistill and
              vanilla feature distillation, reweight_score, top-k 64),
              each split into teacher forward, student forward and loss,
              backward and AdamW (a step: K1 18 / 12, K2 9 / 0, K4 2, K5
              1; cam_overflow 0 for the student's and the guided decode's
              queries); one fp32 step kernels vs plain (losses 1e-5
              relative, grad_norm 5e-4, assignments identical or at an
              equal optimum cost within 1e-5); K4 on that step's soft
              matching, 12 problems of 64 x 900, and on one 900 x 900
              problem of the same step with every teacher row, identical
              to the plain version, kernel and plain ms; one step of
              mixdistill_r50_m2_cls_reg_img (the MobileNetV2 student) and
              of detr4d_r50_distill_r50_1x (R50 -> R50 at 640x1600, K2's
              backward on the student: K1 12 / 6, K2 18 / 9, K4 2, K5 1);
              tools.distill_train.main --synthetic --steps 2, then
              tools.distill_test.main on the checkpoint it saved.
 17. petr     the PETR family (models/petr_head.py, models/petr_seg.py),
              bf16, seeded random weights; its dense cross-attention is
              plain PyTorch, so a request launches no K1, and K2 9 on the
              R50-DCN configs only. petrv2_vovnet_gridmask_p4_1600x640
              (12 x 640x1600, VoVNet-99, CPFPN, 48,000 keys,
              mean_time_stamp 0.5): 3 requests, one split into backbone
              and neck, head, the head's cross-attention and decode (CUDA
              events), one profiled, 2 streamed requests and in fp32 a
              streamed request against infer (phase plain's bounds), one
              train step (K4 1, K5 1); petrv2_res50_gridmask_p4_800x320
              (12 x 320x800, R50-DCN, FPN level 0 at stride 8: 48,000
              keys): 3 requests (K2 9), petr_plain (fp32 kernels vs plain,
              phase plain's bounds), one train step (K2 9 / 9, K4 1, K5
              1), petr_train_plain (train_plain's bounds), exported by
              tools/export_model.py (verified with mean_time_stamp) and
              served by tools/serve.py: one /infer request answered as
              Engine.infer answers it, one without mean_time_stamp refused
              with 400; petr_r50dcn_gridmask_p4 and _c5 (6 cameras) one
              request each (K2 9); petrv2_BEVseg one request and one train
              step with lane targets from a seeded (3, 256, 256) map
              (`loss_mask`); the generic deformable decoder
              (models/detr_decoder.py: 900 queries, 6 layers, the 4
              flagship FPN levels of one 640x1600 camera, 21,250 tokens),
              fp32, K1 6 against its plain version within 1e-4 per layer;
              one decoder layer's dense cross-attention at the main
              config's keys: the plain route, its core, and off the path
              F.scaled_dot_product_attention on the same q, k, v.
 18. dist     the flagship train step under a torch.distributed process
              group (parallel/mesh.py; the card's machine has one GPU, so
              no time here is a multi-GPU time): (a) a world-size-1 NCCL
              group in this process: one fp32 step through
              TrainStep(mesh=make_mesh()) against the step without a
              group (train_plain's bounds), the one-rank all-reduce / 1
              bit-equal, its bytes equal to every parameter in fp32, and 3
              bf16 steps timed each way beside the coalesced all-reduce's
              ms; (b) two ranks sharing the card over gloo (NCCL refuses
              two ranks on one device), data=2: one fp32 step on a global
              batch of 2, one sample a rank, against one process on the
              same batch (train_plain's bounds, each rank's assignments
              identical to its image's); (c) the same two ranks as cam=2,
              6 cameras a rank: an fp32 forward against one process
              (phase plain's bounds, cam_overflow summed equal) and one
              fp32 step (train_plain's bounds), each rank launching K1 6
              / K2 9 a forward and a step's STEP_LAUNCHES for its
              cameras; (d) one bf16 step with head.fix_offset: the
              offsets' update AdamW's pure decay within 1e-6 relative;
              (e) on the same two ranks at cam=2, the other head families
              against one process, fp32: the MP config, detr4d_res50 with
              DETR3D's and with DETR3D-v2's attention (each replaying the
              one process's reference points, and free running), PETRv2
              on VoVNet at 12 x 640x1600 (48,000 keys, the softmax merged
              across the ranks), petr_r50dcn_gridmask_p4 (K2) and
              petrv2_BEVseg (lane maps): every decoder output within
              phase plain's bounds, cam_overflow and each rank's K1 / K2
              launches equal to one process's, ms a forward and the
              collectives' ms; one step each of MP and of PETRv2 (its
              800x320 config, dropout on) within train_plain's bounds,
              assignments identical, peak memory a rank; the planted MP
              gate sliced before its view breaks the bound (the merge
              without the global max is reported). Each rank prints its
              card's name and power limit; a rank's failure or timeout
              fails the phase.
Phase `kernels` also holds K3 (the fused int8-table conv, fp32 within
1e-4 and bf16 within one bf16 step of the output's magnitude, both
strides, the flagship's 7 int8 DCN shapes, with `gemm_ref_ms` as K2's),
K6 (the lidar phase's clouds: ids exactly and rows within 1e-5, the max
exactly on raw and relu'd features and on the cloud in scan order
(`scan_order`: by sweep, then azimuth), each timed (`ms`, `relu_ms`,
`scan_order_ms`), its backward bit-equal to the plain version on raw and
relu'd features, with the host's us and the device ms of a call) and K7 (900 x 900 and 300 x 128, with the host's us per
call and the share of pairs its pre-test skips) to their plain
versions, with the time of one PyTorch call that computes the same
function where there is one (K6: scatter_reduce_ 'amax' for the grid,
index_add_ for the cell sums; the backward beside autograd's own backward
of scatter_reduce_, several calls), and the host time and device kernels
of one K6 features call and of one index_add_, of one K6 scatter call
and of one K5 call. K1's forward lists its
device kernels too. K1's forward is also checked and timed at the variants' layouts (the
MP neighbour call: 7,200 rows a camera, no compaction list; DETR3D: one
head of 256 channels, 4 levels, one point a level), per request of those
configs. K1's backward is checked and timed twice:
on uniform samples (the table's row) and on samples clustered around 50
reference points per camera at 3 pixels' spread, as a trained model's
queries look at the same objects.

Then the card's name and power limit as nvidia-smi gives them, the kernel
table as one JSON line (each row's launches by path, each path's counted
from 0 just before it; the forward kernels' `launches` summed over the
serving paths), and last `{"ok": true, "device": {...}}`. Any
failed phase raises: the script exits non-zero and prints no result. It
needs one CUDA device and the CUDA toolkit, and imports no JAX.
"""

import contextlib
import dataclasses
import gc
import importlib.util
import itertools
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from graph_detr4d_tpu_torch.config import HeadConfig
from graph_detr4d_tpu_torch.configs import get_config
from graph_detr4d_tpu_torch.core import iou3d
from graph_detr4d_tpu_torch.core.coder import decode_batch
from graph_detr4d_tpu_torch.data.synthetic import synthetic_batch
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D, model_extras
from graph_detr4d_tpu_torch.ops import build
from graph_detr4d_tpu_torch.core.losses import detr3d_loss
from graph_detr4d_tpu_torch.ops import deform_conv as dcn_ops
from graph_detr4d_tpu_torch.ops import focal_loss as focal_ops
from graph_detr4d_tpu_torch.ops import hungarian as lsa_ops
from graph_detr4d_tpu_torch.geometry.boxes import denormalize_bbox
from graph_detr4d_tpu_torch.models import dgcnn as dgcnn_mod
from graph_detr4d_tpu_torch.models import transformer as transformer_mod
from graph_detr4d_tpu_torch.models.dgcnn import ObjDGCNN
from graph_detr4d_tpu_torch.ops import msda as msda_ops
from graph_detr4d_tpu_torch.ops import voxelize as vox_ops
from graph_detr4d_tpu_torch.parallel.step import build_tta_eval_step
from graph_detr4d_tpu_torch.serve import Engine, LidarEngine
from graph_detr4d_tpu_torch.train.optim import clip_by_global_norm
from graph_detr4d_tpu_torch.train.step import TrainStep
from graph_detr4d_tpu_torch.train.trainer import Trainer
from graph_detr4d_tpu_torch.weights import init_weights
from graph_detr4d_tpu_torch import native as native_loader
from graph_detr4d_tpu_torch.data import pipeline as data_pipeline
from graph_detr4d_tpu_torch.data.fixture import write_nuscenes_fixture
from graph_detr4d_tpu_torch.data.nuscenes import NuScenesSweepDataset
from graph_detr4d_tpu_torch.tools import test as test_cli
from graph_detr4d_tpu_torch.tools import train as train_cli
from graph_detr4d_tpu_torch.models.camera_aware import cam_coord_channels
from graph_detr4d_tpu_torch.serve import extras_spec
from graph_detr4d_tpu_torch.tools import export_model as export_cli
from graph_detr4d_tpu_torch.tools import serve as serve_cli
from graph_detr4d_tpu_torch.configs import get_distill_config
from graph_detr4d_tpu_torch.distill.distiller import Distiller
from graph_detr4d_tpu_torch.tools import distill_test as distill_test_cli
from graph_detr4d_tpu_torch.tools import distill_train as distill_train_cli
from graph_detr4d_tpu_torch.train.distill_step import DistillStep
from graph_detr4d_tpu_torch.models.detr_decoder import (
    Deformable3DDetrTransformerDecoder)
from graph_detr4d_tpu_torch.models.petr_seg import maps_to_patches
from graph_detr4d_tpu_torch.models.transformer import MultiheadAttention
from graph_detr4d_tpu_torch.serve import synth_extra
from graph_detr4d_tpu_torch.tools.int8_box_bound import box_drift

CONFIG = "detr4d_res50_deform_pe_testaug_2subset_12e"
REQUESTS = 4
MSDA_CALLS, DCN_CALLS = 6, 9  # per request: decoder layers, DCN convs
TRAIN_STEPS, NUM_GT = 5, 40
# fp32 train step, kernels vs plain: losses and grad_norm, relative.
# First set at 1e-4 / 1e-3, tightened after runs measured at most 3.4e-7
# and 4.8e-5 (NVIDIA H100 80GB HBM3, 700 W; see PERF.md)
TRAIN_PLAIN_RTOL, TRAIN_PLAIN_GRAD_NORM_RTOL = 1e-5, 5e-4
# launches per train step: K1 fwd / bwd, K2 fwd / bwd, K5, K4
STEP_LAUNCHES = {"msda_forward": 6, "msda_backward": 6,
                 "deform_conv_forward": 9, "deform_conv_backward": 9,
                 "focal_loss": 1, "hungarian": 1}
# fp32 kernel path vs plain path: decoder layers 0-1, and every layer
PLAIN_EARLY_ATOL, PLAIN_ATOL = 1e-4, 1e-3
# and, for the graph variants, a plain route left free to refine its own
# reference points (their fp32 rounding feeds back into where they
# sample): every layer within this, set above runs measured at most 2.2e-3
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md), so that a gross fault of the
# box-refinement feedback still fails
FREE_RUNNING_ATOL = 1e-2
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s,
# dense bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
# the DCN convs of one request at 640x1600 x 12 cameras: (H, W, Cin,
# stride) of the input, and how many of the 9 have that shape
DCN_SHAPES = [((80, 200, 256, 2), 1), ((40, 100, 256, 1), 5),
              ((40, 100, 512, 2), 1), ((20, 50, 512, 1), 2)]
MSDA_LEVELS = [(80, 200), (40, 100), (20, 50), (10, 25)]
# the 7 of them that take the int8 table under backbone.dcn_gather=int8
INT8_SHAPES = DCN_SHAPES[:3]
INT8_LAUNCHES = {"deform_conv_int8_forward": 7, "deform_conv_forward": 2,
                 "msda_forward": 6}  # per request
# the LiDAR detector: ObjDGCNN's defaults; clouds the size of a nuScenes
# 10-sweep cloud
LIDAR_GRID, LIDAR_POINTS, LIDAR_FEATURES = (128, 128), 300_000, 5
LIDAR_LEVELS = [(128, 128), (64, 64), (32, 32), (16, 16)]
LIDAR_LAUNCHES = {"pillar_features": 1, "pillar_scatter": 1,
                  "msda_forward": 6}  # per request
# phase lidar_plain: k-NN rows per call whose plain-route choice may differ
# (runs measured at most 2 of 900), each a near-tie: the route's own k-th
# and (k+1)-th squared distances within this relative gap
KNN_MAX_DIFFERING, KNN_TIE_RTOL = 4, 1e-5
# phase lidar_grad: one fp32 ObjDGCNN loss and backward, launches per step
LIDAR_GRAD_LAUNCHES = {"pillar_features": 1, "pillar_scatter": 1,
                       "pillar_scatter_backward": 1, "msda_forward": 6,
                       "msda_backward": 6, "hungarian": 1, "focal_loss": 1}
IOU_SHAPES = [(900, 900), (300, 128)]
# the graph attention variants served at full width (seeded random weights
# each): the MP config (K1 2 calls a decoder layer: centre and neighbours),
# and the plain head with DETR3D's attention and with DETR3D-v2's (a call a
# layer each)
MP_CONFIG = "detr4d_res50_deform_pe_mp_testaug_2subset_12e"
VARIANTS = {"detr4d_res50": ("detr4d_res50", [], MSDA_CALLS),
            "detr4d_res50_detr3d_v2": ("detr4d_res50",
                                       ["head.attn_type=detr3d_v2"], MSDA_CALLS)}
# phase mp_plain: the MP query graph's rows per decoder layer whose plain
# route's own neighbour set may differ from the replayed kernel route's,
# each a near-tie: its own 8th and 9th nearest squared distances within
# this relative gap
MP_MAX_FLIPS, MP_TIE_RTOL = 8, 1e-4
# phase data: a nuScenes-layout fixture at the source size, the train CLI
# for 3 steps (checkpoint at 2) then resumed to 4, the test CLI over it.
# The resumed step's update against the in-memory trainer's on the same
# batch: ||w_r - w_m|| / ||w_m - w_before|| over all floating weights
# within DATA_UPDATE_RTOL, and per tensor (that tensor's difference over
# its own update; a tensor the step left as it was stays bit-equal)
# within DATA_TENSOR_UPDATE_RTOL. The gradients differ only by the order
# of float atomics (K1's backward grad_value among them): measured 4.3e-4
# over all, 1.04e-2 in the worst tensor (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md). Two restore faults planted in the same resumed step must each
# break a bound: AdamW's step count off by one (every tensor, ~6%), and
# the moments of one small tensor, RESTORE_FAULT_TENSOR, zeroed.
DATA_SAMPLES, DATA_SRC_HW = 4, (900, 1600)
DATA_UPDATE_RTOL, DATA_TENSOR_UPDATE_RTOL = 1e-2, 1e-1
RESTORE_FAULT_TENSOR = "pts_bbox_head.adapt_pos3d.0.bias"
TTA_MULTS = (1.0, 0.95, 1.05)
# native loader vs the python path: mean |difference| of the normalized
# images (tests/test_pipeline.py:376)
NATIVE_MEAN_ABS = 0.06
# phase hdetr: the flagship plus H-DETR's one2many group of 1,800 queries
# (K4 and K5 twice a step: the one2one and the one2many set loss)
HDETR_CONFIG = "h_detr4d_res50_deform_pe_testaug_2subset_12e"
HDETR_REQUESTS, HDETR_TRAIN_STEPS = 2, 2
HDETR_STEP_LAUNCHES = {**STEP_LAUNCHES, "focal_loss": 2, "hungarian": 2}
# phase camaware: the four camera-aware configs, each served once on a
# fixture batch with its real intrinsics, ida scale and depth factors;
# fp32 kernels vs plain on two, a bf16 train step on the other two; and
# the ResNet-18 student (no DCN) served once
CAMAWARE_CONFIGS = ("detr4d_res50_deform_camaware_pe_aug_2subset_12e",
                    "detr4d_res50_deform_camaware_fpe_2subset_12e",
                    "detr4d_res50_deform_camconvfpe_2subset_12e",
                    "detr4d_res50_deform_simpleda_2subset_12e")
CAMAWARE_PLAIN = CAMAWARE_CONFIGS[1:3]
CAMAWARE_TRAIN = CAMAWARE_CONFIGS[0::3]
R18_CONFIG = "detr4d_res18_deform_pe_testaug_320_2subset"
# phase http: the flagship exported twice and served over HTTP in process
HTTP_FLOAT_REQUESTS, HTTP_UINT8_REQUESTS, HTTP_STREAM_REQUESTS = 2, 4, 4
HTTP_BENCH_REQUESTS = 8
# phase backbones: VoVNet V-99-eSE under the flagship's head (served,
# fp32 kernels vs plain, a train step), the plain-head VoVNet config and
# the MobileNetV2 student (served, a train step); VoVNet and MobileNetV2
# have no DCN, so K2 is bypassed
VOVNET_CONFIG = "detr4d_vovnet_deform"
VOVNET_PLAIN_HEAD_CONFIG = "detr4d_vovnet"
M2_CONFIG = "detr4d_m2_deform_pe_testaug_320_fullset"
BACKBONE_REQUESTS = 3
NO_DCN_STEP_LAUNCHES = {**STEP_LAUNCHES, "deform_conv_forward": 0,
                        "deform_conv_backward": 0}
# phase distill: MixDistill R50-DCN -> R18 with vanilla feature distill
# (3 timed steps, a fp32 kernels-vs-plain step), then one step of the
# MobileNetV2 student's bundle and of R50 -> R50 at 640x1600, and the
# distill CLIs chained
DISTILL_BUNDLE = "mixdistill_r50_r18_cls_reg_img"
DISTILL_M2_BUNDLE = "mixdistill_r50_m2_cls_reg_img"
DISTILL_R50_BUNDLE = "detr4d_r50_distill_r50_1x"
DISTILL_CLI_BUNDLE = "mixdistill_r50_r18_cls_reg_2subset"
DISTILL_STEPS = 3
# launches a distill step: the teacher's forward (K1 6, K2 9), the
# student's forward (K1 6, and 6 more for the MixDistill decode) and its
# backward, K4 for the GT matching and one launch for every distill
# matching (the student's and the guided decode's together), K5 once
MIX_STEP_LAUNCHES = {"msda_forward": 18, "msda_backward": 12,
                     "deform_conv_forward": 9, "deform_conv_backward": 0,
                     "focal_loss": 1, "hungarian": 2}
R50_DISTILL_STEP_LAUNCHES = {"msda_forward": 12, "msda_backward": 6,
                             "deform_conv_forward": 18,
                             "deform_conv_backward": 9, "focal_loss": 1,
                             "hungarian": 2}

# phase petr: the PETR family at full width (seeded random weights, bf16).
# Its heads attend densely in plain PyTorch, with no K1: a request
# launches K2 9 on the R50-DCN configs and no kernel on VoVNet's
PETR_MAIN = "petrv2_vovnet_gridmask_p4_1600x640"
PETR_R50 = "petrv2_res50_gridmask_p4_800x320"
PETR_V1 = ("petr_r50dcn_gridmask_p4", "petr_r50dcn_gridmask_c5")
PETR_SEG = "petrv2_BEVseg"
PETR_REQUESTS = 3
PETR_DCN = {"deform_conv_forward": DCN_CALLS}  # a request on R50-DCN
PETR_STEP = {"focal_loss": 1, "hungarian": 1}  # a train step on VoVNet
PETR_DCN_STEP = {**PETR_STEP, "deform_conv_forward": DCN_CALLS,
                 "deform_conv_backward": DCN_CALLS}
SEG_MAP_HW = (256, 256)  # petrv2_BEVseg's map: 256 patches of 16x16
# the generic deformable decoder: 900 queries and 6 layers over one
# camera's 4 flagship FPN levels at 640x1600 (MSDA_LEVELS, 21,250 tokens)
DECODER_QUERIES, DECODER_LAYERS = 900, 6


def emit(record):
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn over iters launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_counts():
    return {"msda_forward": msda_ops.launches,
            "msda_backward": msda_ops.backward_launches,
            "deform_conv_forward": dcn_ops.forward_launches,
            "deform_conv_backward": dcn_ops.backward_launches,
            "focal_loss": focal_ops.launches,
            "hungarian": lsa_ops.launches,
            "deform_conv_int8_forward": dcn_ops.int8_launches,
            "pillar_features": vox_ops.launches,
            "pillar_scatter": vox_ops.scatter_launches,
            "pillar_scatter_backward": vox_ops.scatter_backward_launches,
            "iou3d": iou3d.launches}


def reset_launch_counts():
    msda_ops.launches = msda_ops.backward_launches = 0
    dcn_ops.forward_launches = dcn_ops.backward_launches = 0
    focal_ops.launches = lsa_ops.launches = 0
    dcn_ops.int8_launches = 0
    vox_ops.launches = vox_ops.scatter_launches = 0
    vox_ops.scatter_backward_launches = 0
    iou3d.launches = 0


def check_grads_close(name, got, want, dtype, skip=None):
    """Gradients: fp32 within 1e-4 of max(1, magnitude), bf16 within 2e-2
    of the magnitude. skip: {tensor position: boolean mask, broadcast to
    it, of elements left out}. Returns (worst abs error, its tensor's
    magnitude)."""
    worst = (0.0, 0.0)
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g.float() - w.float()).abs()
        if skip and i in skip:
            diff = diff.masked_fill(skip[i], 0.0)
        err = diff.max().item()
        scale = w.float().abs().max().item()
        if not np.isfinite(err):
            raise AssertionError(f"{name}[{i}]: non-finite gradient")
        tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
        if err > tol:
            raise AssertionError(f"{name}[{i}]: {dtype} max abs error {err} > "
                                 f"{tol} (magnitude {scale})")
        worst = max(worst, (err, scale))
    return worst


def dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def device_events(prof):
    """The profile's device-side entries (kernels, memcpy, memset) with
    device time: an operator's CPU entry, and a user annotation such as
    `Optimizer.step#AdamW.step`, repeat the device time of the kernels
    they launched."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def bf16_step(magnitude):
    """One bf16 step (unit in the last place) at this magnitude."""
    return 2.0 ** (np.floor(np.log2(magnitude)) - 7)


def host_us(fn, calls=100):
    """Host time to issue one call of fn (microseconds, mean over `calls`
    calls issued back to back after a synchronize): where it exceeds the
    call's device time, CUDA-event times measure the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def device_breakdown(fn):
    """Device time of each kernel (and memset) of one call of fn, from a
    torch.profiler trace of that call after a warm-up call:
    [[name, ms, count], ...], longest first."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.key[:60], dev_us(e) / 1e3, e.count]
            for e in sorted(device_events(prof), key=dev_us, reverse=True)]


def launch_device_ms(fn, kernel, tries=3):
    """Device ms of the one kernel, named `kernel`, that one call of fn
    launches: from the first of `tries` device_breakdown traces that lists
    that launch once and nothing else. The profiler can miss a launch (a
    cooperative one; K4 and K5 after phase train), so where no trace shows
    it the time is None, not a sum over an empty list. Returns
    (breakdown, ms)."""
    for _ in range(tries):
        device = device_breakdown(fn)
        if (len(device) == 1 and kernel in device[0][0]
                and device[0][2] == 1):
            return device, device[0][1]
    return device, None


def check_close(name, got, want, dtype, bf16_tol=None):
    """fp32 within 1e-4; bf16 within bf16_tol(magnitude), by default 2e-2
    of the output's magnitude. Returns (max abs error, magnitude)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not np.isfinite(err):
        raise AssertionError(f"{name}: non-finite output")
    if dtype == torch.float32 and err > 1e-4:
        raise AssertionError(f"{name}: fp32 max abs error {err} > 1e-4")
    tol = (bf16_tol or (lambda m: 2e-2 * m))(scale)
    if dtype == torch.bfloat16 and err > tol:
        raise AssertionError(
            f"{name}: bf16 max abs error {err} > {tol} (magnitude {scale})")
    return err, scale


def bilinear_corners(x, y, H, W):
    """Integer corners and bilinear weights (zero outside) of samples at
    pixel coordinates (x, y), as both kernels compute them."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xx, yy = x0 + dx, y0 + dy
        w = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        yield xx, yy, w * inb


KINK = 1e-4  # pixels: 8x the fp32 rounding of a position near 200


def near_kink(py, px):
    """Samples within KINK of an integer pixel coordinate (float64
    positions). The bilinear sample's derivative along a coordinate jumps
    where that coordinate crosses an integer, so there the gradient for
    the position is a choice between two one-sided values, and the
    kernel's fp32 position and the plain version's float64 one may land on
    either side. Their position gradients are left out of the comparison;
    every other gradient is continuous there."""
    return ((py - py.round()).abs() < KINK) | ((px - px.round()).abs() < KINK)


def msda_kinks(loc, levels):
    """near_kink of every K1 sample: (BN, Q, heads, L, P, 1)."""
    H = torch.tensor([h for h, _ in levels], dtype=torch.float64,
                     device=loc.device).view(1, 1, 1, -1, 1)
    W = torch.tensor([w for _, w in levels], dtype=torch.float64,
                     device=loc.device).view(1, 1, 1, -1, 1)
    return near_kink(loc[..., 1].double() * H - 0.5,
                     loc[..., 0].double() * W - 0.5)[..., None]


def dcn_kinks(offsets, stride):
    """near_kink of every K2 tap sample: (B, Ho, Wo, 9, 1)."""
    _, Ho, Wo = offsets.shape[:3]
    dev = offsets.device
    k = torch.arange(9, device=dev)
    py = ((torch.arange(Ho, device=dev) * stride - 1)[None, :, None, None]
          + k // 3 + offsets[..., 0].double())
    px = ((torch.arange(Wo, device=dev) * stride - 1)[None, None, :, None]
          + k % 3 + offsets[..., 1].double())
    return near_kink(py, px)[..., None]


def touched_value_rows(value, loc, attn, index, need_attn, levels=MSDA_LEVELS):
    """(distinct value rows, corner count) that K1's samples of the
    selected queries (index None: every query) read: in-image corners, and
    with need_attn only those whose attention weight is nonzero (the
    forward skips the rest; the backward needs every in-image sample for
    grad_attn)."""
    BN, S, heads, hd = value.shape
    rows = torch.arange(BN, device=value.device)[:, None]
    if index is not None:
        loc, attn = loc[rows, index], attn[rows, index]
    R, P = loc.shape[1], loc.shape[4]
    bn = rows[:, :, None, None].expand(BN, R, heads, P)
    h = torch.arange(heads, device=value.device)[None, None, :, None]
    touched, nnz, start = [], 0, 0
    for lvl, (H, W) in enumerate(levels):
        x = loc[:, :, :, lvl, :, 0] * W - 0.5
        y = loc[:, :, :, lvl, :, 1] * H - 0.5
        a = attn[:, :, :, lvl]
        for xx, yy, w in bilinear_corners(x, y, H, W):
            keep = (w * a) != 0 if need_attn else w != 0
            pix = start + yy[keep].long() * W + xx[keep].long()
            touched.append((bn[keep] * S + pix) * heads + h.expand_as(keep)[keep])
            nnz += int(keep.sum())
        start += H * W
    return torch.unique(torch.cat(touched)).numel(), nnz


def msda_bound_ms(value, loc, attn, index, levels=MSDA_LEVELS):
    """Least time for one K1 call on these inputs: the value rows its
    nonzero corner weights touch (each read once), the selected queries'
    loc / attn, the index and the output, over HBM bandwidth; or its FMAs
    over the fp32 rate."""
    BN, S, heads, hd = value.shape
    rows_read, nnz = touched_value_rows(value, loc, attn, index, True, levels)
    R = loc.shape[1] if index is None else index.shape[1]
    per_query = attn[0, 0].numel()  # heads * L * P samples of one query
    elt = value.element_size()
    bytes_ = (rows_read * hd * elt + BN * R * per_query * (2 * 4 + 4)
              + (0 if index is None else index.numel() * 8)
              + BN * R * heads * hd * elt)
    flops = 2 * hd * nnz
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def msda_backward_bound_ms(value, loc, attn, index):
    """Least time for one K1 backward call: the value rows its in-image
    corners touch and the selected queries' loc / attn, the index and
    grad_out read once; grad_value (dense, value's dtype), grad_loc and
    grad_attn (dense, fp32) written once; or about 8 FLOPs per in-image
    corner and channel (sample, two position derivatives, the scatter)
    over the fp32 rate."""
    BN, S, heads, hd = value.shape
    rows_read, corners = touched_value_rows(value, loc, attn, index, False)
    R = index.shape[1]
    per_query = attn[0, 0].numel()  # heads * L * P samples of one query
    elt = value.element_size()
    bytes_ = (rows_read * hd * elt + BN * R * per_query * (2 * 4 + 4)
              + index.numel() * 8
              + BN * R * heads * hd * elt + value.numel() * elt
              + loc.numel() * 4 + attn.numel() * 4)
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 8 * hd * corners / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def clustered_loc(gen, dev, BN, Q, heads, L, P, points=50, spread_px=3.0):
    """K1 sampling locations as a trained model's queries place them: each
    query of a camera looks around one of `points` reference points of
    that camera (uniform in [0.05, 0.95]^2), its samples at a normal
    spread of `spread_px` pixels of each level."""
    ref = torch.rand(BN, points, 2, generator=gen) * 0.9 + 0.05
    pick = torch.randint(0, points, (BN, Q), generator=gen)
    centre = ref[torch.arange(BN)[:, None], pick]  # (BN, Q, 2) as (x, y)
    size = torch.tensor([[w, h] for h, w in MSDA_LEVELS], dtype=torch.float32)
    noise = torch.randn(BN, Q, heads, L, P, 2, generator=gen) * spread_px
    loc = centre[:, :, None, None, None, :] + noise / size[:, None, :]
    return loc.contiguous().to(dev)


def msda_backward_record(label, value32, loc, attn, index, gen, dev,
                         plain=True):
    """K1's backward on these samples: checked against the plain version
    (fp32 and bf16, with and without the index list) and timed in bf16
    with the index list, per train step (the plain version too, with
    `plain`)."""
    BN, Q, heads, L, P = attn.shape
    hd = value32.shape[-1]
    R = index.shape[1]
    kinks = msda_kinks(loc, MSDA_LEVELS)
    checks = {"samples_near_kink": int(kinks.sum())}
    for dtype in (torch.float32, torch.bfloat16):
        value = value32.to(dtype)
        for name, idx in (("index", index), ("all", None)):
            g = (torch.randn(BN, R if idx is not None else Q, heads * hd,
                             generator=gen)).to(dev, dtype)
            got = msda_ops.msda_backward(value, MSDA_LEVELS, loc, attn, g, idx)
            want = msda_ops.msda_backward_plain(value, MSDA_LEVELS, loc, attn,
                                                g, idx)
            checks[f"{name}_{str(dtype)[6:]}"] = check_grads_close(
                f"msda_backward {label} {name} {dtype}", got, want, dtype,
                skip={1: kinks})
            del got, want
    value = value32.to(torch.bfloat16)
    g = torch.randn(BN, R, heads * hd, generator=gen).to(dev, torch.bfloat16)
    ms = cuda_ms(lambda: msda_ops.msda_backward(value, MSDA_LEVELS, loc, attn,
                                                g, index), 20)
    bound, bound_by = msda_backward_bound_ms(value, loc, attn, index)
    rows, _ = touched_value_rows(value, loc, attn, index, False)
    breakdown = device_breakdown(lambda: msda_ops.msda_backward(
        value, MSDA_LEVELS, loc, attn, g, index))
    record = dict(checks=checks, ms=ms * MSDA_CALLS, per_call_ms=ms,
                  bound_ms=bound * MSDA_CALLS, bound_by=bound_by,
                  touched_value_rows=rows, device_ms_per_call=breakdown)
    if plain:
        record["plain_ms"] = MSDA_CALLS * cuda_ms(
            lambda: msda_ops.msda_backward_plain(value, MSDA_LEVELS, loc,
                                                 attn, g, index), 3)
    return record


def dcn_in_image_corners(x, offsets, stride):
    B, H, W, C = x.shape
    _, Ho, Wo = offsets.shape[:3]
    ys = torch.arange(Ho, device=x.device)[:, None] * stride - 1
    xs = torch.arange(Wo, device=x.device)[None, :] * stride - 1
    corners = 0
    for k in range(9):
        py = ys + k // 3 + offsets[..., k, 0].float()
        px = xs + k % 3 + offsets[..., k, 1].float()
        corners += sum(int((w != 0).sum())
                       for _, _, w in bilinear_corners(px, py, H, W))
    return corners


def dcn_peak_flops(x):
    return PEAK_BF16_TENSOR_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS


def dcn_bound_ms(x, offsets, w):
    """Least time for one fused K2 or K3 forward call: x, offsets, mask
    and the (9 Cin, Cout) weight read once and the (B, Ho, Wo, Cout)
    output written once (x's dtype), over HBM bandwidth; or the
    contraction's 2 M 9Cin Cout FLOPs over the tensor-core rate of x's
    dtype. K3's int8 table is an intermediate of its design, not of the
    function, and counts no bytes."""
    B, H, W, C = x.shape
    npix = B * offsets.shape[1] * offsets.shape[2]
    cout = w.shape[1]
    bytes_ = (x.numel() + npix * 27 + w.numel() + npix * cout) * x.element_size()
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 2 * npix * 9 * C * cout / dcn_peak_flops(x)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dcn_backward_bound_ms(x, offsets, w):
    """Least time for one fused K2 backward call: x, offsets, mask, the
    weight and grad_out read once, grad_x, grad_offsets, grad_mask and
    grad_w written once (x's dtype); or the two contractions' 4 M 9Cin
    Cout FLOPs (G = grad_out W^T and grad_w = A^T grad_out) over the
    tensor-core rate of x's dtype."""
    B, H, W, C = x.shape
    npix = B * offsets.shape[1] * offsets.shape[2]
    cout = w.shape[1]
    bytes_ = (2 * (x.numel() + npix * 27 + w.numel()) + npix * cout) * x.element_size()
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 4 * npix * 9 * C * cout / dcn_peak_flops(x)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def fp32_step_config(cfg):
    """train_plain's configuration: fp32, dropout 0, grid mask off."""
    return dataclasses.replace(
        cfg, bf16=False, head=dataclasses.replace(cfg.head, dropout=0.0),
        train=dataclasses.replace(cfg.train, use_grid_mask=False))


def cuda_batch(batch):
    return {k: torch.as_tensor(v).cuda() for k, v in batch.items()}


def phase_build():
    t0 = time.perf_counter()
    nvcc = build.build()
    smi = smi_line()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": nvcc, "card": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def kernel_msda(dev, gen):
    """K1 forward and backward at the main path's call, against their plain
    versions; the backward also on clustered samples. Returns the two
    records."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    results = {}
    # K1 at the main path's call: 12 cameras, 900 queries of which each
    # camera keeps 450 (cam_capacity 0.5), 8 heads x 32, 4 levels x 4 points
    BN, Q, R, heads, hd, L, P = 12, 900, 450, 8, 32, 4, 4
    S = sum(h * w for h, w in MSDA_LEVELS)
    value32 = randn(BN, S, heads, hd)
    loc = (rand(BN, Q, heads, L, P, 2) * 1.2 - 0.1).contiguous()  # some outside
    attn = torch.softmax(randn(BN, Q, heads, L * P), -1).view(BN, Q, heads, L, P)
    attn = (attn * (rand(BN, Q, heads, L, P) > 0.5)).contiguous()  # masked
    index = torch.stack([torch.randperm(Q, generator=gen)[:R]
                         for _ in range(BN)]).to(dev)
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        value = value32.to(dtype)
        for name, idx in (("index", index), ("all", None)):
            got = msda_ops.msda_forward(value, MSDA_LEVELS, loc, attn, idx)
            want = msda_ops.msda_forward_plain(value, MSDA_LEVELS, loc, attn, idx)
            checks[f"{name}_{str(dtype)[6:]}"] = check_close(
                f"msda {name} {dtype}", got, want, dtype)
    value = value32.to(torch.bfloat16)
    ms = cuda_ms(lambda: msda_ops.msda_forward(value, MSDA_LEVELS, loc, attn,
                                               index), 20)
    plain_ms = cuda_ms(lambda: msda_ops.msda_forward_plain(
        value, MSDA_LEVELS, loc, attn, index), 3)
    bound, bound_by = msda_bound_ms(value, loc, attn, index)
    results["msda_forward"] = dict(
        checks=checks, ms=ms * MSDA_CALLS, plain_ms=plain_ms * MSDA_CALLS,
        bound_ms=bound * MSDA_CALLS, bound_by=bound_by, per_call_ms=ms,
        device_ms_per_call=device_breakdown(lambda: msda_ops.msda_forward(
            value, MSDA_LEVELS, loc, attn, index)))
    results["msda_forward"]["layouts"] = kernel_msda_layouts(dev)
    emit({"phase": "kernels", "kernel": "msda_forward",
          "shape": [BN, Q, R, heads, hd, L, P], **results["msda_forward"]})

    # K1 backward: the same inputs, grad_out of the output's shape; then
    # samples clustered around 50 points a camera, with their own generator
    # so that the later kernels' inputs stay those of earlier runs
    results["msda_backward"] = msda_backward_record(
        "uniform", value32, loc, attn, index, gen, dev)
    cgen = torch.Generator(device="cpu").manual_seed(1)
    results["msda_backward"]["clustered"] = msda_backward_record(
        "clustered", value32, clustered_loc(cgen, dev, BN, Q, heads, L, P),
        attn, index, cgen, dev, plain=False)
    emit({"phase": "kernels", "kernel": "msda_backward",
          "shape": [BN, Q, R, heads, hd, L, P], **results["msda_backward"]})
    del value32, value
    return results["msda_forward"], results["msda_backward"]


def msda_layout_record(name, value32, levels, loc, attn, calls):
    """K1 at one layout with every query (no compaction list): fp32 and
    bf16 against the plain version; bf16 time, plain time and bound of
    `calls` calls (one request's), the device ms of one."""
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        value = value32.to(dtype)
        got = msda_ops.msda_forward(value, levels, loc, attn)
        want = msda_ops.msda_forward_plain(value, levels, loc, attn)
        checks[str(dtype)[6:]] = check_close(f"msda {name} {dtype}", got, want,
                                             dtype)
        del got, want
    value = value32.to(torch.bfloat16)

    def kernel():
        return msda_ops.msda_forward(value, levels, loc, attn)

    bound, by = msda_bound_ms(value, loc, attn, None, levels)
    _, device_ms = launch_device_ms(kernel, "msda_forward_kernel")
    return dict(
        checks=checks, ms=calls * cuda_ms(kernel, 20),
        plain_ms=calls * cuda_ms(lambda: msda_ops.msda_forward_plain(
            value, levels, loc, attn), 3),
        bound_ms=calls * bound, bound_by=by, device_ms_per_call=device_ms,
        calls_per_request=calls)


def kernel_msda_layouts(dev):
    """K1 in the layouts of the graph attention variants, per request of
    their configs (12 cameras, 900 queries): the MP neighbour branch (every
    query's 8 neighbours, 7,200 rows a camera, 8 heads x 32, 4 levels, one
    point, no compaction list; a call a decoder layer) and DETR3D (one head
    of 256 channels, 4 levels, one point a level at one location, a
    camera's weights all 0 where it does not see the point; a call a
    decoder layer), on their own generator."""
    gen = torch.Generator().manual_seed(3)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    S = sum(h * w for h, w in MSDA_LEVELS)
    BN, R, heads, hd, L = 12, 7200, 8, 32, len(MSDA_LEVELS)
    value32 = torch.randn(BN, S, heads, hd, generator=gen).to(dev)
    loc = (rand(BN, R, heads, L, 1, 2) * 1.2 - 0.1).contiguous()
    attn = torch.softmax(torch.randn(BN, R, heads, L, generator=gen).to(dev), -1)
    attn = (attn.view(BN, R, heads, L, 1) * (rand(BN, R, heads, L, 1) > 0.5)).contiguous()
    layouts = {"mp_neighbour": msda_layout_record(
        "mp_neighbour", value32, MSDA_LEVELS, loc, attn, MSDA_CALLS)}
    del value32, loc, attn
    value32 = torch.randn(BN, S, 1, 256, generator=gen).to(dev)
    loc = (rand(BN, 900, 1, 1, 1, 2) * 1.2 - 0.1).expand(BN, 900, 1, L, 1, 2)
    attn = rand(BN, 900, 1, L, 1) * (rand(BN, 900, 1, 1, 1) > 0.5)
    layouts["detr3d"] = msda_layout_record(
        "detr3d", value32, MSDA_LEVELS, loc.contiguous(), attn.contiguous(),
        MSDA_CALLS)
    return layouts


def phase_kernels(dev):
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    results = {}
    results["msda_forward"], results["msda_backward"] = kernel_msda(dev, gen)

    # K2 forward and backward (the fused conv) at the 4 DCN shapes of one
    # request, both strides, Cout = Cin (ResNet-50's bottleneck widths),
    # weights at the init scale 1 / sqrt(9 Cin) so that outputs are O(1)
    fwd, bwd = ({"checks": {}, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "gemm_ref_ms": 0.0, "max_abs_err": 0.0, "by": set()}
                for _ in range(2))
    for (H, W, C, stride), count in DCN_SHAPES:
        Ho, Wo = dcn_ops.output_size(H, stride, 1), dcn_ops.output_size(W, stride, 1)
        x32 = randn(12, H, W, C)
        off32 = randn(12, Ho, Wo, 9, 2) * 3.0  # some taps land outside
        mask32 = rand(12, Ho, Wo, 9)
        w32 = randn(9 * C, C) / np.sqrt(9 * C)
        g32 = randn(12, Ho, Wo, C)
        tag = f"{H}x{W}x{C}_s{stride}"
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            x, off, mask, w, g = (t.to(dtype) for t in (x32, off32, mask32, w32, g32))
            kinks = dcn_kinks(off, stride)
            bwd["checks"][f"{tag}_{dt}_near_kink"] = int(kinks.sum())
            got = dcn_ops.deform_conv_forward(x, off, mask, w, stride)
            want = dcn_ops.deform_conv2d_plain(x, off, mask, w, stride)
            fwd["checks"][f"{tag}_{dt}"] = check_close(
                f"deform_conv_forward {tag} {dtype}", got, want, dtype)
            del got, want
            got = dcn_ops.deform_conv_backward(x, off, mask, w, g, stride)
            want = dcn_ops.deform_conv2d_backward_plain(x, off, mask, w, g, stride)
            bwd["checks"][f"{tag}_{dt}"] = check_grads_close(
                f"deform_conv_backward {tag} {dtype}", got, want, dtype,
                skip={1: kinks})
            if dtype == torch.float32:
                for rec in (fwd, bwd):
                    rec["max_abs_err"] = max(rec["max_abs_err"],
                                             rec["checks"][f"{tag}_{dt}"][0])
            del got, want
        x, off, mask, w, g = (t.to(torch.bfloat16)
                              for t in (x32, off32, mask32, w32, g32))
        # the bare contraction in cuBLAS, at the same shapes: what the old
        # route ran after its sampling kernel (once forward, twice backward)
        a = torch.randn(12 * Ho * Wo, 9 * C, device=dev, dtype=torch.bfloat16)
        gemm_ms = count * cuda_ms(lambda: torch.matmul(a, w), 20)
        del a
        # the backward's data-gradient kernel alone (no weight gradient)
        bwd["data_grad_ms"] = bwd.get("data_grad_ms", 0.0) + count * cuda_ms(
            lambda: dcn_ops.deform_conv_backward(x, off, mask, w, g, stride,
                                                 weight_grad=False), 20)
        for rec, fn, plain, bound_fn in (
            (fwd, lambda: dcn_ops.deform_conv_forward(x, off, mask, w, stride),
             lambda: dcn_ops.deform_conv2d_plain(x, off, mask, w, stride),
             dcn_bound_ms),
            (bwd, lambda: dcn_ops.deform_conv_backward(x, off, mask, w, g, stride),
             lambda: dcn_ops.deform_conv2d_backward_plain(x, off, mask, w, g,
                                                          stride),
             dcn_backward_bound_ms),
        ):
            rec["ms"] += count * cuda_ms(fn, 20)
            rec["plain_ms"] += count * cuda_ms(plain, 3)
            rec["gemm_ref_ms"] += gemm_ms
            b, b_by = bound_fn(x, off, w)
            rec["bound_ms"] += count * b
            rec["by"].add(b_by)
        del x32, off32, mask32, w32, g32, x, off, mask, w, g
        torch.cuda.empty_cache()
    for name, rec in (("deform_conv_forward", fwd), ("deform_conv_backward", bwd)):
        by = rec.pop("by")
        results[name] = dict(rec, bound_by="bytes" if by == {"bytes"}
                             else "operations")
        emit({"phase": "kernels", "kernel": name, "shapes": DCN_SHAPES,
              **results[name]})

    results["focal_loss"] = kernel_focal_loss(dev, gen)
    results["hungarian"] = kernel_hungarian(dev, gen)
    results["deform_conv_int8_forward"] = kernel_int8(dev, gen)
    (results["pillar_features"], results["pillar_scatter"],
     results["pillar_scatter_backward"]) = kernel_voxelize(dev, gen)
    results["iou3d"] = kernel_iou3d(dev)
    return results


def kernel_focal_loss(dev, gen):
    """K5 at the flagship's loss: 6 decoder layers x 900 queries x 10
    classes, labels with background, per-layer avg_factor."""
    layers, N, C = 6, 900, 10
    logits = (torch.randn(layers, N, C, generator=gen) * 3).to(dev)
    labels = torch.randint(0, C + 1, (layers, N), generator=gen).to(dev)
    weights = torch.rand(layers, N, generator=gen).to(dev)
    avg = (torch.rand(layers, generator=gen) * 40 + 1).to(dev)
    rec = focal_loss_record(logits, labels, weights, avg, 0.25, 2.0)
    checks = {k: rec.pop(k) for k in ("loss_rel", "grad_abs", "grad_scale",
                                      "deterministic")}

    def plain():
        leaf = logits.clone().requires_grad_()
        out = focal_ops.sigmoid_focal_loss_plain(leaf, labels, weights, avg)
        torch.autograd.grad(out.sum(), leaf)

    n = logits.numel()
    # read logits, labels, weights, avg; write the loss and dlogits
    bytes_ = n * 4 + labels.numel() * 8 + weights.numel() * 4 + layers * 8 + n * 4
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = 40 * n / PEAK_FP32_FLOPS  # exp, log1p and the rest, ~40 flops
    record = dict(checks=checks,
                  max_abs_err=max(rec.pop("loss_abs"), checks["grad_abs"]),
                  plain_ms=cuda_ms(plain, 20), bound_ms=1e3 * max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations", **rec)
    emit({"phase": "kernels", "kernel": "focal_loss",
          "shape": [layers, N, C], **record})
    return record


def focal_loss_record(logits, labels, weights, avg, alpha, gamma):
    """K5 on given inputs against autograd of the plain version (loss
    within 1e-5 relative, gradient within 1e-5 of its magnitude, the loss
    bitwise equal over two calls): CUDA-event ms, host us a call and the
    device kernels of one call."""
    def kernel():
        return focal_ops.focal_loss_with_grad(logits, labels, weights, avg,
                                              alpha, gamma)

    loss, grad = kernel()
    again, _ = kernel()
    leaf = logits.clone().requires_grad_()
    want = focal_ops.sigmoid_focal_loss_plain(leaf, labels, weights, avg,
                                              alpha, gamma)
    (want_grad,) = torch.autograd.grad(want.sum(), leaf)
    rec = dict(loss_rel=((loss - want).abs() / want.abs()).max().item(),
               loss_abs=(loss - want).abs().max().item(),
               grad_abs=(grad - want_grad).abs().max().item(),
               grad_scale=want_grad.abs().max().item(),
               deterministic=torch.equal(loss, again),
               ms=cuda_ms(kernel, 50), host_us_per_call=host_us(kernel))
    rec["device_ms_per_call"], rec["kernel_device_ms"] = launch_device_ms(
        kernel, "focal_loss_kernel")
    if not (rec["loss_rel"] <= 1e-5 and rec["deterministic"]
            and rec["grad_abs"] <= 1e-5 * rec["grad_scale"]):
        raise AssertionError(f"focal_loss: {rec}")
    return rec


def kernel_focal_loss_train(calls):
    """K5 on the flagship train step's own inputs (phase train's warm-up
    step, recorded by record_focal_inputs): 6 layers x 900 queries x 10
    classes, 40 boxes' labels, the step's label weights and avg_factor."""
    (args, kw), = calls
    rec = focal_loss_record(*args, kw["alpha"], kw["gamma"])
    emit({"phase": "kernels", "kernel": "focal_loss_train_inputs",
          "shape": list(args[0].shape), **rec})
    return rec


def hungarian_record(cost, nv):
    """K4 on (problems, R, C) costs on the card against the plain version
    (identical assignments required), its CUDA-event time, the host's
    microseconds to issue one call, the device time of its kernel (the
    profiler), the Dijkstra steps of each problem and the nanoseconds per
    step of the longest, which bounds the kernel: its steps are
    sequential."""
    got = lsa_ops.hungarian_assignment(cost, nv)
    want, steps = lsa_ops.hungarian_assignment_plain(cost.cpu(), nv.cpu(),
                                                     return_steps=True)
    mismatches = int((got.cpu() != want).sum())

    def call():
        return lsa_ops.hungarian_assignment(cost, nv)

    device, kernel_ms = launch_device_ms(call, "lsa_kernel")
    P, R, C = cost.shape
    # the work depends on the data: the valid rows are read once (the
    # kernel keeps the rows it reads in shared memory), and each Dijkstra
    # step does 3 adds and a compare a column
    valid_rows = int(nv.clamp(0, R).sum())
    bytes_ = valid_rows * C * 4 + P * 4 + P * R * 4
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = sum(steps) * C * 4 / PEAK_FP32_FLOPS
    return dict(mismatches=mismatches, dijkstra_steps=steps,
                longest_steps=max(steps), ms=cuda_ms(call, 20),
                host_us_per_call=host_us(call), device_ms_per_call=device,
                kernel_device_ms=kernel_ms,
                ns_per_step=(None if kernel_ms is None
                             else 1e6 * kernel_ms / max(max(steps), 1)),
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_hungarian(dev, gen):
    """K4 at the flagship's matching shape: 6 problems (layers) of 128 GT
    rows x 900 queries on uniform random costs, num_valid from 0 to 128
    (timed), and on planted ties and nan / inf entries; identical to the
    plain version. Then H-DETR's one2many shape, 768 rows x 1,800
    columns, which the kernel must take: identical to the plain version
    at num_valid 200, scipy's optimum at 768."""
    P, R, C = 6, 128, 900
    nv = torch.tensor([0, 1, 40, 64, 127, 128], dtype=torch.int32)
    base = torch.rand(P, R, C, generator=gen)
    cases = {
        "random": base,
        "ties": torch.round(base * 4) / 4,
        "nan_inf": base.clone().index_put_(
            (torch.arange(P), torch.arange(P), torch.arange(P) * 7),
            torch.tensor([float("nan"), float("inf"), float("-inf")] * 2)),
    }
    mismatches = {}
    for name, cost in cases.items():
        got = lsa_ops.hungarian_assignment(cost.to(dev), nv.to(dev))
        mismatches[name] = int((got.cpu() != lsa_ops.hungarian_assignment_plain(
            cost, nv)).sum())
    rec = hungarian_record(base.to(dev), nv.to(dev))
    t0 = time.perf_counter()
    lsa_ops.hungarian_assignment_plain(base.to(dev), nv.to(dev))
    torch.cuda.synchronize()
    rec["plain_ms"] = 1e3 * (time.perf_counter() - t0)
    mismatches["random"] += rec.pop("mismatches")
    rec["hdetr"] = kernel_hungarian_hdetr(dev)
    record = dict(checks={"mismatches": mismatches}, max_abs_err=0.0,
                  note="latency-bound: the steps of a problem are sequential",
                  **rec)
    emit({"phase": "kernels", "kernel": "hungarian", "shape": [P, R, C],
          "num_valid": nv.tolist(), **record})
    if any(mismatches.values()):
        raise AssertionError(f"hungarian: assignments differ {mismatches}")
    return record


def kernel_hungarian_hdetr(dev):
    import scipy.optimize

    R, C = 768, 1800
    max_cols = lsa_ops._lib().lsa_max_cols(R)
    # its own generator, so that the later kernels' inputs stay those of
    # earlier runs
    cost = torch.rand(2, R, C, generator=torch.Generator().manual_seed(2))
    nv = torch.tensor([200, R], dtype=torch.int32)
    cost_d, nv_d = cost.to(dev), nv.to(dev)
    got = lsa_ops.hungarian_assignment(cost_d, nv_d).cpu()
    want = lsa_ops.hungarian_assignment_plain(cost[:1], nv[:1])
    c = cost[1].numpy()
    rows, cols = scipy.optimize.linear_sum_assignment(c)
    total = float(c[np.arange(R), got[1].numpy()].astype(np.float64).sum())
    optimum = float(c[rows, cols].astype(np.float64).sum())
    rec = dict(shape=[2, R, C], num_valid=nv.tolist(), max_cols=max_cols,
               mismatches_at_200=int((got[0] != want[0]).sum()),
               cost_rel_err_at_768=abs(total - optimum) / optimum,
               ms=cuda_ms(lambda: lsa_ops.hungarian_assignment(cost_d, nv_d), 3))
    if not (max_cols >= C and rec["mismatches_at_200"] == 0
            and rec["cost_rel_err_at_768"] <= 1e-5
            and len(set(got[1].tolist())) == R):
        raise AssertionError(f"hungarian at H-DETR's shape: {rec}")
    return rec


def kernel_hungarian_train(dev, calls):
    """K4 on the flagship train step's own costs (phase train's warm-up
    step, recorded by record_assignments): 6 layers x 128 GT rows (40
    valid) x 900 queries; identical to the plain version."""
    (cost, nv, _), = calls
    rec = hungarian_record(cost.to(dev), nv.to(dev))
    emit({"phase": "kernels", "kernel": "hungarian_train_costs",
          "shape": list(cost.shape), "num_valid": nv.tolist(), **rec})
    if rec["mismatches"]:
        raise AssertionError(f"hungarian on the train step's costs: {rec}")
    return rec


def kernel_int8(dev, gen):
    """K3, the fused int8-table conv, at the 7 DCN convs of one request
    that take the int8 table (12 images, both strides, Cout = Cin, weights
    at the init scale), fp32 and bf16, against deform_conv2d_int8_plain;
    bf16 times summed over the request's calls, and cuBLAS's bare
    contraction at the same shapes (`gemm_ref_ms`, which the old route
    paid after its column tile)."""
    rec = {"checks": {}, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "gemm_ref_ms": 0.0, "max_abs_err": 0.0}
    by = set()
    for (H, W, C, stride), count in INT8_SHAPES:
        assert dcn_ops.select_variant(H, W, "int8") == "int8"
        Ho, Wo = dcn_ops.output_size(H, stride, 1), dcn_ops.output_size(W, stride, 1)
        x32 = torch.randn(12, H, W, C, generator=gen).to(dev)
        off32 = (torch.randn(12, Ho, Wo, 9, 2, generator=gen) * 3.0).to(dev)
        mask32 = torch.rand(12, Ho, Wo, 9, generator=gen).to(dev)
        w32 = (torch.randn(9 * C, C, generator=gen) / np.sqrt(9 * C)).to(dev)
        tag = f"{H}x{W}x{C}_s{stride}"
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask, w = (t.to(dtype) for t in (x32, off32, mask32, w32))
            got = dcn_ops.deform_conv_int8_forward(x, off, mask, w, stride)
            want = dcn_ops.deform_conv2d_int8_plain(x, off, mask, w, stride)
            rec["checks"][f"{tag}_{str(dtype)[6:]}"] = check_close(
                f"deform_conv_int8_forward {tag} {dtype}", got, want, dtype,
                bf16_tol=bf16_step)
            if dtype == torch.float32:
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         rec["checks"][f"{tag}_float32"][0])
            del got, want
        x, off, mask, w = (t.to(torch.bfloat16)
                           for t in (x32, off32, mask32, w32))
        rec["ms"] += count * cuda_ms(
            lambda: dcn_ops.deform_conv_int8_forward(x, off, mask, w, stride), 20)
        rec.setdefault("device_ms_per_call", {})[tag] = device_breakdown(
            lambda: dcn_ops.deform_conv_int8_forward(x, off, mask, w, stride))
        rec["plain_ms"] += count * cuda_ms(
            lambda: dcn_ops.deform_conv2d_int8_plain(x, off, mask, w, stride), 3)
        a = torch.randn(12 * Ho * Wo, 9 * C, device=dev, dtype=torch.bfloat16)
        rec["gemm_ref_ms"] += count * cuda_ms(lambda: torch.matmul(a, w), 20)
        del a
        b, b_by = dcn_bound_ms(x, off, w)
        rec["bound_ms"] += count * b
        by.add(b_by)
        del x32, off32, mask32, w32, x, off, mask, w
        torch.cuda.empty_cache()
    rec["bound_by"] = "bytes" if by == {"bytes"} else "operations"
    emit({"phase": "kernels", "kernel": "deform_conv_int8_forward",
          "shapes": INT8_SHAPES, **rec})
    return rec


def lidar_cloud(seed, n=LIDAR_POINTS):
    """A synthetic 10-sweep LiDAR cloud: (1, n, 5) float32 (x, y, z,
    intensity, time lag) and its (1, n) mask. ~60% ground returns on a
    plane out to 60 m (the part beyond the 51.2 m range falls outside),
    ~30% on 60 box-shaped objects, ~3% above or below the z range, and a
    masked padded tail of zeros (the last 7%)."""
    rng = np.random.RandomState(seed)
    n_pad, n_obj, n_z = n * 7 // 100, n * 30 // 100, n * 3 // 100
    n_ground = n - n_pad - n_obj - n_z
    r = 60.0 * np.sqrt(rng.rand(n_ground))
    th = rng.rand(n_ground) * 2 * np.pi
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       -1.8 + 0.05 * rng.randn(n_ground)], -1)
    centre = rng.uniform(-50, 50, (60, 2))
    size = rng.uniform(0.6, 1.4, (60, 1)) * np.array([4.5, 1.9, 1.6])
    yaw = rng.uniform(-np.pi, np.pi, 60)
    k = rng.randint(0, 60, n_obj)
    local = (rng.rand(n_obj, 3) - 0.5) * size[k]
    c, s_ = np.cos(yaw[k]), np.sin(yaw[k])
    objects = np.stack([centre[k, 0] + c * local[:, 0] - s_ * local[:, 1],
                        centre[k, 1] + s_ * local[:, 0] + c * local[:, 1],
                        -1.8 + local[:, 2] + size[k, 2] / 2], -1)
    z_out = np.stack([rng.uniform(-50, 50, n_z), rng.uniform(-50, 50, n_z),
                      np.where(rng.rand(n_z) < 0.5, rng.uniform(3, 6, n_z),
                               rng.uniform(-8, -5, n_z))], -1)
    xyz = np.concatenate([ground, objects, z_out])[rng.permutation(n - n_pad)]
    pts = np.zeros((1, n, LIDAR_FEATURES), np.float32)
    pts[0, : n - n_pad, :3] = xyz
    pts[0, : n - n_pad, 3] = rng.rand(n - n_pad)
    pts[0, : n - n_pad, 4] = rng.randint(0, 10, n - n_pad) * 0.05
    mask = np.zeros((1, n), np.float32)
    mask[0, : n - n_pad] = 1.0
    return pts, mask


def scan_order(pts, mask):
    """The order in which a 10-sweep cloud of lidar_cloud's layout
    arrives: its valid points by sweep (the time lag, feature 4), then
    azimuth, the masked padded tail last. Returns a permutation of the
    points (numpy, int64)."""
    n = pts.shape[1]
    valid = np.flatnonzero(mask[0] > 0)
    p = pts[0, valid]
    order = valid[np.lexsort((np.arctan2(p[:, 1], p[:, 0]), p[:, 4]))]
    return np.concatenate([order, np.setdiff1d(np.arange(n), valid)])


def kernel_voxelize(dev, gen):
    """K6 at the lidar phase's first cloud: kernels A + B (ids and
    augmented rows) and kernel C (max-scatter of 64-channel features,
    negative values included) against their plain versions, and the
    PyTorch calls that compute their cores (index_add_ of the cell xyz
    sums; scatter_reduce_ 'amax' of the grid)."""
    pts_np, mask_np = lidar_cloud(0)
    pts, mask = torch.from_numpy(pts_np).to(dev), torch.from_numpy(mask_np).to(dev)
    pc = HeadConfig().pc_range
    H, W = LIDAR_GRID
    ids, aug = vox_ops.pillar_features(pts, mask, pc, LIDAR_GRID)
    want_ids, want_aug = vox_ops.pillar_features_plain(pts, mask, pc, LIDAR_GRID)
    ids_differ = int((ids != want_ids).sum())
    aug_err = (aug - want_aug).abs().max().item()
    trash = float((ids == H * W).float().mean())
    if ids_differ or not aug_err <= 1e-5:
        raise AssertionError(f"pillar_features: {ids_differ} ids differ, "
                             f"rows {aug_err} > 1e-5")
    P = pts.shape[1]
    seg = ids.long().reshape(-1)
    xyz = pts[0, :, :3].contiguous()
    sums = torch.zeros(H * W + 1, 3, device=dev)
    feat_bytes = P * (LIDAR_FEATURES * 4 + 4 + 4 + (LIDAR_FEATURES + 5) * 4)

    def kernel():
        return vox_ops.pillar_features(pts, mask, pc, LIDAR_GRID)

    def library():
        return sums.index_add_(0, seg, xyz)

    features = dict(
        checks={"ids_differing": ids_differ, "rows_max_abs_err": aug_err,
                "trash_share": trash},
        max_abs_err=aug_err,
        ms=cuda_ms(kernel, 20),
        plain_ms=cuda_ms(lambda: vox_ops.pillar_features_plain(
            pts, mask, pc, LIDAR_GRID), 3),
        library_ms=cuda_ms(library, 20),
        bound_ms=1e3 * feat_bytes / PEAK_BYTES_PER_S, bound_by="bytes",
        host_us_per_call=host_us(kernel), device_ms_per_call=device_breakdown(kernel),
        library_host_us_per_call=host_us(library),
        library_device_ms_per_call=device_breakdown(library))
    emit({"phase": "kernels", "kernel": "pillar_features",
          "shape": [1, P, LIDAR_FEATURES], "grid": LIDAR_GRID, **features})

    feats = (torch.randn(1, P, 64, generator=gen) - 0.5).to(dev)
    # the same cloud as it arrives (by sweep, then azimuth), its ids
    # computed from the sorted points; and relu'd features, as
    # PillarEncoder gives them (ties at 0)
    order = torch.from_numpy(scan_order(pts_np, mask_np)).to(dev)
    scan_ids, _ = vox_ops.pillar_features(pts[:, order], mask[:, order], pc,
                                          LIDAR_GRID)
    if not torch.equal(scan_ids, ids[:, order]):
        raise AssertionError("pillar_features: ids depend on the points' order")
    cases = {"raw": (feats, ids), "relu": (torch.relu(feats + 0.5), ids),
             "scan_order": (feats[:, order].contiguous(), scan_ids)}
    for name, (f, i) in cases.items():
        got = vox_ops.pillar_scatter(f, i, LIDAR_GRID)
        want = vox_ops.pillar_scatter_plain(f, i, LIDAR_GRID)
        if not torch.equal(got, want):
            raise AssertionError(
                f"pillar_scatter {name}: max differs from the plain version by "
                f"{(got - want).abs().max().item()}")
        if name == "raw":
            negative = int((got < 0).sum())
    idx = seg[:, None].expand(-1, 64)
    grid = torch.zeros(H * W + 1, 64, device=dev)
    scatter_bytes = P * 64 * 4 + P * 4 + H * W * 64 * 4

    def scatter_kernel(f=feats, i=ids):
        return vox_ops.pillar_scatter(f, i, LIDAR_GRID)

    scatter = dict(
        checks={"equal": list(cases), "negative_cells": negative},
        max_abs_err=0.0,
        ms=cuda_ms(scatter_kernel, 20),
        relu_ms=cuda_ms(lambda: scatter_kernel(*cases["relu"]), 20),
        scan_order_ms=cuda_ms(lambda: scatter_kernel(*cases["scan_order"]), 20),
        plain_ms=cuda_ms(lambda: vox_ops.pillar_scatter_plain(
            feats, ids, LIDAR_GRID), 3),
        library_ms=cuda_ms(lambda: grid.scatter_reduce_(
            0, idx, feats[0], "amax", include_self=False), 20),
        bound_ms=1e3 * scatter_bytes / PEAK_BYTES_PER_S, bound_by="bytes",
        host_us_per_call=host_us(scatter_kernel))
    scatter["device_ms_per_call"], scatter["kernel_device_ms"] = (
        launch_device_ms(scatter_kernel, "scatter_max_kernel"))
    emit({"phase": "kernels", "kernel": "pillar_scatter",
          "shape": [1, P, 64], "grid": LIDAR_GRID, **scatter})
    return features, scatter, kernel_scatter_backward(feats, ids, gen, dev)


def kernel_scatter_backward(feats, ids, gen, dev):
    """K6's scatter backward at the lidar phase's cloud, 64 channels: on
    the raw features (negative cells) and on relu'd ones (what the model
    gives it: ties at 0 in many channels of a cell), bit-equal to the
    plain version. Timed on the relu'd features (CUDA events, host us a
    call, the device ms of its one launch), beside autograd's own backward
    of scatter_reduce_ 'amax' (several PyTorch calls, so no library_ms)."""
    P, C = feats.shape[1], feats.shape[2]
    H, W = LIDAR_GRID
    g = torch.randn(1, H, W, C, generator=gen).to(dev)
    checks = {}
    for name, f in (("raw", feats), ("relu", torch.relu(feats + 0.5))):
        out = vox_ops.pillar_scatter(f, ids, LIDAR_GRID)
        got = vox_ops.pillar_scatter_backward(f, ids, out, g, LIDAR_GRID)
        want = vox_ops.pillar_scatter_backward_plain(f, ids, g, LIDAR_GRID)
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"pillar_scatter_backward {name}: differs "
                                 f"from the plain version by {err}")
        checks[name] = [err, int((got != 0).sum())]
    leaf = f.detach().clone().requires_grad_()
    graph = vox_ops.pillar_scatter_plain(leaf, ids, LIDAR_GRID)
    bytes_ = 2 * P * C * 4 + P * 4 + H * W * C * 4

    def kernel():
        return vox_ops.pillar_scatter_backward(f, ids, out, g, LIDAR_GRID)

    record = dict(
        checks=checks, max_abs_err=max(v[0] for v in checks.values()),
        ms=cuda_ms(kernel, 20),
        plain_ms=cuda_ms(lambda: vox_ops.pillar_scatter_backward_plain(
            f, ids, g, LIDAR_GRID), 3),
        pytorch_backward_ms=cuda_ms(lambda: torch.autograd.grad(
            graph, leaf, g, retain_graph=True), 20),
        library_ms=None, bound_ms=1e3 * bytes_ / PEAK_BYTES_PER_S,
        bound_by="bytes", host_us_per_call=host_us(kernel))
    record["device_ms_per_call"], record["kernel_device_ms"] = launch_device_ms(
        kernel, "scatter_max_backward_kernel")
    emit({"phase": "kernels", "kernel": "pillar_scatter_backward",
          "shape": [1, P, C], "grid": LIDAR_GRID, **record})
    return record


def random_boxes(rng, n, near=None):
    """(n, 7) boxes within the 51.2 m range; with `near`, jittered copies
    of rows of `near`, so that pairs overlap."""
    if near is not None:
        b = near[rng.randint(0, len(near), n)].copy()
        b[:, :2] += rng.uniform(-1.5, 1.5, (n, 2))
        b[:, 6] += rng.uniform(-0.6, 0.6, n)
        return b.astype(np.float32)
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-50, 50, (n, 2))
    b[:, 2] = rng.uniform(-2, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def pretest_skips(bboxes1, bboxes2, mode: str = "iou"):
    """(M, N) bool: the pairs whose answer is 0 without clipping, by K7's
    float32 pre-test (csrc/iou3d.cu) written out in PyTorch. Both boxes
    finite, and either their BEV bounding circles apart by more than
    iou3d.PRETEST_MARGIN of the pair's scale (the largest centre
    coordinate plus both radii; the clip's rounding is ~1e-6 of it, so
    the clip of such a pair is empty and its area exactly 0), or, for IoU
    and IoF, their z-extents not overlapping (0 times a finite area)."""
    b1, b2 = bboxes1[:, :7].float(), bboxes2[:, :7].float()

    def circle(b):
        radius = 0.5 * torch.sqrt(b[:, 3] * b[:, 3] + b[:, 4] * b[:, 4])
        extent = torch.maximum(b[:, 0].abs(), b[:, 1].abs())
        return b[:, 0], b[:, 1], radius, extent

    x1, y1, r1, e1 = circle(b1)
    x2, y2, r2, e2 = circle(b2)
    dx, dy = x1[:, None] - x2[None], y1[:, None] - y2[None]
    scale = torch.maximum(e1[:, None], e2[None]) + r1[:, None] + r2[None]
    reach = (r1[:, None] + r2[None]) + iou3d.PRETEST_MARGIN * scale
    skip = dx * dx + dy * dy > reach * reach
    if mode != "bev":
        skip |= iou3d._z_overlap(b1, b2) == 0
    ok = torch.isfinite(b1).all(1)
    return skip & ok[:, None] & torch.isfinite(b2).all(1)[None]


def iou_operations(b1, b2):
    """About the float operations K7's IoU needs on these boxes: the
    pre-test, 25 a pair, for every pair; for the pairs it leaves
    (`pretest_skips`), per clip step 10 per vertex tested (two side
    tests) and 9 per vertex emitted (a crossing at most), then 3 per
    vertex of the shoelace and 12 for the z overlap and the ratio:
    counted from this run's polygons."""
    M, N = b1.shape[0], b2.shape[0]
    clip = ~pretest_skips(b1, b2).reshape(-1)
    c1, c2 = iou3d.box_corners_bev(b1), iou3d.box_corners_bev(b2)
    p1 = c1[:, None].expand(M, N, 4, 2).reshape(M * N, 4, 2)[clip]
    p2 = c2[None].expand(M, N, 4, 2).reshape(M * N, 4, 2)[clip]
    pts = torch.cat([p1, p1[:, :1].expand(-1, iou3d.V_MAX - 4, 2)], dim=1)
    count = torch.full((p1.shape[0],), 4, dtype=torch.long, device=b1.device)
    ops = 25 * M * N
    for i in range(4):
        tested = int(count.sum())
        pts, count = iou3d._clip_poly(pts, count, p2[:, i], p2[:, (i + 1) % 4])
        ops += 10 * tested + 9 * int(count.sum())
    return ops + 3 * int(count.sum()) + 12 * p1.shape[0]


def kernel_skipped(b1, b2, mode="iou"):
    """The pairs K7's pre-test answered without clipping, counted by the
    kernel, and the count of `pretest_skips`."""
    skipped = torch.zeros(1, dtype=torch.int64, device=b1.device)
    iou3d.bbox_overlaps_3d(b1, b2, mode, skipped=skipped)
    return int(skipped), int(pretest_skips(b1, b2, mode).sum())


def kernel_iou3d(dev):
    """K7 at the iou phase's shapes, 900 x 900 and 300 x 128 boxes 50 m
    out, against the plain version (1e-5); per shape the host's
    microseconds to issue a call, the device kernels of one call and the
    share of pairs the kernel's pre-test answered without clipping, as the
    kernel counts it (it must equal `pretest_skips`' count)."""
    rng = np.random.RandomState(0)
    rec = {"checks": {}, "ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
           "host_us_per_call": [], "device_ms_per_call": [],
           "pretest_skipped_share": []}
    ops = 0
    for M, N in IOU_SHAPES:
        b1 = random_boxes(rng, M)
        b2 = random_boxes(rng, N, near=b1)
        b1, b2 = torch.from_numpy(b1).to(dev), torch.from_numpy(b2).to(dev)
        for mode in ("iou", "iof"):
            got = iou3d.bbox_overlaps_3d(b1, b2, mode)
            want = iou3d.bbox_overlaps_3d_plain(b1, b2, mode)
            err = (got - want).abs().max().item()
            if not err <= 1e-5:
                raise AssertionError(f"iou3d {M}x{N} {mode}: {err} > 1e-5")
            rec["checks"][f"{M}x{N}_{mode}"] = [err, int((want > 0.1).sum())]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)

        def call():
            return iou3d.bbox_overlaps_3d(b1, b2)

        rec["ms"] += cuda_ms(call, 20)
        rec["plain_ms"] += cuda_ms(lambda: iou3d.bbox_overlaps_3d_plain(b1, b2), 3)
        rec["host_us_per_call"].append(host_us(call))
        rec["device_ms_per_call"].append(device_breakdown(call))
        for mode in ("iou", "iof", "bev"):
            counted, want = kernel_skipped(b1, b2, mode)
            if counted != want:
                raise AssertionError(f"iou3d {M}x{N} {mode}: the kernel skipped "
                                     f"{counted} pairs, its pre-test {want}")
            if mode == "iou":
                rec["pretest_skipped_share"].append(counted / (M * N))
        ops += iou_operations(b1, b2)
        torch.cuda.empty_cache()
    t_ops = ops / PEAK_FP32_FLOPS
    t_bytes = sum((M + N) * 7 * 4 + M * N * 4 for M, N in IOU_SHAPES) / PEAK_BYTES_PER_S
    rec.update(bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               operations=ops)
    emit({"phase": "kernels", "kernel": "iou3d", "shapes": IOU_SHAPES, **rec})
    return rec


def random_state_dict(cfg):
    """Seeded random weights (weights.init_weights: zero-initialised
    projections perturbed, reg-branch output layers scaled down)."""
    model = GraphDETR4D(cfg, device="cpu")
    init_weights(model, seed=0)
    return model.state_dict()


def timed_requests(fn, requests):
    """fn(*args) for each args of `requests`, each timed by CUDA events,
    with the launch counters and the peak memory counted from just before
    the first. Returns (ms per request, results, launches, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, results = [], []
    for args in requests:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        results.append(fn(*args))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, results, launch_counts(), torch.cuda.max_memory_allocated()


def check_answers(name, results, cfg, launches, want_per_request, same=True):
    """Every answer of the right shape and finite (and, with `same`, one
    label set for the repeated requests); the launch counters exactly
    want_per_request (kernel: launches a request) times the requests."""
    want = dict.fromkeys(launches, 0)
    want.update({k: v * len(results) for k, v in want_per_request.items()})
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    for r in results:
        if r["bboxes"].shape != (1, cfg.coder.max_num, 9):
            raise AssertionError(f"{name}: bboxes shape {r['bboxes'].shape}")
        for k in ("bboxes", "scores"):
            if not np.isfinite(r[k]).all():
                raise AssertionError(f"{name}: non-finite {k}")
    if same and not all(np.array_equal(x["labels"], results[-1]["labels"])
                        for x in results):
        raise AssertionError(f"{name}: repeated requests disagree")


def phase_serve(cfg, sd):
    batch = synthetic_batch(cfg, seed=0)
    engine = Engine(cfg, sd)  # warms up
    times, results, launches, peak = timed_requests(
        engine.infer, [(batch["images"], batch["lidar2img"])] * REQUESTS)
    r = results[-1]
    emit({"phase": "serve", "config": CONFIG, "requests": REQUESTS,
          "ms_per_request": times, "mean_ms": sum(times) / len(times),
          "peak_memory_bytes": peak, "cam_overflow": r["cam_overflow"],
          "valid_detections": int(r["valid"].sum()), "launches": launches})
    check_answers("serve", results, cfg, launches,
                  {"msda_forward": MSDA_CALLS, "deform_conv_forward": DCN_CALLS})
    return engine, batch, launches, sum(times) / len(times)


def layer_errors(a, b):
    """Per decoder layer, the max abs difference of logits and boxes."""
    errs = {}
    for key in ("all_cls_scores", "all_bbox_preds"):
        if not torch.isfinite(a[key]).all():
            raise AssertionError(f"non-finite {key}")
        errs[key] = [(a[key][i] - b[key][i]).abs().max().item()
                     for i in range(len(a[key]))]
    return errs


def check_layer_errors(name, errs):
    """Layers 0-1 within PLAIN_EARLY_ATOL, every layer within PLAIN_ATOL."""
    for key, per_layer in errs.items():
        for i, e in enumerate(per_layer):
            tol = PLAIN_EARLY_ATOL if i < 2 else PLAIN_ATOL
            if not e <= tol:
                raise AssertionError(f"{name}: {key} layer {i} {e} > {tol}")


def check_free_running(name, errs):
    """Every layer of a free-running plain route within FREE_RUNNING_ATOL."""
    for key, per_layer in errs.items():
        for i, e in enumerate(per_layer):
            if not e <= FREE_RUNNING_ATOL:
                raise AssertionError(f"{name}: free-running {key} layer {i} "
                                     f"{e} > {FREE_RUNNING_ATOL}")


def phase_stream(engine, cfg, sd, serve_ms):
    """Streaming on the flagship: REQUESTS requests of one stream, each
    the 6 new cameras of another synthetic frame, timed beside serve's
    mean (launches a request: K1 6, K2 9, the backbone on 6 cameras);
    then the cache filled with max_streams streams (its bytes, and the
    peak), one more stream evicting the least recently used, and
    reset_stream. Then the flagship in fp32: a stream's second request
    against infer on the concatenated 12 cameras, every decoder layer's
    raw outputs compared as in phase plain. Returns (launches, the fp32
    engine)."""
    nf = cfg.head.num_frame_cams
    l2i = synthetic_batch(cfg, seed=0)["lidar2img"]
    frames = [synthetic_batch(cfg, seed=s)["images"][:, :nf]
              for s in range(REQUESTS)]
    for s in list(engine._streams):
        engine.reset_stream(s)
    times, results, launches, peak = timed_requests(
        lambda f: engine.infer_stream(f, l2i, stream="live"),
        [(f,) for f in frames])
    check_answers("stream", results, cfg, launches,
                  {"msda_forward": MSDA_CALLS, "deform_conv_forward": DCN_CALLS},
                  same=False)
    engine.reset_stream("live")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for i in range(engine.max_streams):
        engine.infer_stream(frames[i % REQUESTS], l2i, stream=i)
    torch.cuda.synchronize()
    cache_bytes = torch.cuda.memory_allocated() - base
    cache_peak = torch.cuda.max_memory_allocated()
    engine.infer_stream(frames[0], l2i, stream="one_more")
    lru = list(engine._streams)
    resets = [engine.reset_stream("one_more"), engine.reset_stream("one_more")]
    for s in list(engine._streams):
        engine.reset_stream(s)

    cfg32 = dataclasses.replace(cfg, bf16=False)
    engine32 = Engine(cfg32, sd)
    outs, inner = [], engine32.model.forward_feats

    def recording(feats, lidar2img, generator=None, **extras):
        outs.append(inner(feats, lidar2img, generator, **extras))
        return outs[-1]

    engine32.model.forward_feats = recording
    engine32.infer_stream(frames[0], l2i, stream="a")
    engine32.infer_stream(frames[1], l2i, stream="a")
    engine32.infer(np.concatenate([frames[1], frames[0]], axis=1), l2i)
    engine32.reset_stream("a")
    del engine32.model.forward_feats
    errs = layer_errors(outs[1], outs[2])
    emit({"phase": "stream", "config": CONFIG, "requests": REQUESTS,
          "ms_per_request": times, "mean_ms": sum(times) / len(times),
          "serve_mean_ms": serve_ms, "peak_memory_bytes": peak,
          "launches": launches, "max_streams": engine.max_streams,
          "cache_bytes": cache_bytes,
          "cache_bytes_per_stream": cache_bytes / engine.max_streams,
          "peak_memory_bytes_with_cache": cache_peak,
          "lru_after_one_more": [str(x) for x in lru], "reset_stream": resets,
          "valid_detections": [int(r["valid"].sum()) for r in results],
          "fp32_vs_infer_max_abs_err_per_layer": errs})
    if lru != list(range(1, engine.max_streams)) + ["one_more"] or resets != [
            True, False]:
        raise AssertionError(f"stream cache: {lru}, resets {resets}")
    check_layer_errors("stream vs infer", errs)
    return launches, engine32


def phase_tta(engine, engine32):
    """build_tta_eval_step on the flagship: fp32, two identical copies
    against one forward, two different copies (other images and
    calibration) against the mean of their two forwards' head outputs
    (raw outputs within 1e-5; the decoded answers of the step equal the
    decode of that mean); then bf16, REQUESTS two-copy requests timed
    (launches a request: K1 12, K2 18)."""
    cfg = engine.cfg
    batches = [synthetic_batch(cfg, seed=s) for s in (0, 1)]
    images = torch.stack([torch.from_numpy(b["images"]) for b in batches]).cuda()
    l2is = torch.stack([torch.from_numpy(b["lidar2img"]) for b in batches]).cuda()
    model = engine32.model
    c = cfg.coder
    with torch.inference_mode():
        one = model(images[0], l2is[0])
        two = model(images[1], l2is[1])
        same = model.aug_forward([images[0], images[0]], l2is[0])
        mixed = model.aug_forward(list(images), l2is)
        det, _ = build_tta_eval_step(model, engine32.cfg)(images, l2is)
    mean = {k: (one[k] + two[k]) / 2.0 for k in one}
    want = decode_batch(mean, max_num=c.max_num,
                        post_center_range=c.post_center_range,
                        score_threshold=c.score_threshold)
    errs = {"identical_copies": layer_errors(same, one),
            "different_copies": layer_errors(mixed, mean)}
    det_err = {"labels_differ": int((det.labels != want.labels).sum()),
               "valid_differ": int((det.valid != want.valid).sum()),
               "scores": (det.scores - want.scores).abs().max().item()}
    step = build_tta_eval_step(engine.model, cfg)
    times, results, launches, peak = timed_requests(
        lambda: step(images, l2is), [()] * REQUESTS)
    emit({"phase": "tta", "config": CONFIG, "copies": 2, "requests": REQUESTS,
          "ms_per_request": times, "mean_ms": sum(times) / len(times),
          "peak_memory_bytes": peak, "launches": launches,
          "fp32_max_abs_err_per_layer": errs, "fp32_decoded": det_err,
          "valid_detections": [int(det.valid.sum()) for det, _ in results]})
    want_launches = dict.fromkeys(launches, 0)
    want_launches.update(msda_forward=2 * MSDA_CALLS * REQUESTS,
                         deform_conv_forward=2 * DCN_CALLS * REQUESTS)
    if launches != want_launches:
        raise AssertionError(f"tta: launch counts {launches} != {want_launches}")
    for case, per in errs.items():
        for key, per_layer in per.items():
            if not max(per_layer) <= 1e-5:
                raise AssertionError(f"tta {case}: {key} {per_layer}")
    if det_err["labels_differ"] or det_err["valid_differ"] or not (
            det_err["scores"] <= 1e-5):
        raise AssertionError(f"tta decoded: {det_err}")
    return launches


@contextlib.contextmanager
def graph_route(calls, replay=False):
    """Record each MP query graph (models/transformer.py::graph_neighbours,
    one per decoder layer) into `calls`; or, with replay, hand back the
    recorded graphs in order and yield, per call, the relative gaps
    (d_k+1 - d_k) / d_k between this route's own k-th and (k+1)-th nearest
    squared distance on the rows whose own neighbour set differs."""
    inner = transformer_mod.graph_neighbours
    recorded = iter(list(calls))
    tie_gaps = []

    def route(ref, k):
        own = inner(ref, k)
        if not replay:
            calls.append(own)
            return own
        rec = next(recorded)
        same = (own.sort(-1).values == rec.sort(-1).values).all(-1)
        d2 = ((ref[:, :, None, :] - ref[:, None, :, :]) ** 2).sum(-1)
        d2 = d2 + torch.eye(ref.shape[1], device=ref.device) * 1e9
        near = torch.topk(d2[~same], k + 1, dim=-1, largest=False).values
        tie_gaps.append(((near[:, k] - near[:, k - 1])
                         / near[:, k - 1].abs()).tolist())
        return rec

    transformer_mod.graph_neighbours = route
    try:
        yield tie_gaps
    finally:
        transformer_mod.graph_neighbours = inner


@contextlib.contextmanager
def reference_route(model, calls, replay=False):
    """Record the reference points each decoder layer of `model` is given
    into `calls`; or, with replay, give each layer the recorded ones in
    turn (a forward pre-hook on its argument 4; a recorded None leaves that
    layer its own), so that a route's own box refinement does not feed
    back into where it samples."""
    recorded = iter(list(calls))

    def hook(module, args):
        if not replay:
            calls.append(args[4])
            return None
        ref = next(recorded)
        return None if ref is None else args[:4] + (ref,) + args[5:]

    handles = [layer.register_forward_pre_hook(hook)
               for layer in model.pts_bbox_head.transformer.decoder.layers]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def compare_routes(cfg, sd, graph=False, references=False, batch=None,
                   extras=None):
    """fp32, one forward through the kernels and one through their plain
    versions from the same weights; with `graph`, the plain route replays
    the kernel route's MP query graphs; with `references`, the reference
    points each decoder layer is given (and a third, free-running plain
    route is compared too). `batch` (default synthetic_batch) and
    `extras` (the model's depth_factors / intrinsics / ida_scale) are the
    inputs. Returns (per-layer errors, launch counts per route, the
    graphs' near-tie gaps, cam_overflow per route, the free route's
    per-layer errors or None)."""
    cfg32 = dataclasses.replace(cfg, bf16=False)
    model = GraphDETR4D(cfg32)
    model.load_state_dict(sd, strict=True)
    model.eval()
    batch = synthetic_batch(cfg32, seed=0) if batch is None else batch
    images = torch.from_numpy(batch["images"]).cuda()
    l2i = torch.from_numpy(batch["lidar2img"]).cuda()
    kw = {k: torch.as_tensor(v).cuda() for k, v in (extras or {}).items()}
    routes = [("kernels", contextlib.nullcontext, False),
              ("plain", plain_kernels, True)]
    if references:
        routes.append(("plain_free", plain_kernels, None))
    outs, counts, graphs, refs, gaps = {}, {}, [], [], []
    with torch.inference_mode():
        for route, ctx, replay in routes:
            reset_launch_counts()
            gctx = (graph_route(graphs, replay) if graph and replay is not None
                    else contextlib.nullcontext([]))
            rctx = (reference_route(model, refs, replay)
                    if references and replay is not None
                    else contextlib.nullcontext())
            with ctx(), gctx as route_gaps, rctx:
                outs[route] = model(images, l2i, **kw)
            if replay:
                gaps = route_gaps
            counts[route] = {k: v for k, v in launch_counts().items() if v}
    overflow = [float(outs[r]["cam_overflow"]) for r in ("kernels", "plain")]
    free = (layer_errors(outs["kernels"], outs["plain_free"]) if references
            else None)
    return (layer_errors(outs["kernels"], outs["plain"]),
            {r: counts[r] for r in ("kernels", "plain")}, gaps, overflow, free)


def phase_serve_mp():
    """The MP config at full width (12 cameras, 640x1600, bf16), seeded
    random weights: REQUESTS requests (launches a request: K1 12, the
    centre and the 7,200-row neighbour call of each layer; K2 9); then
    phase mp_plain: fp32 kernels vs plain versions as phase variants
    compares them, the plain route also replaying the kernel route's query
    graphs, its own differing rows counted (at most MP_MAX_FLIPS a layer,
    each a near-tie within MP_TIE_RTOL). Returns the serving launches."""
    cfg = get_config(MP_CONFIG)
    sd = random_state_dict(cfg)
    batch = synthetic_batch(cfg, seed=0)
    engine = Engine(cfg, sd)
    times, results, launches, peak = timed_requests(
        engine.infer, [(batch["images"], batch["lidar2img"])] * REQUESTS)
    r = results[-1]
    emit({"phase": "serve_mp", "config": MP_CONFIG, "requests": REQUESTS,
          "ms_per_request": times, "mean_ms": sum(times) / len(times),
          "peak_memory_bytes": peak, "cam_overflow": r["cam_overflow"],
          "valid_detections": int(r["valid"].sum()), "launches": launches})
    check_answers("serve_mp", results, cfg, launches,
                  {"msda_forward": 2 * MSDA_CALLS, "deform_conv_forward": DCN_CALLS})
    del engine
    torch.cuda.empty_cache()
    errs, counts, gaps, _, free = compare_routes(cfg, sd, graph=True,
                                                 references=True)
    emit({"phase": "mp_plain", "config": MP_CONFIG, "dtype": "float32",
          "max_abs_err_per_layer": errs, "launches": counts,
          "graph_rows_differing_per_layer": [len(g) for g in gaps],
          "graph_tie_gaps_per_layer": gaps,
          "free_running_max_abs_err_per_layer": free})
    if counts != {"kernels": {"msda_forward": 2 * MSDA_CALLS,
                              "deform_conv_forward": DCN_CALLS}, "plain": {}}:
        raise AssertionError(f"mp_plain: launches per route {counts}")
    if len(gaps) != MSDA_CALLS or not all(
            len(g) <= MP_MAX_FLIPS and all(0 <= x < MP_TIE_RTOL for x in g)
            for g in gaps):
        raise AssertionError(f"mp_plain: graph rows differing per layer, with "
                             f"their relative gaps: {gaps}")
    check_layer_errors("mp_plain", errs)
    check_free_running("mp_plain", free)
    return launches


def phase_variants():
    """The plain head with DETR3D's attention (detr4d_res50) and with
    DETR3D-v2's, at full width with seeded random weights: one timed
    request each (after the engine's warm-up), its launches, and the fp32
    kernels-vs-plain check of phase plain, the plain route given the
    kernel route's reference points in every decoder layer (DETR3D
    samples one point a level of the random backbone's features, so a
    route's own refinement feeds its rounding back into where it samples:
    free running, the two routes differed by 1.7e-3 in layer 5's logits,
    PERF.md); the free-running difference is held to FREE_RUNNING_ATOL.
    Returns the summed launches."""
    total = dict.fromkeys(launch_counts(), 0)
    for name, (config, overrides, k1_calls) in VARIANTS.items():
        cfg = get_config(config, overrides)
        sd = random_state_dict(cfg)
        batch = synthetic_batch(cfg, seed=0)
        engine = Engine(cfg, sd)
        times, results, launches, peak = timed_requests(
            engine.infer, [(batch["images"], batch["lidar2img"])])
        del engine
        torch.cuda.empty_cache()
        errs, counts, _, _, free = compare_routes(cfg, sd, references=True)
        emit({"phase": "variants", "variant": name, "config": config,
              "overrides": overrides, "ms_per_request": times,
              "peak_memory_bytes": peak, "launches": launches,
              "valid_detections": int(results[0]["valid"].sum()),
              "plain_max_abs_err_per_layer": errs, "plain_launches": counts,
              "free_running_max_abs_err_per_layer": free})
        check_answers(name, results, cfg, launches,
                      {"msda_forward": k1_calls, "deform_conv_forward": DCN_CALLS})
        if counts != {"kernels": {"msda_forward": k1_calls,
                                  "deform_conv_forward": DCN_CALLS}, "plain": {}}:
            raise AssertionError(f"{name}: launches per route {counts}")
        check_layer_errors(name, errs)
        check_free_running(name, free)
        for k, v in launches.items():
            total[k] += v
        torch.cuda.empty_cache()
    return total


def final_layer(engine, batch):
    """The final decoder layer's logits and codes for one request."""
    with torch.inference_mode():
        out = engine.model(torch.as_tensor(batch["images"]).to(engine.device),
                           torch.as_tensor(batch["lidar2img"]).to(engine.device))
    return out["all_cls_scores"][-1].float(), out["all_bbox_preds"][-1].float()


def phase_serve_int8(sd, batch, ref):
    """The flagship with backbone.dcn_gather=int8, the same weights and
    requests as phase serve; `ref` is the exact path's final layer."""
    cfg = get_config(CONFIG, ["backbone.dcn_gather=int8"])
    engine = Engine(cfg, sd)  # warms up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, results = [], []
    for _ in range(REQUESTS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = engine.infer(batch["images"], batch["lidar2img"])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        results.append(r)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    fused = final_layer(engine, batch)
    # a second witness, outside the timed requests: the same int8 convs
    # through their plain version (quantize, column tile, cuBLAS matmul)
    with plain_kernels(INT8_ROUTE):
        plain = final_layer(engine, batch)
    max_num = cfg.coder.max_num
    r = results[-1]
    emit({"phase": "serve_int8", "config": CONFIG, "dcn_gather": "int8",
          "requests": REQUESTS, "ms_per_request": times,
          "mean_ms": sum(times) / len(times), "peak_memory_bytes": peak,
          "cam_overflow": r["cam_overflow"],
          "valid_detections": int(r["valid"].sum()), "launches": launches,
          "drift_vs_shift4": box_drift(ref, fused, max_num),
          "plain_int8_drift_vs_shift4": box_drift(ref, plain, max_num),
          "drift_vs_plain_int8": box_drift(plain, fused, max_num)})
    want = dict.fromkeys(launches, 0)
    want.update({k: v * REQUESTS for k, v in INT8_LAUNCHES.items()})
    if launches != want:
        raise AssertionError(f"int8 launch counts {launches} != {want}")
    if r["bboxes"].shape != (1, cfg.coder.max_num, 9):
        raise AssertionError(f"bboxes shape {r['bboxes'].shape}")
    for k in ("bboxes", "scores"):
        if not np.isfinite(r[k]).all():
            raise AssertionError(f"int8: non-finite {k}")
    if not all(np.array_equal(x["labels"], r["labels"]) for x in results):
        raise AssertionError("int8: repeated requests disagree")
    return launches


def lidar_state_dict():
    """Seeded random weights of the full-width ObjDGCNN."""
    model = ObjDGCNN(device="cpu")
    init_weights(model, seed=0)
    return model.state_dict()


def phase_lidar(sd):
    """serve.LidarEngine answers REQUESTS synthetic clouds (seeds 0..)."""
    clouds = [lidar_cloud(seed) for seed in range(REQUESTS)]
    engine = LidarEngine(sd)  # warms up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, results = [], []
    for pts, mask in clouds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = engine.infer(pts, mask)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        results.append(r)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    pts, mask = clouds[0]
    H, W = LIDAR_GRID
    pc = HeadConfig().pc_range
    ids, _ = vox_ops.pillar_features_plain(
        torch.from_numpy(pts), torch.from_numpy(mask), pc, LIDAR_GRID)
    emit({"phase": "lidar", "model": "ObjDGCNN", "grid": LIDAR_GRID,
          "points": LIDAR_POINTS, "features": LIDAR_FEATURES,
          "valid_points": int(mask.sum()),
          "in_range_points": int((ids < H * W).sum()),
          "occupied_pillars": int(torch.unique(ids[ids < H * W]).numel()),
          "requests": REQUESTS, "ms_per_request": times,
          "mean_ms": sum(times) / len(times), "peak_memory_bytes": peak,
          "valid_detections": [int(x["valid"].sum()) for x in results],
          "launches": launches})
    want = dict.fromkeys(launches, 0)
    want.update({k: v * REQUESTS for k, v in LIDAR_LAUNCHES.items()})
    if launches != want:
        raise AssertionError(f"lidar launch counts {launches} != {want}")
    for r in results:
        if r["bboxes"].shape != (1, 300, 9):
            raise AssertionError(f"lidar bboxes shape {r['bboxes'].shape}")
        for k in ("bboxes", "scores"):
            if not np.isfinite(r[k]).all():
                raise AssertionError(f"lidar: non-finite {k}")
    return engine, clouds, launches


@contextlib.contextmanager
def knn_route(calls, replay=False):
    """Record each k-NN selection of the LiDAR head (models/dgcnn.py::
    knn_farthest, two per decoder layer) into `calls`; or, with replay,
    hand back the recorded selections in order and yield, per call, the
    relative gaps (d_k - d_k+1) / |d_k| between this route's own k-th and
    (k+1)-th largest squared distance on the rows whose own selection
    would have been another set."""
    inner = dgcnn_mod.knn_farthest
    recorded = iter(list(calls))
    tie_gaps = []

    def route(x, k):
        own = inner(x, k)
        if not replay:
            calls.append(own)
            return own
        rec = next(recorded)
        same = (own.sort(-1).values == rec.sort(-1).values).all(-1)
        sq = (x * x).sum(-1)
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.matmul(
            x, x.transpose(1, 2))
        top = torch.topk(d2[~same], k + 1, dim=-1).values
        gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1].abs()
        tie_gaps.append(gap.tolist())
        return rec

    dgcnn_mod.knn_farthest = route
    try:
        yield tie_gaps
    finally:
        dgcnn_mod.knn_farthest = inner


@contextlib.contextmanager
def neighbour_max_route(calls, replay=False):
    """Record the neighbour each max over a query's k neighbours chooses
    (models/dgcnn.py::neighbour_max, two per decoder layer) into `calls`;
    or, with replay, take the recorded neighbours (a gather, so the
    gradient goes where the recorded route's went) and yield, per call, the
    relative gaps (own max - recorded value) / |own max| where this route's
    own choice would have been another neighbour."""
    inner = dgcnn_mod.neighbour_max
    recorded = iter(list(calls))
    tie_gaps = []

    def route(y):
        if not replay:
            calls.append(y.detach().argmax(dim=2, keepdim=True))
            return inner(y)
        rec = next(recorded)
        got = y.gather(2, rec).squeeze(2)
        own = inner(y.detach())
        differ = own != got.detach()
        tie_gaps.append(((own - got.detach())[differ] / own[differ].abs()).tolist())
        return got

    dgcnn_mod.neighbour_max = route
    try:
        yield tie_gaps
    finally:
        dgcnn_mod.neighbour_max = inner


def phase_lidar_plain(sd, cloud):
    """fp32 ObjDGCNN, kernels vs plain versions, every decoder layer
    compared as in phase plain. The head's k-NN picks the 16 farthest of
    900 queries, a discontinuous choice: where two distances tie within
    the routes' rounding, the two routes pick different sets and that
    query's features jump (from layer 2 on, in the first run). So the
    plain route reuses the kernel route's neighbour sets; the rows whose
    own choice would differ must be few (KNN_MAX_DIFFERING per call) and
    real near-ties (own k-th and (k+1)-th distance within KNN_TIE_RTOL),
    and the free-running difference is reported too."""
    model = ObjDGCNN()
    model.load_state_dict(sd, strict=True)
    model.eval()
    pts, mask = (torch.from_numpy(a).cuda() for a in cloud)
    outs, counts, knn = {}, {}, []
    routes = (("kernels", contextlib.nullcontext, False),
              ("plain", plain_kernels, True),
              ("plain_free", plain_kernels, None))
    with torch.inference_mode():
        for route, ctx, replay in routes:
            reset_launch_counts()
            knn_ctx = (contextlib.nullcontext([]) if replay is None
                       else knn_route(knn, replay))
            with ctx(), knn_ctx as gaps:
                outs[route] = model(pts, mask)
            if replay:
                tie_gaps = gaps
            c = launch_counts()
            counts[route] = [c[k] for k in LIDAR_LAUNCHES]
    errs = {}
    for route in ("plain", "plain_free"):
        errs[route] = {}
        for key in ("all_cls_scores", "all_bbox_preds"):
            a, b = outs["kernels"][key], outs[route][key]
            if not torch.isfinite(a).all():
                raise AssertionError(f"lidar: non-finite {key}")
            errs[route][key] = [(a[i] - b[i]).abs().max().item()
                                for i in range(len(a))]
    emit({"phase": "lidar_plain", "dtype": "float32",
          "max_abs_err_per_layer": errs["plain"],
          "knn_rows_differing_per_call": [len(g) for g in tie_gaps],
          "knn_tie_gaps_per_call": tie_gaps,
          "free_running_max_abs_err_per_layer": errs["plain_free"],
          "launches": counts})
    want = {"kernels": list(LIDAR_LAUNCHES.values()),
            "plain": [0] * len(LIDAR_LAUNCHES),
            "plain_free": [0] * len(LIDAR_LAUNCHES)}
    if counts != want:
        raise AssertionError(f"lidar launches per route {counts} != {want}")
    if len(tie_gaps) != 2 * model.head_cfg.num_decoder_layers or not all(
            len(g) <= KNN_MAX_DIFFERING and all(0 <= x < KNN_TIE_RTOL for x in g)
            for g in tie_gaps):
        raise AssertionError(f"k-NN rows differing per call, with their "
                             f"relative k-th distance gaps: {tie_gaps}")
    for key, per_layer in errs["plain"].items():
        for i, e in enumerate(per_layer):
            tol = PLAIN_EARLY_ATOL if i < 2 else PLAIN_ATOL
            if not e <= tol:
                raise AssertionError(
                    f"lidar kernel path vs plain path: {key} layer {i} "
                    f"{e} > {tol}")


def lidar_gt(cfg):
    """NUM_GT synthetic ground-truth boxes in the LiDAR range (the flagship
    batch's, seed 0; the images are left tiny, nothing reads them)."""
    b = synthetic_batch(dataclasses.replace(cfg, img_size=(32, 32)), seed=0,
                        num_gt=NUM_GT)
    return [torch.from_numpy(b[k]).cuda()
            for k in ("gt_bboxes", "gt_labels", "gt_valid")]


def relative_err(got, want):
    """max |got - want| over max |want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_lidar_grad(sd, cloud, cfg):
    """One fp32 ObjDGCNN loss and backward (core/losses.detr3d_loss on the
    head's outputs against NUM_GT synthetic boxes, as tests/
    test_lidar_seg.py feeds the JAX head into it) from the lidar phase's
    weights and first cloud, once through the kernels (K6 features,
    scatter and its backward, K1 forward and backward, K4, K5: launches
    exactly LIDAR_GRAD_LAUNCHES) and once through the plain versions
    (autograd; no launch), the plain route reusing the kernel route's k-NN
    sets as in phase lidar_plain, and its edge convs' neighbour maxima
    (the gradient of a max goes to the neighbour it chose: where the two
    routes' rounding reorders a near-tie, the choice, and with it the
    pillar layers' gradients, jump; measured on an H100, without the
    replay, 5e-4 to 1.5e-3 of their magnitude); the rows where the plain
    route's own choice would differ must be near-ties (KNN_TIE_RTOL).
    The loss within TRAIN_PLAIN_RTOL, the pillar layers' gradients (pfn,
    pfn_norm) and the global gradient norm within
    TRAIN_PLAIN_GRAD_NORM_RTOL of their magnitude; pfn's weight gradient
    finite and nonzero on the kernel route."""
    model = ObjDGCNN()
    model.load_state_dict(sd, strict=True)
    pts, mask = (torch.from_numpy(a).cuda() for a in cloud)
    gt = lidar_gt(cfg)
    losses, grads, counts, knn, maxima = {}, {}, {}, [], []
    tie_gaps = max_gaps = None
    for route, ctx, replay in (("kernels", contextlib.nullcontext, False),
                               ("plain", plain_kernels, True)):
        model.zero_grad(set_to_none=True)
        reset_launch_counts()
        with ctx(), knn_route(knn, replay) as gaps, \
                neighbour_max_route(maxima, replay) as mgaps:
            total, _ = detr3d_loss(model(pts, mask), *gt, cfg.loss,
                                   model.head_cfg)
            total.backward()
        torch.cuda.synchronize()
        if replay:
            tie_gaps, max_gaps = gaps, mgaps
        counts[route] = launch_counts()
        losses[route] = total.item()
        grads[route] = {n: p.grad.detach().clone()
                        for n, p in model.named_parameters() if p.grad is not None}
    norms = {r: torch.stack([g.norm() for g in gs.values()]).norm().item()
             for r, gs in grads.items()}
    pillar = [n for n in grads["kernels"] if n.startswith("pillar_encoder.")]
    errs = {n: relative_err(grads["kernels"][n], grads["plain"][n])
            for n in pillar}
    pfn = grads["kernels"]["pillar_encoder.pfn.weight"]
    emit({"phase": "lidar_grad", "dtype": "float32", "num_gt": NUM_GT,
          "loss": losses, "grad_norm": norms,
          "loss_rel_err": abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"]),
          "grad_norm_rel_err": abs(norms["kernels"] - norms["plain"]) / norms["plain"],
          "pillar_grad_rel_err": errs,
          "pfn_weight_grad_abs_max": pfn.abs().max().item(),
          "knn_rows_differing_per_call": [len(g) for g in tie_gaps],
          "neighbour_max_choices_differing_per_call": [len(g) for g in max_gaps],
          "neighbour_max_tie_gaps": [x for g in max_gaps for x in g],
          "launches": counts})
    want_plain = dict.fromkeys(counts["plain"], 0)
    if counts != {"kernels": {**want_plain, **LIDAR_GRAD_LAUNCHES},
                  "plain": want_plain}:
        raise AssertionError(f"lidar_grad launches per route {counts}")
    if not (torch.isfinite(pfn).all() and pfn.abs().max() > 0):
        raise AssertionError("lidar_grad: pfn.weight.grad is not finite and nonzero")
    if len(pillar) != 4 or len(grads["kernels"]) != len(grads["plain"]):
        raise AssertionError(f"lidar_grad: gradients of {pillar}")
    if not all(len(g) <= KNN_MAX_DIFFERING and all(0 <= x < KNN_TIE_RTOL for x in g)
               for g in tie_gaps):
        raise AssertionError(f"lidar_grad k-NN rows differing per call: {tie_gaps}")
    if len(max_gaps) != 2 * model.head_cfg.num_decoder_layers or not all(
            0 <= x < KNN_TIE_RTOL for g in max_gaps for x in g):
        raise AssertionError(f"lidar_grad neighbour maxima choosing otherwise: {max_gaps}")
    if not abs(losses["kernels"] - losses["plain"]) <= TRAIN_PLAIN_RTOL * abs(losses["plain"]):
        raise AssertionError(f"lidar_grad loss {losses}")
    bad = {k: e for k, e in {**errs, "grad_norm": abs(norms["kernels"] - norms["plain"])
                             / norms["plain"]}.items()
           if not e <= TRAIN_PLAIN_GRAD_NORM_RTOL}
    if bad:
        raise AssertionError(f"lidar_grad kernels vs plain, relative: {bad}")
    return counts["kernels"]


def phase_iou(engine, cloud):
    """core/iou3d.bbox_overlaps_3d on the lidar answer: the final layer's
    900 boxes against themselves, the 300 decoded boxes against 128
    ground-truth-like boxes (jittered copies of half of them, and random
    ones). Counters from 0 just before the two calls."""
    pts, mask = (torch.from_numpy(a).to(engine.device) for a in cloud)
    with torch.inference_mode():
        out = engine.model(pts, mask)
    boxes = denormalize_bbox(out["all_bbox_preds"][-1, 0].float())[:, :7]
    det = torch.from_numpy(engine.infer(*cloud)["bboxes"][0, :, :7]).to(
        engine.device)
    rng = np.random.RandomState(1)
    gt = np.concatenate([random_boxes(rng, 64, near=det.cpu().numpy()),
                         random_boxes(rng, 64)])
    gt = torch.from_numpy(gt).to(engine.device)
    boxes, det = boxes.contiguous(), det.contiguous()
    skipped = torch.zeros(2, dtype=torch.int64, device=engine.device)
    reset_launch_counts()
    ious = [iou3d.bbox_overlaps_3d(boxes, boxes, skipped=skipped[0:1]),
            iou3d.bbox_overlaps_3d(det, gt, skipped=skipped[1:2])]
    torch.cuda.synchronize()
    launches = launch_counts()
    pairs = [(boxes, boxes), (det, gt)]
    skip_counts = [int(pretest_skips(a, b).sum()) for a, b in pairs]
    errs = [(i - iou3d.bbox_overlaps_3d_plain(a, b)).abs().max().item()
            for i, (a, b) in zip(ious, pairs)]
    diag = torch.diagonal(ious[0])
    emit({"phase": "iou", "shapes": [list(i.shape) for i in ious],
          "max_abs_err_vs_plain": errs, "launches": launches,
          "self_iou_min": diag.min().item(),
          "iou_max": max(i.max().item() for i in ious),
          "pretest_skipped_share": [
              int(k) / i.numel() for k, i in zip(skipped.tolist(), ious)],
          "pretest_skips_counted": skip_counts,
          "pairs_above_0.1": [int((i > 0.1).sum()) for i in ious]})
    want = dict.fromkeys(launches, 0)
    want["iou3d"] = 2
    if launches != want:
        raise AssertionError(f"iou launch counts {launches} != {want}")
    if skipped.tolist() != skip_counts:
        raise AssertionError(f"iou: the kernel skipped {skipped.tolist()} "
                             f"pairs, its pre-test {skip_counts}")
    for i, e in zip(ious, errs):
        if not (torch.isfinite(i).all() and e <= 1e-5):
            raise AssertionError(f"iou: non-finite or {e} > 1e-5 from plain")
        # 1 up to the shoelace's rounding over absolute coordinates, ~1e-4
        # for a 1 m^2 box 50 m out, either way (tests/test_torch_iou3d.py)
        if not (i.min() >= 0 and i.max() <= 1.01):
            raise AssertionError(f"iou outside [0, 1.01]: {i.max().item()}")
    if not diag.min() > 0.99:  # a box against itself
        raise AssertionError(f"self IoU {diag.min().item()}")
    return launches


def profiled_span(fn, top=8):
    """One call of fn (after a warm-up call) under torch.profiler: its
    span between CUDA events, the device busy ms and idle share in it,
    the device kernels launched and the `top` ones by device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
    span_ms = start.elapsed_time(end)
    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    return {"span_ms": span_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / span_ms,
            "device_kernels": sum(e.count for e in events),
            "top_device_ms": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in
                              sorted(events, key=dev_us, reverse=True)[:top]]}


def phase_breakdown(engine, batch):
    """Where one request's time goes: its stages between CUDA events, and
    a torch.profiler trace of one request (device busy share of the
    request's span, top kernels by device time)."""
    model, c, dev = engine.model, engine.cfg.coder, engine.device
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        ev[0].record()
        images = torch.as_tensor(batch["images"]).to(dev)
        l2i = torch.as_tensor(batch["lidar2img"]).to(dev)
        ev[1].record()
        feats = model.extract_feats(images)
        ev[2].record()
        out = model.forward_feats(feats, l2i)
        ev[3].record()
        det = decode_batch(out, max_num=c.max_num,
                           post_center_range=c.post_center_range)
        _ = [v.cpu() for v in det]  # D2H of the detections
        ev[4].record()
        ev[4].synchronize()
    names = ("h2d", "backbone_neck", "head", "decode_d2h")
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}

    prof = profiled_span(
        lambda: engine.infer(batch["images"], batch["lidar2img"]), top=12)
    emit({"phase": "breakdown", "stages_ms": stages,
          "profiled_request_ms": prof["span_ms"],
          "device_busy_ms": prof["device_busy_ms"],
          "device_idle_share": prof["device_idle_share"],
          "top_device_ms": prof["top_device_ms"]})
    if prof["device_busy_ms"] > prof["span_ms"]:  # counted twice somewhere
        raise AssertionError(f"device busy {prof['device_busy_ms']} ms exceeds "
                             f"the request's {prof['span_ms']} ms")


KERNEL_ROUTES = ((msda_ops, "msda_forward", "msda_forward_plain"),
                 (dcn_ops, "deform_conv", "deform_conv2d_plain"),
                 (dcn_ops, "deform_conv_int8_forward", "deform_conv2d_int8_plain"),
                 (vox_ops, "pillar_features", "pillar_features_plain"),
                 (vox_ops, "pillar_scatter", "pillar_scatter_plain"),
                 (iou3d, "bbox_overlaps_3d", "bbox_overlaps_3d_plain"),
                 (focal_ops, "sigmoid_focal_loss", "sigmoid_focal_loss_plain"),
                 (lsa_ops, "hungarian_assignment",
                  "hungarian_assignment_plain"))
INT8_ROUTE = KERNEL_ROUTES[2:3]


@contextlib.contextmanager
def plain_kernels(routes=KERNEL_ROUTES):
    """Route the model's and the loss's kernel calls (those of `routes`)
    to the plain versions (autograd differentiates those, so no backward
    kernel runs either)."""
    saved = [getattr(m, k) for m, k, _ in routes]
    for m, k, plain in routes:
        setattr(m, k, getattr(m, plain))
    try:
        yield
    finally:
        for (m, k, _), fn in zip(routes, saved):
            setattr(m, k, fn)


@contextlib.contextmanager
def record_focal_inputs(calls):
    """Append ((logits, labels, weights, avg_factor), {alpha, gamma}) of
    every K5 call (whichever route is active) to `calls`."""
    inner = focal_ops.sigmoid_focal_loss

    def recording(logits, labels, weights, avg_factor, alpha=0.25, gamma=2.0):
        calls.append((tuple(t.detach().clone() for t in
                            (logits, labels, weights, avg_factor)),
                      {"alpha": alpha, "gamma": gamma}))
        return inner(logits, labels, weights, avg_factor, alpha, gamma)

    focal_ops.sigmoid_focal_loss = recording
    try:
        yield
    finally:
        focal_ops.sigmoid_focal_loss = inner


@contextlib.contextmanager
def record_assignments(calls):
    """Append (cost, num_valid, col4row) of every K4 call (whichever route
    is active) to `calls`."""
    inner = lsa_ops.hungarian_assignment

    def recording(cost, num_valid=None):
        out = inner(cost, num_valid)
        calls.append((cost.detach().clone(), num_valid, out))
        return out

    lsa_ops.hungarian_assignment = recording
    try:
        yield
    finally:
        lsa_ops.hungarian_assignment = inner


def phase_plain(cfg, sd):
    """fp32, kernels vs plain versions, every decoder layer compared:
    layers 0 and 1 within PLAIN_EARLY_ATOL, so that a kernel fault shows
    before the decoder amplifies rounding, and every layer within
    PLAIN_ATOL. The launch counts prove that each forward took the route
    it claims."""
    errs, counts, _, overflow, _ = compare_routes(cfg, sd)
    emit({"phase": "plain", "dtype": "float32",
          "max_abs_err_per_layer": errs, "launches": counts,
          "cam_overflow": overflow})
    want = {"kernels": {"msda_forward": MSDA_CALLS,
                        "deform_conv_forward": DCN_CALLS}, "plain": {}}
    if counts != want:
        raise AssertionError(f"launches per route {counts} != {want}")
    check_layer_errors("kernel path vs plain path", errs)


def train_batch(cfg):
    return synthetic_batch(cfg, seed=0, num_gt=NUM_GT)


def phase_train(cfg, sd, work_dir):
    """Trainer at full width: 1 warm-up step (its K4 and K5 calls
    recorded, for kernel_hungarian_train and kernel_focal_loss_train), then TRAIN_STEPS timed ones with the launch
    counters counted from 0 just before them."""
    batch = train_batch(cfg)
    trainer = Trainer(cfg, sd, itertools.repeat(batch), work_dir, seed=0)
    frozen = "img_backbone.conv1.weight"
    main_w = "pts_bbox_head.cls_branches.0.0.weight"
    before = {k: trainer.model.state_dict()[k].clone()
              for k in (frozen, main_w)}
    assignments, focal_inputs = [], []
    with record_assignments(assignments), record_focal_inputs(focal_inputs):
        trainer.fit(1, log_interval=1)  # warm-up: cuDNN / cuBLAS choices
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, records = [], []
    for step in range(2, TRAIN_STEPS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        records += trainer.fit(step, log_interval=1)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    after = {k: trainer.model.state_dict()[k] for k in before}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    want_step = {**dict.fromkeys(launches, 0), **STEP_LAUNCHES}
    emit({"phase": "train", "config": CONFIG, "steps": TRAIN_STEPS,
          "batch": 1, "num_gt": NUM_GT, "grid_mask": cfg.train.use_grid_mask,
          "dropout": cfg.head.dropout, "remat": cfg.backbone.remat,
          "ms_per_step": times, "mean_ms": sum(times) / len(times),
          "peak_memory_bytes": peak,
          "loss": [r["loss"] for r in records],
          "grad_norm": [r["grad_norm"] for r in records],
          "launches": launches, "launches_per_step": per_step})
    if per_step != want_step:
        raise AssertionError(f"launches per step {per_step} != {want_step}")
    for r in records:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite train metrics {r}")
    if not torch.equal(after[frozen], before[frozen]):
        raise AssertionError(f"frozen {frozen} changed")
    if torch.equal(after[main_w], before[main_w]):
        raise AssertionError(f"main-group {main_w} did not change")
    return trainer, batch, launches, assignments, focal_inputs


def phase_train_breakdown(trainer, batch):
    """Where one train step's time goes: its stages between CUDA events
    (the same work as TrainStep.step), and a torch.profiler trace of one
    Trainer step (device busy share of its span, top kernels)."""
    ts, dev = trainer.train_step, trainer.device
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    ev[0].record()
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    ev[1].record()
    for p in ts.params:
        p.grad = None
    feats = ts.model.extract_feats(b["images"], ts.generator)
    ev[2].record()
    out = ts.model.forward_feats(feats, b["lidar2img"], ts.generator)
    ev[3].record()
    total, _ = detr3d_loss(out, b["gt_bboxes"], b["gt_labels"],
                           b["gt_valid"], ts.cfg.loss, ts.cfg.head)
    ev[4].record()
    total.backward()
    ev[5].record()
    clip_by_global_norm([p.grad for p in ts.params if p.grad is not None],
                        ts.cfg.train.grad_clip_norm)
    ts.optimizer.step()
    ts.scheduler.step()
    ev[6].record()
    ev[6].synchronize()
    names = ("h2d", "backbone_neck_fwd", "head_fwd", "loss_and_matching",
             "backward", "clip_and_adamw")
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.fit(trainer.step + 1, log_interval=1)
        end.record()
        end.synchronize()
    span_ms = start.elapsed_time(end)
    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:15]
    # the port's K1 and K2 kernels in the step, whatever their rank
    ours = [e for e in events
            if any(k in e.key for k in ("msda_", "deform_conv_", "scan_kernel"))]
    emit({"phase": "train_breakdown", "stages_ms": stages,
          "profiled_step_ms": span_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / span_ms,
          "top_device_ms": [[e.key[:60], dev_us(e) / 1e3, e.count]
                            for e in top],
          "k1_k2_device_ms": [[e.key[:60], dev_us(e) / 1e3, e.count]
                              for e in sorted(ours, key=dev_us, reverse=True)]})
    if busy_ms > span_ms:
        raise AssertionError(
            f"device busy {busy_ms} ms exceeds the step's {span_ms} ms")


def assignment_cost(cost, num_valid, col4row):
    """Summed cost of each problem's solved rows."""
    total = []
    c = torch.nan_to_num(cost.float(), nan=100.0, posinf=100.0, neginf=-100.0)
    for p in range(cost.shape[0]):
        n = int(num_valid[p])
        rows = torch.arange(n, device=cost.device)
        total.append(float(c[p, rows, col4row[p, :n].long()].double().sum()))
    return total


def gt_of_query(cost, col4row):
    """(queries,) for one K4 problem, the GT box each query is assigned
    (-1 for none), named by the first row whose cost row equals the
    assigned row's: H-DETR's tiled copies of a box have identical rows, so
    a swap of two copies names the same box."""
    R, Q = cost.shape
    _, inv = torch.unique(cost, dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), R, dtype=torch.long,
                       device=cost.device)
    rows = torch.arange(R, device=cost.device)
    first.scatter_reduce_(0, inv, rows, "amin")
    out = torch.full((Q,), -1, dtype=torch.long, device=cost.device)
    solved = col4row >= 0
    out[col4row[solved].long()] = first[inv][solved]
    return out


def phase_train_plain(cfg, sd, phase="train_plain",
                      step_launches=STEP_LAUNCHES, extras=None):
    """One fp32 step (dropout 0, grid mask off) from the same weights
    through the kernels, then through the plain versions. Every K4 call
    of the step (H-DETR's one2one and one2many groups: two) is compared.
    extras: batch entries besides train_batch's (PETRv2's
    mean_time_stamp)."""
    cfg32 = fp32_step_config(cfg)
    batch = cuda_batch({**train_batch(cfg32), **(extras or {})})
    metrics, counts, calls = {}, {}, {}
    for route, ctx in (("kernels", contextlib.nullcontext),
                       ("plain", plain_kernels)):
        model = GraphDETR4D(cfg32)
        model.load_state_dict(sd, strict=True)
        step = TrainStep(model, cfg32, seed=0)
        calls[route] = []
        reset_launch_counts()
        with ctx(), record_assignments(calls[route]):
            m = step.step(batch)
        counts[route] = launch_counts()
        metrics[route] = {k: float(v) for k, v in m.items()}
        del model, step
        torch.cuda.empty_cache()
    kern, plain = metrics["kernels"], metrics["plain"]
    rel = {k: abs(kern[k] - plain[k]) / max(abs(plain[k]), 1e-12)
           for k in kern}
    differ, cost_rel, differ_gt = [], [], []
    if len(calls["kernels"]) != len(calls["plain"]):
        raise AssertionError(f"{phase}: K4 calls per route differ")
    for (ck, nk, ak), (cp, npl, ap) in zip(calls["kernels"], calls["plain"]):
        differ.append([int((ak[i] != ap[i]).sum()) for i in range(ak.shape[0])])
        # H-DETR's one2many rows are the GT tiled k times: a swap of two
        # copies of one box is an equal-cost optimum. Per query, the GT
        # box it is given
        differ_gt.append([int((gt_of_query(ck[i], ak[i])
                               != gt_of_query(cp[i], ap[i])).sum())
                          for i in range(ak.shape[0])])
        opt_k, opt_p = assignment_cost(ck, nk, ak), assignment_cost(cp, npl, ap)
        cost_rel.append([abs(a - b) / max(abs(b), 1e-12)
                         for a, b in zip(opt_k, opt_p)])
    one = len(differ) == 1  # the flagship's line keeps its shape
    emit({"phase": phase, "dtype": "float32", "metrics": metrics,
          "rel_err": rel, "launches": counts,
          "assignment_rows_differing_per_layer": differ[0] if one else differ,
          "optimum_cost_rel_err_per_layer": cost_rel[0] if one else cost_rel,
          **({} if one else {
              "queries_given_another_gt_box_per_layer": differ_gt})})
    want_plain = dict.fromkeys(counts["plain"], 0)
    want_kernels = {**want_plain, **step_launches}
    if counts != {"kernels": want_kernels, "plain": want_plain}:
        raise AssertionError(f"{phase}: launches per route {counts}")
    for k, e in rel.items():
        tol = TRAIN_PLAIN_GRAD_NORM_RTOL if k == "grad_norm" else TRAIN_PLAIN_RTOL
        if not e <= tol:
            raise AssertionError(f"{phase}: train step kernels vs plain: {k} "
                                 f"{e} > {tol}")
    for c, (dc, ec) in enumerate(zip(differ, cost_rel)):
        for i, (d, e) in enumerate(zip(dc, ec)):
            if d and not e <= 1e-5:
                raise AssertionError(
                    f"{phase}: K4 call {c} layer {i}: {d} rows assigned "
                    f"differently and optimum costs differ by {e}")
    return metrics


@contextlib.contextmanager
def record_resume(states):
    """Append a copy of the restored state to `states` whenever a Trainer
    resumes."""
    inner = Trainer.resume

    def recording(self):
        step = inner(self)
        states.append(clone_tree(self.state()))
        return step

    Trainer.resume = recording
    try:
        yield
    finally:
        Trainer.resume = inner


@contextlib.contextmanager
def record_steps(calls):
    """Append (a copy of the batch, the metrics) of every TrainStep.step
    to `calls`."""
    inner = TrainStep.step

    def recording(self, batch):
        copy = {k: v.clone() for k, v in batch.items()}
        metrics = inner(self, batch)
        calls.append((copy, metrics))
        return metrics

    TrainStep.step = recording
    try:
        yield
    finally:
        TrainStep.step = inner


def clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def trees_equal(a, b, where=""):
    """Names of the leaves where two state trees differ (tensors bitwise)."""
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [where]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [where]
        return [d for k in a for d in trees_equal(a[k], b[k], f"{where}.{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in trees_equal(x, y, f"{where}[{i}]")]
    return [] if a == b else [where]


def update_ratios(got, want, before):
    """Per floating tensor, worst first: (||got - want|| / ||want -
    before||, name, ||got - want||, ||want - before||); the ratio is 0
    where got equals want and inf where only the update is 0."""
    out = []
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        diff = float((got[k].double() - w.double()).norm())
        upd = float((w.double() - before[k].double()).norm())
        ratio = diff / upd if upd else (0.0 if diff == 0 else float("inf"))
        out.append((ratio, k, diff, upd))
    return sorted(out, reverse=True)


def update_bounds_broken(diffs):
    """The bounds a resumed step's update_ratios break: 'all' (over all
    weights) and 'tensor' (in some tensor); the ratio over all weights."""
    num = sum(d * d for _, _, d, _ in diffs) ** 0.5
    den = sum(u * u for _, _, _, u in diffs) ** 0.5
    whole = num / den
    broken = (["all"] if not whole <= DATA_UPDATE_RTOL else []) + (
        ["tensor"] if not diffs[0][0] <= DATA_TENSOR_UPDATE_RTOL else [])
    return broken, whole


def step_with_restore_fault(trainer, saved, batch, fault):
    """Load `saved` into the trainer, plant a restore fault in its AdamW
    state, take one step on `batch`; returns the weights after it."""
    ts = trainer.train_step
    opt = clone_tree(saved["optimizer"])
    if fault == "adamw_step_plus_one":
        for st in opt["state"].values():
            st["step"] = st["step"] + 1
    elif fault == "one_tensor_moments_zeroed":
        params = [p for g in ts.optimizer.param_groups for p in g["params"]]
        target = dict(trainer.model.named_parameters())[RESTORE_FAULT_TENSOR]
        st = opt["state"][next(i for i, p in enumerate(params) if p is target)]
        st["exp_avg"].zero_()
        st["exp_avg_sq"].zero_()
    else:
        raise ValueError(fault)
    trainer.model.load_state_dict(saved["state_dict"], strict=True)
    ts.optimizer.load_state_dict(opt)
    ts.scheduler.load_state_dict(clone_tree(saved["scheduler"]))
    ts.generator.set_state(saved["generators"]["train"].cpu())
    ts.step(batch)
    return clone_tree(trainer.model.state_dict())


def read_log(work_dir):
    with open(f"{work_dir}/train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def tta_calibration_errors(ann_file, cfg):
    """The TTA copies' lidar2img from build_batch against _tta_ida's
    composition written out here (crop centred in x, from the bottom in
    y, composed in float64): max |difference| per copy."""
    s = NuScenesSweepDataset(ann_file, test_mode=True).sample(0)
    H, W = cfg.img_size
    b = data_pipeline.build_batch([s], cfg.img_size, src_hw=DATA_SRC_HW,
                                  tta_resize_mults=TTA_MULTS)
    p = data_pipeline.sample_ida_params(
        np.random.RandomState(0), DATA_SRC_HW, cfg.img_size, training=False)
    errs = []
    for a, m in enumerate(TTA_MULTS):
        r = p.resize * m
        newW, newH = int(DATA_SRC_HW[1] * r), int(DATA_SRC_HW[0] * r)
        cw, ch = int(max(0, newW - W) / 2), max(0, newH - H)
        crop = p.crop if a == 0 else (cw, ch, cw + W, ch + H)
        ida = data_pipeline.IdaAugParams(
            resize=p.resize if a == 0 else r, crop=crop, flip=False).ida_mat()
        ida4 = np.eye(4)
        ida4[:2, :2], ida4[:2, 2] = ida[:2, :2], ida[:2, 2]
        want = np.stack([(ida4 @ l).astype(np.float32) for l in s["lidar2img"]])
        errs.append(float(np.abs(b["lidar2img"][a, 0] - want).max()))
    return errs


def native_vs_python(ann_file, cfg):
    """The native loader's eval batch against the python path's: the route
    that ran and the mean |difference| of the normalized images (None
    where the loader did not build here, with the reason)."""
    if not native_loader.available():
        return {"route": "python (native loader unavailable: "
                f"{native_loader.unavailable_reason()})", "mean_abs_diff": None}
    s = NuScenesSweepDataset(ann_file, test_mode=True).sample(0)
    py = data_pipeline.build_batch([s], cfg.img_size, src_hw=DATA_SRC_HW)
    nat = data_pipeline.build_batch([s], cfg.img_size, src_hw=DATA_SRC_HW,
                                    use_native=True)
    return {"route": "native (libjpeg, C++ threads)",
            "mean_abs_diff": float(np.abs(nat["images"] - py["images"]).mean())}


def phase_data(cfg):
    """The data pipeline, checkpoints and the train / test CLIs at the
    flagship's full width, from JPEG frames at the source size."""
    decoder = "cv2" if importlib.util.find_spec("cv2") else "PIL"
    if importlib.util.find_spec(decoder) is None:
        raise AssertionError("no JPEG decoder (cv2 or PIL) for the pipeline")
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ann, encoder = write_nuscenes_fixture(
            f"{tmp}/nusc", DATA_SAMPLES, DATA_SRC_HW, seed=0)
        fixture_s = time.perf_counter() - t0
        wd = f"{tmp}/work"
        common = ["--config", CONFIG, "--ann-file", ann, "--work-dir", wd,
                  "--load-interval", "1", "--log-interval", "1",
                  "--ckpt-every", "2", "--seed", "0"]
        # train: 3 steps, a checkpoint at 2 and at the end, one profiled
        reset_launch_counts()
        t0 = time.perf_counter()
        first = train_cli.main(common + ["--total-steps", "3",
                                         "--profile-steps", "1"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = launch_counts()
        log = read_log(wd)
        prof = first.profile_summary
        saved = clone_tree(first.state())
        # resume to 4: the restored state, and the step it takes
        restored, steps = [], []
        with record_resume(restored), record_steps(steps):
            second = train_cli.main(common + ["--total-steps", "4",
                                              "--resume"])
        (batch, resumed_metrics), = steps
        # the in-memory trainer's step on the resumed run's batch
        mem_metrics = first.train_step.step(batch)
        resumed_loss = float(resumed_metrics["loss"])
        mem_loss = float(mem_metrics["loss"])
        # per tensor: the resumed step against the in-memory one, over
        # that tensor's own update; then the same step with each restore
        # fault planted
        before, want = saved["state_dict"], first.model.state_dict()
        update_diffs = update_ratios(second.model.state_dict(), want, before)
        update_broken, update_rel = update_bounds_broken(update_diffs)
        fault_diffs = {
            fault: update_ratios(step_with_restore_fault(
                second, saved, batch, fault), want, before)
            for fault in ("adamw_step_plus_one", "one_tensor_moments_zeroed")}
        fault_broken = {f: update_bounds_broken(d)
                        for f, d in fault_diffs.items()}
        differing = trees_equal(restored[0], saved) if restored else ["none"]
        ckpts = sorted(os.listdir(f"{wd}/checkpoints"))
        del first, second, saved, restored, steps, batch
        gc.collect()
        torch.cuda.empty_cache()

        # test: from the checkpoint dir, from a reference-layout .pth, and
        # with the submission written
        test_common = ["--config", CONFIG, "--ann-file", ann]
        sd = test_cli.load_checkpoint(f"{wd}/checkpoints")
        pth = f"{tmp}/reference_layout.pth"
        torch.save({"state_dict": sd, "meta": {"step": 4}}, pth)
        runs, test_launches = {}, {}
        for name, extra in (
                ("checkpoint_dir", ["--checkpoint", f"{wd}/checkpoints"]),
                ("reference_pth", ["--checkpoint", pth]),
                ("format_nusc", ["--checkpoint", pth, "--format-nusc",
                                 f"{tmp}/nusc_out", "--out",
                                 f"{tmp}/results.json"]),
                ("tta", ["--checkpoint", pth, "--max-samples", "1",
                         "--tta-resizes", ",".join(map(str, TTA_MULTS))])):
            reset_launch_counts()
            t0 = time.perf_counter()
            runs[name] = test_cli.main(test_common + extra)
            torch.cuda.synchronize()
            runs[name]["seconds"] = time.perf_counter() - t0
            test_launches[name] = launch_counts()
        with open(f"{tmp}/nusc_out/results_nusc.json") as f:
            submission = json.load(f)
        tta_errs = tta_calibration_errors(ann, cfg)
        native = native_vs_python(ann, cfg)
    gc.collect()

    train_steps = [r for r in log if "loss" in r]
    per_step = {k: v / 3 for k, v in train_launches.items()}
    want_step = {**dict.fromkeys(train_launches, 0), **STEP_LAUNCHES}
    test_run = runs["checkpoint_dir"]
    timing = test_run["timing"]
    per_request = {name: {k: v / len(runs[name]["results"])
                          for k, v in c.items() if v}
                   for name, c in test_launches.items()}
    data_launches = {k: train_launches[k] + sum(c[k] for c in test_launches.values())
                     for k in train_launches}
    emit({
        "phase": "data", "seconds": time.perf_counter() - phase_t0,
        "config": CONFIG, "samples": DATA_SAMPLES,
        "source_hw": DATA_SRC_HW, "cameras": cfg.head.num_cams,
        "img_size": cfg.img_size, "jpeg_encoder": encoder,
        "jpeg_decoder": decoder, "native_loader": native,
        "fixture_seconds": fixture_s,
        "train": {
            "seconds_3_steps": train_s,
            "loss": [r["loss"] for r in train_steps],
            "iter_time_s": [r["iter_time"] for r in train_steps],
            "steps_per_s": [1.0 / r["iter_time"] for r in train_steps],
            "host_ms_per_sample": [1e3 * r["data_time"] for r in train_steps],
            "h2d_ms": [r.get("h2d_ms") for r in train_steps],
            "h2d_bytes": [r["h2d_bytes"] for r in train_steps],
            "launches_per_step": per_step, "checkpoints": ckpts,
            "resumed_loss": resumed_loss, "in_memory_loss": mem_loss,
            "resumed_state_differing": differing,
            "update_rel_diff": update_rel,
            "update_rel_diff_worst": [list(w) for w in update_diffs[:8]],
            "restore_faults_update_rel_diff": {
                fault: {"all": fault_broken[fault][1],
                        "broken": fault_broken[fault][0], "worst": list(d[0]),
                        "least_of_updated": min(r for r, _, _, u in d if u),
                        RESTORE_FAULT_TENSOR: next(
                            r for r, k, *_ in d if k == RESTORE_FAULT_TENSOR)}
                for fault, d in fault_diffs.items()},
            "profiled_step": prof,
        },
        "test": {
            name: {"seconds": r["seconds"], "mAP": r["metrics"]["mAP"],
                   "NDS": r["metrics"]["NDS"], "cam_overflow": r["cam_overflow"],
                   "launches_per_request": per_request[name]}
            for name, r in runs.items()},
        "test_timing": {
            "host_ms_per_sample": timing["host_ms"],
            "h2d_ms": timing.get("h2d_ms"), "h2d_bytes": timing["h2d_bytes"],
            "forward_ms": timing.get("forward_ms"),
            "samples_per_s": len(test_run["results"]) / test_run["seconds"]},
        "tta_calibration_max_abs_err": tta_errs,
        "submission_samples": len(submission["results"]),
    })
    if per_step != want_step:
        raise AssertionError(f"data: train launches per step {per_step} != "
                             f"{want_step}")
    if len(train_steps) != 3 or not all(np.isfinite(r["loss"])
                                        for r in train_steps):
        raise AssertionError(f"data: train log {train_steps}")
    if ckpts != ["step_00000002.pth", "step_00000003.pth", "step_00000004.pth"]:
        raise AssertionError(f"data: checkpoints {ckpts}")
    if differing:
        raise AssertionError(f"data: restored state differs at {differing[:8]}")
    if resumed_loss != mem_loss:
        raise AssertionError(f"data: resumed loss {resumed_loss} != the "
                             f"in-memory state's {mem_loss}")
    if update_broken:
        raise AssertionError(f"data: the resumed step's update differs from "
                             f"the in-memory step's ({update_broken}): "
                             f"{update_rel} over all, {update_diffs[:4]}")
    for fault, (broken, whole) in fault_broken.items():
        if not broken:
            raise AssertionError(f"data: the check cannot see the restore "
                                 f"fault {fault}: {whole} over all, "
                                 f"{fault_diffs[fault][:4]}")
    want_req = {"msda_forward": MSDA_CALLS, "deform_conv_forward": DCN_CALLS}
    want_tta = {k: v * len(TTA_MULTS) for k, v in want_req.items()}
    for name, r in runs.items():
        want = want_tta if name == "tta" else want_req
        if per_request[name] != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"data: test {name} launches per request "
                                 f"{per_request[name]} != {want}")
        if any(o != 0 for o in r["cam_overflow"]):
            raise AssertionError(f"data: test {name} cam_overflow "
                                 f"{r['cam_overflow']}")
        if len(r["results"]) != (1 if name == "tta" else DATA_SAMPLES):
            raise AssertionError(f"data: test {name} answered "
                                 f"{len(r['results'])} samples")
        for res in r["results"]:
            if not all(np.isfinite(res[k]).all() for k in ("boxes", "scores")):
                raise AssertionError(f"data: test {name} non-finite answer")
    for name in ("reference_pth", "format_nusc"):
        if runs[name]["results"] != test_run["results"]:
            raise AssertionError(f"data: test {name} answers differ from the "
                                 "checkpoint directory's")
    if len(submission["results"]) != DATA_SAMPLES:
        raise AssertionError(f"data: submission holds "
                             f"{len(submission['results'])} samples")
    if max(tta_errs) != 0.0:
        raise AssertionError(f"data: TTA calibrations {tta_errs}")
    if native["mean_abs_diff"] is not None and \
            not native["mean_abs_diff"] < NATIVE_MEAN_ABS:
        raise AssertionError(f"data: native loader differs by "
                             f"{native['mean_abs_diff']}")
    return data_launches


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def counts_since(before):
    """Launches since the snapshot `before` (a launch_counts() dict)."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def zero_camera_gate(sd):
    """A copy of sd with every decoder layer's camera-gate projection 0,
    the JAX init's value: each camera's gate is then 0.5 for every query."""
    return {k: torch.zeros_like(v) if "cam_attention_weights" in k else v
            for k, v in sd.items()}


def hdetr_isolation(cfg, sd, batch):
    """fp32: the H-DETR model's one2one outputs against the flagship's on
    the same batch, the flagship given the same weights and the first
    num_query rows of the query embedding. With the seeded random camera
    gate the two differ: the gate's reference quirk (a (B, Q, N) view read
    as (B, N, Q)) mixes queries, so a query's gate depends on how many
    queries there are. With the gate zeroed (as the JAX init leaves it)
    the group mask isolates the groups: held to phase plain's bounds.
    Returns (errors with the random gate, errors with the zeroed gate,
    cam_overflow per model)."""
    flag = dataclasses.replace(get_config(CONFIG), bf16=False)
    cfg32 = dataclasses.replace(cfg, bf16=False)
    q1, key = cfg.head.num_query, "pts_bbox_head.query_embedding.weight"
    images = torch.from_numpy(batch["images"]).cuda()
    l2i = torch.from_numpy(batch["lidar2img"]).cuda()
    errs, overflow = {}, {}
    for gate in ("random", "zeroed"):
        hsd = sd if gate == "random" else zero_camera_gate(sd)
        fsd = {**hsd, key: hsd[key][:q1]}
        outs = {}
        for name, c, w in (("hdetr", cfg32, hsd), ("flagship", flag, fsd)):
            model = GraphDETR4D(c)
            model.load_state_dict(w, strict=True)
            model.eval()
            reset_launch_counts()
            with torch.inference_mode():
                outs[name] = model(images, l2i)
            counts = {k: v for k, v in launch_counts().items() if v}
            if counts != {"msda_forward": MSDA_CALLS,
                          "deform_conv_forward": DCN_CALLS}:
                raise AssertionError(f"hdetr isolation {name}: launches {counts}")
            overflow[f"{gate}_{name}"] = float(outs[name]["cam_overflow"])
            del model
        errs[gate] = layer_errors(outs["hdetr"], outs["flagship"])
        del outs
        torch.cuda.empty_cache()
    return errs["random"], errs["zeroed"], overflow


def phase_hdetr():
    """H-DETR (the flagship plus a one2many group of 1,800 queries) at full
    width, bf16, seeded random weights: HDETR_REQUESTS requests through
    serve.Engine (K1 6, K2 9, cam_overflow 0 at K = 1,350 a camera), the
    fp32 one2one isolation check (hdetr_isolation), 1 + HDETR_TRAIN_STEPS
    Trainer steps with NUM_GT boxes (a step: K1 6 / 6, K2 9 / 9, K4 2, K5
    2), and one fp32 step through the kernels against the plain versions
    (phase train_plain's bounds, both groups' assignments). Returns the
    launches of the requests and the timed steps."""
    t0 = time.perf_counter()
    cfg = get_config(HDETR_CONFIG)
    sd = random_state_dict(cfg)
    batch = synthetic_batch(cfg, seed=0)
    engine = Engine(cfg, sd)
    times, results, launches, peak = timed_requests(
        engine.infer, [(batch["images"], batch["lidar2img"])] * HDETR_REQUESTS)
    del engine
    torch.cuda.empty_cache()
    check_answers("hdetr", results, cfg, launches,
                  {"msda_forward": MSDA_CALLS, "deform_conv_forward": DCN_CALLS})
    overflow = [r["cam_overflow"] for r in results]
    if any(overflow):
        raise AssertionError(f"hdetr: cam_overflow {overflow}")
    random_gate, zeroed_gate, iso_overflow = hdetr_isolation(cfg, sd, batch)

    with tempfile.TemporaryDirectory() as work_dir:
        trainer = Trainer(cfg, sd, itertools.repeat(train_batch(cfg)),
                          work_dir, seed=0)
        trainer.fit(1, log_interval=1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        step_ms, records = [], []
        for step in range(2, HDETR_TRAIN_STEPS + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            records += trainer.fit(step, log_interval=1)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        train_launches = launch_counts()
        train_peak = torch.cuda.max_memory_allocated()
        trainer.close()
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {k: v / HDETR_TRAIN_STEPS for k, v in train_launches.items()}
    emit({"phase": "hdetr", "config": HDETR_CONFIG,
          "requests": HDETR_REQUESTS, "ms_per_request": times,
          "mean_ms": sum(times) / len(times), "peak_memory_bytes": peak,
          "cam_overflow": overflow,
          "valid_detections": int(results[-1]["valid"].sum()),
          "launches": launches,
          "isolation_random_gate_max_abs_err_per_layer": random_gate,
          "isolation_zeroed_gate_max_abs_err_per_layer": zeroed_gate,
          "isolation_cam_overflow": iso_overflow,
          "train_steps": HDETR_TRAIN_STEPS, "num_gt": NUM_GT,
          "ms_per_step": step_ms, "mean_step_ms": sum(step_ms) / len(step_ms),
          "train_peak_memory_bytes": train_peak,
          "loss": [r["loss"] for r in records],
          "o2m_loss_cls": [r["o2m.loss_cls"] for r in records],
          "grad_norm": [r["grad_norm"] for r in records],
          "train_launches_per_step": per_step})
    if any(iso_overflow.values()):
        raise AssertionError(f"hdetr isolation: cam_overflow {iso_overflow}")
    check_layer_errors("hdetr one2one vs flagship (gate zeroed)", zeroed_gate)
    want_step = {**dict.fromkeys(train_launches, 0), **HDETR_STEP_LAUNCHES}
    if per_step != want_step:
        raise AssertionError(f"hdetr: launches per step {per_step} != {want_step}")
    for r in records:
        if "o2m.loss_cls" not in r or not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"hdetr: train metrics {r}")
    phase_train_plain(cfg, sd, phase="hdetr_train_plain",
                      step_launches=HDETR_STEP_LAUNCHES)
    torch.cuda.empty_cache()
    emit({"phase": "hdetr_done", "seconds": time.perf_counter() - t0})
    return add_counts(dict(launches), train_launches)


def camaware_batch(cfg, tmp):
    """One eval batch of a nuScenes-layout fixture (data/fixture.py, 6 +
    6 JPEGs at DATA_SRC_HW) through the port's pipeline, with its real
    intrinsics and ida_scale, and depth_factors from the pipeline's
    scale-aware resize (data/pipeline.py::scale_aware_resize) of those
    intrinsics at the batch's image scale."""
    ann, _ = write_nuscenes_fixture(f"{tmp}/nusc", 1, DATA_SRC_HW, seed=1)
    s = NuScenesSweepDataset(ann, test_mode=True,
                             max_gt=cfg.loss.max_gt).sample(0, temporal=True)
    b = data_pipeline.build_batch(
        [s], cfg.img_size, training=False,
        img_norm=(cfg.img_mean, cfg.img_std, cfg.img_bgr))
    scale = float(b["ida_scale"][0, 0]) / np.sqrt(2.0)  # |ida00|
    _, _, depth_factors, _ = data_pipeline.scale_aware_resize(
        [np.zeros((8, 8, 3), np.uint8)], b["lidar2img"][0],
        b["intrinsics"][0], scale)
    b["depth_factors"] = depth_factors[:1]
    return b


def cam_coord_record(batch, img_hw):
    """cam_coord_channels at the flagship's 4 FPN levels of one request:
    CUDA-event ms, its peak bytes above the baseline, and the bytes of the
    image-size grid JAX builds before its resize."""
    k = torch.as_tensor(batch["intrinsics"]).cuda()
    args = (k[..., 0, 0], k[..., 1, 1], k[..., 0, 2], k[..., 1, 2])

    def run():
        return [cam_coord_channels(h, w, *img_hw, *args)
                for h, w in MSDA_LEVELS]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    B, N = k.shape[:2]
    return {"ms": cuda_ms(run, 20), "peak_bytes": peak,
            "output_bytes": sum(o.numel() * 4 for o in out),
            "jax_full_grid_bytes_per_level": B * N * img_hw[0] * img_hw[1]
            * out[0].shape[-1] * 4}


def phase_camaware():
    """The camera-aware configs at full width, bf16, seeded random weights
    each, on one fixture batch (camaware_batch): one request each (K1 6,
    K2 9, cam_overflow 0); fp32 kernels vs plain on CAMAWARE_PLAIN (phase
    plain's bounds); one bf16 TrainStep step on CAMAWARE_TRAIN (loss
    finite; K1 6 / 6, K2 9 / 9, K4 1, K5 1); cam_coord_channels' ms and
    peak bytes; and the ResNet-18 student served once (K1 6, K2 0).
    Returns the launches of the requests and the train steps."""
    t0 = time.perf_counter()
    total = dict.fromkeys(launch_counts(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        batch = camaware_batch(get_config(CAMAWARE_CONFIGS[0]), tmp)
    ident = np.eye(4, dtype=np.float32)
    if np.allclose(batch["intrinsics"], ident) or np.allclose(
            batch["ida_scale"], 1.0) or int(batch["gt_valid"].sum()) == 0:
        raise AssertionError("camaware: identity extras or no GT in the batch")
    records = {}
    for name in CAMAWARE_CONFIGS:
        cfg = get_config(name)
        sd = random_state_dict(cfg)
        extras = {n: batch[n] for n, _ in extras_spec(cfg, 1)}
        engine = Engine(cfg, sd)
        times, results, launches, peak = timed_requests(
            engine.infer, [(batch["images"], batch["lidar2img"],
                            list(extras.values()))])
        del engine
        torch.cuda.empty_cache()
        check_answers(name, results, cfg, launches,
                      {"msda_forward": MSDA_CALLS,
                       "deform_conv_forward": DCN_CALLS})
        if results[0]["cam_overflow"]:
            raise AssertionError(f"{name}: cam_overflow "
                                 f"{results[0]['cam_overflow']}")
        add_counts(total, launches)
        rec = {"extras": list(extras), "ms_per_request": times,
               "peak_memory_bytes": peak, "launches": launches,
               "valid_detections": int(results[0]["valid"].sum())}
        if name in CAMAWARE_PLAIN:
            # every extra the model reads: the camconv gate takes the
            # intrinsics in process, though an artifact of that config
            # (as the JAX export's) has no intrinsics input. The plain
            # route replays the kernel route's reference points, as phase
            # variants does: on this batch a free-running route's own
            # refinement fed its rounding back to 1.28e-3 in layer 5's
            # logits (PERF.md); the free-running route is held to
            # FREE_RUNNING_ATOL
            errs, counts, _, ov, free = compare_routes(
                cfg, sd, references=True, batch=batch, extras={
                    k: batch[k] for k in ("intrinsics", "ida_scale",
                                          "depth_factors")})
            rec.update(plain_max_abs_err_per_layer=errs, plain_launches=counts,
                       plain_cam_overflow=ov,
                       free_running_max_abs_err_per_layer=free)
            if counts != {"kernels": {"msda_forward": MSDA_CALLS,
                                      "deform_conv_forward": DCN_CALLS},
                          "plain": {}}:
                raise AssertionError(f"{name}: launches per route {counts}")
            check_layer_errors(name, errs)
            check_free_running(name, free)
        if name in CAMAWARE_TRAIN:
            model = GraphDETR4D(cfg)
            model.load_state_dict(sd, strict=True)
            step = TrainStep(model, cfg, seed=0)
            dev = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            start = time.perf_counter()
            m = {k: float(v) for k, v in step.step(dev).items()}
            torch.cuda.synchronize()
            counts = launch_counts()
            rec.update(train_loss=m["loss"], train_grad_norm=m["grad_norm"],
                       train_step_s=time.perf_counter() - start,
                       train_peak_memory_bytes=torch.cuda.max_memory_allocated(),
                       train_launches=counts)
            del model, step, dev
            torch.cuda.empty_cache()
            add_counts(total, counts)
            if counts != {**dict.fromkeys(counts, 0), **STEP_LAUNCHES}:
                raise AssertionError(f"{name}: train launches {counts}")
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"{name}: train metrics {m}")
        records[name] = rec
    coord = cam_coord_record(batch, get_config(CAMAWARE_CONFIGS[2]).img_size)

    cfg = get_config(R18_CONFIG)
    sd = random_state_dict(cfg)
    r18 = synthetic_batch(cfg, seed=0)
    engine = Engine(cfg, sd)
    times, results, launches, peak = timed_requests(
        engine.infer, [(r18["images"], r18["lidar2img"])])
    del engine
    torch.cuda.empty_cache()
    check_answers(R18_CONFIG, results, cfg, launches,
                  {"msda_forward": MSDA_CALLS})
    add_counts(total, launches)
    records[R18_CONFIG] = {"ms_per_request": times, "peak_memory_bytes": peak,
                           "launches": launches,
                           "cam_overflow": results[0]["cam_overflow"]}
    emit({"phase": "camaware", "configs": records,
          "batch_intrinsics_fx": batch["intrinsics"][0, :, 0, 0].tolist(),
          "batch_ida_scale": batch["ida_scale"][0].tolist(),
          "batch_depth_factors": batch["depth_factors"].tolist(),
          "cam_coord_channels": coord,
          "seconds": time.perf_counter() - t0})
    return total


def http_json(det):
    """An in-process answer as the server's JSON (json round trip)."""
    return json.loads(json.dumps(serve_cli.detections_json(det)))


def phase_http(cfg, sd):
    """The flagship exported twice by tools/export_model.py (default float
    input; --uint8-input --streaming), both verified on the card, served
    in process by tools/serve.py on port 0 (--ready-file): float /infer
    requests (K1 6, K2 9 a request), uint8 /infer requests on the
    streaming artifact (K1 6, K2 18: its halves are encoded separately),
    /infer_stream requests of 6 new cameras (K1 6, K2 9) and
    /reset_stream; answers bit-equal to in-process Engine.infer; the
    bench client at concurrency 1 and 2 on each route; concurrent answers
    bit-equal to serial ones; a float body refused by the uint8 artifact
    with 400, the server serving on; /healthz's served equal to the
    requests answered. Returns the launches of every HTTP request."""
    t0 = time.perf_counter()
    nf = cfg.head.num_frame_cams
    u8cfg = dataclasses.replace(cfg, device_normalize=True)
    floats = [synthetic_batch(cfg, seed=s) for s in range(HTTP_FLOAT_REQUESTS)]
    u8s = [synthetic_batch(u8cfg, seed=s) for s in range(HTTP_UINT8_REQUESTS)]
    with tempfile.TemporaryDirectory() as tmp:
        pth = f"{tmp}/weights.pth"
        torch.save({"state_dict": sd}, pth)
        dirs, export_s = {}, {}
        for name, flags in (("float", []),
                            ("uint8_stream", ["--uint8-input", "--streaming"])):
            dirs[name] = f"{tmp}/{name}"
            start = time.perf_counter()
            export_cli.main(["--config", CONFIG, "--checkpoint", pth,
                             "--out", dirs[name], *flags])
            export_s[name] = time.perf_counter() - start
        servers, urls, ready_ports = {}, {}, {}
        for name, d in dirs.items():
            ready = f"{tmp}/{name}.ready"
            srv, engine, thread = serve_cli.serve_in_thread(
                ["--artifact", d, "--port", "0", "--ready-file", ready])
            servers[name] = (srv, engine, thread)
            urls[name] = f"http://127.0.0.1:{srv.server_address[1]}"
            with open(ready) as f:
                ready_ports[name] = int(f.read())
            if ready_ports[name] != srv.server_address[1]:
                raise AssertionError(f"http: ready file {ready_ports[name]}")
        answered = dict.fromkeys(dirs, 0)

        def post(name, route, body, want=200):
            status, answer = serve_cli.post(urls[name] + route, body)
            if status != want:
                raise AssertionError(f"http {name}{route}: {status} {answer}")
            answered[name] += status == 200 and route.startswith("/infer")
            return answer

        def body(b, n_cams=None):
            images = b["images"] if n_cams is None else b["images"][:, :n_cams]
            return serve_cli.npz_body(images=images, lidar2img=b["lidar2img"])

        torch.cuda.synchronize()
        reset_launch_counts()
        per_route, ms = {}, {}
        for route, name, reqs, n_cams, path in (
                ("float_infer", "float", floats, None, "/infer"),
                ("uint8_infer", "uint8_stream", u8s, None, "/infer"),
                ("stream", "uint8_stream", u8s, nf, "/infer_stream?stream=car")):
            before, answers, ms[route] = launch_counts(), [], []
            for b in reqs:
                data = body(b, n_cams)
                start = time.perf_counter()
                answers.append(post(name, path, data))
                ms[route].append(1e3 * (time.perf_counter() - start))
            per_route[route] = (answers, counts_since(before))
        reset_answer = post("uint8_stream", "/reset_stream?stream=car", b"")
        bench = {}
        for route, name, extra in (("float_infer", "float", []),
                                   ("uint8_infer", "uint8_stream", []),
                                   ("stream", "uint8_stream", ["--stream"])):
            for conc in (1, 2):
                bench[f"{route}_c{conc}"] = serve_cli.main(
                    ["--bench", urls[name], "--requests",
                     str(HTTP_BENCH_REQUESTS), "--concurrency", str(conc),
                     *extra])
                answered[name] += HTTP_BENCH_REQUESTS
        bodies = [body(b) for b in floats]
        with ThreadPoolExecutor(2) as pool:
            parallel = list(pool.map(lambda d: post("float", "/infer", d),
                                     bodies * 2))
        refused = post("uint8_stream", "/infer", bodies[0], want=400)
        after_refusal = post("uint8_stream", "/infer", body(u8s[0]))
        launches = launch_counts()
        health = {name: serve_cli.get(url + "/healthz")[1]
                  for name, url in urls.items()}
        # in process, on the servers' own engines, after the counted traffic
        direct = {
            "float_infer": [http_json(servers["float"][1].infer(
                b["images"], b["lidar2img"])) for b in floats],
            "uint8_infer": [http_json(servers["uint8_stream"][1].infer(
                b["images"], b["lidar2img"])) for b in u8s]}
        for srv, engine, thread in servers.values():
            srv.shutdown()
            thread.join(60)
        del servers, engine
        gc.collect()
        torch.cuda.empty_cache()
    want = {"float_infer": {"msda_forward": MSDA_CALLS,
                            "deform_conv_forward": DCN_CALLS},
            "uint8_infer": {"msda_forward": MSDA_CALLS,
                            "deform_conv_forward": 2 * DCN_CALLS},
            "stream": {"msda_forward": MSDA_CALLS,
                       "deform_conv_forward": DCN_CALLS}}
    emit({"phase": "http", "config": CONFIG, "export_s": export_s,
          "ready_ports": ready_ports, "ms_per_request": ms,
          "launches_per_route": {r: c for r, (_, c) in per_route.items()},
          "bench": bench, "healthz": health, "answered": answered,
          "reset_stream": reset_answer, "refused_float_body": refused,
          "seconds": time.perf_counter() - t0})
    for route, (answers, counts) in per_route.items():
        n = len(answers)
        w = {**dict.fromkeys(counts, 0),
             **{k: v * n for k, v in want[route].items()}}
        if counts != w:
            raise AssertionError(f"http {route}: launches {counts} != {w}")
        for a in answers:
            d, = a["detections"]
            if not (d["scores"] and np.isfinite(d["bboxes"]).all()):
                raise AssertionError(f"http {route}: empty or non-finite answer")
        if route in direct and answers != direct[route]:
            raise AssertionError(f"http {route}: HTTP answers differ from "
                                 "in-process Engine.infer")
    if parallel != per_route["float_infer"][0] * 2:
        raise AssertionError("http: concurrent answers differ from serial ones")
    if reset_answer != {"reset": True} or not after_refusal["detections"]:
        raise AssertionError(f"http: reset {reset_answer}")
    served = {name: h["served"] for name, h in health.items()}
    if served != answered:
        raise AssertionError(f"http: /healthz served {served} != {answered}")
    return launches


def timed_train_steps(step_fn, batch, steps, warmup=True):
    """A warm-up call of step_fn(batch) (unless the caller made one), then
    `steps` calls timed by CUDA events, with the launches and the peak
    memory counted from just before them. Returns (ms per step, float
    metrics per step, launches, peak bytes)."""
    if warmup:
        step_fn(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, metrics = [], []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m = step_fn(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    return times, metrics, launch_counts(), torch.cuda.max_memory_allocated()


def check_step_launches(name, launches, steps, want_per_step):
    want = {**dict.fromkeys(launches, 0),
            **{k: v * steps for k, v in want_per_step.items()}}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != {want}")


def check_finite_metrics(name, metrics):
    for m in metrics:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name}: non-finite metrics {m}")


def phase_backbones():
    """VoVNet V-99-eSE and MobileNetV2 at full width, bf16, seeded random
    weights: detr4d_vovnet_deform (12 x 640x1600, the flagship's head)
    answers BACKBONE_REQUESTS requests (K1 6, K2 0, cam_overflow 0), its
    fp32 kernels vs plain as phase variants (the reference points
    replayed; free running within FREE_RUNNING_ATOL), its backbone and
    neck profiled (device busy share, kernels launched, top kernels), one
    timed TrainStep step (K1 6 / 6, K4 1, K5 1); detr4d_vovnet (the plain
    head, DETR3D attention) answers one request; the MobileNetV2 student
    (12 x 320x800) one request and one train step. Returns the summed
    launches."""
    t0 = time.perf_counter()
    total = dict.fromkeys(launch_counts(), 0)
    records = {}
    for name, requests, plain, train in (
            (VOVNET_CONFIG, BACKBONE_REQUESTS, True, True),
            (VOVNET_PLAIN_HEAD_CONFIG, 1, False, False),
            (M2_CONFIG, 1, False, True)):
        cfg = get_config(name)
        sd = random_state_dict(cfg)
        batch = synthetic_batch(cfg, seed=0)
        engine = Engine(cfg, sd)
        times, results, launches, peak = timed_requests(
            engine.infer, [(batch["images"], batch["lidar2img"])] * requests)
        check_answers(name, results, cfg, launches,
                      {"msda_forward": MSDA_CALLS})
        overflow = [r["cam_overflow"] for r in results]
        if any(overflow):
            raise AssertionError(f"{name}: cam_overflow {overflow}")
        add_counts(total, launches)
        rec = {"backbone": cfg.vovnet_spec if cfg.backbone_type == "vovnet"
               else cfg.backbone_type, "img_size": list(cfg.img_size),
               "ms_per_request": times, "mean_ms": sum(times) / len(times),
               "peak_memory_bytes": peak, "cam_overflow": overflow,
               "launches": launches,
               "valid_detections": int(results[-1]["valid"].sum())}
        if plain:
            images = torch.as_tensor(batch["images"]).cuda()
            model = engine.model

            def backbone_neck():
                with torch.inference_mode():
                    model.extract_feats(images)

            rec["backbone_neck_profile"] = profiled_span(backbone_neck)
        del engine
        torch.cuda.empty_cache()
        if plain:
            errs, counts, _, ov, free = compare_routes(cfg, sd, references=True)
            rec.update(plain_max_abs_err_per_layer=errs, plain_launches=counts,
                       plain_cam_overflow=ov,
                       free_running_max_abs_err_per_layer=free)
            if counts != {"kernels": {"msda_forward": MSDA_CALLS}, "plain": {}}:
                raise AssertionError(f"{name}: launches per route {counts}")
            check_layer_errors(name, errs)
            check_free_running(name, free)
        if train:
            model = GraphDETR4D(cfg)
            model.load_state_dict(sd, strict=True)
            step = TrainStep(model, cfg, seed=0)
            dev = {k: torch.as_tensor(v).cuda()
                   for k, v in train_batch(cfg).items()}
            ms, metrics, counts, tpeak = timed_train_steps(step.step, dev, 1)
            del model, step, dev
            torch.cuda.empty_cache()
            check_step_launches(name, counts, 1, NO_DCN_STEP_LAUNCHES)
            check_finite_metrics(name, metrics)
            add_counts(total, counts)
            rec.update(train_ms=ms, train_loss=metrics[0]["loss"],
                       train_grad_norm=metrics[0]["grad_norm"],
                       train_peak_memory_bytes=tpeak, train_launches=counts)
        records[name] = rec
    emit({"phase": "backbones", "configs": records,
          "seconds": time.perf_counter() - t0})
    return total


def distill_models(bundle, fix=lambda c: c):
    """(teacher, Distiller, student config, DistillConfig) of a bundle on
    the card with seeded random weights (the teacher seed 0, the
    Distiller seed 1, as the distill CLI draws them); `fix` maps each
    model config to the one to build."""
    t_cfg, s_cfg = fix(bundle.teacher), fix(bundle.student)
    teacher = GraphDETR4D(t_cfg, device="cpu")
    init_weights(teacher, 0)
    dist = Distiller(s_cfg, t_cfg.neck.out_channels, device="cpu")
    init_weights(dist, 1)
    return (teacher.cuda(), dist.cuda(), s_cfg,
            distill_train_cli.distill_config(bundle))


def backbone_name(cfg):
    return {"vovnet": cfg.vovnet_spec, "mobilenetv2": "MobileNetV2"}.get(
        cfg.backbone_type, f"ResNet-{cfg.backbone.depth}")


def distill_batch(bundle, cfg=None):
    """The step's batch, made from the teacher's config as the distill
    CLI makes it, NUM_GT boxes, on the card."""
    b = synthetic_batch(cfg or bundle.teacher, seed=0, num_gt=NUM_GT)
    return {k: torch.as_tensor(v).cuda() for k, v in b.items()}


def distill_split_step(step, batch, split):
    """One DistillStep step with its phases between CUDA events: teacher
    forward, student forward and loss, backward and AdamW (ms appended to
    `split`); also the student's and the guided decode's cam_overflow."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    t_feats, t_outs = step.teacher_forward(batch)
    ev[1].record()
    total, metrics, s_outs = step.student_loss(batch, t_feats, t_outs)
    ev[2].record()
    metrics["grad_norm"] = step.update(total)
    ev[3].record()
    ev[3].synchronize()
    split.append({n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(
        ("teacher_forward", "student_forward_loss", "backward_adamw"))})
    metrics["cam_overflow"] = torch.as_tensor(s_outs["cam_overflow"])
    if "cam_overflow_guided" in s_outs:
        metrics["cam_overflow_guided"] = torch.as_tensor(
            s_outs["cam_overflow_guided"])
    return {k: v.detach() for k, v in metrics.items()}


def distill_plain(bundle):
    """One fp32 distill step (dropout 0, grid mask off) from the same
    weights through the kernels, then through the plain versions: every
    loss within TRAIN_PLAIN_RTOL, grad_norm within
    TRAIN_PLAIN_GRAD_NORM_RTOL, and each K4 call's assignments identical
    or, where the two routes' rounding picks another optimum, at the same
    summed cost within 1e-5 (phase train_plain's rule), the differing rows
    counted."""
    fp32 = fp32_step_config
    batch = distill_batch(bundle, fp32(bundle.teacher))
    metrics, counts, calls = {}, {}, {}
    for route, ctx in (("kernels", contextlib.nullcontext),
                       ("plain", plain_kernels)):
        teacher, dist, s_cfg, dcfg = distill_models(bundle, fp32)
        step = DistillStep(teacher, dist, s_cfg, dcfg, seed=0)
        calls[route] = []
        reset_launch_counts()
        with ctx(), record_assignments(calls[route]):
            m = step.step(batch)
        counts[route] = launch_counts()
        metrics[route] = {k: float(v) for k, v in m.items()}
        del teacher, dist, step
        torch.cuda.empty_cache()
    kern, plain = metrics["kernels"], metrics["plain"]
    rel = {k: abs(kern[k] - plain[k]) / max(abs(plain[k]), 1e-12)
           for k in kern}
    differ, cost_rel = [], []
    if len(calls["kernels"]) != len(calls["plain"]):
        raise AssertionError("distill_plain: K4 calls per route differ")
    for (ck, nk, ak), (cp, npl, ap) in zip(calls["kernels"], calls["plain"]):
        nk = torch.full((ck.shape[0],), ck.shape[1]) if nk is None else nk
        npl = torch.full((cp.shape[0],), cp.shape[1]) if npl is None else npl
        differ.append([int((ak[i] != ap[i]).sum()) for i in range(ak.shape[0])])
        opt_k, opt_p = assignment_cost(ck, nk, ak), assignment_cost(cp, npl, ap)
        cost_rel.append([abs(a - b) / max(abs(b), 1e-12)
                         for a, b in zip(opt_k, opt_p)])
    rec = {"dtype": "float32", "metrics": metrics, "rel_err": rel,
           "launches": counts,
           "k4_shapes": [list(c.shape) for c, _, _ in calls["kernels"]],
           "assignment_rows_differing": differ,
           "optimum_cost_rel_err": cost_rel}
    want_plain = dict.fromkeys(counts["plain"], 0)
    if counts != {"kernels": {**want_plain, **MIX_STEP_LAUNCHES},
                  "plain": want_plain}:
        raise AssertionError(f"distill_plain: launches per route {counts}")
    for k, e in rel.items():
        tol = TRAIN_PLAIN_GRAD_NORM_RTOL if k == "grad_norm" else TRAIN_PLAIN_RTOL
        if not e <= tol:
            raise AssertionError(f"distill_plain: {k} {e} > {tol}")
    for c, (dc, ec) in enumerate(zip(differ, cost_rel)):
        for i, (d, e) in enumerate(zip(dc, ec)):
            if d and not e <= 1e-5:
                raise AssertionError(
                    f"distill_plain: K4 call {c} problem {i}: {d} rows "
                    f"assigned differently and optimum costs differ by {e}")
    return rec


def kernel_hungarian_distill(dev, calls, square):
    """K4 at the distill shapes against its plain version (identical
    assignments): the step's own soft matching, (B x 6 stages x 2,
    student and guided decode) problems of 64 teacher rows by 900 student
    queries, and one 900 x 900 problem of the same step with every
    teacher row (--teacher-top-k 0). Kernel ms (CUDA events) and plain
    ms (one call)."""
    out = {}
    for label, cost in (("top_k", calls), ("all_rows", square)):
        nv = torch.full((cost.shape[0],), cost.shape[1], dtype=torch.int32,
                        device=dev)
        rec = hungarian_record(cost.to(dev), nv)
        t0 = time.perf_counter()
        lsa_ops.hungarian_assignment_plain(cost.to(dev), nv)
        torch.cuda.synchronize()
        rec["plain_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["shape"] = list(cost.shape)
        rec.pop("device_ms_per_call")
        out[label] = rec
        emit({"phase": "kernels", "kernel": f"hungarian_distill_{label}", **rec})
        if rec["mismatches"]:
            raise AssertionError(f"hungarian at the distill shape {label}: {rec}")
    return out


def distill_step_record(name, bundle, steps, want_per_step):
    """`steps` timed steps of a bundle (after a warm-up), bf16, split into
    their phases; launches, peak, metrics, cam_overflow of the student's
    and the guided decode's queries (must be 0). Returns (record,
    launches, the warm-up step's K4 calls)."""
    teacher, dist, s_cfg, dcfg = distill_models(bundle)
    step = DistillStep(teacher, dist, s_cfg, dcfg, seed=0)
    batch = distill_batch(bundle)
    split, warm_calls = [], []
    with record_assignments(warm_calls):
        distill_split_step(step, batch, split)
    ms, metrics, launches, peak = timed_train_steps(
        lambda b: distill_split_step(step, b, split), batch, steps,
        warmup=False)
    check_step_launches(name, launches, steps, want_per_step)
    check_finite_metrics(name, metrics)
    overflow = [(m["cam_overflow"], m.get("cam_overflow_guided", 0.0))
                for m in metrics]
    if any(a or b for a, b in overflow):
        raise AssertionError(f"{name}: cam_overflow (student, guided) {overflow}")
    split = split[1:]
    mean_split = {k: sum(s[k] for s in split) / len(split) for k in split[0]}
    rec = {"teacher": backbone_name(bundle.teacher),
           "student": backbone_name(bundle.student),
           "img_size": list(bundle.student.img_size), "mix": dcfg.mix,
           "feat": dcfg.use_feat_distill, "reweight_score": dcfg.reweight_score,
           "teacher_top_k": dcfg.teacher_top_k, "ms_per_step": ms,
           "mean_ms": sum(ms) / len(ms), "split_ms": mean_split,
           "teacher_share": mean_split["teacher_forward"] / sum(
               mean_split.values()),
           "peak_memory_bytes": peak, "launches_per_step": {
               k: v / steps for k, v in launches.items()},
           "metrics": metrics, "cam_overflow_student_guided": overflow}
    square = None
    if name == DISTILL_BUNDLE:
        # the same step's soft matching with every teacher row
        every = []
        with torch.no_grad(), record_assignments(every):
            full = DistillStep(teacher, dist, s_cfg, dataclasses.replace(
                dcfg, teacher_top_k=None), seed=0)
            t_feats, t_outs = full.teacher_forward(batch)
            full.student_loss(batch, t_feats, t_outs)
        square = next(c for c, _, _ in every if c.shape[1] == c.shape[2])[:1]
    del teacher, dist, step, batch
    torch.cuda.empty_cache()
    distill_calls = next(c for c, nv, _ in warm_calls if nv is None)
    return rec, launches, distill_calls, square


def distill_clis():
    """tools.distill_train.main --synthetic --steps 2 on DISTILL_CLI_BUNDLE
    (K1 18 / 12, K2 9, K4 2, K5 1 a step), then tools.distill_test.main on
    the student checkpoint it saved (2 synthetic samples: K1 6 each, K2 0).
    Returns (record, launches)."""
    with tempfile.TemporaryDirectory() as wd:
        reset_launch_counts()
        t0 = time.perf_counter()
        _, records = distill_train_cli.main(
            ["--config", DISTILL_CLI_BUNDLE, "--synthetic", "--steps", "2",
             "--log-interval", "1", "--work-dir", wd])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = launch_counts()
        check_step_launches("distill_train CLI", train_launches, 2,
                            {**MIX_STEP_LAUNCHES})
        reset_launch_counts()
        t0 = time.perf_counter()
        out = distill_test_cli.main(
            ["--config", DISTILL_CLI_BUNDLE, "--checkpoint",
             os.path.join(wd, "checkpoints"), "--max-samples", "2"])
        test_s = time.perf_counter() - t0
        test_launches = launch_counts()
    check_step_launches("distill_test CLI", test_launches, 2,
                        {"msda_forward": MSDA_CALLS})
    check_finite_metrics("distill_train CLI", records)
    if any(out["cam_overflow"]) or len(out["results"]) != 2:
        raise AssertionError(f"distill_test CLI: {out['cam_overflow']}")
    rec = {"train_s": train_s, "train_records": records,
           "train_launches": train_launches, "test_s": test_s,
           "test_metrics": {k: v for k, v in out["metrics"].items()
                            if not isinstance(v, dict)},
           "test_launches": test_launches}
    return rec, add_counts(dict(train_launches), test_launches)


def phase_distill(dev):
    """Teacher -> student distillation at full width, seeded random
    weights, bf16: DISTILL_STEPS timed steps of DISTILL_BUNDLE
    (MixDistill R50-DCN -> R18 at 12 x 320x800, vanilla feature
    distillation, reweight_score, top-k 64) split into teacher forward,
    student forward and loss, backward and AdamW (launches a step
    MIX_STEP_LAUNCHES, cam_overflow 0 for the student's and the guided
    decode's queries); distill_plain on it; K4 at its distill shapes
    against the plain version (kernel_hungarian_distill); one step of
    the MobileNetV2 student's bundle and of R50 -> R50 at 640x1600 (K2
    backward on the student); the distill CLIs chained. Returns
    (launches, K4's distill records)."""
    t0 = time.perf_counter()
    total = dict.fromkeys(launch_counts(), 0)
    records = {}
    for name, steps, want in (
            (DISTILL_BUNDLE, DISTILL_STEPS, MIX_STEP_LAUNCHES),
            (DISTILL_M2_BUNDLE, 1, MIX_STEP_LAUNCHES),
            (DISTILL_R50_BUNDLE, 1, R50_DISTILL_STEP_LAUNCHES)):
        bundle = get_distill_config(name)
        rec, launches, calls, square = distill_step_record(name, bundle,
                                                           steps, want)
        add_counts(total, launches)
        if name == DISTILL_BUNDLE:
            hungarian = kernel_hungarian_distill(dev, calls, square)
            rec["distill_plain"] = distill_plain(bundle)
        records[name] = rec
        torch.cuda.empty_cache()
    records["clis"], cli_launches = distill_clis()
    add_counts(total, cli_launches)
    emit({"phase": "distill", "bundles": records,
          "seconds": time.perf_counter() - t0})
    return total, hungarian


def petr_extras(cfg):
    """The serving extras of a config (serve.extras_spec), each at its
    placeholder value (synth_extra: mean_time_stamp 0.5 s)."""
    return [synth_extra(n, shape) for n, shape in extras_spec(cfg, 1)]


def petr_train_extras(cfg, maps=False):
    """A train batch's extras: mean_time_stamp for the temporal heads and,
    with `maps`, lane targets patchified from a seeded synthetic map of
    SEG_MAP_HW (blobs of each of the 3 channels)."""
    extras = {n: v for (n, _), v in zip(extras_spec(cfg, 1), petr_extras(cfg))}
    if maps:
        rng = np.random.RandomState(0)
        m = np.zeros((3, *SEG_MAP_HW), np.float32)
        for c in range(3):
            for _ in range(12):
                y, x = rng.randint(0, SEG_MAP_HW[0] - 40, 2)
                m[c, y:y + rng.randint(4, 40), x:x + rng.randint(4, 40)] = 1.0
        extras["maps"] = maps_to_patches(m)[None]
    return extras


def petr_serve(name, requests, want):
    """`requests` timed requests of a config through serve.Engine (seeded
    random weights, its extras), launches exactly `want` a request,
    cam_overflow 0. Returns (cfg, weights, engine, batch, extras, record,
    launches)."""
    cfg = get_config(name)
    sd = random_state_dict(cfg)
    batch = synthetic_batch(cfg, seed=0)
    extras = petr_extras(cfg)
    engine = Engine(cfg, sd)
    level0 = []  # the head's level-0 grid (B, N, H, W, C): its keys
    hook = engine.model.pts_bbox_head.input_proj.register_forward_hook(
        lambda m, a, out: level0.append(tuple(out.shape)))
    times, results, launches, peak = timed_requests(
        engine.infer, [(batch["images"], batch["lidar2img"], extras)] * requests)
    hook.remove()
    check_answers(name, results, cfg, launches, want)
    overflow = [r["cam_overflow"] for r in results]
    if any(overflow):
        raise AssertionError(f"{name}: cam_overflow {overflow}")
    _, N, Hf, Wf, _ = level0[0]
    rec = {"img_size": list(cfg.img_size), "cameras": N,
           "level0_hw": [Hf, Wf], "attention_keys": N * Hf * Wf,
           "extras": [n for n, _ in extras_spec(cfg, 1)],
           "ms_per_request": times, "mean_ms": sum(times) / len(times),
           "peak_memory_bytes": peak, "launches": launches,
           "valid_detections": int(results[-1]["valid"].sum())}
    return cfg, sd, engine, batch, extras, rec, launches


def petr_request_split(engine, batch, extras):
    """One request's device ms by CUDA events: backbone and neck
    (extract_feats), head (forward_feats), inside the head the dense
    cross-attention of every decoder layer (events around each
    `attentions[1]`), and the decode; the head's and the attention's
    shares of the request."""
    model = engine.model
    images = torch.as_tensor(batch["images"]).cuda()
    l2i = torch.as_tensor(batch["lidar2img"]).cuda()
    mts = torch.as_tensor(extras[0]).cuda()
    spans = []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    layers = model.pts_bbox_head.transformer.decoder.layers
    handles = [h for layer in layers for h in (
        layer.attentions[1].register_forward_pre_hook(
            lambda m, a: spans.append([event()])),
        layer.attentions[1].register_forward_hook(
            lambda m, a, o: spans[-1].append(event())))]
    try:
        with torch.inference_mode():
            e0 = event()
            feats = model.extract_feats(images)
            e1 = event()
            out = model.forward_feats(feats, l2i, mean_time_stamp=mts)
            e2 = event()
            engine._answer(out)
            e3 = event()
        e3.synchronize()
    finally:
        for h in handles:
            h.remove()
    total = e0.elapsed_time(e3)
    head = e1.elapsed_time(e2)
    attn = sum(a.elapsed_time(b) for a, b in spans)
    return {"backbone_neck_ms": e0.elapsed_time(e1), "head_ms": head,
            "cross_attention_ms": attn, "decode_ms": e2.elapsed_time(e3),
            "total_ms": total, "head_share": head / total,
            "attention_share": attn / total,
            "attention_share_of_head": attn / head}


def petr_stream(engine, cfg, sd, batch, extras):
    """Engine.infer_stream on the main config: 2 requests of one stream,
    each a frame's 6 new cameras (no launches: VoVNet), then in fp32 a
    stream's second request against infer on the concatenated 12
    cameras, every decoder layer within phase plain's bounds. Returns
    (record, launches)."""
    nf = cfg.head.num_frame_cams
    l2i = batch["lidar2img"]
    frames = [synthetic_batch(cfg, seed=s)["images"][:, :nf] for s in (1, 2)]
    times, results, launches, _ = timed_requests(
        lambda f: engine.infer_stream(f, l2i, extras, stream="live"),
        [(f,) for f in frames])
    check_answers("petr stream", results, cfg, launches, {}, same=False)
    engine.reset_stream("live")
    engine32 = Engine(dataclasses.replace(cfg, bf16=False), sd)
    outs, inner = [], engine32.model.forward_feats

    def recording(feats, lidar2img, generator=None, **kw):
        outs.append(inner(feats, lidar2img, generator, **kw))
        return outs[-1]

    engine32.model.forward_feats = recording
    engine32.infer_stream(frames[0], l2i, extras, stream="a")
    engine32.infer_stream(frames[1], l2i, extras, stream="a")
    engine32.infer(np.concatenate([frames[1], frames[0]], axis=1), l2i, extras)
    errs = layer_errors(outs[1], outs[2])
    del engine32, outs
    torch.cuda.empty_cache()
    check_layer_errors("petr stream vs infer", errs)
    return {"ms_per_request": times, "launches": launches,
            "fp32_vs_infer_max_abs_err_per_layer": errs}, launches


def petr_train_step(name, cfg, sd, want, maps=False):
    """One timed bf16 TrainStep step (after a warm-up step), with the
    config's extras (and lane targets with `maps`): launches exactly
    `want`, finite metrics. Returns (record, launches)."""
    model = GraphDETR4D(cfg)
    model.load_state_dict(sd, strict=True)
    step = TrainStep(model, cfg, seed=0)
    dev = {k: torch.as_tensor(v).cuda()
           for k, v in {**train_batch(cfg),
                        **petr_train_extras(cfg, maps)}.items()}
    ms, metrics, counts, peak = timed_train_steps(step.step, dev, 1)
    del model, step, dev
    torch.cuda.empty_cache()
    check_step_launches(name, counts, 1, want)
    check_finite_metrics(name, metrics)
    if maps and not metrics[0].get("loss_mask", 0.0) > 0.0:
        raise AssertionError(f"{name}: no lane loss in {metrics[0]}")
    return {"train_ms": ms, "train_metrics": metrics[0],
            "train_peak_memory_bytes": peak, "train_launches": counts}, counts


def petr_attention_reference(dev, cfg, keys):
    """One PETR decoder layer's dense cross-attention of `cfg`'s head at
    `keys` keys (900 queries, 8 heads of 32 on every PETR config), bf16:
    the port's plain route
    (models/transformer.py::MultiheadAttention, fp32 logits and softmax)
    timed by CUDA events, its core (QK^T, softmax, AV) alone, and off the
    path one F.scaled_dot_product_attention call on the same projected
    q, k, v; the core against SDPA (max abs error, bf16 output); the
    least time of the function (q, k, v and the output moved once, QK^T
    and AV at the bf16 tensor peak) and the fp32 logits' bytes."""
    C, heads, Q = cfg.head.embed_dims, cfg.head.num_heads, cfg.head.num_query
    hd = C // heads
    g = torch.Generator(device=dev).manual_seed(0)
    mha = MultiheadAttention(C, heads, 0.0).to(dev)
    init_weights(mha, seed=0)
    bf = torch.bfloat16
    query = torch.randn(1, Q, C, generator=g, device=dev).to(bf)
    memory = torch.randn(1, keys, C, generator=g, device=dev).to(bf)
    key = memory + torch.randn(1, keys, C, generator=g, device=dev).to(bf)
    w, b = mha.in_proj_weight.to(bf), mha.in_proj_bias.to(bf)

    def proj(x, i):
        y = torch.nn.functional.linear(x, w[i * C:(i + 1) * C],
                                       b[i * C:(i + 1) * C])
        return y.view(1, -1, heads, hd).transpose(1, 2).contiguous()

    with torch.inference_mode():
        qh, kh, vh = proj(query, 0), proj(key, 1), proj(memory, 2)

        def core():
            logits = ((qh / hd ** 0.5) @ kh.transpose(-1, -2)).float()
            return torch.softmax(logits, dim=-1).to(bf) @ vh

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)

        layer_ms = cuda_ms(lambda: mha(query, key, memory), 5)
        core_ms = cuda_ms(core, 5)
        sdpa_ms = cuda_ms(sdpa, 5)
        err = (core().float() - sdpa().float()).abs().max().item()
    moved = 2 * (qh.numel() + kh.numel() + vh.numel() + qh.numel())
    flops = 2 * 2 * heads * Q * keys * hd
    bound_ms = 1e3 * max(moved / PEAK_BYTES_PER_S, flops / PEAK_BF16_TENSOR_FLOPS)
    return {"keys": keys, "queries": Q, "heads": heads, "head_dim": hd,
            "layer_ms": layer_ms, "core_ms": core_ms, "sdpa_ms": sdpa_ms,
            "core_vs_sdpa_max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16_TENSOR_FLOPS
            > moved / PEAK_BYTES_PER_S else "bytes",
            "fp32_logits_bytes": 4 * heads * Q * keys}


def petr_generic_decoder(dev):
    """The generic deformable decoder (models/detr_decoder.py), fp32,
    seeded random weights: DECODER_QUERIES queries, DECODER_LAYERS layers
    over MSDA_LEVELS, 2-d reference points scaled by valid_ratios, once
    through K1 (a launch a layer) and once through its plain version (no
    launch), every layer's output within PLAIN_EARLY_ATOL; each route
    timed. Returns (record, the kernel route's launches)."""
    C = 256
    dec = Deformable3DDetrTransformerDecoder(
        embed_dims=C, num_layers=DECODER_LAYERS, num_heads=8,
        num_levels=len(MSDA_LEVELS), num_points=4, ffn_dims=512)
    init_weights(dec, seed=0)
    dec = dec.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    query, query_pos = (torch.randn(1, DECODER_QUERIES, C, generator=g,
                                    device=dev) for _ in range(2))
    values = [torch.randn(1, h, w, C, generator=g, device=dev)
              for h, w in MSDA_LEVELS]
    ref = torch.rand(1, DECODER_QUERIES, 2, generator=g, device=dev)
    ratios = 0.8 + 0.2 * torch.rand(1, len(MSDA_LEVELS), 2, generator=g,
                                    device=dev)

    def run():
        return dec(query, query_pos, values, ref, valid_ratios=ratios)

    outs, counts, ms = {}, {}, {}
    with torch.inference_mode():
        for route, ctx in (("kernels", contextlib.nullcontext),
                           ("plain", plain_kernels)):
            with ctx():
                reset_launch_counts()
                outs[route] = run()[0]
                counts[route] = {k: v for k, v in launch_counts().items() if v}
                ms[route] = cuda_ms(run, 3)
    errs = [(a - b).abs().max().item()
            for a, b in zip(outs["kernels"], outs["plain"])]
    rec = {"queries": DECODER_QUERIES, "layers": DECODER_LAYERS,
           "levels": MSDA_LEVELS, "tokens": sum(h * w for h, w in MSDA_LEVELS),
           "max_abs_err_per_layer": errs, "launches": counts,
           "ms": ms["kernels"], "plain_ms": ms["plain"]}
    del dec, values
    torch.cuda.empty_cache()
    if counts != {"kernels": {"msda_forward": DECODER_LAYERS}, "plain": {}}:
        raise AssertionError(f"generic decoder: launches per route {counts}")
    if not all(np.isfinite(e) and e <= PLAIN_EARLY_ATOL for e in errs):
        raise AssertionError(f"generic decoder: kernels vs plain {errs}")
    return rec, counts["kernels"]


def petr_http(name, sd):
    """tools/export_model.py on a PETRv2 config (verified on the card with
    its mean_time_stamp), served in process by tools/serve.py: one /infer
    request with mean_time_stamp (K2 9) answered as in-process
    Engine.infer answers it, and one without it refused with 400.
    Returns (record, launches)."""
    cfg = get_config(name)
    b = synthetic_batch(cfg, seed=1)
    extras = petr_extras(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        pth, d = f"{tmp}/weights.pth", f"{tmp}/artifact"
        torch.save({"state_dict": sd}, pth)
        start = time.perf_counter()
        manifest = export_cli.main(["--config", name, "--checkpoint", pth,
                                    "--out", d])
        export_s = time.perf_counter() - start
        srv, engine, thread = serve_cli.serve_in_thread(
            ["--artifact", d, "--port", "0"])
        url = f"http://127.0.0.1:{srv.server_address[1]}/infer"
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            start = time.perf_counter()
            status, answer = serve_cli.post(url, serve_cli.npz_body(
                images=b["images"], lidar2img=b["lidar2img"],
                mean_time_stamp=extras[0]))
            ms = 1e3 * (time.perf_counter() - start)
            launches = launch_counts()
            refused, error = serve_cli.post(url, serve_cli.npz_body(
                images=b["images"], lidar2img=b["lidar2img"]))
            direct = http_json(engine.infer(b["images"], b["lidar2img"],
                                            extras))
        finally:
            srv.shutdown()
            thread.join(60)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    rec = {"config": name, "extras": manifest["extras"],
           "platforms": manifest["platforms"], "export_s": export_s,
           "ms": ms, "launches": launches, "status": status,
           "refused_without_mean_time_stamp": [refused, error]}
    check_step_launches("petr http", launches, 1, PETR_DCN)
    if (status != 200 or answer != direct or manifest["extras"]
            != ["mean_time_stamp"] or refused != 400):
        raise AssertionError(f"petr http: {rec}")
    return rec, launches


def phase_petr(dev):
    """The PETR family at full width, seeded random weights, bf16 (see the
    docstring's phase 17). Returns the summed launches."""
    t0 = time.perf_counter()
    total = dict.fromkeys(launch_counts(), 0)
    records = {}
    # the main config: served, split, profiled, streamed, trained
    cfg, sd, engine, batch, extras, rec, launches = petr_serve(
        PETR_MAIN, PETR_REQUESTS, {})
    add_counts(total, launches)
    rec["split"] = petr_request_split(engine, batch, extras)
    rec["profile"] = profiled_span(lambda: engine.infer(
        batch["images"], batch["lidar2img"], extras))
    rec["stream"], launches = petr_stream(engine, cfg, sd, batch, extras)
    add_counts(total, launches)
    del engine
    torch.cuda.empty_cache()
    step, launches = petr_train_step(PETR_MAIN, cfg, sd, PETR_STEP)
    rec.update(step)
    add_counts(total, launches)
    records[PETR_MAIN] = rec
    main_cfg, keys = cfg, rec["attention_keys"]
    del sd
    # R50-DCN under PETRv2: served, kernels vs plain, trained (bf16, then
    # one fp32 step on each route)
    cfg, sd, engine, batch, extras, rec, launches = petr_serve(
        PETR_R50, PETR_REQUESTS, PETR_DCN)
    add_counts(total, launches)
    del engine
    torch.cuda.empty_cache()
    errs, counts, _, overflow, _ = compare_routes(
        cfg, sd, extras={"mean_time_stamp": extras[0]})
    rec.update(petr_plain_max_abs_err_per_layer=errs,
               petr_plain_launches=counts)
    if counts != {"kernels": PETR_DCN, "plain": {}}:
        raise AssertionError(f"petr_plain: launches per route {counts}")
    check_layer_errors("petr_plain", errs)
    step, launches = petr_train_step(PETR_R50, cfg, sd, PETR_DCN_STEP)
    rec.update(step)
    add_counts(total, launches)
    rec["train_plain"] = phase_train_plain(
        cfg, sd, phase="petr_train_plain", step_launches=PETR_DCN_STEP,
        extras=petr_train_extras(cfg))
    torch.cuda.empty_cache()
    records[PETR_R50] = rec
    rec["http"], launches = petr_http(PETR_R50, sd)
    add_counts(total, launches)
    del sd
    # PETRv1 over a CPFPN and over the raw C5: one request each
    for name in PETR_V1:
        _, _, engine, _, _, rec, launches = petr_serve(name, 1, PETR_DCN)
        add_counts(total, launches)
        records[name] = rec
        del engine
        torch.cuda.empty_cache()
    # PETR-seg: served, one step with the lane loss
    cfg, sd, engine, _, _, rec, launches = petr_serve(PETR_SEG, 1, {})
    add_counts(total, launches)
    del engine
    torch.cuda.empty_cache()
    step, launches = petr_train_step(PETR_SEG, cfg, sd, PETR_STEP, maps=True)
    rec.update(step)
    add_counts(total, launches)
    records[PETR_SEG] = rec
    del sd
    records["generic_decoder"], launches = petr_generic_decoder(dev)
    add_counts(total, launches)
    records["attention_reference"] = petr_attention_reference(dev, main_cfg,
                                                              keys)
    emit({"phase": "petr", "configs": records, "launches": total,
          "seconds": time.perf_counter() - t0})
    return total


# phase dist: the flagship train step under a torch.distributed process
# group. The card's machine has one GPU: (a) a world-size-1 NCCL group in
# this process (the NCCL code path), then two ranks sharing the card over
# gloo (NCCL refuses two ranks on one device): (b) data=2, one sample a
# rank, and (c) cam=2, 6 cameras a rank; (d) a bf16 step with
# head.fix_offset; (e), on the same two ranks, the other head families at
# cam=2. Times of the two ranks are of processes sharing one card: no
# multi-GPU time exists.
DIST_TIMED_STEPS = 3
DIST_SPAWN_TIMEOUT_S = 600.0
# (e): each head family at full width, cam=2 against one process, fp32
# (dropout 0 and the grid mask off, but PETRv2's step keeps dropout on: the
# dense attention's (Q, T) weight mask is drawn whole and sliced by rank):
# eval forwards within phase plain's bounds on every decoder layer (lane
# maps too), cam_overflow equal, each rank's K1 / K2 launches equal to one
# process's; MP's and PETRv2's steps within train_plain's bounds with
# assignments identical. The heads that refine where they sample (MP,
# DETR3D, DETR3D-v2) replay the one process's reference points, as phases
# mp_plain and variants do, and also run free (FREE_RUNNING_ATOL). MP's
# 2-way fusion projection is zeroed so both branches weigh 0.5: random
# weights saturate its softmax over the summed queries and hide a branch.
# Two planted faults, each in a replayed or dense forward of a rank: MP's
# centre gate sliced by camera before the (B, Q, N) -> (B, N, Q) view,
# which must break the bound, and PETRv2's merge without the global row
# max, reported (its random-weight attention is near-uniform, so the two
# halves' row maxima nearly agree; tests/test_torch_dist.py breaks it at
# tiny width). PETRv2's step runs its
# 800x320 config (`step_config`): at 640x1600 in fp32 the two ranks' steps
# did not fit the card together (a rank held 22.9 GB when the card's 79 GB
# were taken; PERF.md).
DIST_HEADS = {
    "mp": dict(config=MP_CONFIG, overrides=[], replay=True, step=True,
               fault="gate"),
    "detr3d": dict(config="detr4d_res50", overrides=[], replay=True),
    "detr3d_v2": dict(config="detr4d_res50",
                      overrides=["head.attn_type=detr3d_v2"], replay=True),
    "petrv2": dict(config=PETR_MAIN, overrides=[], step=True, dropout=True,
                   fault="merge",
                   step_config="petrv2_vovnet_gridmask_p4_800x320"),
    "petr_r50dcn": dict(config=PETR_V1[0], overrides=[]),
    "petr_seg": dict(config=PETR_SEG, overrides=[]),
}
# (d): the offsets' update against AdamW's pure decay, relative
FIX_OFFSET_RTOL = 1e-6






def step_record(step, batch):
    """One TrainStep.step with its K4 calls recorded and the launches
    counted from 0: (float metrics, launches, [(cost, num_valid, col4row)]
    on the host)."""
    calls = []
    reset_launch_counts()
    with record_assignments(calls):
        m = step.step(batch)
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in m.items()}, launch_counts(),
            [(c.cpu().numpy(), n.cpu().numpy(), a.cpu().numpy())
             for c, n, a in calls])


def check_step_against(name, got, want, rtol=TRAIN_PLAIN_RTOL,
                       grad_norm_rtol=TRAIN_PLAIN_GRAD_NORM_RTOL):
    """train_plain's bounds on two runs' metrics; returns the relative
    errors."""
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
    for k, e in rel.items():
        tol = grad_norm_rtol if k == "grad_norm" else rtol
        if not e <= tol:
            raise AssertionError(f"{name}: {k} {got[k]} vs {want[k]}: "
                                 f"{e} > {tol}")
    return rel


def check_assignments(name, got, want, rows):
    """K4's answers of one rank (`got`, its problems in order) against the
    one-process call's rows `rows` of `want`: identical, or at an equal
    optimum cost within 1e-5. Returns the rows that differ a problem."""
    if len(got) != 1 or len(want) != 1:
        raise AssertionError(f"{name}: K4 calls {len(got)} / {len(want)}")
    (ck, nk, ak), (cw, nw, aw) = ([torch.from_numpy(x) for x in call]
                                  for call in (got[0], want[0]))
    differ = []
    for i, j in enumerate(rows):
        d = int((ak[i] != aw[j]).sum())
        differ.append(d)
        if d:
            a = assignment_cost(ck[i:i + 1], nk[i:i + 1], ak[i:i + 1])[0]
            b = assignment_cost(cw[j:j + 1], nw[j:j + 1], aw[j:j + 1])[0]
            if not abs(a - b) <= 1e-5 * max(abs(b), 1e-12):
                raise AssertionError(f"{name}: problem {i}: {d} rows "
                                     f"assigned otherwise at cost {a} vs {b}")
    return differ


def forward_outputs(model, batch):
    with torch.no_grad():
        out = model(batch["images"], batch["lidar2img"])
    return ({k: out[k].float().cpu().numpy() for k in
             ("all_cls_scores", "all_bbox_preds")},
            float(out["cam_overflow"]))




def dist_head_config(h, step=False):
    """A DIST_HEADS entry's fp32 config; with `step` its train step's (its
    step_config where it names one, the entry's dropout kept where it says
    so)."""
    name = h.get("step_config", h["config"]) if step else h["config"]
    cfg = get_config(name, h["overrides"])
    out = fp32_step_config(cfg)
    if step and h.get("dropout"):
        out = dataclasses.replace(out, head=dataclasses.replace(
            out.head, dropout=cfg.head.dropout))
    return out


def dist_head_batch(cfg):
    """The train batch of a config with its model extras (PETRv2's and
    PETR-seg's mean_time_stamp)."""
    return {**train_batch(cfg), **petr_train_extras(cfg)}


def head_forward(model, batch):
    """An eval forward: ({'all_*': numpy}, cam_overflow, ms by CUDA events,
    launches)."""
    reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.no_grad():
        start.record()
        out = model(batch["images"], batch["lidar2img"], **model_extras(batch))
        end.record()
    end.synchronize()
    return ({k: v.float().cpu().numpy() for k, v in out.items()
             if k.startswith("all_")}, float(out["cam_overflow"]),
            start.elapsed_time(end), launch_counts())


def head_step(model, cfg, batch, mesh=None):
    """One timed TrainStep step: (metrics, launches, K4 calls, ms, peak
    bytes)."""
    step = TrainStep(model, cfg, seed=0, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    metrics, launches, calls = step_record(step, batch)
    end.record()
    end.synchronize()
    return (metrics, launches, calls, start.elapsed_time(end),
            torch.cuda.max_memory_allocated())


def graph_rows_differing(got, want):
    """Per decoder layer, the MP query-graph rows of `got` whose neighbour
    set differs from `want`'s (lists of (B, Q, k) index arrays)."""
    return [int((np.sort(g, -1) != np.sort(w, -1)).any(-1).sum())
            for g, w in zip(got, want)]


def dist_heads_one_process(tmp):
    """The one-process side of (e): each DIST_HEADS config's weights saved
    under `tmp`, its eval forward (recording the reference points, and
    MP's query graphs, where the ranks replay or compare them) and its
    step (recording its reference points likewise). Returns (the ranks'
    spec, the results)."""
    spec, want = {}, {}
    for name, h in DIST_HEADS.items():
        cfg = dist_head_config(h)
        sd = random_state_dict(get_config(h["config"], h["overrides"]))
        if name == "mp":  # both fusion branches weigh 0.5
            sd = {k: torch.zeros_like(v) if ".output_weight." in k else v
                  for k, v in sd.items()}
        path = os.path.join(tmp, f"{name}.pt")
        torch.save(sd, path)
        model = GraphDETR4D(cfg)
        model.load_state_dict(sd, strict=True)
        model.eval()
        batch = cuda_batch(dist_head_batch(cfg))
        refs, graphs, step_refs = [], [], []
        replay = h.get("replay")
        with (reference_route(model, refs) if replay
              else contextlib.nullcontext()), graph_route(graphs):
            out, overflow, _, launches = head_forward(model, batch)
        torch.cuda.reset_peak_memory_stats()
        _, _, ms, _ = head_forward(model, batch)  # timed after a warm-up
        rec = {"outputs": out, "cam_overflow": overflow, "ms": ms,
               "peak": torch.cuda.max_memory_allocated(), "launches": launches,
               "graphs": [g.cpu().numpy() for g in graphs]}
        del model
        if h.get("step"):
            scfg = dist_head_config(h, step=True)
            model = GraphDETR4D(scfg)
            model.load_state_dict(sd, strict=True)
            with (reference_route(model, step_refs) if replay
                  else contextlib.nullcontext()):
                (rec["metrics"], rec["step_launches"], rec["calls"],
                 rec["step_ms"], rec["step_peak"]) = head_step(
                    model, scfg, cuda_batch(dist_head_batch(scfg)))
            del model
        del sd, batch
        gc.collect()
        torch.cuda.empty_cache()
        # a step replays layers 1 on: layer 0's reference points carry the
        # gradient of their projection, and both sides compute them alike
        spec[name] = {**h, "weights": path,
                      "refs": [r.cpu().numpy() for r in refs],
                      "step_refs": [None] + [r.detach().cpu().numpy()
                                             for r in step_refs[1:]]
                      if step_refs else []}
        want[name] = rec
    return spec, want


@contextlib.contextmanager
def timed_collectives():
    """Time every camera collective the heads call (the cross-attentions'
    all_reduce_sum / all_reduce_max), each between two device syncs:
    yields a dict that sums their host ms and counts them."""
    from graph_detr4d_tpu_torch.models import attention as attention_mod
    from graph_detr4d_tpu_torch.models import attention_variants as variants_mod

    spent = {"ms": 0.0, "calls": 0}
    patched = [(m, n, getattr(m, n)) for m, n in (
        (attention_mod, "all_reduce_sum"), (variants_mod, "all_reduce_sum"),
        (transformer_mod, "all_reduce_sum"), (transformer_mod, "all_reduce_max"))]

    def timed(fn):
        def call(x, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(x, group)
            torch.cuda.synchronize()
            spent["ms"] += 1e3 * (time.perf_counter() - t0)
            spent["calls"] += 1
            return y
        return call

    for m, n, fn in patched:
        setattr(m, n, timed(fn))
    try:
        yield spent
    finally:
        for m, n, fn in patched:
            setattr(m, n, fn)


@contextlib.contextmanager
def gate_sliced_before_view(model, mesh):
    """The planted MP fault: each decoder layer's camera-gate logits (B, Q,
    N) rewritten so that the module's view-then-slice reads, for this
    rank's cameras, the logits sliced by camera first and transposed."""
    def hook(module, args, g):
        B, Q, N = g.shape
        n = N // mesh.cam
        cams = slice(mesh.cam_index * n, (mesh.cam_index + 1) * n)
        view = g.reshape(B, N, Q).clone()
        view[:, cams] = g[:, :, cams].transpose(1, 2)
        return view.reshape(B, Q, N)

    handles = [layer.attentions[1].cam_attention_weights.register_forward_hook(
        hook) for layer in model.pts_bbox_head.transformer.decoder.layers]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def dist_heads_rank(mesh2, spec):
    """The rank's side of (e) on the cam=2 mesh: each config's eval forward
    with this rank's cameras (replaying the one process's reference
    points, then free running, its MP query graphs recorded, and timed),
    PETRv2's with the planted fault, and the steps (replaying the one
    process's step reference points). Host values only."""
    from graph_detr4d_tpu_torch.models.detector import shard_cameras
    from graph_detr4d_tpu_torch.parallel.mesh import shard_batch

    def replaying(model, refs):
        if not refs:
            return contextlib.nullcontext()
        return reference_route(model, [None if r is None else
                                       torch.from_numpy(r).cuda()
                                       for r in refs], replay=True)

    out = {}
    for name, h in spec.items():
        cfg = dist_head_config(h)
        sd = torch.load(h["weights"], map_location="cuda", weights_only=True)
        model = GraphDETR4D(cfg)
        model.load_state_dict(sd, strict=True)
        shard_cameras(model.eval(), mesh2)
        batch = cuda_batch(shard_batch(dist_head_batch(cfg), mesh2))
        rec = {"cameras": int(batch["images"].shape[1])}
        if h["refs"]:
            with replaying(model, h["refs"]):
                rec["replayed"], _, _, _ = head_forward(model, batch)
        graphs = []
        with graph_route(graphs):
            (rec["outputs"], rec["cam_overflow"], _,
             rec["launches"]) = head_forward(model, batch)
        rec["graphs"] = [g.cpu().numpy() for g in graphs]
        torch.cuda.reset_peak_memory_stats()
        _, _, rec["ms"], _ = head_forward(model, batch)
        rec["peak"] = torch.cuda.max_memory_allocated()
        with timed_collectives() as spent:
            _, _, rec["synced_ms"], _ = head_forward(model, batch)
        rec["collectives"] = spent
        if h.get("fault") == "gate":
            with replaying(model, h["refs"]), gate_sliced_before_view(
                    model, mesh2):
                rec["fault"], _, _, _ = head_forward(model, batch)
        elif h.get("fault") == "merge":  # each rank with its own row max
            real = transformer_mod.all_reduce_max
            transformer_mod.all_reduce_max = lambda x, group: x.detach()
            try:
                rec["fault"], _, _, _ = head_forward(model, batch)
            finally:
                transformer_mod.all_reduce_max = real
        del model
        if h.get("step"):
            scfg = dist_head_config(h, step=True)
            model = GraphDETR4D(scfg)
            model.load_state_dict(sd, strict=True)
            with replaying(model, h["step_refs"]):
                (rec["metrics"], rec["step_launches"], rec["calls"],
                 rec["step_ms"], rec["step_peak"]) = head_step(
                    model, scfg, cuda_batch(shard_batch(
                        dist_head_batch(scfg), mesh2)), mesh2)
            del model
        del sd, batch
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = rec
    return out


def output_errors(got, want):
    """Per decoder layer, the max abs difference of every 'all_*' output
    (logits, boxes and PETR-seg's lane maps)."""
    errs = {}
    for k, w in want.items():
        if not np.isfinite(got[k]).all():
            raise AssertionError(f"non-finite {k}")
        errs[k] = [float(np.abs(got[k][i] - w[i]).max()) for i in range(len(w))]
    return errs


def within_plain_bounds(errs):
    return all(e <= (PLAIN_EARLY_ATOL if i < 2 else PLAIN_ATOL)
               for per_layer in errs.values() for i, e in enumerate(per_layer))


def check_dist_heads(ranks, want, path):
    """(e)'s checks of both ranks against the one process: (the record,
    the failed checks' messages)."""
    record, failed = {}, []

    def check(fn, *args):
        try:
            return fn(*args)
        except AssertionError as e:
            failed.append(str(e))
            return None

    for name, w in want.items():
        h = DIST_HEADS[name]
        cfg = get_config(h["config"], h["overrides"])
        rec = {"config": h["config"], "overrides": h["overrides"],
               "one_process": {"forward_ms": w["ms"],
                               "forward_peak_memory_bytes": w["peak"],
                               "forward_launches": w["launches"]}}
        if h.get("step"):
            rec["one_process"].update(
                step_config=h.get("step_config", h["config"]),
                step_ms=w["step_ms"], step_peak_memory_bytes=w["step_peak"],
                metrics=w["metrics"])
        for r, res in enumerate(ranks):
            got, tag = res["heads"][name], f"dist (e) {name} rank {r}"
            if got["cameras"] != cfg.head.num_cams // 2:
                failed.append(f"{tag}: {got['cameras']} cameras")
            rr = {"forward_ms_shared_card": got["ms"],
                  "forward_peak_memory_bytes": got["peak"],
                  "synced_forward_ms": got["synced_ms"],
                  "collective_ms": got["collectives"]["ms"],
                  "collectives": got["collectives"]["calls"],
                  "forward_launches": got["launches"]}
            free = output_errors(got["outputs"], w["outputs"])
            if h.get("replay"):
                errs = output_errors(got["replayed"], w["outputs"])
                rr["free_running_max_abs_err_per_layer"] = free
                if w["graphs"]:
                    # a free run's own query graphs: a near-tie of the 8th
                    # and 9th nearest reference points flips on the camera
                    # sum's rounding, and the query then reads other
                    # neighbours (reported, not bounded)
                    rr["free_running_graph_rows_differing_per_layer"] = (
                        graph_rows_differing(got["graphs"], w["graphs"]))
                else:
                    check(check_free_running, tag, free)
            else:
                errs = free
            rr["max_abs_err_per_layer"] = errs
            check(check_layer_errors, tag, errs)
            if got["cam_overflow"] != w["cam_overflow"]:
                failed.append(f"{tag}: cam_overflow {got['cam_overflow']} "
                              f"vs {w['cam_overflow']}")
            if got["launches"] != w["launches"]:
                failed.append(f"{tag}: launches {got['launches']} vs one "
                              f"process {w['launches']}")
            add_counts(path, got["launches"])
            if h.get("fault"):
                ferrs = output_errors(got["fault"], w["outputs"])
                rr["fault"] = h["fault"]
                rr["fault_max_abs_err_per_layer"] = ferrs
                rr["fault_breaks_the_bound"] = not within_plain_bounds(ferrs)
                if h["fault"] == "gate" and not rr["fault_breaks_the_bound"]:
                    failed.append(f"{tag}: the gate sliced before its view "
                                  f"stays within the bounds: {ferrs}")
            if h.get("step"):
                rr["rel_err"] = check(check_step_against, tag,
                                      got["metrics"], w["metrics"])
                rr["assignment_rows_differing_per_layer"] = check(
                    check_assignments, tag, got["calls"], w["calls"],
                    range(cfg.head.num_decoder_layers))
                if got["step_launches"] != w["step_launches"]:
                    failed.append(f"{tag}: step launches "
                                  f"{got['step_launches']} vs "
                                  f"{w['step_launches']}")
                add_counts(path, got["step_launches"])
                rr.update(metrics=got["metrics"],
                          step_ms_shared_card=got["step_ms"],
                          step_peak_memory_bytes=got["step_peak"],
                          step_launches=got["step_launches"])
            rec[f"rank{r}"] = rr
        record[name] = rec
    return record, failed


def dist_rank(rank, world, heads_spec_path):
    """One of two ranks sharing the card over gloo: (b) one fp32 step of a
    data=2 mesh on sample `rank` of the global batch of 2; (c) on a cam=2
    mesh, an fp32 forward and one fp32 step with this rank's 6 cameras;
    (e) the other head families on that mesh (dist_heads_rank, the spec
    pickled at heads_spec_path). Returns host values only."""
    from graph_detr4d_tpu_torch.models.detector import shard_cameras
    from graph_detr4d_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh, make_mesh_2d, shard_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("cuda", backend="gloo", timeout_s=DIST_SPAWN_TIMEOUT_S)
    cfg32 = fp32_step_config(get_config(CONFIG))
    sd = random_state_dict(get_config(CONFIG))
    out = {"card": smi_line()}

    model = GraphDETR4D(cfg32)
    model.load_state_dict(sd, strict=True)
    step = TrainStep(model, cfg32, seed=0, mesh=make_mesh())
    global2 = synthetic_batch(cfg32, 2, seed=0, num_gt=NUM_GT)
    local = cuda_batch({k: v[rank:rank + 1] for k, v in global2.items()})
    torch.cuda.reset_peak_memory_stats()
    metrics, launches, calls = step_record(step, local)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    step.step(local)
    end.record()
    end.synchronize()
    out["data"] = {"metrics": metrics, "launches": launches, "calls": calls,
                   "reduced_bytes": step.reduced_bytes,
                   "second_step_ms_shared_card": start.elapsed_time(end),
                   "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del model, step, local
    torch.cuda.empty_cache()

    mesh2 = make_mesh_2d(cam=2)
    model = GraphDETR4D(cfg32)
    model.load_state_dict(sd, strict=True)
    shard_cameras(model, mesh2)
    batch = cuda_batch(shard_batch(train_batch(cfg32), mesh2))
    reset_launch_counts()
    fwd, overflow = forward_outputs(model, batch)
    fwd_launches = launch_counts()
    step = TrainStep(model, cfg32, seed=0, mesh=mesh2)
    metrics, launches, calls = step_record(step, batch)
    out["cam"] = {"forward": fwd, "cam_overflow": overflow,
                  "cameras": int(batch["images"].shape[1]),
                  "forward_launches": fwd_launches, "metrics": metrics,
                  "launches": launches, "calls": calls}
    del model, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    with open(heads_spec_path, "rb") as f:
        out["heads"] = dist_heads_rank(mesh2, pickle.load(f))
    return out


def phase_dist(cfg, sd):
    """(a)-(d) above; returns the launches of the path (this process's
    distributed steps and both ranks')."""
    import torch.distributed as dist

    from graph_detr4d_tpu_torch.parallel import mesh as mesh_mod
    from graph_detr4d_tpu_torch.train.optim import lr_factor

    t0 = time.perf_counter()
    cfg32 = fp32_step_config(cfg)
    path = dict.fromkeys(launch_counts(), 0)
    param_bytes = 4 * sum(p.numel() for p in
                          GraphDETR4D(cfg, device="cpu").parameters())

    def build(c, mesh=None):
        model = GraphDETR4D(c)
        model.load_state_dict(sd, strict=True)
        return TrainStep(model, c, seed=0, mesh=mesh)

    # (a) NCCL, world size 1, in this process
    os.environ.update(MASTER_ADDR="localhost", RANK="0", WORLD_SIZE="1",
                      LOCAL_RANK="0",
                      MASTER_PORT=str(mesh_mod.free_port()))
    mesh_mod.init_distributed("cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        mesh = mesh_mod.make_mesh()
        batch = cuda_batch(train_batch(cfg32))
        ref = build(cfg32)
        want, _, _ = step_record(ref, batch)
        del ref
        torch.cuda.empty_cache()
        step = build(cfg32, mesh)
        got, launches, _ = step_record(step, batch)
        check_step_launches("dist (a)", launches, 1, STEP_LAUNCHES)
        add_counts(path, launches)
        nccl_rel = check_step_against("dist (a) NCCL world 1", got, want)
        grads = [p.grad for p in step.model.parameters()]
        copies = [g.clone() for g in grads]
        reduced = mesh_mod.all_reduce_mean_(copies)
        sum_div_1_err = max(float((c - g).abs().max())
                            for c, g in zip(copies, grads))
        del step, grads, copies
        torch.cuda.empty_cache()
        # bf16 steps both ways, and the all-reduce alone
        bf16 = {}
        batch16 = cuda_batch(train_batch(cfg))
        for way, m in (("one_process", None), ("nccl_world_1", mesh)):
            s = build(cfg, m)
            times, _, launches, peak = timed_train_steps(
                s.step, batch16, DIST_TIMED_STEPS)
            if m is not None:
                add_counts(path, launches)
                check_step_launches("dist (a) bf16", launches,
                                    DIST_TIMED_STEPS, STEP_LAUNCHES)
                grads = [p.grad for p in s.model.parameters()]
                ar_ms = cuda_ms(lambda: mesh_mod.all_reduce_mean_(grads), 5)
            bf16[way] = {"ms_per_step": times, "peak_memory_bytes": peak}
            del s
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                  "LOCAL_RANK"):
            os.environ.pop(k, None)
    record_a = {"rel_err": nccl_rel, "sum_div_1_max_abs_diff": sum_div_1_err,
                "all_reduce_bytes": reduced, "predicted_bytes": param_bytes,
                "all_reduce_ms": ar_ms, "bf16": bf16}
    if sum_div_1_err != 0.0:
        raise AssertionError(f"dist (a): all-reduce / 1 differs by "
                             f"{sum_div_1_err}")
    if reduced != param_bytes:
        raise AssertionError(f"dist (a): reduced {reduced} bytes, the "
                             f"parameters hold {param_bytes}")

    # the one-process references of (b) and (c), freed before the ranks
    global2 = synthetic_batch(cfg32, 2, seed=0, num_gt=NUM_GT)
    ref = build(cfg32)
    want2, _, calls2 = step_record(ref, cuda_batch(global2))
    del ref
    ref = build(cfg32)
    batch = cuda_batch(train_batch(cfg32))
    ref.model.eval()
    want_fwd, want_overflow = forward_outputs(ref.model, batch)
    want1, _, calls1 = step_record(ref, batch)
    del ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="dist_heads_")
    try:
        heads_spec, heads_want = dist_heads_one_process(tmp)
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(heads_spec, f)
        # (b), (c) and (e): two ranks sharing the card over gloo
        ranks = mesh_mod.spawn_ranks(dist_rank, 2, spec_path,
                                     timeout_s=DIST_SPAWN_TIMEOUT_S)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record_e, failed_e = check_dist_heads(ranks, heads_want, path)
    emit({"phase": "dist", "part": "(e) cam=2 heads", "heads": record_e,
          "failed": failed_e})
    if failed_e:
        raise AssertionError(f"dist (e): {failed_e}")
    layers = cfg.head.num_decoder_layers
    record_b, record_c = {}, {}
    for r, res in enumerate(ranks):
        d, c = res["data"], res["cam"]
        rb = {"card": res["card"]}
        rb["rel_err"] = check_step_against(f"dist (b) rank {r}",
                                           d["metrics"], want2)
        rb["assignment_rows_differing_per_layer"] = check_assignments(
            f"dist (b) rank {r}", d["calls"], calls2,
            [l * 2 + r for l in range(layers)])
        check_step_launches(f"dist (b) rank {r}", d["launches"], 1,
                            STEP_LAUNCHES)
        if d["reduced_bytes"] != param_bytes:
            raise AssertionError(f"dist (b): {d['reduced_bytes']} bytes")
        rb.update(launches=d["launches"], all_reduce_bytes=d["reduced_bytes"],
                  second_step_ms_shared_card=d["second_step_ms_shared_card"],
                  peak_memory_bytes=d["peak_memory_bytes"])
        add_counts(path, d["launches"])
        record_b[f"rank{r}"] = rb

        if c["cameras"] != cfg.head.num_cams // 2:
            raise AssertionError(f"dist (c): rank {r} holds {c['cameras']}")
        errs = layer_errors(
            *({k: torch.from_numpy(v) for k, v in o.items()}
              for o in (c["forward"], want_fwd)))
        check_layer_errors(f"dist (c) rank {r} forward", errs)
        if c["cam_overflow"] != want_overflow:
            raise AssertionError(f"dist (c): cam_overflow {c['cam_overflow']}"
                                 f" vs {want_overflow}")
        # the rank's cameras: a K1 launch a layer, the 9 DCN convs
        check_step_launches(f"dist (c) rank {r} forward",
                            c["forward_launches"], 1,
                            {"msda_forward": MSDA_CALLS,
                             "deform_conv_forward": DCN_CALLS})
        check_step_launches(f"dist (c) rank {r} step", c["launches"], 1,
                            STEP_LAUNCHES)
        rc = {"max_abs_err_per_layer": errs, "cam_overflow": c["cam_overflow"],
              "cameras": c["cameras"],
              "rel_err": check_step_against(f"dist (c) rank {r}",
                                            c["metrics"], want1),
              "assignment_rows_differing_per_layer": check_assignments(
                  f"dist (c) rank {r}", c["calls"], calls1, range(layers)),
              "forward_launches": c["forward_launches"],
              "launches": c["launches"]}
        add_counts(path, c["forward_launches"])
        add_counts(path, c["launches"])
        record_c[f"rank{r}"] = rc

    # (d) head.fix_offset, bf16
    fixed = dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, fix_offset=True))
    step = build(fixed)
    offsets = {n: p.detach().clone() for n, p in step.model.named_parameters()
               if "deform_sampling_offsets" in n}
    main_w = "pts_bbox_head.cls_branches.0.0.weight"
    before_main = step.model.state_dict()[main_w].clone()
    metrics, launches, _ = step_record(step, cuda_batch(train_batch(fixed)))
    check_step_launches("dist (d)", launches, 1, STEP_LAUNCHES)
    add_counts(path, launches)
    check_finite_metrics("dist (d)", [metrics])
    lr0 = fixed.train.lr * lr_factor(fixed.train, 0)
    decay = 1.0 - lr0 * fixed.train.weight_decay
    named = dict(step.model.named_parameters())
    fix_err = max(float(((named[n].detach().double() - p.double() * decay).abs()
                         / (p.double() * decay).abs().clamp(min=1e-30)).max())
                  for n, p in offsets.items())
    if not fix_err <= FIX_OFFSET_RTOL:
        raise AssertionError(f"dist (d): offsets' update off pure decay by "
                             f"{fix_err}")
    if torch.equal(step.model.state_dict()[main_w], before_main):
        raise AssertionError(f"dist (d): {main_w} did not move")
    del step
    torch.cuda.empty_cache()
    emit({"phase": "dist", "config": CONFIG,
          "note": "one H100: (a) is a world-size-1 NCCL group; (b) and (c) "
                  "are two processes sharing one card over gloo, so their "
                  "times are no multi-GPU time",
          "nccl_world_1": record_a, "data2_gloo_shared_card": record_b,
          "cam2_gloo_shared_card": record_c,
          "cam2_heads_gloo_shared_card": "the (e) line above",
          "fix_offset": {"offsets_rel_err_vs_pure_decay": fix_err,
                         "offset_tensors": len(offsets), "lr0": lr0,
                         "metrics": metrics},
          "launches": path, "seconds": time.perf_counter() - t0})
    return path


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_build()
    kernels = phase_kernels(dev)
    cfg = get_config(CONFIG)
    sd = random_state_dict(cfg)
    engine, batch, serve_launches, serve_ms = phase_serve(cfg, sd)
    phase_breakdown(engine, batch)
    ref = final_layer(engine, batch)
    stream_launches, engine32 = phase_stream(engine, cfg, sd, serve_ms)
    tta_launches = phase_tta(engine, engine32)
    del engine, engine32
    torch.cuda.empty_cache()
    mp_launches = phase_serve_mp()
    torch.cuda.empty_cache()
    variant_launches = phase_variants()
    torch.cuda.empty_cache()
    # every serving path's launches, each counted from 0 just before it
    serving = {"serve": serve_launches, "stream": stream_launches,
               "tta": tta_launches, "serve_mp": mp_launches,
               "variants": variant_launches}
    int8_launches = phase_serve_int8(sd, batch, ref)
    torch.cuda.empty_cache()
    phase_plain(cfg, sd)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        trainer, batch, train_launches, assignments, focal_inputs = phase_train(
            cfg, sd, work_dir)
        phase_train_breakdown(trainer, batch)
        trainer.close()
        del trainer
    torch.cuda.empty_cache()
    kernels["hungarian"]["train_costs"] = kernel_hungarian_train(dev, assignments)
    kernels["focal_loss"]["train_inputs"] = kernel_focal_loss_train(focal_inputs)
    phase_train_plain(cfg, sd)
    torch.cuda.empty_cache()
    data_launches = phase_data(cfg)
    torch.cuda.empty_cache()
    lidar_sd = lidar_state_dict()
    lidar_engine, clouds, lidar_launches = phase_lidar(lidar_sd)
    iou_launches = phase_iou(lidar_engine, clouds[0])
    del lidar_engine
    torch.cuda.empty_cache()
    phase_lidar_plain(lidar_sd, clouds[0])
    torch.cuda.empty_cache()
    lidar_grad_launches = phase_lidar_grad(lidar_sd, clouds[0], cfg)
    torch.cuda.empty_cache()
    hdetr_launches = phase_hdetr()
    torch.cuda.empty_cache()
    camaware_launches = phase_camaware()
    torch.cuda.empty_cache()
    http_launches = phase_http(cfg, sd)
    torch.cuda.empty_cache()
    backbone_launches = phase_backbones()
    torch.cuda.empty_cache()
    distill_launches, kernels["hungarian"]["distill"] = phase_distill(dev)
    torch.cuda.empty_cache()
    petr_launches = phase_petr(dev)
    torch.cuda.empty_cache()
    dist_launches = phase_dist(cfg, sd)

    paths = {**serving, "serve_int8": int8_launches, "train": train_launches,
             "data": data_launches, "lidar": lidar_launches, "iou": iou_launches,
             "lidar_grad": lidar_grad_launches, "hdetr": hdetr_launches,
             "camaware": camaware_launches, "http": http_launches,
             "backbones": backbone_launches, "distill": distill_launches,
             "petr": petr_launches, "dist": dist_launches}
    serving_total = {k: sum(c[k] for c in serving.values())
                     for k in serve_launches}
    table = []
    for name, src, replaces, launches, covers in (
        ("msda_forward", "graph_detr4d_tpu_torch/csrc/msda.cu",
         "graph_detr4d_tpu/ops/msda.py:374", serving_total,
         "one flagship request's calls, bf16 (mp_neighbour_ms, detr3d_ms: "
         "one request's calls of those variants' layouts)"),
        ("deform_conv_forward", "graph_detr4d_tpu_torch/csrc/deform_conv.cu",
         "graph_detr4d_tpu/ops/deform_conv.py:78", serving_total,
         "one request's 9 calls, bf16 (sampling and contraction)"),
        ("msda_backward", "graph_detr4d_tpu_torch/csrc/msda.cu",
         "graph_detr4d_tpu/ops/msda.py:374", train_launches,
         "one train step's calls, bf16"),
        ("deform_conv_backward", "graph_detr4d_tpu_torch/csrc/deform_conv.cu",
         "graph_detr4d_tpu/ops/deform_conv.py:78", train_launches,
         "one train step's 9 calls, bf16 (x, offset, mask and weight "
         "gradients)"),
        ("focal_loss", "graph_detr4d_tpu_torch/csrc/focal_loss.cu",
         "graph_detr4d_tpu/ops/focal_loss.py:14", train_launches,
         "one train step's call, fp32"),
        ("hungarian", "graph_detr4d_tpu_torch/csrc/hungarian.cu",
         "graph_detr4d_tpu/ops/hungarian.py:95", train_launches,
         "one call on uniform random costs, 6 problems of 128 x 900 with "
         "num_valid 0-128 (train_costs_ms: the train step's own costs, 40 "
         "valid rows of 128; distill_ms: a distill step's soft matching, "
         "12 problems of 64 x 900; distill_all_rows_ms: one of 900 x 900 "
         "from the same step)"),
        ("deform_conv_int8_forward",
         "graph_detr4d_tpu_torch/csrc/deform_conv_int8.cu",
         "graph_detr4d_tpu/ops/deform_conv.py:259", int8_launches,
         "one int8 request's 7 calls, bf16 (amax, quantize, sampling and "
         "contraction)"),
        ("pillar_features", "graph_detr4d_tpu_torch/csrc/voxelize.cu",
         "graph_detr4d_tpu/ops/voxelize.py:26", lidar_launches,
         "one lidar request's call (pillar_indices + pillar_center_offsets,"
         " voxelize.py:26,77), 300,000 points"),
        ("pillar_scatter", "graph_detr4d_tpu_torch/csrc/voxelize.cu",
         "graph_detr4d_tpu/ops/voxelize.py:52", lidar_launches,
         "one lidar request's call, 300,000 points x 64 channels"),
        ("pillar_scatter_backward", "graph_detr4d_tpu_torch/csrc/voxelize.cu",
         "graph_detr4d_tpu/ops/voxelize.py:52", lidar_grad_launches,
         "one lidar_grad step's call, 300,000 points x 64 relu'd channels "
         "(pytorch_backward_ms: autograd's backward of scatter_reduce_ "
         "'amax', several calls)"),
        ("iou3d", "graph_detr4d_tpu_torch/csrc/iou3d.cu",
         "graph_detr4d_tpu/core/iou3d.py:159", iou_launches,
         "the iou phase's 2 calls, 900 x 900 and 300 x 128"),
    ):
        k = kernels[name]
        if "max_abs_err" in k:
            err = k["max_abs_err"]
        else:
            err = max(v[0] for c, v in k["checks"].items()
                      if c.endswith("float32") and isinstance(v, tuple))
        for rec in k.get("layouts", {}).values():
            err = max(err, rec["checks"]["float32"][0])
        row = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "train_launches": train_launches[name],
            "launches_by_path": {p: c[name] for p, c in paths.items() if c[name]},
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"), "ms_covers": covers,
        }
        for layout, rec in k.get("layouts", {}).items():
            for key in ("ms", "plain_ms", "bound_ms", "device_ms_per_call"):
                row[f"{layout}_{key}"] = rec[key]
        if "gemm_ref_ms" in k:  # not the same function: no library_ms
            row["gemm_ref_ms"] = k["gemm_ref_ms"]
        if "pytorch_backward_ms" in k:
            row["pytorch_backward_ms"] = k["pytorch_backward_ms"]
        if "distill" in k:  # K4 at the distill shapes, kernel and plain
            for label, rec in k["distill"].items():
                tag = "distill" if label == "top_k" else f"distill_{label}"
                for key in ("shape", "ms", "plain_ms", "bound_ms",
                            "longest_steps"):
                    row[f"{tag}_{key}"] = rec[key]
        if "train_costs" in k:
            row["train_costs_ms"] = k["train_costs"]["ms"]
            row["longest_steps"] = k["longest_steps"]
            row["ns_per_step"] = k["ns_per_step"]
            row["train_costs_ns_per_step"] = k["train_costs"]["ns_per_step"]
        if "host_us_per_call" in k:
            row["host_us_per_call"] = k["host_us_per_call"]
        if name in ("focal_loss", "pillar_scatter", "pillar_scatter_backward"):
            row["device_ms_per_call"] = k["kernel_device_ms"]
        if "relu_ms" in k:
            row["relu_ms"] = k["relu_ms"]
            row["scan_order_ms"] = k["scan_order_ms"]
        if "train_inputs" in k:
            row["train_inputs_ms"] = k["train_inputs"]["ms"]
            row["train_inputs_host_us_per_call"] = k["train_inputs"][
                "host_us_per_call"]
            row["train_inputs_device_ms_per_call"] = k["train_inputs"][
                "kernel_device_ms"]
        if "pretest_skipped_share" in k:
            row["pretest_skipped_share"] = k["pretest_skipped_share"]
        if "clustered" in k:
            row["clustered_ms"] = k["clustered"]["ms"]
            row["clustered_bound_ms"] = k["clustered"]["bound_ms"]
        table.append(row)
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
