#!/usr/bin/env python3
"""Smoke run of posebyte_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only decode_variants,engine,aot,debug

Phases, each printing one JSON line with its elapsed seconds (with --only:
device, build, kernels, int8_calibration and the named ones of the last
four):
  device       the card's name and power limit (nvidia-smi)
  build        nvcc builds the kernels in csrc/ (or loads the cached build);
               each kernel's registers and spills as ptxas reports them
               (Kernel 1's dominance part and its greedy pass once per
               count of register words a lane, Kernel 3 twice: its cv and
               its kalman136 instantiation); a spill in any of Kernels
               1-4 fails
  kernels      each kernel against its plain PyTorch version on the card, at
               the main path's shapes, on seeded inputs; outputs must be
               equal ("launches" here counts this phase's comparison and
               timing launches); Kernel 3 also with its stage clock on,
               whose outputs must equal those without it; Kernel 1 also at
               N = 1024, Kernel 2 also with its round count (rounds_out).
               Each kernel's "ms" is its call as the pipeline makes it
               (CUDA events around calls issued back to back), its
               "device_ms" the same calls run back to back by a device kept
               ahead of the host (utils/timing.py)
  main_path    PosePipeline on the card: yolov8n-pose, 640 input, bf16, raw u8
               ingest, 16 frames of 1280x720 from the synthetic scene,
               through process_frame and fetch_outputs; the kernels' launch
               counts must be 1 (NMS) and 3 (auction) per frame. Kernel 2's
               rounds per tier over the 16 frames (mean, maximum, share at
               the budget), from the path's own matrices. Also times
               Kernel 1 at B = 1 on the last frame's own candidates
               (N = 256), with their valid count
  cpu_vs_card  8 frames in fp32 on the CPU (plain versions) and on the card
               (kernels): track ids equal, keypoints within 1e-2 px
  chunk_path   PosePipeline.process_chunk on the card at the headline
               configuration (yolov8n-pose, 640, bf16, raw u8 ingest,
               chunk K = 128 frames of 1280x720, 6 people): one warm-up and
               two timed chunks, one bulk copy of the outputs per chunk, then
               fetch_outputs per frame; launches per chunk must be exactly
               nms_keep 1 (grid = K), tracker_chunk 1 and auction 0. Also
               times Kernel 1 on the chunk's own candidates (B = 128), and
               Kernel 3 on the last chunk's own inputs with its stage split
  chunk_cpu_vs_card  the chunk path in fp32 at K = 8 on the CPU (plain
               versions) and on the card (Kernels 1 and 3): track ids
               equal, keypoints within 1e-2 px
  reid_kernels Kernel 3 with Re-ID (reid_weight 0.3) against its plain
               version on the card at S = 1 and S = 3 streams of the stress
               case, at capacities D = 64 and D = 128, with the embeddings
               of both appearance sources (the pose-colour descriptor and
               the learned head of assets/reid-head-synthetic.safetensors)
               sampled from the frames the detections came from; integer
               outputs must be equal and the float difference 0
  reid_main_path  the per-frame path with Re-ID on the card, bf16, 16 frames
               per source: launches 1 (NMS) and 3 (auction) per frame
  reid_chunk_path the chunk path with Re-ID at K = 128, bf16, one warm-up
               and two timed chunks per source: launches per chunk exactly
               nms_keep 1, tracker_chunk 1, auction 0; tracks within 10 px
               of the 6 people
  reid_cpu_vs_card  per source, a chunk of K = 8 and 4 per-frame frames in
               fp32 on the CPU and on the card: track ids equal, keypoints
               within 1e-2 px
  kalman_kernels  Kernel 3's kalman136 variant against its plain version on
               the card at S = 1 and 3, D = 64 (K = 128) and D = 128
               (K = 32), without and with Re-ID (the descriptor's
               embeddings), holes in the advance mask: integer outputs
               equal and the float difference, filter included, 0; the
               stress case (K = 128, T = 128, D = 64, S = 1) timed with cv
               and kalman136 in turns
  kalman_main_path  the per-frame path with kalman136 on the card, bf16, 16
               frames: launches 1 (NMS) and 3 (auction) per frame
  kalman_chunk_path the chunk path with kalman136 at K = 128, bf16, one
               warm-up and two timed chunks: launches per chunk exactly
               nms_keep 1, tracker_chunk 1, auction 0; frames/s
  kalman_cpu_vs_card  kalman136 in fp32, a chunk of K = 8 and 4 per-frame
               frames on the CPU and on the card: track ids equal,
               keypoints within 1e-2 px
  int8_calibration  the int8 (w8a8) configuration: yolov8n-pose quantised
               with PARTIAL_QUANT_SKIP (59 int8 convolutions), activation
               scales by percentile calibration on the card over 16
               synthetic-scene frames rendered at 640
  int8_kernels Kernel 4 against its plain version on the card (an exact
               float64 convolution) in both modes (int8 input; float
               input quantised in its load, the path's): int32 sums and
               bf16 outputs bit for bit at the JAX kernel test's shape, at
               every distinct shape the int8 path gives Kernel 4 for one
               frame (B = 1, its own inputs, recorded by wrapping
               ops.conv_int8.conv_w8a8_cuda around one forward), and at
               every one of those shapes at B = 128 in the path's layout;
               each distinct shape timed at B = 128 in both modes (kernel,
               plain version, the bound of each mode, and three yardsticks
               the port never calls: the two-pass route, eager
               quantize_activation then the int8 mode; cuDNN's bf16 conv
               of the same shape; torch._int_mm on the im2col'd input),
               summed per chunk
  int8_main_path   the per-frame path at int8 on the card, bf16
               activations, 16 frames: launches per frame conv_int8 59,
               nms_keep 1, auction 3, and no call of quantize_activation
  int8_chunk_path  the chunk path at int8, K = 128: one warm-up and two
               timed chunks, launches per chunk conv_int8 59, nms_keep 1,
               tracker_chunk 1, auction 0, no quantize_activation;
               frames/s
  int8_cpu_vs_card int8 with float32 activations, a chunk of K = 8 and 4
               per-frame frames on the CPU and on the card: track ids
               equal, keypoints within 8 px and their median difference
               within 0.5 px (INT8_KP_MAX_PX says why); and on these
               frames the quantisation in Kernel 4's load (read back by a
               1x1 identity conv in int32 mode) equal to the CPU's on
               values at (n + 0.5) * s_x for every calibrated s_x and on
               the float inputs the CPU computed for every int8 conv, with
               the int8 activations that differ when each device computes
               its own float inputs counted per conv and frame
  v11_main_path, v11_cpu_vs_card, v11_chunk_path, v11_chunk_cpu_vs_card
               main_path, cpu_vs_card, chunk_path and chunk_cpu_vs_card
               for yolo11n-pose (640, assets/yolo11n-pose-synthetic640,
               the same frames, launches and bars); the chunk phases of
               both models (and of both at int8) also profile one more
               chunk (device busy and Kernel 4 ms per frame, operations,
               idle share, top items) and time the model's forward at
               B = 128 on the device (model_device_ms_per_frame)
  v11_int8     yolo11n-pose at int8, in parts each printing its line:
               v11_int8_calibration (85 convs, 7 depthwise),
               v11_int8_kernels (every Kernel 4 launch of one forward, 78,
               against its plain version on its own inputs, each distinct
               shape at B = 128 checked and timed), v11_int8_chunk_path
               (78 Kernel 4 launches per chunk), v11_int8_cpu_vs_card;
               then the v11_int8 line: their verdicts and the depthwise
               route (models.layers.conv_w8a8_depthwise recorded over one
               forward of a chunk, bf16 and float32 activations) bit for
               bit against its float64 plain version
  pt_import    an Ultralytics-structured .pt of yolo11n-pose written from
               the checkpoint (module classes that exist only while it is
               written, float32, identity BatchNorm) and read back by
               models.load_pretrained: tensors within PT_FOLD_RTOL of
               load_params', PosePipeline on the card with either set of
               weights (fp32, 4 frames): ids equal, keypoints within 1e-2
               px; and at bf16
  serving_path StreamServer on the card (yolov8n-pose, 640, bf16, raw u8
               ingest), 8 streams of 1920x1080, each its own synthetic
               scene: all open, 16 frames each, stream 3 starved for 4
               steps, stream 5 closed after 6 frames and reopened (a reset)
               with 6 more, stepped until drained; every step exactly
               nms_keep 1 (B = 8), tracker_chunk 1 (K = 1, S = 8), auction
               0; each stream's frame counter equal to the frames it was
               served, the reopened stream's ids from 1, every stream's
               last tracks within 10 px of its people; frames/s, steps/s,
               device busy ms per step (torch.profiler), Kernels 1 and 3
               timed on a full step's own inputs
  chunked_serving_path  ChunkedStreamServer (chunk 8), the same streams
               and script (stream 3 starved until nothing else is
               queued): nms_keep 1 (B = 64) and tracker_chunk 1 (K = 8, S
               = 8) per step; the same checks and times
  serving_cpu_vs_card  both servers in fp32 on the CPU and on the card,
               4 streams x 4 frames, one reset and one starved step: ids
               and emit equal, keypoints within 1e-2 px; on the card the
               chunked server's outputs equal the per-frame server's (ids
               equal, poses within 1e-4); the chunked server again with
               the learned Re-ID head, ids equal
  frontend     PoseServingFrontend over loopback around the card's chunked
               server: two PoseClients (60 s socket timeouts), a stream
               each; the fifth frame into a queue of 4 answers BUSY; the
               tracks that come back equal the server's own outputs
               un-letterboxed (within 1e-2 px, the JSON's rounding); closing
               it stops its threads
  accuracy     the trained checkpoints from pixels through cli.evaluate's
               loop (evaluate_tracks) on the held-out clip (seed 424242, 3
               people, 640x360, the port's renderer): yolov8n-pose 256 (48
               frames), yolov8n-pose 640 and yolo11n-pose 640 (24), each
               fp32 and bf16, per frame and at chunk 8: OKS-mAP, AP50,
               MOTA, IDF1 and id switches against the JAX package's bars
               (mAP 0.90 / 0.88 / 0.86, MOTA 0.95, at most 1 switch), the
               chunked ids equal to the per-frame ids, launches 1 / 3 / 0
               per frame and 1 / 0 / 1 per chunk; then yolov8n-pose 640 at
               int8, calibrated by percentile on the card over the clip's
               first 4 frames (59 Kernel 4 launches a frame, no eager
               quantisation): OKS-mAP against the fp32 tracks and against
               the ground truth beside the JAX percentile bars (printed)
  hard_clip    the crowded clip (CrowdedScene seed 86002, 8 people, 96
               frames), yolov8n-pose 256, fp32, per frame: the card against
               the JAX bars (MOTA 0.51, IDF1 0.47, at most 29 switches), the
               CPU's run beside it, and the card with the learned Re-ID
               head at reid_weight 0.3 (reported)
  cli          cli.benchmark.main(-n 200, -e the v8n-640 checkpoint, --json,
               --stages) on the card, its Kernel 1 and 2 launches exactly
               those of its components, then Kernel 1 on its 100 candidates
               and Kernel 2 on its 50 x 50 cost against their plain
               versions, timed ("*_n100", "*_50x50" row keys); cli.export
               of pt_import's .pt at bf16 and at int8 (synthetic
               calibration), each read back equal; the demo's loop
               (cli.demo.track_frames) per frame and at chunk 8 over 16
               frames with the native drawing: frames/s, launches, the
               drawn bytes equal to the CPU's drawing of the same tracks,
               and a fixed drawing equal to DRAW_DIGEST
  train        yolov8n-pose from init_params in float32 on a fixed batch of
               synthetic letterboxed frames (the trainer's make_split), 30
               steps of the trainer's optimizer chain (clip_by_global_norm
               5, adamw with the warmup-cosine schedule) through
               models.train.make_scan_train, at 640 with batch 16 and at
               the trainer's defaults, 256 with batch 32: the loss finite
               and its last below 0.7 x its first; ms per step, images/s,
               peak memory, device busy share of one profiled step, the
               step's bound (3 x the forward's conv operations at 67
               TFLOP/s); one SGD step (lr 1e-2) on the card and on the CPU
               from the same params and batch: loss within 1e-4, params
               within rtol 5e-4, atol 5e-6
  train_resume scripts.train_synthetic.main --resume the v8n-256
               checkpoint (10 steps at lr 1e-5): its save check (the file
               read back on the CPU, the loss equal to the card's) and its
               eval_detection on its own validation split (256 frames, seed
               + 777000, no noise), Kernel 1 once per batch of 32; then the
               saved file's detections of that split on the card and on
               the CPU: valid masks equal, keypoints within 1e-2 px, mAP
               within 0.03 of the checkpoint's metrics file
  train_reid   20 steps of scripts.train_reid's step (info_nce_loss, Adam)
               from init_reid_head on the card: the loss falls;
               eval_separation of the trained head on the script's
               validation split: top1_acc within 0.03 of its metrics file
  parallel     parallel.MultiStreamPipeline (4 calls) and
               MultiStreamChunkPipeline (one chunk of 8) on make_mesh(1), 8
               streams of 1920x1080, yolov8n-pose 640 fp32: per call
               Kernel 1 once, Kernel 3 once, Kernel 2 never; ids equal to
               StreamServer's and ChunkedStreamServer's on the same frames
               with every stream advancing, and to the pipelines' run on
               the CPU (keypoints within 1e-2 px); frames/s
  dp           parallel.make_data_mesh(1): an NCCL group of one (a
               FileStore under build/dp); make_dp_train_step equal to
               make_train_step bit for bit (SGD, cuDNN and the index
               backward in their deterministic modes); make_dp_scan_train
               for 10 steps lowers the loss
  decode_variants  the headline chunk (K = 128, 1280x720, bf16, raw u8)
               with decode_fusion post or tail and topk_impl sort, bisect
               or approx: outputs equal to post/sort bit for bit, launches
               per chunk nms_keep 1, tracker_chunk 1, auction 0, each
               variant's decode device ms and call ms per chunk on the
               chunk's own heads; the per-frame path with tail and bisect
               (1 and 3 launches a frame) equal to post/sort; tail and
               bisect in fp32 on the CPU and the card (a chunk of 8 and 4
               frames): ids equal, keypoints within 1e-2 px; the packed
               stem (P = 4, B = 8, fp32) giving the plain stem's detections
  engine       models.engine.YoloPoseEngine (yolov8n-pose 640, bf16) on
               1280x720 frames: detect (legacy NMS), detect_batch of 8,
               detect_device_native (Kernel 1 once a call),
               detect_from_device, each timed; the int8 engine (59 Kernel 4
               launches and 1 Kernel 1 launch a frame); fp32 card against
               CPU (validity equal, keypoints within 1e-2 px)
  aot          models.aot: the bf16, int8 and fp32 programs exported on the
               card into build/aot and loaded back, each against eager
               forward_raw (within AOT_REL of its largest value) and timed
               beside it; the int8 program's runs launch Kernel 4 59 times
               each, its plain version never; a CPU export against the
               card's fp32 program (1e-2 px); a card program refused on
               the CPU
  debug        tracker.debug on the card against the CPU from the same
               state (assignments, gates equal; costs within 1e-6; 3
               Kernel 2 launches a call), dump_detections and
               get_track_states equal, and utils.profiling.torch_trace's
               Chrome trace holding the auction kernel by name
Each path's launch counts are set to 0 just before it runs and read just
after. Then a line {"kernels": [...]} with each kernel's launches (summed
over the paths' runs, yolo11n-pose's included), error, times and bound
(yolo11n-pose's under "_v11" keys, Kernel 4's under "v11"; the tracker
chunk's also
with Re-ID and with kalman136, and the variants it was held in, with
Kernel 3's stage clock split (ops.tracker_chunk.read_stage_clock: us per
frame of each stage, auction rounds per frame, share of frames at the
round budget) for the pipeline chunk, the stress chunk, Re-ID at D = 64
and 128 and kalman136; Kernel 1's also per frame at B = 1 and at
B = 128, and at the servers' B = 8 and 64, Kernel 3's at the servers' K =
1 and 8 for S = 8; Kernel 4's per chunk of the int8 path, its float mode as "ms"
and its int8 mode beside it, with its instantiations and yardsticks), and
last {"ok": true, "device": {...}}. Any failure raises and exits non-zero
before that line; a hang is cut by faulthandler.
"""
import collections
import contextlib
import faulthandler
import functools
import json
import os
import subprocess
import sys
import time

LIMIT_S = 840          # hard stop for a hung run
FRAMES = 16
CMP_FRAMES = 8
CHUNK = 128            # frames per chunk, the JAX package's headline
TIMED_CHUNKS = 2
CMP_CHUNK = 8
WIDTH, HEIGHT = 1280, 720
N_PERSONS = 6
SEED = 7
REID_WEIGHT = 0.3      # the repo's one Re-ID configuration
LETTERBOX = 640        # the model input, where the Re-ID sources sample
V8, V11 = "yolov8n-pose", "yolo11n-pose"   # the two families' n models
HEAD_ASSET = "reid-head-synthetic.safetensors"
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
INT8_OPS_S = 1979e12   # dense int8 tensor-core operations/s
INT8_CALIB_FRAMES = 16  # one calibration batch
# int8 card against CPU: keypoints within this (median within 0.5 px). The
# float convolutions of cuDNN and oneDNN differ ~1e-6 relative, which moves
# a few activations across a rounding boundary of the next quantisation
# (int8_quant_witness counts them per conv; the quantisation itself is
# equal on equal inputs); one int8 step of a head activation moves a
# keypoint by up to ~4 px at stride 32, and the flips cascade through the
# layers after them.
INT8_KP_MAX_PX = 8.0


# sha256 of draw_scene()'s bytes as the native rasteriser draws them on
# the host the tests run on (tests/test_torch_video.py holds it there); the
# cli phase draws the same on the card's host and compares.
DRAW_DIGEST = ("ae39c999b61339699c4ea470497e13c9"
               "9e2fb1c4aa69243bfc269967d7c7e7a7")


def draw_scene():
    """A fixed 640x360 drawing through the port's native rasteriser: the
    tracks of six people of the synthetic scene (ids across the palette's
    wrap, one box leaving the frame, low-confidence keypoints) by
    draw_all_tracks, then draw_stats. numpy and the native library only."""
    import numpy as np
    from posebyte_tpu_torch.tracker.output import TrackOutput
    from posebyte_tpu_torch.utils import native
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, pose_bbox
    from posebyte_tpu_torch.utils.video import draw_all_tracks, draw_stats
    if not native.available():
        raise SystemExit("the native rasteriser did not build")
    poses = SyntheticScene(6, 640, 360, seed=SEED).step()
    poses[2, :5, 2] = 0.1
    poses[4, :, 0] += 150.0
    tracks = [TrackOutput(track_id=7 * i + 1, score=0.5 + 0.07 * i,
                          bbox=pose_bbox(p), keypoints=p)
              for i, p in enumerate(poses)]
    frame = np.full((360, 640, 3), 40, np.uint8)
    draw_all_tracks(frame, tracks)
    draw_stats(frame, 29.97, len(tracks), 12.34)
    return frame


def draw_digest():
    import hashlib
    return hashlib.sha256(draw_scene().tobytes()).hexdigest()


def emit(phase, t0, **kw):
    print(json.dumps({"phase": phase,
                      "s": round(time.perf_counter() - t0, 3), **kw}),
          flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call over `reps` calls issued back to back (CUDA events),
    after one warm-up call: the call as the pipeline makes it, the host's
    time per call where the host is slower than the device. A row's "ms"
    keeps this meaning (utils/timing.py::call_ms)."""
    from posebyte_tpu_torch.utils.timing import call_ms
    return call_ms(fn, reps)


def device_ms(fn, reps):
    """Mean device ms per call over `reps` calls with the device kept
    ahead of the host by a sleep kernel, so that it runs them back to back
    (utils/timing.py::device_ms): a row's "device_ms"."""
    from posebyte_tpu_torch.utils import timing
    return timing.device_ms(fn, reps)


def conv_int8_work(B, H, W, C, O, k, stride, bias=True, in_bytes=1):
    """(bytes, int8 operations) of one w8a8 convolution: the activation
    [B, H, W, C] (in_bytes per element: 1 for Kernel 4's int8 mode, 2 for
    its float mode on bf16) and the weights [k, k, C, O] int8 read once,
    scale (and bias) float32 read once, the bf16 output written once; a
    multiply and an add per tap, input channel and output element."""
    Ho, Wo = (H + 2 * (k // 2) - k) // stride + 1, \
        (W + 2 * (k // 2) - k) // stride + 1
    nbytes = (in_bytes * B * H * W * C + k * k * C * O + 4 * O * (1 + bias)
              + 2 * B * Ho * Wo * O)
    return nbytes, 2 * k * k * C * B * Ho * Wo * O


def nms_work(poses, boxes, valid, iou_thr):
    """(bytes, float32 operations) the keep mask needs on these inputs:
    each input read once, the mask written once; per valid pair j < k the
    box IoU (~12 operations) and, where IoU alone does not decide, ~8 per
    co-visible keypoint (subtract, square, add, scale, divide, exp, sum)."""
    from posebyte_tpu_torch.ops.geometry import boxes_iou_matrix
    n = valid.shape[0]
    nbytes = poses.numel() * 4 + boxes.numel() * 4 + 2 * n
    pair = (valid[:, None] & valid[None, :]).triu(1)
    iou = boxes_iou_matrix(boxes, boxes)
    vis = poses[..., 2] > 0.2
    covis = (vis[:, None, :] & vis[None, :, :]).sum(-1)
    need_oks = pair & (iou <= iou_thr)
    ops = 12 * int(pair.sum()) + 8 * int((covis * need_oks).sum())
    return nbytes, ops


def greedy_sweeps(poses, boxes, valid):
    """Jacobi sweeps the greedy solution needs (longest suppression chain
    + 1); the TPU kernel stops after 24."""
    import torch
    from posebyte_tpu_torch.core.structs import Detections
    from posebyte_tpu_torch.ops.nms import nms_overlap_matrix
    det = Detections(poses, boxes, torch.zeros_like(boxes[:, 0]), valid)
    dom = nms_overlap_matrix(det, 0.55, 0.55).triu(1)
    keep, prev, sweeps = valid, torch.zeros_like(valid), 0
    while not torch.equal(keep, prev):
        prev, keep = keep, valid & ~(dom & keep[:, None]).any(0)
        sweeps += 1
    return sweeps


def bound(nbytes, ops, ops_s=F32_OPS_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def chunk_case(dev, streams, seed=SEED):
    """Kernel 3's inputs on the card: `streams` streams of K = CHUNK frames
    of seeded detections from the synthetic scene (dropouts, a lost and
    recovered person, near-duplicates, empty and crowded frames), holes in
    the advance mask, and a fresh pool of T = 128 slots, D = 64."""
    import torch
    from posebyte_tpu_torch.core.structs import Detections, TrackerState
    from posebyte_tpu_torch.ops.tracker_chunk import _stack
    from posebyte_tpu_torch.utils.synthetic import tracker_chunk_case
    dets, advs = [], []
    for s in range(streams):
        arrays, adv = tracker_chunk_case(seed + s, CHUNK, 64, n_persons=6,
                                         crowd=40)
        dets.append(Detections(*(torch.from_numpy(a).to(dev)
                                 for a in arrays)))
        advs.append(torch.from_numpy(adv).to(dev))
    state = TrackerState.init(128, 64, dev)
    return (_stack([state] * streams), _stack(dets), torch.stack(advs))


def chunk_diff(got, want):
    """(integer mismatches, max abs float difference) between two
    (state, outs) results of the tracker chunk."""
    import dataclasses
    (gs, go), (ws, wo) = got, want
    pairs = [(getattr(gs, f.name), getattr(ws, f.name))
             for f in dataclasses.fields(gs)] + [(go[k], wo[k]) for k in wo]
    mism, err = 0, 0.0
    for g, w in pairs:
        if g.dtype.is_floating_point:
            err = max(err, float((g - w).abs().max()))
        else:
            mism += int((g != w).sum())
    return mism, err


def tracker_chunk_work(dets, adv, outs, T=128, emb=None, kalman=False):
    """(bytes, float32 operations) of one chunk of one or more streams on
    these inputs: each input read once (detections, mask, each stream's
    initial state with its embeddings, with Re-ID the detections'
    embeddings [K, D, 51], with kalman136 the filter's mean and covariance
    [T, 136]), each output written once (frame outputs, final state); per
    frame, ~30 operations for the
    gate of each active-track x valid-detection pair plus ~8 per keypoint
    of the OKS (17) and torso OKS (4) on each such pair, and ~20 per track
    pair of the dedup. With Re-ID also ~15 per keypoint (the two energies,
    the dot product, the three sums) and ~8 more (square roots, division,
    blend) for the cosine of each such pair, ~5 per keypoint for each
    valid detection's energies, and ~6 per component for the EMA of each
    matched track (at most min(active, valid) of them). With kalman136 28
    per (slot, keypoint) for the predict of every slot and ~22 per
    keypoint of each matched track's update. The active tracks entering a
    frame are those of the last advanced frame's output."""
    K, D = dets.scores.shape[-2:]
    streams = dets.scores.numel() // (K * D)
    state_bytes = streams * (T * (51 + 34 + 1 + 51) * 4 + T * 6 * 4 + T
                             + 8 + D * 4 + (2 * T * 136 * 4 if kalman
                                            else 0))
    nbytes = (dets.poses.numel() * 4 + dets.scores.numel() * 4
              + dets.valid.numel() + adv.numel() + 2 * state_bytes
              + sum(v.numel() * v.element_size() for v in outs.values())
              + (emb.numel() * 4 if emb is not None else 0))
    na = outs["num_active"].reshape(-1, K).tolist()
    nv = dets.valid.reshape(-1, K, D).sum(-1).tolist()
    ad = adv.reshape(-1, K).tolist()
    pair = 30 + 8 * (17 + 4) + (15 * 17 + 8 if emb is not None else 0)
    ops = 0
    for s_na, s_nv, s_ad in zip(na, nv, ad):
        active = 0
        for k in range(K):
            ops += active * s_nv[k] * pair + 20 * active ** 2
            if emb is not None:
                ops += 5 * 17 * s_nv[k] + 6 * 51 * min(active, s_nv[k])
            if kalman:
                ops += 28 * T * 17 + 22 * 17 * min(active, s_nv[k])
            if s_ad[k]:
                active = s_na[k]
    return nbytes, ops


def stage_split(run, ms_per_frame, frames=CHUNK):
    """Kernel 3's stage clock over one launch of `run(stage_cycles)` (one
    stream of `frames` frames): ops.tracker_chunk.read_stage_clock with
    the us per frame of each stage at the measured ms per frame."""
    import torch
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    clock = torch.zeros(TC.CLOCK_COLUMNS, dtype=torch.int64, device="cuda")
    out = run(clock)
    torch.cuda.synchronize()
    return TC.read_stage_clock(clock, frames, ms_per_frame), out


def tracker_chunk_row(dev):
    """Kernel 3 against its plain version at S = 1 and S = 3 streams
    (integer outputs and state equal, floats within 1e-5 px + 1e-6
    relative), and its times."""
    import torch
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    cfg = TrackerConfig()
    mism, err, emitted = 0, 0.0, 0
    for streams in (1, 3):
        state, dets, adv = chunk_case(dev, streams)
        got = TC.tracker_chunk_cuda(state, dets, cfg, adv)
        want = TC.tracker_chunk_plain(state, dets, cfg, adv)
        torch.cuda.synchronize()
        m, e = chunk_diff(got, want)
        mism, err = mism + m, max(err, e)
        emitted += int(got[1]["emit"].sum())
        if m or e > 1e-5 + 1e-6 * 1280:
            raise SystemExit(f"tracker_chunk at S={streams}: {m} integer "
                             f"mismatches, float error {e}")
    state, dets, adv = chunk_case(dev, 1)
    one = (TC._pick(state, 0), TC._pick(dets, 0), adv[0])
    outs = TC.tracker_chunk_cuda(*one[:2], cfg, one[2])[1]
    nbytes, ops = tracker_chunk_work(dets, adv, outs)
    b_ms, b_by = bound(nbytes, ops)
    ms = cuda_ms(lambda: TC.tracker_chunk_cuda(*one[:2], cfg, one[2]), 20)
    dev_ms = device_ms(lambda: TC.tracker_chunk_cuda(*one[:2], cfg, one[2]),
                       20)
    split, clocked = stage_split(lambda c: TC.tracker_chunk_cuda(
        *one[:2], cfg, one[2], stage_cycles=c), ms / CHUNK)
    m, e = chunk_diff(clocked, TC.tracker_chunk_cuda(*one[:2], cfg, one[2]))
    if m or e:
        raise SystemExit(f"tracker_chunk with its stage clock: {m} integer "
                         f"mismatches, float error {e}")
    return {
        "name": "tracker_chunk", "route": "cuda",
        "source": "posebyte_tpu_torch/csrc/tracker_chunk.cu",
        "replaces": "posebyte_tpu/ops/pallas_tracker.py:648",
        "mismatches": mism, "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "ms_per_frame": ms / CHUNK,
        "plain_ms": cuda_ms(lambda: TC.tracker_chunk_plain(
            *one[:2], cfg, one[2]), 1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"K={CHUNK},T=128,D=64,S=1 and 3,emitted={emitted}",
        "bytes": nbytes, "ops": ops, "stage_split": split}


def phase_kernels(t0):
    import numpy as np
    import torch
    from posebyte_tpu_torch.ops import assignment as A
    from posebyte_tpu_torch.ops import nms as N
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    from posebyte_tpu_torch.utils.synthetic import auction_case, nms_case

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows = {}
    start = {"nms_keep": N.nms_keep_cuda.launches,
             "auction": A.auction_assign_cuda.launches,
             "tracker_chunk": TC.tracker_chunk_cuda.launches}

    # ---- Kernel 1: NMS keep mask, N = 256 --------------------------------
    mism, sweeps = 0, 0
    cases = [nms_case(rng), nms_case(rng, chain=40), nms_case(rng, chain=0)]
    for p_np, b_np, v_np in cases:
        p, b, v = (torch.from_numpy(a).to(dev) for a in (p_np, b_np, v_np))
        got = N.nms_keep_cuda(p, b, v, 0.55, 0.55)
        want = N.nms_keep_plain(p, b, v, 0.55, 0.55)
        torch.cuda.synchronize()
        mism += int((got != want).sum())
        sweeps = max(sweeps, greedy_sweeps(p, b, v))
    # N = 1024 (max_candidates at the reference's cap): the greedy pass
    # reads its mask from shared memory. Its own generator, so that the
    # cases after it are those of earlier runs.
    p_np, b_np, v_np = nms_case(np.random.default_rng(SEED + 1), n=1024,
                                n_valid=1000, chain=40)
    p4, b4, v4 = (torch.from_numpy(a).to(dev) for a in (p_np, b_np, v_np))
    got = N.nms_keep_cuda(p4, b4, v4, 0.55, 0.55)
    want = N.nms_keep_plain(p4, b4, v4, 0.55, 0.55)
    torch.cuda.synchronize()
    mism += int((got != want).sum())
    b4_ms, _ = bound(*nms_work(p4, b4, v4, 0.55))
    p, b, v = (torch.from_numpy(a).to(dev) for a in cases[0])
    nbytes, ops = nms_work(p, b, v, 0.55)
    b_ms, b_by = bound(nbytes, ops)
    rows["nms_keep"] = {
        "name": "nms_keep", "route": "cuda",
        "source": "posebyte_tpu_torch/csrc/nms_keep.cu",
        "replaces": "posebyte_tpu/ops/pallas_kernels.py:226",
        "mismatches": mism, "max_abs_err": float(mism > 0),
        "ms": cuda_ms(lambda: N.nms_keep_cuda(p, b, v, 0.55, 0.55), 200),
        "device_ms": device_ms(lambda: N.nms_keep_cuda(p, b, v, 0.55, 0.55),
                               200),
        "plain_ms": cuda_ms(lambda: N.nms_keep_plain(p, b, v, 0.55, 0.55),
                            10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_n1024": cuda_ms(lambda: N.nms_keep_cuda(p4, b4, v4, 0.55, 0.55),
                            50),
        "device_ms_n1024": device_ms(
            lambda: N.nms_keep_cuda(p4, b4, v4, 0.55, 0.55), 50),
        "plain_ms_n1024": cuda_ms(
            lambda: N.nms_keep_plain(p4, b4, v4, 0.55, 0.55), 2),
        "bound_ms_n1024": b4_ms,
        "shape": f"N=256,sweeps={sweeps}; N=1024,valid=1000",
        "bytes": nbytes, "ops": ops}

    # ---- Kernel 2: auction, 128 x 64 -------------------------------------
    mism, err, rounds = 0, 0, 0
    counted = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(3):
        c_np, a_np = auction_case(rng)
        c, a = torch.from_numpy(c_np).to(dev), torch.from_numpy(a_np).to(dev)
        r1, c1 = A.auction_assign_cuda(c, a)
        r3, c3 = A.auction_assign_cuda(c[None], a[None], rounds=counted)
        r2, c2, rounds = A.auction_assign_rounds(c, a)
        torch.cuda.synchronize()
        mism += int((r1 != r2).sum()) + int((c1 != c2).sum()) + \
            int((r3[0] != r2).sum()) + int((c3[0] != c2).sum()) + \
            int(int(counted[0]) != rounds)
        err = max(err, int((r1 - r2).abs().max()), int((c1 - c2).abs().max()))
    R, Cc = c.shape
    nbytes = R * Cc * 4 + R + 4 * (R + Cc)
    budget = A.auction_iterations(R)
    ops = 6 * R * Cc * rounds + (4 * R * Cc if rounds < budget else 0)
    b_ms, b_by = bound(nbytes, ops)
    rows["auction"] = {
        "name": "auction", "route": "cuda",
        "source": "posebyte_tpu_torch/csrc/auction.cu",
        "replaces": "posebyte_tpu/ops/pallas_kernels.py:98",
        "mismatches": mism, "max_abs_err": float(err),
        "ms": cuda_ms(lambda: A.auction_assign_cuda(c, a), 200),
        "device_ms": device_ms(lambda: A.auction_assign_cuda(c, a), 200),
        "plain_ms": cuda_ms(lambda: A.auction_assign(c, a), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"R={R},C={Cc}", "rounds": rounds, "bytes": nbytes,
        "ops": ops}

    # ---- Kernel 3: tracker chunk, K = 128, T = 128, D = 64 -------------
    rows["tracker_chunk"] = tracker_chunk_row(dev)

    done = {"nms_keep": N.nms_keep_cuda.launches,
            "auction": A.auction_assign_cuda.launches,
            "tracker_chunk": TC.tracker_chunk_cuda.launches}
    emit("kernels", t0, kernels=[
        {"name": r["name"], "launches": done[k] - start[k],
         "mismatches": r["mismatches"], "max_abs_err": r["max_abs_err"],
         "kernel_ms": r["ms"], "device_ms": r["device_ms"],
         "ms_per_frame": r.get("ms_per_frame"),
         "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "shape": r["shape"]} for k, r in rows.items()])
    bad = {k: r["mismatches"] for k, r in rows.items() if r["mismatches"]}
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return rows


def suffix(model):
    """The row keys' suffix of a model's numbers: none for the v8 model
    the rows were first written for, "_v11" for YOLO11."""
    return "" if model == V8 else "_v11"


def make_frames(n):
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame
    scene = SyntheticScene(N_PERSONS, WIDTH, HEIGHT, seed=SEED)
    gts, frames = [], []
    for _ in range(n):
        gt = scene.step()
        gts.append(gt)
        frames.append(render_frame(gt, WIDTH, HEIGHT))
    return gts, frames


def phase_main_path(t0, params, rows, model=V8, phase="main_path"):
    """The per-frame path of `model` (bf16) over FRAMES frames; the v8
    run's Kernel 1 time and Kernel 2 rounds keep their row keys, another
    model's get its suffix ("_v11")."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.ops import nms as N
    from posebyte_tpu_torch.ops.assignment import auction_assign_cuda
    from posebyte_tpu_torch.ops.nms import nms_keep_cuda
    from posebyte_tpu_torch.ops.tracker_chunk import tracker_chunk_cuda
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.tracker import step as S

    gts, frames = make_frames(FRAMES)
    pipe = PosePipeline(PipelineConfig(model_name=model), params)  # bf16
    sfx = suffix(model)
    nms_keep_cuda.launches = 0
    auction_assign_cuda.launches = 0
    tracker_chunk_cuda.launches = 0
    dets, tracks, ms = [], [], []
    nms_calls, nms_keep = [], N.nms_keep    # the candidates pose_nms keeps
    N.nms_keep = lambda *a: (nms_calls.append(a), nms_keep(*a))[1]
    auction_calls, auction = [], S._auction    # 3 tiers a frame

    def record(*a):
        out = auction(*a)
        auction_calls.append(a + out)
        return out
    S._auction = record
    try:
        for fr in frames:
            t = time.perf_counter()
            out = pipe.process_frame(fr)
            res = pipe.fetch_outputs(out, WIDTH, HEIGHT)
            ms.append((time.perf_counter() - t) * 1e3)
            dets.append(int(out["det_valid"].sum()))
            tracks.append(len(res))
            for r in res:
                if not (np.isfinite(r.keypoints).all()
                        and np.isfinite(r.bbox).all()):
                    raise SystemExit("non-finite track output")
    finally:
        N.nms_keep = nms_keep
        S._auction = auction
    launches = {"nms_keep": nms_keep_cuda.launches,
                "auction": auction_assign_cuda.launches,
                "tracker_chunk": tracker_chunk_cuda.launches}
    tiers = auction_tier_rounds(auction_calls)
    # Kernel 1 at B = 1 on the last frame's own candidates (N = 256)
    p, b, v, iou_thr, oks_thr = nms_calls[-1]
    nms_ms = cuda_ms(lambda: nms_keep_cuda(p, b, v, iou_thr, oks_thr), 200)
    nms_bound, _ = bound(*nms_work(p.reshape(-1, 17, 3), b.reshape(-1, 4),
                                   v.reshape(-1), iou_thr))
    rows["nms_keep"].update({"ms_frame" + sfx: nms_ms,
                             "bound_ms_frame" + sfx: nms_bound,
                             "frame_candidates" + sfx: int(v.sum())})
    # accuracy: every person of the last frame has a track within 10 px
    kp = np.stack([r.keypoints[:, :2] for r in res]) if res else \
        np.zeros((0, 17, 2), np.float32)
    errs = [float(np.abs(kp - g[None, :, :2]).mean(axis=(1, 2)).min())
            if len(kp) else float("inf") for g in gts[-1]]
    emit(phase, t0, model=model, frames=FRAMES, dets_per_frame=dets,
         tracks_per_frame=tracks, launches=launches,
         ms_per_frame_after_warmup=float(np.mean(ms[4:])),
         ms_first_frame=ms[0], last_frame_kp_err_px=errs,
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
         nms_frame_ms=nms_ms, nms_frame_bound_ms=nms_bound,
         nms_frame_shape=list(v.shape), nms_frame_valid=int(v.sum()),
         auction_rounds_per_tier=tiers)
    rows["auction"]["rounds_main_path" + sfx] = tiers
    for k, n in launches.items():
        rows[k]["launches"] = rows[k].get("launches", 0) + n
    if launches != {"nms_keep": FRAMES, "auction": 3 * FRAMES,
                    "tracker_chunk": 0}:
        raise SystemExit(f"{phase} launch counts {launches}, expected "
                         f"{FRAMES}, {3 * FRAMES} and 0")
    if max(errs) > 10.0:
        raise SystemExit(f"{phase}: tracks miss the synthetic people: "
                         f"{errs}")


def auction_tier_rounds(calls):
    """Kernel 2's rounds per tier over the per-frame path's auctions
    (cost, active, row, col per call, three tiers a frame in order): each
    tier's matrices again in one launch with rounds_out, whose assignments
    must equal the path's; the mean and maximum rounds and the share of
    frames at the budget min(3R, 50)."""
    import torch
    from posebyte_tpu_torch.ops import assignment as A
    tiers = []
    for t in range(3):
        sel = calls[t::3]
        cost = torch.stack([c[0] for c in sel])
        rounds = torch.zeros(len(sel), dtype=torch.int32, device=cost.device)
        row, col = A.auction_assign_cuda(
            cost, torch.stack([c[1] for c in sel]), rounds=rounds)
        if not (torch.equal(row, torch.stack([c[2] for c in sel]))
                and torch.equal(col, torch.stack([c[3] for c in sel]))):
            raise SystemExit(f"tier {t + 1}: Kernel 2 with rounds_out gave "
                             "other assignments than the path's")
        r = rounds.cpu().numpy()
        budget = A.auction_iterations(cost.shape[1])
        tiers.append({"tier": t + 1, "frames": len(r),
                      "mean": float(r.mean()), "max": int(r.max()),
                      "share_at_budget": float((r >= budget).mean()),
                      "shape": list(cost.shape[1:])})
    return tiers


def phase_cpu_vs_card(t0, params, model=V8, phase="cpu_vs_card"):
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.pipeline import PosePipeline

    _, frames = make_frames(CMP_FRAMES)
    cfg = PipelineConfig(precision="fp32", model_name=model)
    runs = {}
    for dev in ("cpu", "cuda"):
        pipe = PosePipeline(cfg, params, device=dev)
        runs[dev] = [pipe.fetch_outputs(pipe.process_frame(f), WIDTH, HEIGHT)
                     for f in frames]
    ids_equal, kp_err = tracks_diff(runs["cpu"], runs["cuda"])
    emit(phase, t0, model=model, frames=CMP_FRAMES, ids_equal=ids_equal,
         tracks_per_frame=[len(r) for r in runs["cuda"]],
         max_kp_diff_px=kp_err)
    if not ids_equal or kp_err > 1e-2 or not any(runs["cuda"]):
        raise SystemExit(f"{phase}: the card and the CPU disagree")


@functools.lru_cache(maxsize=4)
def _chunks(n_chunks, k):
    import numpy as np
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame
    scene = SyntheticScene(N_PERSONS, WIDTH, HEIGHT, seed=SEED)
    out = []
    for _ in range(n_chunks):
        gts = [scene.step() for _ in range(k)]
        out.append((np.stack([render_frame(g, WIDTH, HEIGHT) for g in gts]),
                    gts[-1]))
    return out


def make_chunks(n_chunks, k):
    """n_chunks consecutive chunks [k, H, W, 3] of one synthetic scene and
    the people's poses in each chunk's last frame (rendered once, shared by
    the phases)."""
    yield from _chunks(n_chunks, k)


def track_errors(res, gt):
    """Per person of `gt`, the mean keypoint distance to the nearest
    track (px); inf when there is no track."""
    import numpy as np
    kp = np.stack([r.keypoints[:, :2] for r in res]) if res else \
        np.zeros((0, 17, 2), np.float32)
    return [float(np.abs(kp - g[None, :, :2]).mean(axis=(1, 2)).min())
            if len(kp) else float("inf") for g in gt]


def phase_chunk_path(t0, params, rows, model=V8, phase="chunk_path"):
    """The chunk path of `model` (bf16) at K = CHUNK; the v8 run's Kernel 1
    and 3 times keep their row keys, another model's get its suffix."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.models.yolo_pose import forward_heads
    from posebyte_tpu_torch.ops.assignment import auction_assign_cuda
    from posebyte_tpu_torch.ops.decode import decode_topk
    from posebyte_tpu_torch.ops.nms import nms_keep_cuda
    from posebyte_tpu_torch.ops.preprocess import letterbox_flat_nhwc
    from posebyte_tpu_torch.ops.tracker_chunk import tracker_chunk_cuda
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.utils.profiling import clocked_split, \
        recorded_tracker_calls

    cfg = PipelineConfig(model_name=model)            # the card, bf16
    pipe = PosePipeline(cfg, params)
    sfx = suffix(model)
    torch.cuda.reset_peak_memory_stats()
    kernels = {"nms_keep": nms_keep_cuda, "auction": auction_assign_cuda,
               "tracker_chunk": tracker_chunk_cuda}
    for fn in kernels.values():
        fn.launches = 0
    ms, per_chunk, tracks, errs = [], [], [], []
    for frames, gt in make_chunks(1 + TIMED_CHUNKS, CHUNK):
        before = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recorded_tracker_calls() as calls:
            outs = pipe.process_chunk(frames)
        res = pipe.fetch_chunk_outputs(outs, WIDTH, HEIGHT)
        ms.append((time.perf_counter() - t) * 1e3)
        per_chunk.append({k: fn.launches - before[k]
                          for k, fn in kernels.items()})
        tracks.append([len(r) for r in res])
        errs = track_errors(res[-1], gt)
        for r in res:
            for tr in r:
                if not (np.isfinite(tr.keypoints).all()
                        and np.isfinite(tr.bbox).all()):
                    raise SystemExit("non-finite track output")
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    prof = profiled_chunk(pipe, frames)

    # Kernel 3 on the last chunk's own inputs: its time and stage clock
    args, kw = calls[-1]
    k3_ms = cuda_ms(lambda: tracker_chunk_cuda(*args, **kw), 20)
    k3_split = clocked_split(calls, k3_ms / CHUNK)

    # Kernel 1 on this chunk's own candidates (B = 128)
    dc = pipe.config.detector
    with torch.inference_mode():
        flat = pipe.stage_chunk(frames)
        imgs = letterbox_flat_nhwc(flat, WIDTH, HEIGHT, dc.input_size,
                                   selection=True, raw=True)
        det = decode_topk(*forward_heads(pipe.params, imgs.to(pipe.dtype),
                                         pipe.family),
                          dc.conf_threshold, dc.max_candidates, dc.input_size)
        nms_ms = cuda_ms(lambda: nms_keep_cuda(
            det.poses, det.boxes, det.valid, dc.iou_threshold,
            dc.oks_threshold), 50)
        nbytes = ops = 0
        for i in range(CHUNK):
            b, o = nms_work(det.poses[i], det.boxes[i], det.valid[i],
                            dc.iou_threshold)
            nbytes, ops = nbytes + b, ops + o
    nms_bound, nms_by = bound(nbytes, ops)
    timed = ms[1:]
    emit(phase, t0, model=model, chunk=CHUNK, chunks=len(ms),
         launches_per_chunk=per_chunk, launches=launches,
         ms_first_chunk=ms[0], ms_per_chunk=timed,
         frames_per_s=CHUNK * len(timed) / (sum(timed) / 1e3),
         tracks_in_last_chunk=tracks[-1][-8:],
         last_frame_kp_err_px=errs, peak_mem_mb=peak,
         candidates_per_frame=float(det.valid.sum()) / CHUNK,
         nms_b128_ms=nms_ms, nms_b128_bound_ms=nms_bound,
         nms_b128_bound_by=nms_by, tracker_chunk_ms=k3_ms, **prof)
    for k, n in launches.items():
        rows[k]["launches"] += n
    rows["nms_keep"].update({"ms_b128" + sfx: nms_ms,
                             "bound_ms_b128" + sfx: nms_bound})
    rows["tracker_chunk"].update({"ms_pipeline" + sfx: k3_ms,
                                  "stage_split_pipeline" + sfx: k3_split})
    if any(c != {"nms_keep": 1, "auction": 0, "tracker_chunk": 1}
           for c in per_chunk):
        raise SystemExit(f"{phase} launch counts per chunk {per_chunk}, "
                         "expected nms_keep 1, tracker_chunk 1, auction 0")
    if max(errs) > 10.0:
        raise SystemExit(f"{phase}: chunk tracks miss the synthetic people: "
                         f"{errs}")


def profiled_chunk(pipe, frames):
    """One more chunk of `frames` under torch.profiler, after the counted
    and timed ones: device busy ms per frame (the kernels' and copies'
    device time; the stage labels' device-side spans are not busy time),
    Kernel 4's by name, device operations per frame, the idle share 1 -
    busy / the profiled wall time, and the 8 device items with the most
    ms per frame; then the model's device ms per frame (model_device_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from posebyte_tpu_torch.utils.profiling import STAGES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe.fetch_chunk_outputs(pipe.process_chunk(frames), WIDTH, HEIGHT)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / CHUNK
    per_item = collections.defaultdict(float)
    ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name not in STAGES:
            per_item[kernel_label(e.name)[:60]] += \
                e.device_time_total / 1e3 / CHUNK
            ops += 1
    busy = sum(per_item.values())
    conv4 = sum(v for k, v in per_item.items() if "conv_int8" in k)
    measured = busy > 0
    top = sorted(per_item.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_ms_per_frame": wall,
            "device_busy_ms_per_frame": busy if measured else None,
            "conv_int8_device_ms_per_frame": conv4 if measured else None,
            "device_ops_per_frame": ops / CHUNK if measured else None,
            "idle_share": 1.0 - busy / wall if measured else None,
            "top_device_ms_per_frame": top,
            "model_device_ms_per_frame": model_device_ms(pipe, frames)}


def model_device_ms(pipe, frames):
    """The model's device ms per frame at B = len(frames): forward_heads on
    the frames' letterbox as the chunk path makes it, run by a device kept
    ahead of the host (utils/timing.py::device_ms), Kernel 4's launches
    included at int8. One call: a forward is ~300-500 launches, and the
    host blocks once ~1000 wait in the card's queue, behind the sleep."""
    import torch
    from posebyte_tpu_torch.models.yolo_pose import forward_heads
    from posebyte_tpu_torch.ops.preprocess import letterbox_flat_nhwc
    with torch.inference_mode():
        imgs = letterbox_flat_nhwc(pipe.stage_chunk(frames), WIDTH, HEIGHT,
                                   pipe.config.detector.input_size,
                                   selection=True, raw=True).to(pipe.dtype)
        return device_ms(lambda: forward_heads(pipe.params, imgs,
                                               pipe.family), 1) / len(frames)


def phase_chunk_cpu_vs_card(t0, params, model=V8,
                            phase="chunk_cpu_vs_card"):
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.pipeline import PosePipeline

    frames, _ = next(make_chunks(1, CMP_CHUNK))
    cfg = PipelineConfig(precision="fp32", model_name=model)
    runs = {}
    for dev in ("cpu", "cuda"):
        pipe = PosePipeline(cfg, params, device=dev)
        runs[dev] = pipe.fetch_chunk_outputs(pipe.process_chunk(frames),
                                             WIDTH, HEIGHT)
    ids_equal, kp_err = tracks_diff(runs["cpu"], runs["cuda"])
    emit(phase, t0, model=model, frames=CMP_CHUNK, ids_equal=ids_equal,
         tracks_per_frame=[len(r) for r in runs["cuda"]],
         max_kp_diff_px=kp_err)
    if not ids_equal or kp_err > 1e-2 or not any(runs["cuda"]):
        raise SystemExit(f"{phase}: the chunk path on the card and the CPU "
                         "disagree")


def reid_sources(dev, params_dir):
    """{name: (embed_fn, reid_params)} of the two appearance sources on
    the card, sampling a raw uint8 letterbox as the chunk path gives it:
    the pose-colour descriptor and the learned head."""
    from posebyte_tpu_torch.models import load_reid_head
    from posebyte_tpu_torch.ops.reid import make_embed_fn
    head = load_reid_head(os.path.join(params_dir, HEAD_ASSET))
    head_dev = {k: v.to(dev) for k, v in head.items()}
    return {"descriptor": (make_embed_fn(None, True), None),
            "head": (make_embed_fn(head_dev, True), head)}


def reid_chunk_case(dev, streams, D=64, seed=SEED):
    """chunk_case's stress detections at capacity D (crowded frames of up
    to D - 24 extra poses) made in the coordinates of a LETTERBOX x
    LETTERBOX model input, the frames of the scene they come from rendered
    at that size (where the Re-ID sources sample), the advance mask and a
    fresh pool of 128 slots: (state, dets, advance, frames [S, K, L, L, 3]
    u8)."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core.structs import Detections, TrackerState
    from posebyte_tpu_torch.ops.tracker_chunk import _stack
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame, tracker_chunk_case
    dets, advs, frames = [], [], []
    for s in range(streams):
        arrays, adv = tracker_chunk_case(seed + s, CHUNK, D, n_persons=6,
                                         width=LETTERBOX, height=LETTERBOX,
                                         crowd=D - 24)
        scene = SyntheticScene(6, LETTERBOX, LETTERBOX, seed=seed + s)
        frames.append(np.stack([render_frame(scene.step(), LETTERBOX,
                                             LETTERBOX)
                                for _ in range(CHUNK)]))
        dets.append(Detections(*(torch.from_numpy(a).to(dev)
                                 for a in arrays)))
        advs.append(torch.from_numpy(adv).to(dev))
    state = TrackerState.init(128, D, dev)
    return (_stack([state] * streams), _stack(dets), torch.stack(advs),
            torch.from_numpy(np.stack(frames)).to(dev))


def reid_case(cases, sources, streams, D):
    """reid_chunk_case at (streams, D) on the card and the detections'
    embeddings from each source ({name: [S, K, D, 51]}), made once and kept
    in the dict `cases` (the rendered frames are dropped)."""
    import torch
    if (streams, D) not in cases:
        state, dets, adv, frames = reid_chunk_case("cuda", streams, D)
        embs = {}
        for name, (embed, _) in sources.items():
            with torch.no_grad():
                emb = embed(frames.flatten(0, 1), dets.poses.flatten(0, 1))
            embs[name] = emb.reshape(*dets.scores.shape, -1).contiguous()
        cases[streams, D] = (state, dets, adv, embs)
    return cases[streams, D]


def phase_reid_kernels(t0, rows, sources, cases):
    """Kernel 3 with Re-ID against its plain version on the card, S = 1
    and S = 3, D = 64 and D = 128, embeddings of both sources: integer
    outputs equal and float difference 0. Its time with the descriptor's
    embeddings at S = 1, D = 64, its plain version's, and its bound."""
    import torch
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    res, timed = [], {}
    for D in (64, 128):
        cfg = TrackerConfig(max_detections=D, reid_weight=REID_WEIGHT)
        for streams in (1, 3):
            state, dets, adv, embs = reid_case(cases, sources, streams, D)
            for name, emb in embs.items():
                got = TC.tracker_chunk_cuda(state, dets, cfg, adv, emb)
                want = TC.tracker_chunk_plain(state, dets, cfg, adv, emb)
                torch.cuda.synchronize()
                m, e = chunk_diff(got, want)
                res.append({"source": name, "streams": streams, "D": D,
                            "mismatches": m, "max_abs_err": e,
                            "emitted": int(got[1]["emit"].sum()),
                            "tracks_with_embedding": int(
                                (got[0].embeddings.abs().sum(-1) > 0).sum())})
                if m or e != 0.0:
                    raise SystemExit(
                        f"tracker_chunk with Re-ID ({name}, S={streams}, "
                        f"D={D}): {m} integer mismatches, float error {e}")
                if streams == 1 and name == "descriptor":
                    timed[D] = (TC._pick(state, 0), TC._pick(dets, 0),
                                adv[0], emb[0], got[1], cfg)
    splits = {}
    for D, (st, de, ad, em, _, cf) in timed.items():
        ms = cuda_ms(lambda: TC.tracker_chunk_cuda(st, de, cf, ad, em), 10)
        splits[f"D={D}"] = stage_split(lambda c: TC.tracker_chunk_cuda(
            st, de, cf, ad, em, stage_cycles=c), ms / CHUNK)[0]
        splits[f"D={D}"]["ms"] = ms
    one_state, one_dets, one_adv, one_emb, outs, cfg = timed[64]
    run = (lambda: TC.tracker_chunk_cuda(one_state, one_dets, cfg, one_adv,
                                         one_emb))
    nbytes, ops = tracker_chunk_work(one_dets, one_adv, outs, emb=one_emb)
    b_ms, b_by = bound(nbytes, ops)
    row = rows["tracker_chunk"]
    row.update(
        ms_reid=cuda_ms(run, 20),
        plain_ms_reid=cuda_ms(lambda: TC.tracker_chunk_plain(
            one_state, one_dets, cfg, one_adv, one_emb), 1),
        bound_ms_reid=b_ms, bound_by_reid=b_by,
        max_abs_err_reid=max(r["max_abs_err"] for r in res),
        mismatches_reid=sum(r["mismatches"] for r in res),
        stage_split_reid=splits)
    emit("reid_kernels", t0, cases=res, ms=row["ms_reid"],
         ms_per_frame=row["ms_reid"] / CHUNK,
         plain_ms=row["plain_ms_reid"], bound_ms=b_ms, bound_by=b_by,
         bytes=nbytes, ops=ops,
         smem_bytes={f"D={d}": TC.smem_bytes(128, d, True)
                     for d in (64, 128)},
         shape=f"K={CHUNK},T=128,D=64 and 128,S=1 and 3,"
               f"reid_weight={REID_WEIGHT}; timed at D=64,S=1")
    rows["tracker_chunk"]["variants"] = ["cv", "reid"]


KALMAN_K128 = 32       # frames of the D = 128 kalman136 cases


def phase_kalman_kernels(t0, rows, sources, cases):
    """Kernel 3's kalman136 variant against its plain version on the card:
    S = 1 and 3, D = 64 (K = CHUNK) and D = 128 (K = KALMAN_K128), without
    and with Re-ID (the descriptor's embeddings), the advance mask with
    holes; integer outputs equal and the float difference, the filter
    included, exactly 0. Then the stress case of the cv row (K = 128,
    T = 128, D = 64, S = 1) timed with cv and with kalman136 in turns
    (cv, kalman136, kalman136, cv), the plain version's time and the
    bound."""
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.core.structs import Detections
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    res = []
    for D in (64, 128):
        k = CHUNK if D == 64 else KALMAN_K128
        for streams in (1, 3):
            state, dets, adv, embs = reid_case(cases, sources, streams, D)
            dets = Detections(*(getattr(dets, f)[:, :k] for f in
                                ("poses", "boxes", "scores", "valid")))
            for reid in (False, True):
                cfg = TrackerConfig(max_detections=D,
                                    motion_model="kalman136",
                                    reid_weight=REID_WEIGHT if reid else 0.0)
                emb = embs["descriptor"][:, :k].contiguous() if reid \
                    else None
                got = TC.tracker_chunk_cuda(state, dets, cfg, adv[:, :k],
                                            emb)
                want = TC.tracker_chunk_plain(state, dets, cfg, adv[:, :k],
                                              emb)
                m, e = chunk_diff(got, want)
                res.append({"streams": streams, "D": D, "K": k,
                            "reid": reid, "mismatches": m,
                            "max_abs_err": e,
                            "emitted": int(got[1]["emit"].sum()),
                            "holes": int((~adv[:, :k]).sum())})
                if m or e != 0.0:
                    raise SystemExit(
                        f"tracker_chunk with kalman136 (S={streams}, D={D}, "
                        f"reid={reid}): {m} integer mismatches, float "
                        f"error {e}")
    state, dets, adv = chunk_case("cuda", 1)
    one = (TC._pick(state, 0), TC._pick(dets, 0), adv[0])
    cv, kalman = TrackerConfig(), TrackerConfig(motion_model="kalman136")
    ms = {"cv": [], "kalman136": []}
    for name in ("cv", "kalman136", "kalman136", "cv"):
        cfg = cv if name == "cv" else kalman
        ms[name].append(cuda_ms(lambda: TC.tracker_chunk_cuda(
            *one[:2], cfg, one[2]), 20))
    outs = TC.tracker_chunk_cuda(*one[:2], kalman, one[2])[1]
    split = stage_split(lambda c: TC.tracker_chunk_cuda(
        *one[:2], kalman, one[2], stage_cycles=c),
        sum(ms["kalman136"]) / 2 / CHUNK)[0]
    nbytes, ops = tracker_chunk_work(dets, adv, outs, kalman=True)
    b_ms, b_by = bound(nbytes, ops)
    row = rows["tracker_chunk"]
    row.update(
        ms_kalman=sum(ms["kalman136"]) / 2,
        plain_ms_kalman=cuda_ms(lambda: TC.tracker_chunk_plain(
            *one[:2], kalman, one[2]), 1),
        bound_ms_kalman=b_ms, bound_by_kalman=b_by,
        max_abs_err_kalman=max(r["max_abs_err"] for r in res),
        mismatches_kalman=sum(r["mismatches"] for r in res),
        variants=row["variants"] + ["kalman136", "kalman136+reid"],
        stage_split_kalman=split)
    emit("kalman_kernels", t0, cases=res, ms_turns=ms,
         ms=row["ms_kalman"], ms_per_frame=row["ms_kalman"] / CHUNK,
         plain_ms=row["plain_ms_kalman"], bound_ms=b_ms, bound_by=b_by,
         bytes=nbytes, ops=ops,
         shape=f"K={CHUNK} (D=64) and {KALMAN_K128} (D=128),T=128,"
               f"S=1 and 3, reid off and on; timed at D=64,S=1")


def _kernel_counts():
    from posebyte_tpu_torch.ops.assignment import auction_assign_cuda
    from posebyte_tpu_torch.ops.nms import nms_keep_cuda
    from posebyte_tpu_torch.ops.tracker_chunk import tracker_chunk_cuda
    return {"nms_keep": nms_keep_cuda, "auction": auction_assign_cuda,
            "tracker_chunk": tracker_chunk_cuda}


def phase_reid_main_path(t0, params, rows, sources):
    """The per-frame path with Re-ID, each source: FRAMES frames through
    process_frame + fetch_outputs; 1 NMS and 3 auction launches per frame."""
    import numpy as np
    from posebyte_tpu_torch.core import PipelineConfig, TrackerConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    gts, frames = make_frames(FRAMES)
    cfg = PipelineConfig(tracker=TrackerConfig(reid_weight=REID_WEIGHT))
    kernels = _kernel_counts()
    out = {}
    for name, (_, reid_params) in sources.items():
        pipe = PosePipeline(cfg, params, reid_params=reid_params)
        for fn in kernels.values():
            fn.launches = 0
        ms = []
        for fr in frames:
            t = time.perf_counter()
            res = pipe.fetch_outputs(pipe.process_frame(fr), WIDTH, HEIGHT)
            ms.append((time.perf_counter() - t) * 1e3)
            for r in res:
                if not (np.isfinite(r.keypoints).all()
                        and np.isfinite(r.bbox).all()):
                    raise SystemExit("non-finite Re-ID track output")
        launches = {k: fn.launches for k, fn in kernels.items()}
        errs = track_errors(res, gts[-1])
        out[name] = {"launches": launches,
                     "ms_per_frame_after_warmup": float(np.mean(ms[4:])),
                     "last_frame_kp_err_px": errs}
        for k, r in rows.items():
            r["launches"] += launches[k]
        if launches != {"nms_keep": FRAMES, "auction": 3 * FRAMES,
                        "tracker_chunk": 0}:
            raise SystemExit(f"Re-ID per-frame launch counts ({name}) "
                             f"{launches}, expected {FRAMES}, "
                             f"{3 * FRAMES} and 0")
        if max(errs) > 10.0:
            raise SystemExit(f"Re-ID tracks ({name}) miss the synthetic "
                             f"people: {errs}")
    emit("reid_main_path", t0, frames=FRAMES, sources=out)


def phase_reid_chunk_path(t0, params, rows, sources):
    """The chunk path with Re-ID at K = CHUNK, each source: one warm-up
    and TIMED_CHUNKS timed chunks; launches per chunk 1 / 0 / 1."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig, TrackerConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    cfg = PipelineConfig(tracker=TrackerConfig(reid_weight=REID_WEIGHT))
    kernels = _kernel_counts()
    out = {}
    for name, (_, reid_params) in sources.items():
        pipe = PosePipeline(cfg, params, reid_params=reid_params)
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        ms, per_chunk, errs = [], [], []
        for frames, gt in make_chunks(1 + TIMED_CHUNKS, CHUNK):
            before = {k: fn.launches for k, fn in kernels.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = pipe.fetch_chunk_outputs(pipe.process_chunk(frames), WIDTH,
                                           HEIGHT)
            ms.append((time.perf_counter() - t) * 1e3)
            per_chunk.append({k: fn.launches - before[k]
                              for k, fn in kernels.items()})
            errs = track_errors(res[-1], gt)
            for r in res:
                for tr in r:
                    if not (np.isfinite(tr.keypoints).all()
                            and np.isfinite(tr.bbox).all()):
                        raise SystemExit("non-finite Re-ID track output")
        launches = {k: fn.launches for k, fn in kernels.items()}
        emb = pipe.state.embeddings
        timed = ms[1:]
        out[name] = {
            "launches_per_chunk": per_chunk, "ms_first_chunk": ms[0],
            "ms_per_chunk": timed,
            "frames_per_s": CHUNK * len(timed) / (sum(timed) / 1e3),
            "last_frame_kp_err_px": errs,
            "tracks_with_embedding": int((emb.abs().sum(-1) > 0).sum()),
            "embeddings_finite": bool(torch.isfinite(emb).all()),
            "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20}
        for k, r in rows.items():
            r["launches"] += launches[k]
        if any(c != {"nms_keep": 1, "auction": 0, "tracker_chunk": 1}
               for c in per_chunk):
            raise SystemExit(f"Re-ID chunk launch counts ({name}) per chunk "
                             f"{per_chunk}, expected nms_keep 1, "
                             "tracker_chunk 1, auction 0")
        if max(errs) > 10.0 or not out[name]["embeddings_finite"]:
            raise SystemExit(f"Re-ID chunk tracks ({name}) miss the "
                             f"synthetic people or are not finite: {errs}")
    emit("reid_chunk_path", t0, chunk=CHUNK, sources=out)


def phase_reid_cpu_vs_card(t0, params, sources):
    """Per source, fp32: a chunk of CMP_CHUNK frames, then 4 per-frame
    frames, on the CPU and on the card; ids equal, keypoints within
    1e-2 px."""
    import numpy as np
    from posebyte_tpu_torch.core import PipelineConfig, TrackerConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    frames, _ = next(make_chunks(1, CMP_CHUNK + 4))
    cfg = PipelineConfig(tracker=TrackerConfig(reid_weight=REID_WEIGHT),
                         precision="fp32")
    out = {}
    for name, (_, reid_params) in sources.items():
        runs = {}
        for dev in ("cpu", "cuda"):
            pipe = PosePipeline(cfg, params, device=dev,
                                reid_params=reid_params)
            runs[dev] = pipe.fetch_chunk_outputs(
                pipe.process_chunk(frames[:CMP_CHUNK]), WIDTH, HEIGHT)
            runs[dev] += [pipe.fetch_outputs(pipe.process_frame(f), WIDTH,
                                             HEIGHT)
                          for f in frames[CMP_CHUNK:]]
        ids_equal, kp_err = True, 0.0
        for a, b in zip(runs["cpu"], runs["cuda"]):
            ids_equal &= [t.track_id for t in a] == [t.track_id for t in b]
            if len(a) == len(b) and a:
                kp_err = max(kp_err, float(np.abs(
                    np.stack([t.keypoints for t in a])
                    - np.stack([t.keypoints for t in b])).max()))
        out[name] = {"ids_equal": ids_equal, "max_kp_diff_px": kp_err,
                     "tracks_per_frame": [len(r) for r in runs["cuda"]]}
        if not ids_equal or kp_err > 1e-2 or not any(runs["cuda"]):
            raise SystemExit(f"the Re-ID path ({name}) on the card and the "
                             "CPU disagree")
    emit("reid_cpu_vs_card", t0, chunk=CMP_CHUNK, frames=4, sources=out)


def phase_kalman_main_path(t0, params, rows):
    """The per-frame path with kalman136: FRAMES frames through
    process_frame + fetch_outputs; 1 NMS and 3 auction launches per frame,
    tracks within 10 px of the people."""
    import numpy as np
    from posebyte_tpu_torch.core import PipelineConfig, TrackerConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    gts, frames = make_frames(FRAMES)
    pipe = PosePipeline(PipelineConfig(
        tracker=TrackerConfig(motion_model="kalman136")), params)
    kernels = _kernel_counts()
    for fn in kernels.values():
        fn.launches = 0
    ms = []
    for fr in frames:
        t = time.perf_counter()
        res = pipe.fetch_outputs(pipe.process_frame(fr), WIDTH, HEIGHT)
        ms.append((time.perf_counter() - t) * 1e3)
        for r in res:
            if not (np.isfinite(r.keypoints).all()
                    and np.isfinite(r.bbox).all()):
                raise SystemExit("non-finite kalman136 track output")
    launches = {k: fn.launches for k, fn in kernels.items()}
    errs = track_errors(res, gts[-1])
    emit("kalman_main_path", t0, frames=FRAMES, launches=launches,
         ms_per_frame_after_warmup=float(np.mean(ms[4:])),
         last_frame_kp_err_px=errs)
    for k, r in rows.items():
        r["launches"] += launches[k]
    if launches != {"nms_keep": FRAMES, "auction": 3 * FRAMES,
                    "tracker_chunk": 0}:
        raise SystemExit(f"kalman136 per-frame launch counts {launches}, "
                         f"expected {FRAMES}, {3 * FRAMES} and 0")
    if max(errs) > 10.0:
        raise SystemExit(f"kalman136 tracks miss the synthetic people: {errs}")


def phase_kalman_chunk_path(t0, params, rows):
    """The chunk path with kalman136 at K = CHUNK: one warm-up and
    TIMED_CHUNKS timed chunks; launches per chunk 1 / 0 / 1; frames/s."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig, TrackerConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    pipe = PosePipeline(PipelineConfig(
        tracker=TrackerConfig(motion_model="kalman136")), params)
    torch.cuda.reset_peak_memory_stats()
    kernels = _kernel_counts()
    for fn in kernels.values():
        fn.launches = 0
    ms, per_chunk, errs = [], [], []
    for frames, gt in make_chunks(1 + TIMED_CHUNKS, CHUNK):
        before = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pipe.fetch_chunk_outputs(pipe.process_chunk(frames), WIDTH,
                                       HEIGHT)
        ms.append((time.perf_counter() - t) * 1e3)
        per_chunk.append({k: fn.launches - before[k]
                          for k, fn in kernels.items()})
        errs = track_errors(res[-1], gt)
        for r in res:
            for tr in r:
                if not (np.isfinite(tr.keypoints).all()
                        and np.isfinite(tr.bbox).all()):
                    raise SystemExit("non-finite kalman136 track output")
    launches = {k: fn.launches for k, fn in kernels.items()}
    kf_finite = bool(torch.isfinite(pipe.state.kf_mean).all()
                     and torch.isfinite(pipe.state.kf_cov).all())
    timed = ms[1:]
    emit("kalman_chunk_path", t0, chunk=CHUNK, launches_per_chunk=per_chunk,
         ms_first_chunk=ms[0], ms_per_chunk=timed,
         frames_per_s=CHUNK * len(timed) / (sum(timed) / 1e3),
         last_frame_kp_err_px=errs, filter_finite=kf_finite,
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    for k, r in rows.items():
        r["launches"] += launches[k]
    if any(c != {"nms_keep": 1, "auction": 0, "tracker_chunk": 1}
           for c in per_chunk):
        raise SystemExit(f"kalman136 chunk launch counts per chunk "
                         f"{per_chunk}, expected nms_keep 1, tracker_chunk "
                         "1, auction 0")
    if max(errs) > 10.0 or not kf_finite:
        raise SystemExit(f"kalman136 chunk tracks miss the synthetic people "
                         f"or the filter is not finite: {errs}")


def phase_kalman_cpu_vs_card(t0, params):
    """kalman136 in fp32: a chunk of CMP_CHUNK frames, then 4 per-frame
    frames, on the CPU and on the card; ids equal, keypoints within
    1e-2 px."""
    import numpy as np
    from posebyte_tpu_torch.core import PipelineConfig, TrackerConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    frames, _ = next(make_chunks(1, CMP_CHUNK + 4))
    cfg = PipelineConfig(tracker=TrackerConfig(motion_model="kalman136"),
                         precision="fp32")
    runs, kf = {}, {}
    for dev in ("cpu", "cuda"):
        pipe = PosePipeline(cfg, params, device=dev)
        runs[dev] = pipe.fetch_chunk_outputs(
            pipe.process_chunk(frames[:CMP_CHUNK]), WIDTH, HEIGHT)
        runs[dev] += [pipe.fetch_outputs(pipe.process_frame(f), WIDTH, HEIGHT)
                      for f in frames[CMP_CHUNK:]]
        kf[dev] = pipe.state.kf_mean.cpu().numpy()
    ids_equal, kp_err = True, 0.0
    for a, b in zip(runs["cpu"], runs["cuda"]):
        ids_equal &= [t.track_id for t in a] == [t.track_id for t in b]
        if len(a) == len(b) and a:
            kp_err = max(kp_err, float(np.abs(
                np.stack([t.keypoints for t in a])
                - np.stack([t.keypoints for t in b])).max()))
    emit("kalman_cpu_vs_card", t0, chunk=CMP_CHUNK, frames=4,
         ids_equal=ids_equal, max_kp_diff_px=kp_err,
         max_kf_mean_diff=float(np.abs(kf["cpu"] - kf["cuda"]).max()),
         tracks_per_frame=[len(r) for r in runs["cuda"]])
    if not ids_equal or kp_err > 1e-2 or not any(runs["cuda"]):
        raise SystemExit("kalman136 on the card and the CPU disagree")


def int8_params(params, model=V8):
    """The int8 configuration: the checkpoint quantised with
    PARTIAL_QUANT_SKIP, activation scales by percentile calibration on the
    card over INT8_CALIB_FRAMES synthetic-scene frames at 640."""
    from posebyte_tpu_torch.models import quant as Q
    from posebyte_tpu_torch.utils.synthetic import calibration_frames
    return Q.calibrate_activations(
        Q.quantize_params(params), model,
        calibration_frames(INT8_CALIB_FRAMES, LETTERBOX, N_PERSONS, SEED),
        device="cuda")


def int8_convs(qparams):
    """(the w8a8 conv keys Kernel 4 runs, the depthwise ones it does not:
    models.layers.is_depthwise)."""
    from posebyte_tpu_torch.models.layers import is_depthwise
    keys = [k[:-len(".act_scale")] for k in qparams
            if k.endswith(".act_scale")]
    return ([k for k in keys if not is_depthwise(k)],
            [k for k in keys if is_depthwise(k)])


def phase_int8_calibration(t0, params, model=V8, phase="int8_calibration"):
    """Calibrates `model`'s int8 parameters on the card: an activation
    scale on every conv outside b0-b4 (59 for yolov8n-pose; for
    yolo11n-pose 85, 7 of them depthwise)."""
    from posebyte_tpu_torch.models import quant as Q
    t = time.perf_counter()
    qparams = int8_params(params, model)
    scales = [float(v) for k, v in qparams.items()
              if k.endswith(".act_scale")]
    want = sum(k.split(".")[0] not in Q.PARTIAL_QUANT_SKIP
               for k in Q.conv_paths(params).values())
    dense, dw = int8_convs(qparams)
    emit(phase, t0, model=model, calibration_s=time.perf_counter() - t,
         frames=INT8_CALIB_FRAMES, method="percentile",
         int8_convs=len(scales), kernel4_convs=len(dense),
         depthwise_convs=len(dw), act_scale_min=min(scales),
         act_scale_max=max(scales))
    if len(scales) != want or (model == V8 and want != 59):
        raise SystemExit(f"{len(scales)} calibrated convolutions, not "
                         f"{want}")
    return qparams


def int8_conv_calls(pipe):
    """The Kernel 4 calls of one frame of the int8 path, in order:
    [(key, k, stride, x, s_x, wq, scale, bias)] with x the float input as
    the model gives it, recorded by wrapping ops.conv_int8.conv_w8a8_cuda
    around one forward of a synthetic frame; the wrapper is removed after."""
    import torch
    from posebyte_tpu_torch.models.yolo_pose import forward_heads
    from posebyte_tpu_torch.ops import conv_int8 as CI
    from posebyte_tpu_torch.ops.preprocess import letterbox_flat_nhwc
    keys = {id(v): k[:-3] for k, v in pipe.params.items()
            if k.endswith(".wq")}
    calls, kernel = [], CI.conv_w8a8_cuda

    def record(x, s_x, wq, scale, bias, k, stride, out_dtype=None):
        calls.append((keys[id(wq)], k, stride, x, s_x, wq, scale, bias))
        return kernel(x, s_x, wq, scale, bias, k, stride, out_dtype)

    _, frames = make_frames(1)
    CI.conv_w8a8_cuda = record
    try:
        with torch.inference_mode():
            flat = pipe.prestage_frame(frames[0])
            img = letterbox_flat_nhwc(flat[None], WIDTH, HEIGHT, LETTERBOX,
                                      raw=True)
            forward_heads(pipe.params, img.to(pipe.dtype), pipe.family)
    finally:
        CI.conv_w8a8_cuda = kernel
    return calls


def _mismatches(got, want):
    """(elements that differ, max abs difference) of two outputs of one
    type; bf16 and float32 compared by their bits."""
    import torch
    torch.cuda.synchronize()
    if got.dtype == torch.int32:
        return int((got != want).sum()), float((got - want).abs().max())
    g, w = got.float(), want.float()
    return (int((g.view(torch.int32) != w.view(torch.int32)).sum()),
            float((g - w).abs().max()))


def conv_mismatches(xq, wq, scale, bias, k, stride):
    """Kernel 4's int8 mode against its plain version, int32 sums and bf16
    outputs: (mismatched elements, max abs difference of the bf16
    outputs)."""
    import torch
    from posebyte_tpu_torch.ops import conv_int8 as CI
    mism, err = 0, 0.0
    for dtype in (torch.int32, torch.bfloat16):
        m, e = _mismatches(
            CI.conv_int8_cuda(xq, wq, scale, bias, k, stride, dtype),
            CI.conv_int8_plain(xq, wq, scale, bias, k, stride, dtype))
        mism += m
        err = max(err, e) if dtype == torch.bfloat16 else err
    return mism, err


def w8a8_mismatches(x, s_x, wq, scale, bias, k, stride):
    """Kernel 4's float mode (x quantised in its load) against its plain
    version, int32 sums and outputs in x's type: (mismatched elements, max
    abs difference of the outputs in x's type)."""
    import torch
    from posebyte_tpu_torch.ops import conv_int8 as CI
    mism, err = 0, 0.0
    for dtype in (torch.int32, x.dtype):
        m, e = _mismatches(
            CI.conv_w8a8_cuda(x, s_x, wq, scale, bias, k, stride, dtype),
            CI.conv_w8a8_plain(x, s_x, wq, scale, bias, k, stride, dtype))
        mism += m
        err = max(err, e) if dtype != torch.int32 else err
    return mism, err


def int_mm_ms(x, wq, k, stride, reps):
    """Yardstick: torch._int_mm (cuBLASLt's s8 GEMM) on the im2col'd
    input [M, k * k * Cp] and the packed weights [k * k * Cp, Op], the
    faster of the weights column-major (a transposed view) and row-major;
    the im2col is not timed. None (with the reason) where it refuses
    both."""
    import torch
    import torch.nn.functional as F
    B, H, W, Cp = x.shape
    pad = k // 2
    Ho, Wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    cols = torch.cat([xp[:, dy:dy + stride * Ho:stride,
                         dx:dx + stride * Wo:stride]
                      for dy in range(k) for dx in range(k)], dim=-1)
    a = cols.reshape(B * Ho * Wo, k * k * Cp)
    ms, why = [], None
    for b in (wq.reshape(wq.shape[0], -1).t(),
              wq.reshape(wq.shape[0], -1).t().contiguous()):
        try:
            ms.append(cuda_ms(lambda: torch._int_mm(a, b), reps))
        except RuntimeError as e:
            why = str(e).splitlines()[0][:160]
    return (min(ms), None) if ms else (None, why)


def like_path_input(x, B, scale, dev):
    """A float activation of the path's layout (pixel stride and channel
    offset of the recorded input x, its dtype), B frames of normal values
    of standard deviation `scale`."""
    import torch
    from posebyte_tpu_torch.ops.conv_int8 import pixel_stride
    _, C, H, W = x.shape
    ps = pixel_stride(x)
    base = x.storage_offset() % ps if ps > C else 0
    full = (torch.randn((B, H, W, ps), device=dev) * scale).to(x.dtype)
    return full.permute(0, 3, 1, 2)[:, base:base + C]


FIELDS = ("convs", "ms", "device_ms", "ms_int8_mode", "ms_two_pass",
          "plain_ms",
          "plain_ms_int8_mode", "bytes", "bytes_int8_mode", "ops",
          "cudnn_bf16_ms", "int_mm_ms")


def phase_int8_kernels(t0, qparams, rows, model=V8, phase="int8_kernels"):
    """Kernel 4 against its plain version on the card in both modes: every
    launch of one frame's forward of `model` at int8 on its own inputs,
    and each distinct shape at B = CHUNK in the path's layout, timed,
    summed per chunk. The v8 run writes Kernel 4's row; another model's
    numbers join it under its suffix ("_v11")."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.ops import conv_int8 as CI
    from posebyte_tpu_torch.pipeline import PosePipeline
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    mism, err = {"int8": 0, "float": 0}, 0.0
    cases = []

    def check(name, x, s_x, wq, scale, bias, k, stride, listed=True):
        nonlocal err
        mi, ei = conv_mismatches(CI.quantize_activation(x, s_x), wq, scale,
                                 bias, k, stride)
        mf, ef = w8a8_mismatches(x, s_x, wq, scale, bias, k, stride)
        mism["int8"] += mi
        mism["float"] += mf
        err = max(err, ei, ef)
        if listed:
            cases.append({"shape": name, "mismatches_int8_mode": mi,
                          "mismatches_float_mode": mf})

    if model == V8:
        # the JAX kernel test's shape: B = 2, 8x8, C = O = 128, no bias;
        # the int8 values at s_x = 1, and as float inputs at s_x = 0.04
        # with ties
        s_x = torch.tensor(0.04, device=dev)
        n = rng.integers(-140, 140, (2, 128, 8, 8)).astype(np.float32)
        x = torch.from_numpy((n + np.float32(0.5)) * np.float32(0.04)).to(
            dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wq = CI.pack_weights(torch.from_numpy(rng.integers(
            -127, 128, (128, 128, 3, 3)).astype(np.int8)).to(dev))
        scale = torch.from_numpy(rng.uniform(0.001, 0.01, 128).astype(
            np.float32)).to(dev)
        check("jax_test B=2,8x8,C=O=128,k=3,s=1", x, s_x, wq, scale, None, 3,
              1)

    # every launch of one frame's forward, B = 1, on its own inputs (the
    # first of each distinct shape listed)
    pipe = PosePipeline(PipelineConfig(precision="int8", model_name=model),
                        qparams)
    calls = int8_conv_calls(pipe)
    shapes = {}
    for key, k, stride, x, s_x, wq, scale, bias in calls:
        _, C, H, W = x.shape
        O = scale.shape[0]
        sk = (k, stride, H, W, C, O)
        first = sk not in shapes
        if first:
            shapes[sk] = {"key": key, "count": 0,
                          "args": (x, s_x, wq, scale, bias)}
        check(f"B=1,{H}x{W},C={C},O={O},k={k},s={stride}", x, s_x, wq,
              scale, bias, k, stride, listed=first)
        shapes[sk]["count"] += 1

    # each distinct shape at B = CHUNK in the path's layout: checked, timed
    per_shape, inst = [], {}
    for (k, stride, H, W, C, O), sh in shapes.items():
        x1, s_x, wq, scale, bias = sh["args"]
        x = like_path_input(x1, CHUNK, 40 * float(s_x), dev)
        xq = CI.quantize_activation(x, s_x)
        check(f"B={CHUNK},{H}x{W},C={C},O={O},k={k},s={stride}", x, s_x,
              wq, scale, bias, k, stride)
        ms = cuda_ms(lambda: CI.conv_w8a8_cuda(x, s_x, wq, scale, bias, k,
                                               stride), 10)
        dev_ms = device_ms(lambda: CI.conv_w8a8_cuda(
            x, s_x, wq, scale, bias, k, stride), 10)
        ms_i8 = cuda_ms(lambda: CI.conv_int8_cuda(xq, wq, scale, bias, k,
                                                  stride), 10)
        two = cuda_ms(lambda: CI.conv_int8_cuda(CI.quantize_activation(
            x, s_x), wq, scale, bias, k, stride), 10)
        plain = cuda_ms(lambda: CI.conv_w8a8_plain(x, s_x, wq, scale, bias,
                                                   k, stride), 1)
        plain_i8 = cuda_ms(lambda: CI.conv_int8_plain(xq, wq, scale, bias,
                                                      k, stride), 1)
        xb = torch.randn((CHUNK, C, H, W), device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wb = torch.randn((O, C, k, k), device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bb = torch.randn(O, device=dev).to(torch.bfloat16)
        cudnn = cuda_ms(lambda: F.conv2d(xb, wb, bb, stride=stride,
                                         padding=k // 2), 10)
        mm, mm_why = int_mm_ms(xq, wq, k, stride, 10)
        work = [conv_int8_work(CHUNK, H, W, C, O, k, stride,
                               bias is not None, in_bytes)
                for in_bytes in (x.element_size(), 1)]
        (b_ms, b_by), (b_i8, b_i8_by) = (bound(nb, op, INT8_OPS_S)
                                         for nb, op in work)
        n = sh["count"]
        per_shape.append({
            "key": sh["key"], "k": k, "stride": stride, "H": H, "W": W,
            "C": C, "ps": CI.pixel_stride(x), "O": O, "count": n,
            "tile_m": CI.tile_m(dev, CHUNK, (H - 1) // stride + 1,
                                (W - 1) // stride + 1, O, patch=k == 3),
            "ms": ms, "device_ms": dev_ms, "ms_int8_mode": ms_i8,
            "ms_two_pass": two,
            "plain_ms": plain, "plain_ms_int8_mode": plain_i8,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_int8_mode": b_i8,
            "bound_by_int8_mode": b_i8_by, "cudnn_bf16_ms": cudnn,
            "int_mm_ms": mm, "int_mm_refused": mm_why,
            "tops": work[0][1] / ms / 1e9,
            "tops_int8_mode": work[0][1] / ms_i8 / 1e9})
        agg = inst.setdefault(f"{k}x{k}s{stride}", dict.fromkeys(FIELDS, 0))
        agg.setdefault("int_mm_shapes_refused", 0)
        for f, v in (("convs", 1), ("ms", ms), ("device_ms", dev_ms),
                     ("ms_int8_mode", ms_i8),
                     ("ms_two_pass", two), ("plain_ms", plain),
                     ("plain_ms_int8_mode", plain_i8),
                     ("bytes", work[0][0]), ("bytes_int8_mode", work[1][0]),
                     ("ops", work[0][1]), ("cudnn_bf16_ms", cudnn),
                     ("int_mm_ms", mm or 0.0)):
            agg[f] += n * v
        agg["int_mm_shapes_refused"] += mm is None
        del x, xq, xb
    for agg in inst.values():
        agg["bound_ms"], agg["bound_by"] = bound(agg["bytes"], agg["ops"],
                                                 INT8_OPS_S)
        agg["bound_ms_int8_mode"], agg["bound_by_int8_mode"] = bound(
            agg["bytes_int8_mode"], agg["ops"], INT8_OPS_S)
    total = {f: sum(a[f] for a in inst.values()) for f in FIELDS}
    b_ms, b_by = bound(total["bytes"], total["ops"], INT8_OPS_S)
    b_i8, b_i8_by = bound(total["bytes_int8_mode"], total["ops"], INT8_OPS_S)
    dense, dw = int8_convs(qparams)
    emit(phase, t0, model=model, cases=cases, mismatches=mism,
         max_abs_err=err, distinct_shapes=len(shapes),
         convs_per_frame=len(calls), calls_checked=len(calls),
         depthwise_convs_per_frame=len(dw), shapes_b128=per_shape,
         instantiations=inst, per_chunk={
             **total, "bound_ms": b_ms, "bound_by": b_by,
             "bound_ms_int8_mode": b_i8, "bound_by_int8_mode": b_i8_by})
    row = {
        "mismatches": mism, "max_abs_err": err,
        "ms": total["ms"], "device_ms": total["device_ms"],
        "ms_per_frame": total["ms"] / CHUNK,
        "plain_ms": total["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "ms_int8_mode": total["ms_int8_mode"],
        "plain_ms_int8_mode": total["plain_ms_int8_mode"],
        "bound_ms_int8_mode": b_i8, "bound_by_int8_mode": b_i8_by,
        "yardstick_two_pass_ms": total["ms_two_pass"],
        "yardstick_cudnn_bf16_ms": total["cudnn_bf16_ms"],
        "yardstick_int_mm_ms": total["int_mm_ms"],
        "instantiations": {n: {f: a[f] for f in (
            "convs", "ms", "ms_int8_mode", "ms_two_pass", "plain_ms",
            "bound_ms", "bound_by", "bound_ms_int8_mode", "cudnn_bf16_ms",
            "int_mm_ms", "int_mm_shapes_refused")}
            for n, a in inst.items()},
        "shape": f"the int8 path's {len(calls)} convolutions per frame at "
                 f"B={CHUNK} (one chunk), bf16 input for the float mode"}
    if model == V8:
        rows["conv3x3_int8"] = {
            "name": "conv3x3_int8", "route": "cuda",
            "source": "posebyte_tpu_torch/csrc/conv_int8.cu",
            "replaces": "posebyte_tpu/ops/pallas_conv.py:56",
            "launches": 0, "library_ms": None, **row}
    else:
        rows["conv3x3_int8"][suffix(model)[1:]] = {
            **row, "shapes_b128": [
                {f: sh[f] for f in ("key", "k", "stride", "H", "W", "C", "O",
                                    "count", "ms", "device_ms", "plain_ms",
                                    "bound_ms")} for sh in per_shape]}
    want = 1 + 2 * len(shapes) if model == V8 else 2 * len(shapes)
    if mism["int8"] or mism["float"] or len(calls) != len(dense) \
            or len(cases) != want:
        raise SystemExit(f"{phase}: Kernel 4: {mism} mismatches with its "
                         f"plain version, {len(calls)} calls per frame, "
                         f"{len(dense)} dense w8a8 convs")
    return {"convs_per_frame": len(calls), "depthwise_convs": len(dw),
            "mismatches": mism, "ms_per_chunk": total["ms"],
            "device_ms_per_chunk": total["device_ms"]}


def _int8_counts():
    """The launch counts of the int8 paths, with "eager_quantize": the
    calls of ops.conv_int8.quantize_activation (wrapped here once with a
    count), which the card's int8 path must not make: it quantises in
    Kernel 4's load."""
    from posebyte_tpu_torch.ops import conv_int8 as CI
    if not hasattr(CI.quantize_activation, "launches"):
        quantize = CI.quantize_activation

        def counted(x, s_x):
            counted.launches += 1
            return quantize(x, s_x)

        counted.launches = 0
        CI.quantize_activation = counted
    return {**_kernel_counts(), "conv_int8": CI.conv_int8_cuda,
            "eager_quantize": CI.quantize_activation}


def phase_int8_main_path(t0, qparams, rows):
    """The per-frame path at int8 (bf16 activations): FRAMES frames
    through process_frame + fetch_outputs; launches per frame conv_int8
    59, nms_keep 1, auction 3, no eager quantisation; tracks within 10 px
    of the people."""
    import numpy as np
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    gts, frames = make_frames(FRAMES)
    pipe = PosePipeline(PipelineConfig(precision="int8"), qparams)
    kernels = _int8_counts()
    for fn in kernels.values():
        fn.launches = 0
    ms = []
    for fr in frames:
        t = time.perf_counter()
        res = pipe.fetch_outputs(pipe.process_frame(fr), WIDTH, HEIGHT)
        ms.append((time.perf_counter() - t) * 1e3)
        for r in res:
            if not (np.isfinite(r.keypoints).all()
                    and np.isfinite(r.bbox).all()):
                raise SystemExit("non-finite int8 track output")
    launches = {k: fn.launches for k, fn in kernels.items()}
    errs = track_errors(res, gts[-1])
    emit("int8_main_path", t0, frames=FRAMES, launches=launches,
         ms_per_frame_after_warmup=float(np.mean(ms[4:])),
         last_frame_kp_err_px=errs)
    rows["conv3x3_int8"]["launches"] = launches["conv_int8"]
    for k, r in rows.items():
        if k in launches and k != "conv3x3_int8":
            r["launches"] += launches[k]
    if launches != {"nms_keep": FRAMES, "auction": 3 * FRAMES,
                    "tracker_chunk": 0, "conv_int8": 59 * FRAMES,
                    "eager_quantize": 0}:
        raise SystemExit(f"int8 per-frame launch counts {launches}")
    if max(errs) > 10.0:
        raise SystemExit(f"int8 tracks miss the synthetic people: {errs}")


def phase_int8_chunk_path(t0, qparams, rows, model=V8,
                          phase="int8_chunk_path"):
    """The chunk path at int8, K = CHUNK: one warm-up and TIMED_CHUNKS
    timed chunks; launches per chunk conv_int8 one per dense w8a8 conv (59
    for yolov8n-pose, 78 for yolo11n-pose, whose 7 depthwise convs take no
    Kernel 4 launch), nms_keep 1, tracker_chunk 1, auction 0, no eager
    quantisation; frames/s, and a profiled chunk's device busy and
    model ms per frame."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    n_conv = len(int8_convs(qparams)[0])
    pipe = PosePipeline(PipelineConfig(precision="int8", model_name=model),
                        qparams)
    torch.cuda.reset_peak_memory_stats()
    kernels = _int8_counts()
    for fn in kernels.values():
        fn.launches = 0
    ms, per_chunk, errs = [], [], []
    for frames, gt in make_chunks(1 + TIMED_CHUNKS, CHUNK):
        before = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pipe.fetch_chunk_outputs(pipe.process_chunk(frames), WIDTH,
                                       HEIGHT)
        ms.append((time.perf_counter() - t) * 1e3)
        per_chunk.append({k: fn.launches - before[k]
                          for k, fn in kernels.items()})
        errs = track_errors(res[-1], gt)
        for r in res:
            for tr in r:
                if not (np.isfinite(tr.keypoints).all()
                        and np.isfinite(tr.bbox).all()):
                    raise SystemExit("non-finite int8 track output")
    launches = {k: fn.launches for k, fn in kernels.items()}
    timed = ms[1:]
    peak = torch.cuda.max_memory_allocated() / 2**20
    prof = profiled_chunk(pipe, frames)
    fps = CHUNK * len(timed) / (sum(timed) / 1e3)
    emit(phase, t0, model=model, chunk=CHUNK, launches_per_chunk=per_chunk,
         ms_first_chunk=ms[0], ms_per_chunk=timed, frames_per_s=fps,
         last_frame_kp_err_px=errs, peak_mem_mb=peak, **prof)
    rows["conv3x3_int8"]["launches"] += launches["conv_int8"]
    for k, r in rows.items():
        if k in launches and k != "conv3x3_int8":
            r["launches"] += launches[k]
    if any(c != {"nms_keep": 1, "auction": 0, "tracker_chunk": 1,
                 "conv_int8": n_conv, "eager_quantize": 0}
           for c in per_chunk):
        raise SystemExit(f"{phase} launch counts per chunk {per_chunk}, "
                         f"expected conv_int8 {n_conv}")
    if max(errs) > 10.0:
        raise SystemExit(f"{phase}: int8 chunk tracks miss the synthetic "
                         f"people: {errs}")
    return {"frames_per_s": fps, "conv_int8_per_chunk": n_conv,
            "last_frame_kp_err_px": errs, **prof}


def fused_quantize(x, s_x, _eye={}):
    """The activation quantisation as Kernel 4's float mode computes it in
    its load, read back through a 1x1 conv with identity weights and scale
    1 in int32 mode: x [B, C, H, W] on the card -> int8 [B, H, W, C] on the
    CPU."""
    import torch
    from posebyte_tpu_torch.ops import conv_int8 as CI
    C = x.shape[1]
    if C not in _eye:
        _eye[C] = (CI.pack_weights(torch.eye(C, dtype=torch.int8)[
            :, :, None, None].to(x.device)), torch.ones(C, device=x.device))
    w, ones = _eye[C]
    q = CI.conv_w8a8_cuda(x, s_x, w, ones, None, 1, 1, torch.int32)
    return q.permute(0, 2, 3, 1).cpu().to(torch.int8)


def int8_quant_witness(qparams, frames, model=V8):
    """The activation quantisation in Kernel 4's load on the card
    (fused_quantize) against quantize_activation on the CPU, with float32
    activations at LETTERBOX. Returns (ties checked, ties mismatched,
    same-input mismatches, letterbox max abs difference, {conv key: [int8
    elements that differ, largest step]} in the forward's order, [int8
    elements that differ per frame]):
    - ties: x = float32((n + 0.5) * s_x), n in -140..139, for each
      calibrated s_x; the card, the CPU and numpy's float32
      clip(round_half_even(x / s_x)) must agree (the card must divide by
      s_x, not multiply by its reciprocal);
    - same input: each int8 conv's float input as the CPU computed it,
      quantised on the card and on the CPU, must be equal;
    - own inputs: `frames` letterboxed and run through the forward on each
      device, as the pipelines do; the int8 activations that differ there
      come from the float operations before each quantisation."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.models import layers as L
    from posebyte_tpu_torch.models.yolo_pose import forward_heads
    from posebyte_tpu_torch.ops.conv_int8 import quantize_activation
    from posebyte_tpu_torch.ops.preprocess import letterbox_flat_nhwc
    from posebyte_tpu_torch.pipeline import PosePipeline
    conv = L.conv_w8a8
    cfg = PipelineConfig(precision="int8", model_name=model)
    inputs, imgs = {}, {}
    for dev in ("cpu", "cuda"):
        pipe = PosePipeline(cfg, qparams, device=dev, dtype=torch.float32)
        keys = {id(v): k[:-len(".act_scale")] for k, v in pipe.params.items()
                if k.endswith(".act_scale")}
        rec = inputs[dev] = {}

        def record(x, s_x, *args, keys=keys, rec=rec):
            rec[keys[id(s_x)]] = (x, s_x)
            return conv(x, s_x, *args)

        L.conv_w8a8 = record
        try:
            with torch.inference_mode():
                imgs[dev] = torch.cat([letterbox_flat_nhwc(
                    pipe.prestage_frame(f)[None], WIDTH, HEIGHT,
                    LETTERBOX, raw=True).float() for f in frames])
                forward_heads(pipe.params, imgs[dev], pipe.family)
        finally:
            L.conv_w8a8 = conv
    lb_diff = float((imgs["cuda"].cpu() - imgs["cpu"]).abs().max())
    per_frame = torch.zeros(len(frames), dtype=torch.int64)
    n_ties = tie_mism = same_mism = 0
    flips = {}
    n = np.arange(-140, 140, dtype=np.float32)
    with torch.inference_mode():
        for key, (xc, sc) in inputs["cpu"].items():
            xg, sg = inputs["cuda"][key]
            s = np.float32(sc.item())
            x = ((n + np.float32(0.5)) * s).astype(np.float32)
            r = np.round(x / s)
            want = np.clip(r, -127, 127).astype(np.int8)
            n_ties += int((r != np.floor(x / s + np.float32(0.5))).sum())
            xt = torch.from_numpy(x).reshape(1, 1, 1, -1)
            tie_mism += int((quantize_activation(xt, sc)[0, 0, :, 0].numpy()
                             != want).sum())
            tie_mism += int((fused_quantize(xt.cuda(), sg)[0, 0, :, 0]
                             .numpy() != want).sum())
            C = xc.shape[1]
            qc = quantize_activation(xc, sc)[..., :C]
            same_mism += int((fused_quantize(xc.cuda(), sg) != qc).sum())
            d = (fused_quantize(xg, sg).int() - qc.int()).abs()
            flips[key] = [int((d > 0).sum()), int(d.max())]
            per_frame += (d > 0).sum(dim=(1, 2, 3))
    return n_ties, tie_mism, same_mism, lb_diff, flips, per_frame.tolist()


def phase_int8_cpu_vs_card(t0, qparams, model=V8,
                           phase="int8_cpu_vs_card"):
    """int8 with float32 activations: a chunk of CMP_CHUNK frames, then 4
    per-frame frames, on the CPU (plain versions) and on the card
    (Kernels 1-4); ids equal, keypoints within INT8_KP_MAX_PX, their median
    difference within 0.5 px."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    frames, _ = next(make_chunks(1, CMP_CHUNK + 4))
    cfg = PipelineConfig(precision="int8", model_name=model)
    runs = {}
    for dev in ("cpu", "cuda"):
        pipe = PosePipeline(cfg, qparams, device=dev, dtype=torch.float32)
        runs[dev] = pipe.fetch_chunk_outputs(
            pipe.process_chunk(frames[:CMP_CHUNK]), WIDTH, HEIGHT)
        runs[dev] += [pipe.fetch_outputs(pipe.process_frame(f), WIDTH, HEIGHT)
                      for f in frames[CMP_CHUNK:]]
    ids_equal, diffs, frame_max = True, [], []
    for a, b in zip(runs["cpu"], runs["cuda"]):
        ids_equal &= [t.track_id for t in a] == [t.track_id for t in b]
        frame_max.append(0.0)
        if len(a) == len(b) and a:
            diffs.append(np.abs(np.stack([t.keypoints[:, :2] for t in a])
                                - np.stack([t.keypoints[:, :2] for t in b]))
                         .ravel())
            frame_max[-1] = float(diffs[-1].max())
    d = np.concatenate(diffs) if diffs else np.zeros(1)
    n_ties, tie_mism, same_mism, lb_diff, flips, per_frame = \
        int8_quant_witness(qparams, frames, model)
    flipped = [k for k, (f, _) in flips.items() if f]
    emit(phase, t0, model=model, chunk=CMP_CHUNK, frames=4,
         quantize_ties=n_ties, quantize_ties_mismatches=tie_mism,
         quantize_same_input_mismatches=same_mism,
         letterbox_max_diff=lb_diff,
         own_input_flips_total=sum(f for f, _ in flips.values()),
         own_input_first_flipped_conv=flipped[0] if flipped else None,
         own_input_convs_flipped=len(flipped),
         own_input_flips_per_frame=per_frame,
         max_kp_diff_px_per_frame=frame_max,
         own_input_flips_per_conv={k: v for k, v in flips.items() if v[0]},
         ids_equal=ids_equal, max_kp_diff_px=float(d.max()),
         kp_diff_px_p50_p90_p99=[float(np.percentile(d, q))
                                 for q in (50, 90, 99)],
         share_within_0_01_px=float((d <= 1e-2).mean()),
         tracks_per_frame=[len(r) for r in runs["cuda"]])
    if not ids_equal or not any(runs["cuda"]) or np.median(d) > 0.5 \
            or d.max() > INT8_KP_MAX_PX or tie_mism or same_mism \
            or n_ties == 0:
        raise SystemExit(f"{phase}: int8 on the card and the CPU disagree")
    return {"ids_equal": ids_equal, "max_kp_diff_px": float(d.max()),
            "median_kp_diff_px": float(np.median(d))}


def depthwise_route_check(qparams, model, frames):
    """The depthwise w8a8 route (ops.conv_int8.conv_w8a8_depthwise: cuDNN's
    float32 depthwise conv of the quantised values) on the card against
    its plain version (a float64 conv, exact) on the path's own inputs,
    recorded by wrapping models.layers.conv_w8a8_depthwise around one
    forward of the letterboxed `frames` with bf16 activations (the path's)
    and one with float32 activations (whose outputs carry the sums'
    every bit): outputs compared by their bits. Returns (calls per
    forward, elements compared, elements that differ)."""
    import torch
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.models import layers as L
    from posebyte_tpu_torch.models.yolo_pose import forward_heads
    from posebyte_tpu_torch.ops import conv_int8 as CI
    from posebyte_tpu_torch.ops.preprocess import letterbox_flat_nhwc
    from posebyte_tpu_torch.pipeline import PosePipeline
    route = L.conv_w8a8_depthwise
    per_forward, n_el, n_diff = [], 0, 0
    for dtype in (torch.bfloat16, torch.float32):
        pipe = PosePipeline(PipelineConfig(precision="int8",
                                           model_name=model), qparams,
                            dtype=dtype)
        calls = []

        def record(*args, calls=calls):
            out = route(*args)
            calls.append((args, out))
            return out

        L.conv_w8a8_depthwise = record
        try:
            with torch.inference_mode():
                flat = pipe.stage_chunk(frames)
                imgs = letterbox_flat_nhwc(flat, WIDTH, HEIGHT, LETTERBOX,
                                           selection=True, raw=True)
                forward_heads(pipe.params, imgs.to(dtype), pipe.family)
        finally:
            L.conv_w8a8_depthwise = route
        per_forward.append(len(calls))
        with torch.inference_mode():
            for args, out in calls:
                want = CI.conv_w8a8_depthwise_plain(*args)
                n_el += out.numel()
                n_diff += int((out.float().view(torch.int32)
                               != want.float().view(torch.int32)).sum())
        del calls
    if per_forward[0] != per_forward[1]:
        raise SystemExit(f"depthwise calls per forward {per_forward}")
    return per_forward[0], n_el, n_diff


def phase_v11_int8(t0, params, rows):
    """yolo11n-pose at int8: percentile calibration on the card; Kernel 4
    held against its plain version at every launch of one forward, on its
    own inputs, and at each distinct shape at B = CHUNK, timed; the
    depthwise route bit for bit against its plain version on the path's
    own inputs; the int8 chunk path; the card against the CPU. Each part
    prints its own line (v11_int8_*), then one line with their verdicts."""
    qparams = phase_int8_calibration(t0, params, V11,
                                     "v11_int8_calibration")
    k4 = phase_int8_kernels(t0, qparams, rows, V11, "v11_int8_kernels")
    frames, _ = next(make_chunks(1 + TIMED_CHUNKS, CHUNK))
    dw_calls, dw_el, dw_diff = depthwise_route_check(qparams, V11, frames)
    chunk = phase_int8_chunk_path(t0, qparams, rows, V11,
                                  "v11_int8_chunk_path")
    cmp = phase_int8_cpu_vs_card(t0, qparams, V11, "v11_int8_cpu_vs_card")
    emit("v11_int8", t0, model=V11,
         kernel4_launches_per_frame=k4["convs_per_frame"],
         kernel4_mismatches=k4["mismatches"],
         kernel4_ms_per_chunk=k4["ms_per_chunk"],
         kernel4_device_ms_per_chunk=k4["device_ms_per_chunk"],
         depthwise_convs_per_forward=dw_calls,
         depthwise_elements_compared=dw_el,
         depthwise_mismatches=dw_diff, chunk_path=chunk,
         cpu_vs_card=cmp)
    if dw_diff or dw_calls != k4["depthwise_convs"] or dw_calls != 7:
        raise SystemExit(f"v11_int8: the depthwise route differs from its "
                         f"plain version in {dw_diff} of {dw_el} elements "
                         f"({dw_calls} calls a forward)")


# The Ultralytics module index of each YOLO11 stage of the port's flat
# dict, and of its head (Ultralytics' yolo11-pose.yaml)
V11_MODULES = {"b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5,
               "b6": 6, "b7": 7, "b8": 8, "b9": 9, "b10": 10, "h13": 13,
               "h16": 16, "h17": 17, "h19": 19, "h20": 20, "h22": 22,
               "head": 23}
PT_FOLD_RTOL = 2.5e-7


def ultralytics_name(key):
    """A YOLO11 conv key of the port -> (its Ultralytics module name,
    whether it is a plain nn.Conv2d: the head's output convs), written
    from the Ultralytics layout, not from the port's import."""
    import re
    top, _, rest = key.partition(".")
    rest = "." + rest if rest else ""
    if top == "head":
        rest = re.sub(r"\.(\d)_dw$", r".\1.0", rest)
        rest = re.sub(r"\.(\d)_pw$", r".\1.1", rest)
    else:
        rest = re.sub(r"\.m\.(\d+)\.1\.", r".m.\1.", rest)   # C3k2
        rest = rest.replace(".ffn1", ".ffn.0").replace(".ffn2", ".ffn.1")
    return f"model.{V11_MODULES[top]}{rest}", top == "head" \
        and rest.endswith(".2")


def write_ultralytics_pt(params, path):
    """An Ultralytics-structured yolo11n-pose .pt of `params` (float32
    tensors, identity BatchNorm statistics: g = 1, mean 0, var = 1 - eps,
    beta the bias), its module classes from a module that exists only
    while the file is written, so that the load must stub them."""
    import sys
    import types
    import numpy as np
    import torch
    from posebyte_tpu_torch.models.weights import BN_EPS
    sd = {}
    for key in [k[:-2] for k in params if k.endswith(".w")]:
        w, b = params[key + ".w"], params[key + ".b"]
        prefix, plain = ultralytics_name(key)
        if plain:
            sd[prefix + ".weight"], sd[prefix + ".bias"] = w, b
            continue
        c = w.shape[0]
        sd.update({prefix + ".conv.weight": w,
                   prefix + ".bn.weight": np.ones(c, np.float32),
                   prefix + ".bn.bias": b,
                   prefix + ".bn.running_mean": np.zeros(c, np.float32),
                   prefix + ".bn.running_var": np.full(c, 1.0 - BN_EPS,
                                                       np.float32)})
    names = ["smoke_ultralytics", "smoke_ultralytics.nn",
             "smoke_ultralytics.nn.tasks"]
    mods = {n: types.ModuleType(n) for n in names}

    class PoseModel(torch.nn.Module):
        pass

    PoseModel.__module__, PoseModel.__qualname__ = names[-1], "PoseModel"
    mods[names[-1]].PoseModel = PoseModel
    root = PoseModel()
    for name, arr in sd.items():
        *parts, leaf = name.split(".")
        m = root
        for part in parts:
            if part not in m._modules:
                m.add_module(part, PoseModel())
            m = m._modules[part]
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if leaf.startswith("running_"):
            m.register_buffer(leaf, t)
        else:
            m.register_parameter(leaf, torch.nn.Parameter(
                t, requires_grad=False))
    sys.modules.update(mods)
    try:
        torch.save({"model": root, "epoch": -1}, path)
    finally:
        for n in names:
            del sys.modules[n]
    return len(sd)


def phase_pt_import(t0, params):
    """The Ultralytics .pt import on yolo11n-pose: the checkpoint written
    as an Ultralytics .pt (write_ultralytics_pt; left in build/pt_import
    for the cli phase, which removes it; returns its path and the imported
    parameters), read back by
    models.load_pretrained, its tensors held against load_params' within
    the BatchNorm fold's rounding (PT_FOLD_RTOL relative: the fold's scale
    g / sqrt(var + eps) is 1 within an ulp and w * scale rounds once; the
    biases exact), then PosePipeline on the card with the imported
    weights against the same with load_params' (fp32, 4 frames): ids equal,
    keypoints within 1e-2 px; and the same frames at bf16 (the default
    precision), tracks on the last and finite."""
    import numpy as np
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.models import load_pretrained
    from posebyte_tpu_torch.pipeline import PosePipeline
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "pt_import")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "yolo11n-pose.pt")
    n_tensors = write_ultralytics_pt(params, path)
    size_mb = os.path.getsize(path) / 2**20
    t = time.perf_counter()
    got = load_pretrained(path, V11)
    load_s = time.perf_counter() - t
    if got.keys() != params.keys():
        raise SystemExit(f"pt_import: keys {sorted(set(got) ^ set(params))}"
                         " differ")
    rel, bias_err = 0.0, 0.0
    for k, want in params.items():
        d = np.abs(got[k] - want)
        if k.endswith(".b"):
            bias_err = max(bias_err, float(d.max()))
        else:
            rel = max(rel, float((d / np.maximum(np.abs(want), 1e-30))
                                 .max()))
    _, frames = make_frames(4)
    runs = {}
    for what, p in (("load_params", params), ("load_pretrained", got)):
        pipe = PosePipeline(PipelineConfig(precision="fp32",
                                           model_name=V11), p)
        runs[what] = [pipe.fetch_outputs(pipe.process_frame(f), WIDTH,
                                         HEIGHT) for f in frames]
    ids_equal, kp_err = True, 0.0
    for a, b in zip(runs["load_params"], runs["load_pretrained"]):
        ids_equal &= [t.track_id for t in a] == [t.track_id for t in b]
        if len(a) == len(b) and a:
            kp_err = max(kp_err, float(np.abs(
                np.stack([t.keypoints for t in a])
                - np.stack([t.keypoints for t in b])).max()))
    pipe = PosePipeline(PipelineConfig(model_name=V11), got)      # bf16
    bf16 = [pipe.fetch_outputs(pipe.process_frame(f), WIDTH, HEIGHT)
            for f in frames]
    finite = all(np.isfinite(r.keypoints).all() for res in bf16
                 for r in res)
    emit("pt_import", t0, model=V11, pt_tensors=n_tensors,
         pt_mb=size_mb, load_s=load_s, weights_max_rel_diff=rel,
         weights_rel_bar=PT_FOLD_RTOL, bias_max_diff=bias_err,
         ids_equal=ids_equal, max_kp_diff_px=kp_err,
         tracks_per_frame=[len(r) for r in runs["load_pretrained"]],
         bf16_tracks_per_frame=[len(r) for r in bf16], bf16_finite=finite)
    if rel > PT_FOLD_RTOL or bias_err or not ids_equal or kp_err > 1e-2 \
            or not any(runs["load_pretrained"]) or not bf16[-1] \
            or not finite:
        raise SystemExit("pt_import: the imported checkpoint disagrees")
    return path, got


SERVE_STREAMS = 8      # the 8 concurrent 1080p streams of sharding.py:85
SERVE_W, SERVE_H = 1920, 1080
SERVE_FRAMES = 16
SERVE_CHUNK = 8        # ChunkedStreamServer's default chunk
STARVED, STARVE_STEPS = 3, 4
REOPENED, BEFORE_REOPEN = 5, 6
CMP_STREAMS, CMP_STREAM_FRAMES = 4, 4


@functools.lru_cache(maxsize=1)
def serving_streams():
    """SERVE_STREAMS streams of 1920x1080 frames, each its own synthetic
    scene (seed SEED + 100 + s, people 1.5x the 1280x720 scenes' size, so
    that they are as large in the letterbox): per stream the frames and
    the people's poses in each."""
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame
    out = []
    for s in range(SERVE_STREAMS):
        scene = SyntheticScene(N_PERSONS, SERVE_W, SERVE_H, seed=SEED + 100 + s,
                               scale_range=(135.0, 210.0), speed=6.0)
        gts = [scene.step() for _ in range(SERVE_FRAMES)]
        out.append(([render_frame(g, SERVE_W, SERVE_H) for g in gts], gts))
    return out


@contextlib.contextmanager
def recorded(module, name):
    """While active, the (args, kwargs) of every call of module.name are
    recorded; the calls themselves are unchanged."""
    orig, calls = getattr(module, name), []

    def record(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def serve_script(srv, streams, kernels):
    """The lifecycle script on a server of SERVE_STREAMS slots: open every
    stream and queue its SERVE_FRAMES frames, but stream STARVED's only
    after STARVE_STEPS steps (or once nothing else is queued) and stream
    REOPENED's first BEFORE_REOPEN only; once those are served, close
    REOPENED, reopen its slot (a reset) and queue BEFORE_REOPEN more of
    its frames; step until drained. Returns the outputs per stream (the
    reopened stream's after its reset, and before it), each step's launch
    counts, frames and wall ms (the step ends with its output copy), the
    steps stream STARVED waited and the frames each stream was served.
    kernels: _kernel_counts(), taken before any wrapper is installed."""
    sids = [srv.open_stream() for _ in range(SERVE_STREAMS)]
    if sids != list(range(SERVE_STREAMS)):
        raise SystemExit(f"stream ids {sids}")
    for sid, (frames, _) in enumerate(streams):
        if sid != STARVED:
            n = BEFORE_REOPEN if sid == REOPENED else SERVE_FRAMES
            for f in frames[:n]:
                srv.submit(sid, f)
    outs = [[] for _ in sids]
    before_reset, counts, served, ms = None, [], [], []
    starved_steps, reopened = None, False
    while True:
        if starved_steps is None and (len(counts) == STARVE_STEPS
                                      or not any(srv._in)):
            starved_steps = len(counts)
            for f in streams[STARVED][0]:
                srv.submit(STARVED, f)
        start = {k: fn.launches for k, fn in kernels.items()}
        t = time.perf_counter()
        n = srv.step()
        ms.append((time.perf_counter() - t) * 1e3)
        if n == 0:
            ms.pop()
            if starved_steps is None or not reopened:
                raise SystemExit("the lifecycle script stalled")
            break
        counts.append({k: fn.launches - start[k] for k, fn in kernels.items()})
        served.append(n)
        for sid in sids:
            outs[sid] += srv.poll(sid)
        if not reopened and len(outs[REOPENED]) == BEFORE_REOPEN:
            srv.close_stream(REOPENED)
            if srv.open_stream() != REOPENED:
                raise SystemExit("the reopened stream took another slot")
            before_reset, outs[REOPENED], reopened = outs[REOPENED], [], True
            for f in streams[REOPENED][0][BEFORE_REOPEN:2 * BEFORE_REOPEN]:
                srv.submit(REOPENED, f)
    for sid in sids:
        srv.close_stream(sid)
    return {"outs": outs, "before_reset": before_reset, "counts": counts,
            "served": served, "ms": ms, "starved_steps": starved_steps,
            "frames": [int(v) for v in srv.states.frame.cpu()]}


def check_serving(run, name):
    """The lifecycle's checks: every step one Kernel 1 and one Kernel 3
    launch and no Kernel 2 launch; each stream's frame counter equal to the
    frames it was served (the starved one's too, the reopened one's since
    its reset); the reopened stream's ids restarting at 1; the last frame's
    tracks of every stream within 10 px of its people. Returns each
    stream's worst keypoint error (px)."""
    import numpy as np
    from posebyte_tpu_torch.pipeline.runner import frame_tracks
    bad = [c for c in run["counts"]
           if c != {"nms_keep": 1, "auction": 0, "tracker_chunk": 1}]
    if bad:
        raise SystemExit(f"{name}: launch counts per step {bad}, expected "
                         "nms_keep 1, tracker_chunk 1, auction 0")
    want = [SERVE_FRAMES] * SERVE_STREAMS
    want[REOPENED] = BEFORE_REOPEN
    got = [len(o) for o in run["outs"]]
    if run["frames"] != want or got != want \
            or len(run["before_reset"]) != BEFORE_REOPEN:
        raise SystemExit(f"{name}: frame counters {run['frames']}, outputs "
                         f"{got}, expected {want}")
    first = next(o for o in run["outs"][REOPENED] if o["emit"].any())
    ids = sorted(int(i) for i in first["ids"][first["emit"]])
    if ids[0] != 1 or len(set(ids)) != len(ids):
        raise SystemExit(f"{name}: the reopened stream's ids {ids} do not "
                         "restart at 1")
    errs = []
    streams = serving_streams()
    for sid, outs in enumerate(run["outs"]):
        last = outs[-1]
        res = frame_tracks(last["ids"], last["scores"], last["poses"],
                           last["boxes"], last["emit"], SERVE_W, SERVE_H,
                           LETTERBOX)
        gt = streams[sid][1][(2 * BEFORE_REOPEN if sid == REOPENED
                              else SERVE_FRAMES) - 1]
        for r in res:
            if not (np.isfinite(r.keypoints).all()
                    and np.isfinite(r.bbox).all()):
                raise SystemExit(f"{name}: non-finite track output")
        errs.append(max(track_errors(res, gt)))
    if max(errs) > 10.0:
        raise SystemExit(f"{name}: tracks miss the synthetic people: {errs}")
    return errs


def busy_ms_per_step(srv):
    """Device busy ms per step (kernels and copies, torch.profiler) over up
    to 3 steps of every stream with queued frames, after one unprofiled
    step (None where the profiler records no device activity), the
    profiled wall ms per step and the 8 kernels or copies with the most
    device ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from posebyte_tpu_torch.utils.profiling import STAGES
    streams = serving_streams()
    k = getattr(srv, "chunk", 1)
    steps = min(3, SERVE_FRAMES // k - 1)
    for sid in range(SERVE_STREAMS):
        srv.open_stream()
        for f in streams[sid][0][:k * (steps + 1)]:
            srv.submit(sid, f)
    srv.step()                                   # the reset step, unprofiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            srv.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / steps
    for sid in range(SERVE_STREAMS):
        srv.poll(sid)
        srv.close_stream(sid)
    per_kernel = collections.defaultdict(float)
    for e in prof.events():
        # a stage label's device-side copy is a span with gaps, not busy
        # time (utils/profiling.py reads the stages the same way)
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name not in STAGES:
            per_kernel[e.name[:60]] += e.device_time_total / 1e3 / steps
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return (busy if busy > 0 else None), wall, top


def serving_kernel_times(rows, nms_call, k3_call, tag):
    """Kernel 1 and Kernel 3 on a serving step's own inputs (the last
    recorded call of each): held against their plain versions on the same
    inputs (Kernel 1 bit for bit, Kernel 3 as tracker_chunk_row holds it),
    the results added to the rows' mismatches and max_abs_err; ms,
    device_ms, plain_ms and bound_ms beside the row's other shapes, under
    `tag` and serving_k{K}_s{S}."""
    import torch
    from posebyte_tpu_torch.ops.nms import nms_keep_cuda, nms_keep_plain
    from posebyte_tpu_torch.ops.tracker_chunk import tracker_chunk_cuda, \
        tracker_chunk_plain
    (p, b, v, iou, oks), _ = nms_call

    def nms_plain():
        return torch.stack([nms_keep_plain(*a, iou, oks)
                            for a in zip(p, b, v)])
    mism = int((nms_keep_cuda(p, b, v, iou, oks) != nms_plain()).sum())
    nbytes = ops = 0
    for i in range(v.shape[0]):
        nb, o = nms_work(p[i], b[i], v[i], iou)
        nbytes, ops = nbytes + nb, ops + o
    r1 = rows["nms_keep"]
    r1["mismatches"] += mism
    r1["max_abs_err"] = float(r1["mismatches"] > 0)
    r1[f"ms_{tag}"] = cuda_ms(lambda: nms_keep_cuda(p, b, v, iou, oks), 50)
    r1[f"device_ms_{tag}"] = device_ms(
        lambda: nms_keep_cuda(p, b, v, iou, oks), 50)
    r1[f"plain_ms_{tag}"] = cuda_ms(nms_plain, 2)
    r1[f"bound_ms_{tag}"], r1[f"bound_by_{tag}"] = bound(nbytes, ops)
    if mism:
        raise SystemExit(f"nms_keep at the serving shape {tag}: {mism} "
                         "mismatches against its plain version")
    args, kw = k3_call
    state, dets, cfg, adv, emb = args
    got = tracker_chunk_cuda(*args, **kw)
    m3, e3 = chunk_diff(got, tracker_chunk_plain(*args, **kw))
    nbytes, ops = tracker_chunk_work(dets, adv, got[1], T=cfg.max_tracks)
    r3 = rows["tracker_chunk"]
    r3["mismatches"] += m3
    r3["max_abs_err"] = max(r3["max_abs_err"], e3)
    k3 = f"serving_k{adv.shape[1]}_s{adv.shape[0]}"
    r3[f"ms_{k3}"] = cuda_ms(lambda: tracker_chunk_cuda(*args, **kw), 20)
    r3[f"device_ms_{k3}"] = device_ms(
        lambda: tracker_chunk_cuda(*args, **kw), 20)
    r3[f"plain_ms_{k3}"] = cuda_ms(lambda: tracker_chunk_plain(*args, **kw),
                                   1)
    r3[f"bound_ms_{k3}"], r3[f"bound_by_{k3}"] = bound(nbytes, ops)
    if m3 or e3 > 1e-5 + 1e-6 * 1280:
        raise SystemExit(f"tracker_chunk at the serving shape {k3}: {m3} "
                         f"integer mismatches, float error {e3}")
    return {"nms_keep": {"mismatches": mism,
                         **{k: r1[k] for k in r1 if k.endswith(tag)}},
            "tracker_chunk": {"mismatches": m3, "max_abs_err": e3,
                              **{k: r3[k] for k in r3 if k.endswith(k3)}}}


def phase_serving_path(t0, params, rows, kind):
    """StreamServer (kind "frame") or ChunkedStreamServer (kind "chunk",
    SERVE_CHUNK) on the card: yolov8n-pose 640, bf16, raw u8 ingest,
    SERVE_STREAMS streams of 1920x1080 through the lifecycle script; then
    the device busy ms per step over a steady window, and Kernels 1 and 3
    timed on the steps' own inputs. Returns the server (the frontend phase
    serves through the chunked one)."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.ops import nms as N
    from posebyte_tpu_torch.pipeline import serving as SV
    streams = serving_streams()
    if kind == "frame":
        srv = SV.StreamServer(SERVE_STREAMS, (SERVE_H, SERVE_W),
                              PipelineConfig(), params)
    else:
        srv = SV.ChunkedStreamServer(SERVE_STREAMS, (SERVE_H, SERVE_W),
                                     SERVE_CHUNK, PipelineConfig(), params)
    # warm-up: one step of one stream, its slot reset when reopened
    srv.open_stream()
    srv.submit(0, streams[0][0][0])
    srv.step()
    srv.poll(0)
    srv.close_stream(0)
    kernels = _kernel_counts()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with recorded(N, "nms_keep") as nms_calls, \
            recorded(SV, "tracker_chunk") as k3_calls:
        run = serve_script(srv, streams, kernels)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    errs = check_serving(run, f"{kind} serving")
    for k, n in launches.items():
        rows[k]["launches"] += n
    busy, busy_wall, top = busy_ms_per_step(srv)
    tag = f"b{SERVE_STREAMS * (SERVE_CHUNK if kind == 'chunk' else 1)}"
    full = int(np.argmax(run["served"]))   # a step with every stream's frames
    times = serving_kernel_times(rows, nms_calls[full], k3_calls[full], tag)
    timed = run["ms"][1:]                 # after the first (reset) step
    frames = sum(run["served"][1:])
    emit("serving_path" if kind == "frame" else "chunked_serving_path", t0,
         streams=SERVE_STREAMS, frame=[SERVE_W, SERVE_H],
         chunk=getattr(srv, "chunk", 1), steps=len(run["served"]),
         served_per_step=run["served"], launches=launches,
         launches_per_step=run["counts"][0], starved_steps=run["starved_steps"],
         frames_per_stream=run["frames"],
         reopened_ids=sorted({int(i) for o in run["outs"][REOPENED]
                              for i in o["ids"][o["emit"]]}),
         frames_per_s=frames / (sum(timed) / 1e3),
         steps_per_s=len(timed) / (sum(timed) / 1e3),
         ms_per_step=timed, ms_first_step=run["ms"][0],
         device_busy_ms_per_step=busy, profiled_wall_ms_per_step=busy_wall,
         top_device_ms_per_step=top,
         kp_err_px_per_stream=errs, peak_mem_mb=peak,
         kernel_times=times, tracks_last_frame=[
             int(o[-1]["emit"].sum()) for o in run["outs"]],
         mean_tracks=float(np.mean([int(o["emit"].sum())
                                    for s in run["outs"] for o in s])))
    return srv


def serving_cmp_run(srv):
    """The comparison script on a server of CMP_STREAMS slots: stream 1
    starved for the first step, stream 2 closed after its first frame and
    reopened (a reset) with 3 more; step until drained. Returns the
    outputs per stream."""
    streams = serving_streams()
    sids = [srv.open_stream() for _ in range(CMP_STREAMS)]
    frames = [streams[s][0][:CMP_STREAM_FRAMES] for s in sids]
    for sid in (0, 3):
        for f in frames[sid]:
            srv.submit(sid, f)
    srv.submit(2, frames[2][0])
    srv.step()
    srv.close_stream(2)
    srv.open_stream()
    for f in frames[2][1:]:
        srv.submit(2, f)
    for f in frames[1]:
        srv.submit(1, f)
    while srv.step():
        pass
    outs = [srv.poll(s) for s in sids]
    for s in sids:
        srv.close_stream(s)
    return outs


def serving_diff(a, b, scale=1.0):
    """(ids and emit equal, max keypoint difference / scale) between two
    runs' per-stream outputs."""
    import numpy as np
    equal, err = True, 0.0
    for sa, sb in zip(a, b):
        equal &= len(sa) == len(sb)
        for x, y in zip(sa, sb):
            equal &= bool(np.array_equal(x["ids"], y["ids"])
                          and np.array_equal(x["emit"], y["emit"]))
            m = x["emit"] & y["emit"]
            if m.any():
                err = max(err, float(np.abs(x["poses"][m][..., :2]
                                            - y["poses"][m][..., :2]).max()
                                     / scale))
    return equal, err


def phase_serving_cpu_vs_card(t0, params, sources):
    """Both servers in fp32 on the CPU and on the card, CMP_STREAMS streams
    x CMP_STREAM_FRAMES frames of 1920x1080 with one reset and one starved
    step: ids and emit equal, keypoints within 1e-2 px (frame pixels); on
    the card the chunked server's outputs equal the per-frame server's
    (ids equal, poses within 1e-4 in letterbox pixels); the chunked server
    again with the learned Re-ID head, ids equal."""
    from posebyte_tpu_torch.core import PipelineConfig, TrackerConfig
    from posebyte_tpu_torch.ops.preprocess import letterbox_params
    from posebyte_tpu_torch.pipeline import serving as SV
    scale = letterbox_params(SERVE_W, SERVE_H, LETTERBOX)[0]
    cfg = PipelineConfig(precision="fp32")
    reid_cfg = PipelineConfig(precision="fp32", tracker=TrackerConfig(
        reid_weight=REID_WEIGHT))
    runs = {}
    for dev in ("cpu", "cuda"):
        runs["frame", dev] = serving_cmp_run(SV.StreamServer(
            CMP_STREAMS, (SERVE_H, SERVE_W), cfg, params, device=dev))
        runs["chunk", dev] = serving_cmp_run(SV.ChunkedStreamServer(
            CMP_STREAMS, (SERVE_H, SERVE_W), CMP_STREAM_FRAMES, cfg, params,
            device=dev))
        runs["head", dev] = serving_cmp_run(SV.ChunkedStreamServer(
            CMP_STREAMS, (SERVE_H, SERVE_W), CMP_STREAM_FRAMES, reid_cfg,
            params, device=dev, reid_params=sources["head"][1]))
    res = {}
    for kind in ("frame", "chunk", "head"):
        eq, err = serving_diff(runs[kind, "cpu"], runs[kind, "cuda"], scale)
        res[kind] = {"ids_equal": eq, "max_kp_diff_px": err}
    eq, err = serving_diff(runs["chunk", "cuda"], runs["frame", "cuda"])
    res["card_chunk_vs_frame"] = {"ids_equal": eq,
                                  "max_pose_diff_letterbox_px": err}
    tracks = sum(int(o["emit"].sum()) for s in runs["frame", "cuda"]
                 for o in s)
    emit("serving_cpu_vs_card", t0, streams=CMP_STREAMS,
         frames_per_stream=[len(s) for s in runs["frame", "cuda"]],
         tracks=tracks, **res)
    if not tracks or any(not res[k]["ids_equal"] or res[k]["max_kp_diff_px"]
                         > 1e-2 for k in ("frame", "chunk", "head")):
        raise SystemExit("the servers on the card and the CPU disagree")
    if not eq or err > 1e-4:
        raise SystemExit("the chunked server on the card disagrees with the "
                         "per-frame server")


def phase_frontend(t0, srv, rows):
    """PoseServingFrontend over loopback around the card's chunked server:
    two clients with a stream each; the tracks that come back equal the
    server's own outputs un-letterboxed (within 1e-2 px, the JSON's
    2-decimal rounding); a full queue answers BUSY; every client socket has a
    timeout, and closing the front end stops its threads."""
    import numpy as np
    from posebyte_tpu_torch.pipeline import frontend as FE
    from posebyte_tpu_torch.pipeline.runner import frame_tracks
    streams = serving_streams()
    kernels = _kernel_counts()
    for fn in kernels.values():
        fn.launches = 0
    fe = FE.PoseServingFrontend(srv, max_queue=4, auto_step=False)
    served_outs = []
    poll = srv.poll
    srv.poll = lambda sid: (lambda o: (served_outs.extend(o), o)[1])(
        poll(sid))
    try:
        clients = [FE.PoseClient(*fe.address, timeout=60.0)
                   for _ in range(2)]
        sids = [c.open_stream() for c in clients]
        accepted = [clients[0].send_frame(sids[0], f)
                    for f in streams[0][0][:5]]
        for f in streams[1][0][:3]:
            accepted.append(clients[1].send_frame(sids[1], f))
        steps = [fe.step_once()]
        again = clients[0].send_frame(sids[0], streams[0][0][5])
        steps.append(fe.step_once())
        got = [c.poll(s) for c, s in zip(clients, sids)]
        stats = clients[0].stats()
        for c, s in zip(clients, sids):
            c.close_stream(s)
            c.close()
    finally:
        srv.poll = poll
        fe.close()
    launches = {k: fn.launches for k, fn in kernels.items()}
    for k, n in launches.items():
        rows[k]["launches"] += n
    want = [frame_tracks(o["ids"], o["scores"], o["poses"], o["boxes"],
                         o["emit"], SERVE_W, SERVE_H, LETTERBOX)
            for o in served_outs]
    flat = got[0] + got[1]
    err, ids_equal = 0.0, len(flat) == len(want)
    for g, w in zip(flat, want):
        ids_equal &= [t["id"] for t in g] == [t.track_id for t in w]
        for a, b in zip(g, w):
            err = max(err, float(np.abs(np.asarray(a["keypoints"])
                                        - b.keypoints).max()),
                      float(np.abs(np.asarray(a["bbox"]) - b.bbox).max()))
    alive = [t.name for t in fe._threads if t.is_alive()]
    emit("frontend", t0, accepted=accepted, busy_refused=accepted[4] is False,
         accepted_after_step=again, steps=steps,
         frames_polled=[len(g) for g in got], launches=launches,
         tracks=[len(t) for t in flat], ids_equal=ids_equal,
         max_diff_px=err, stats=stats, threads_alive=alive)
    if accepted != [True] * 4 + [False] + [True] * 3 or not again \
            or steps != [7, 1] or [len(g) for g in got] != [5, 3] \
            or not ids_equal or err > 1e-2 or alive or not any(flat) \
            or launches != {"nms_keep": 2, "auction": 0, "tracker_chunk": 2}:
        raise SystemExit("the frontend's round trip failed")


# ---- the accuracy loop, the hard clip and the command line ---------------

ACC_W, ACC_H, ACC_SEED = 640, 360, 424242   # tests/test_trained_pixels.py
ACC_CHUNK = 8
# (model, input size, frames, OKS-mAP bar): the JAX package's per-checkpoint
# bars (tests/test_trained_pixels.py:60-67); MOTA >= 0.95 and at most one
# id switch for each.
ACC_RUNS = ((V8, 256, 48, 0.90), (V8, 640, 24, 0.88), (V11, 640, 24, 0.86))
ACC_MOTA, ACC_SWITCHES = 0.95, 1
# int8 against fp32 and against the ground truth, percentile calibration
# (tests/test_trained_pixels.py:153, measured there at 256 on detections)
INT8_ACC_BARS = {"agree_mAP": 0.86, "agree_AP50": 0.95, "gt_mAP": 0.86}
INT8_ACC_CALIB = 4
# the crowded clip of tests/test_hard_tracking.py:125 and its bars
HARD_SEED, HARD_FRAMES, HARD_PERSONS = 86002, 96, 8
HARD_BARS = {"MOTA": 0.51, "IDF1": 0.47, "id_switches": 29}
BENCH_ITERS = 200


def acc_pipeline(params, model, size, precision, device=None, conf=0.30,
                 det_conf=None, reid_params=None, **tracker):
    """The accuracy loop's pipeline (tests/test_trained_pixels.py
    ::_pipeline): input `size`, detector confidence det_conf (default
    conf), tracker thresholds from conf."""
    from posebyte_tpu_torch.core import (DetectorConfig, PipelineConfig,
                                         TrackerConfig)
    from posebyte_tpu_torch.pipeline import PosePipeline
    num_anchors = sum((size // s) ** 2 for s in (8, 16, 32))
    cfg = PipelineConfig(
        detector=DetectorConfig(input_size=size, num_anchors=num_anchors,
                                conf_threshold=det_conf or conf),
        tracker=TrackerConfig.from_conf_threshold(conf, **tracker),
        model_name=model, precision=precision)
    return PosePipeline(cfg, params, device=device, reid_params=reid_params)


def held_out_clip(n):
    """The held-out clip (seed 424242, 3 people, 640x360) rendered by the
    port's renderer: (frames, ground-truth poses)."""
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame
    scene = SyntheticScene(n_persons=3, width=ACC_W, height=ACC_H,
                           seed=ACC_SEED, scale_range=(80.0, 130.0),
                           speed=4.0)
    gts = [g.copy() for g in scene.frames(n)]
    return [render_frame(g, ACC_W, ACC_H) for g in gts], gts


def counted_run(rows, kernels, fn):
    """fn() with the kernels' launch counts set to 0 just before and read
    just after, added to the rows: (fn's result, the counts)."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    launches = {k: f.launches for k, f in kernels.items()}
    for k, n in launches.items():
        row = "conv3x3_int8" if k == "conv_int8" else k
        if row in rows:
            rows[row]["launches"] = rows[row].get("launches", 0) + n
    return out, launches


def track_ids(tracks):
    return [[t.track_id for t in f] for f in tracks]


def phase_accuracy(t0, rows, assets):
    """The trained checkpoints from pixels on the card through cli.evaluate's
    loop (evaluate_tracks) on the held-out clip rendered by the port:
    yolov8n-pose 256 (48 frames), yolov8n-pose 640 and yolo11n-pose 640
    (24), each fp32 and bf16, per frame and at chunk 8; every run holds
    its checkpoint's bars, and the chunked run's ids equal the per-frame
    run's. Then yolov8n-pose 640 at int8, calibrated by percentile on the
    card over the clip's first 4 frames: its tracks' OKS-mAP against the
    fp32 tracks and against the ground truth over the frames after them,
    beside the JAX package's bars (printed, not asserted: those were
    measured on detections at 256)."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.cli.evaluate import evaluate_tracks
    from posebyte_tpu_torch.models import load_params, quant
    from posebyte_tpu_torch.ops.preprocess import letterbox_image
    from posebyte_tpu_torch.utils.evaluation import keypoint_map
    frames, gts = held_out_clip(max(r[2] for r in ACC_RUNS))
    kernels = _int8_counts()
    runs, bad, fp32_640 = [], [], None
    for model, size, n, bar in ACC_RUNS:
        params, _ = load_params(os.path.join(
            assets, f"{model}-synthetic{size}.safetensors"))
        for precision in ("fp32", "bf16"):
            ids = {}
            for chunk in (0, ACC_CHUNK):
                pipe = acc_pipeline(params, model, size, precision)
                tracks = []
                t = time.perf_counter()
                s, launches = counted_run(rows, kernels, lambda: (
                    evaluate_tracks(pipe, frames[:n], gts[:n], ACC_W, ACC_H,
                                    warmup=pipe.config.tracker.min_hits,
                                    chunk=chunk, record=tracks)))
                wall = time.perf_counter() - t
                ids[chunk] = track_ids(tracks)
                if (model, size, precision, chunk) == (V8, 640, "fp32", 0):
                    fp32_640 = tracks
                want = {"nms_keep": n // chunk, "auction": 0,
                        "tracker_chunk": n // chunk} if chunk else \
                    {"nms_keep": n, "auction": 3 * n, "tracker_chunk": 0}
                run = {"model": model, "size": size, "precision": precision,
                       "chunk": chunk, "frames": s["frames"],
                       "mAP": s["mAP"], "AP50": s["AP50"], "AP75": s["AP75"],
                       "MOTA": s["MOTA"], "IDF1": s["IDF1"],
                       "id_switches": s["id_switches"],
                       "misses": s["misses"],
                       "false_positives": s["false_positives"],
                       "mAP_bar": bar, "launches": launches,
                       "frames_per_s_cold": n / wall}
                runs.append(run)
                if s["mAP"] < bar or s["MOTA"] < ACC_MOTA or \
                        s["id_switches"] > ACC_SWITCHES or \
                        any(launches[k] != v for k, v in want.items()):
                    bad.append(run)
            runs[-1]["chunk_ids_equal"] = ids[0] == ids[ACC_CHUNK]
            if ids[0] != ids[ACC_CHUNK]:
                bad.append(runs[-1])
    # int8: yolov8n-pose 640, percentile calibration on the first frames
    params, _ = load_params(os.path.join(
        assets, f"{V8}-synthetic640.safetensors"))
    calib = np.stack([letterbox_image(torch.from_numpy(f), 640)
                      .permute(1, 2, 0).numpy()
                      for f in frames[:INT8_ACC_CALIB]])
    qparams = quant.calibrate_activations(quant.quantize_params(params), V8,
                                          calib, method="percentile")
    pipe = acc_pipeline(qparams, V8, 640, "int8")
    n = len(fp32_640)
    tracks = []
    s, launches = counted_run(rows, kernels, lambda: evaluate_tracks(
        pipe, frames[:n], gts[:n], ACC_W, ACC_H,
        warmup=pipe.config.tracker.min_hits, record=tracks))

    def kps(fr):
        return np.stack([t.keypoints for t in fr]) if fr else \
            np.zeros((0, 17, 3), np.float32)

    later = range(INT8_ACC_CALIB, n)
    preds = [kps(tracks[i]) for i in later]
    scores = [np.asarray([t.score for t in tracks[i]], np.float32)
              for i in later]
    agree = keypoint_map([kps(fp32_640[i]) for i in later], preds, scores)
    vs_gt = keypoint_map([gts[i] for i in later], preds, scores)
    int8 = {"model": V8, "size": 640, "calibration": "percentile",
            "calib_frames": INT8_ACC_CALIB, "frames": s["frames"],
            "agree_mAP": agree["mAP"], "agree_AP50": agree["AP50"],
            "gt_mAP": vs_gt["mAP"], "gt_AP50": vs_gt["AP50"],
            "MOTA": s["MOTA"], "IDF1": s["IDF1"],
            "id_switches": s["id_switches"], "jax_bars": INT8_ACC_BARS,
            "meets_jax_bars": agree["mAP"] >= INT8_ACC_BARS["agree_mAP"]
            and agree["AP50"] >= INT8_ACC_BARS["agree_AP50"]
            and vs_gt["mAP"] >= INT8_ACC_BARS["gt_mAP"],
            "launches": launches}
    emit("accuracy", t0, clip=f"SyntheticScene seed {ACC_SEED}, 3 people, "
         f"{ACC_W}x{ACC_H}, the port's renderer", runs=runs, int8=int8,
         failed=bad)
    if bad or launches["conv_int8"] != 59 * n:
        raise SystemExit(f"accuracy: {len(bad)} runs miss their bars, "
                         "launch counts or chunked ids")


def hard_clip():
    """The crowded clip of tests/test_hard_tracking.py:125, rendered by the
    port's renderer: (frames, poses, active masks)."""
    import numpy as np
    from posebyte_tpu_torch.utils.synthetic import CrowdedScene, \
        render_frame
    scene = CrowdedScene(n_persons=HARD_PERSONS, width=ACC_W, height=ACC_H,
                         seed=HARD_SEED, scale_range=(80.0, 130.0),
                         speed=5.0, entry_exit=True, clip_len=HARD_FRAMES)
    gts = [(p.copy(), a.copy()) for p, a in scene.frames(HARD_FRAMES)]
    palette = np.asarray([(60 + (60 * i) % 196, 200, 255 - (50 * i) % 200)
                          for i in range(HARD_PERSONS)])
    return ([render_frame(p[a], ACC_W, ACC_H, colors=palette[a])
             for p, a in gts], [p for p, _ in gts], [a for _, a in gts])


def phase_hard_clip(t0, rows, assets):
    """The crowded clip (CrowdedScene seed 86002, 8 people, 96 frames),
    yolov8n-pose 256, fp32, per frame, detector confidence 0.15 and tracker
    thresholds from 0.30, as tests/test_hard_tracking.py runs it: on the
    card (its bars asserted) and on the CPU beside it; then on the card
    with the learned Re-ID head at reid_weight 0.3 (reported, no bar)."""
    from posebyte_tpu_torch.cli.evaluate import evaluate_tracks
    from posebyte_tpu_torch.models import load_params, load_reid_head
    frames, gts, active = hard_clip()
    params, _ = load_params(os.path.join(
        assets, f"{V8}-synthetic256.safetensors"))
    kernels = _kernel_counts()
    keys = ("MOTA", "IDF1", "id_switches", "misses", "false_positives",
            "mAP")
    res, launches = {}, {}
    for what, dev, extra in (
            ("card", None, {}), ("cpu", "cpu", {}),
            ("card_reid_head", None, {"reid_weight": REID_WEIGHT})):
        reid = load_reid_head(os.path.join(assets, HEAD_ASSET)) \
            if extra else None
        pipe = acc_pipeline(params, V8, 256, "fp32", dev, conf=0.30,
                            det_conf=0.15, reid_params=reid, **extra)
        t = time.perf_counter()
        s, launches[what] = counted_run(rows, kernels, lambda: (
            evaluate_tracks(pipe, frames, gts, ACC_W, ACC_H,
                            warmup=pipe.config.tracker.min_hits,
                            gt_active=active)))
        res[what] = {**{k: s[k] for k in keys},
                     "s": time.perf_counter() - t}
    card = res["card"]
    emit("hard_clip", t0, clip=f"CrowdedScene seed {HARD_SEED}, "
         f"{HARD_PERSONS} people, {HARD_FRAMES} frames, the port's renderer",
         bars=HARD_BARS, **res, launches=launches)
    want = {"nms_keep": HARD_FRAMES, "auction": 3 * HARD_FRAMES,
            "tracker_chunk": 0}
    if card["MOTA"] < HARD_BARS["MOTA"] or card["IDF1"] < HARD_BARS["IDF1"] \
            or card["id_switches"] > HARD_BARS["id_switches"] \
            or launches["card"] != want or launches["card_reid_head"] != want:
        raise SystemExit("hard_clip: the card misses the bars or the "
                         "launch counts")


def phase_cli(t0, rows, assets, pt_path, pt_params):
    """The command line on the card:
    - cli.benchmark.main(["-n", 200, "-e", the v8n-640 checkpoint, "--json",
      "--stages"]): every component's ms and the stage table, Kernel 1 and
      Kernel 2 launched exactly as often as its components call them; then
      Kernel 1 on the benchmark's 100 candidates and Kernel 2 on its 50 x 50
      cost against their plain versions, timed beside their bounds (the
      kernels line's *_n100 and *_50x50 keys);
    - cli.export.main on the .pt that pt_import wrote, at bf16 and at int8
      with --allow-synthetic-calib, each read back equal (bf16: the
      imported tensors; int8: their quantised weights, every quantised conv
      calibrated);
    - the demo's loop (cli.demo.track_frames) per frame and at chunk 8 over
      16 rendered 1280x720 frames (bf16, v8n-640) with draw_all_tracks and
      draw_stats through the native rasteriser: frames/s of the loop with
      its drawing (after one warm pass of the same loop, the native
      library built before it), the drawn bytes equal to the CPU's
      drawing of the same tracks, and chip_smoke's fixed drawing equal to
      DRAW_DIGEST."""
    import contextlib
    import io

    import numpy as np
    import torch
    from posebyte_tpu_torch.cli import benchmark, demo, export
    from posebyte_tpu_torch.models import load_params, quant
    from posebyte_tpu_torch.ops import assignment as A
    from posebyte_tpu_torch.ops import nms as N
    from posebyte_tpu_torch.utils.video import draw_all_tracks, draw_stats

    kernels = _kernel_counts()
    v8 = os.path.join(assets, f"{V8}-synthetic640.safetensors")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        (rc, launches) = counted_run(rows, kernels, lambda: benchmark.main(
            ["-n", str(BENCH_ITERS), "-e", v8, "--json", "--stages"]))
    text = out.getvalue().strip().splitlines()
    bench = json.loads(text[-1])
    n = BENCH_ITERS
    # loop_ms makes one warm-up call; the end-to-end run 3 warm-up frames
    want = {"nms_keep": (n + 1) + (n + 3),
            "auction": (n + 1) + 3 * (n + 1) + 3 * (n + 3) + 3 * (n + 1),
            "tracker_chunk": 0}
    bench_ok = rc == 0 and launches == want and all(
        v > 0 for v in bench.values())

    # Kernel 1 on the benchmark's candidates, in pose_nms's score order
    dev = torch.device("cuda")
    fx = benchmark.fixture(dev)
    det = fx["nms"]
    order = torch.argsort(-det.scores, stable=True)
    p, b, v = (det.poses[order].contiguous(), det.boxes[order].contiguous(),
               det.valid[order].contiguous())
    got, want_keep = N.nms_keep_cuda(p, b, v, 0.55, 0.55), \
        N.nms_keep_plain(p, b, v, 0.55, 0.55)
    nms_mism = int((got != want_keep).sum())
    rows["nms_keep"]["mismatches"] += nms_mism
    rows["nms_keep"].update(
        ms_n100=cuda_ms(lambda: N.nms_keep_cuda(p, b, v, 0.55, 0.55), 200),
        device_ms_n100=device_ms(lambda: N.nms_keep_cuda(p, b, v, 0.55,
                                                         0.55), 200),
        plain_ms_n100=cuda_ms(lambda: N.nms_keep_plain(p, b, v, 0.55, 0.55),
                              10),
        bound_ms_n100=bound(*nms_work(p, b, v, 0.55))[0])
    # Kernel 2 on the benchmark's 50 x 50 cost, every row active
    cost = fx["cost"]
    r1, c1 = A.auction_assign_cuda(cost)
    r2, c2, rounds = A.auction_assign_rounds(cost)
    auc_mism = int((r1 != r2).sum()) + int((c1 != c2).sum())
    rows["auction"]["mismatches"] += auc_mism
    R, Cc = cost.shape
    ops = 6 * R * Cc * rounds + (4 * R * Cc
                                 if rounds < A.auction_iterations(R) else 0)
    rows["auction"].update(
        ms_50x50=cuda_ms(lambda: A.auction_assign_cuda(cost), 200),
        device_ms_50x50=device_ms(lambda: A.auction_assign_cuda(cost), 200),
        plain_ms_50x50=cuda_ms(lambda: A.auction_assign(cost), 5),
        bound_ms_50x50=bound(R * Cc * 4 + 4 * (R + Cc), ops)[0],
        rounds_50x50=rounds)

    # export of the .pt at bf16 and int8
    exported, root = {}, os.path.dirname(pt_path)
    try:
        for precision in ("bf16", "int8"):
            path = os.path.join(root, f"{V11}-{precision}.safetensors")
            argv = ["-m", pt_path, "-o", path, "-p", precision]
            if precision == "int8":
                argv.append("--allow-synthetic-calib")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = export.main(argv)
            got, name = load_params(path)
            os.remove(path)
            want_p = pt_params if precision == "bf16" else \
                quant.quantize_params(pt_params)
            equal = rc == 0 and name == V11 and all(
                np.array_equal(got[k], want_p[k]) for k in want_p) and (
                set(got) - set(want_p) == {
                    k[:-len(".scale")] + ".act_scale" for k in want_p
                    if k.endswith(".scale")})
            exported[precision] = {
                "rc": rc, "read_back_equal": equal,
                "act_scales": sum(k.endswith(".act_scale") for k in got),
                "printed": [ln for ln in out.getvalue().splitlines()
                            if ln.startswith("[export]")]}
    finally:
        if os.path.exists(pt_path):
            os.remove(pt_path)

    # the demo's loop with drawing, per frame and at chunk 8
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.pipeline import PosePipeline
    params, _ = load_params(v8)
    _, frames = make_frames(FRAMES)
    loops = {}
    digest = draw_digest()               # builds the native library first
    for chunk in (0, ACC_CHUNK):
        pipe = PosePipeline(PipelineConfig(model_name=V8), params)   # bf16

        def loop():
            drawn, t_prev = [], time.perf_counter()
            for frame, tracks in demo.track_frames(
                    pipe, (f.copy() for f in frames), WIDTH, HEIGHT, chunk):
                now = time.perf_counter()
                ms = (now - t_prev) * 1e3
                draw_all_tracks(frame, tracks)
                draw_stats(frame, 1e3 / max(ms, 1e-3), len(tracks), ms)
                drawn.append((frame, tracks, ms))
                t_prev = time.perf_counter()
            return drawn
        loop()                                         # the warm pass
        pipe.reset()
        t = time.perf_counter()
        drawn, launches_demo = counted_run(rows, kernels, loop)
        wall = time.perf_counter() - t
        same = True
        for orig, (frame, tracks, ms) in zip(frames, drawn):
            again = orig.copy()
            draw_all_tracks(again, tracks)
            draw_stats(again, 1e3 / max(ms, 1e-3), len(tracks), ms)
            same &= again.tobytes() == frame.tobytes()
        loops[chunk] = {"frames_per_s": FRAMES / wall,
                        "ms_per_frame": [round(d[2], 3) for d in drawn],
                        "launches": launches_demo,
                        "drawn_bytes_equal_cpu": same,
                        "ids": track_ids([d[1] for d in drawn])}
    demo_ok = all(r["drawn_bytes_equal_cpu"] for r in loops.values()) and \
        loops[0]["launches"] == {"nms_keep": FRAMES, "auction": 3 * FRAMES,
                                 "tracker_chunk": 0} and \
        loops[ACC_CHUNK]["launches"] == {
            "nms_keep": FRAMES // ACC_CHUNK, "auction": 0,
            "tracker_chunk": FRAMES // ACC_CHUNK} and \
        digest == DRAW_DIGEST
    emit("cli", t0, benchmark=bench, benchmark_launches=launches,
         benchmark_launches_expected=want,
         stages=[ln for ln in text[:-1] if "us/frame" in ln],
         nms_n100_mismatches=nms_mism, auction_50x50_mismatches=auc_mism,
         auction_50x50_rounds=rounds, export=exported,
         demo={("per_frame" if k == 0 else f"chunk_{k}"): {
             kk: vv for kk, vv in r.items() if kk != "ids"}
             for k, r in loops.items()},
         demo_chunk_ids_equal=loops[0]["ids"] == loops[ACC_CHUNK]["ids"],
         draw_digest_equal=digest == DRAW_DIGEST)
    if not bench_ok or nms_mism or auc_mism or not demo_ok or not all(
            e["read_back_equal"] for e in exported.values()):
        raise SystemExit("cli: a command-line check failed")


# Training and the parallel package (the phases train, train_resume,
# train_reid, parallel and dp).
TRAIN_STEPS = 30
# (input, batch): yolov8n-pose at full width and 640, then the trainer's
# defaults
TRAIN_RUNS = ((640, 16), (256, 32))
TRAIN_WARM = 5         # steps before the timed ones
TRAIN_FALL = 0.7       # last loss below this x the first (tests/test_train.py)
SGD_LR = 1e-2          # the card/CPU step (tests/test_parallel_train.py)
STEP_RTOL_LOSS, STEP_RTOL, STEP_ATOL = 1e-4, 5e-4, 5e-6
RESUME = "yolov8n-pose-synthetic256"
RESUME_MAP_TOL = 0.03  # the port's renderer is not cv2's
REID_STEPS, REID_PAIRS, REID_BATCH = 20, 64, 16
REID_TOL = 0.03
PAR_STEPS = 4
DP_STEPS, DP_SIZE, DP_BATCH, DP_FRAMES = 10, 256, 16, 64
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
DEV = "cuda"        # the card (the new phases' device, by name)


def train_data(size, batch, seed=SEED):
    """`batch` synthetic letterboxed frames at `size` (the trainer's
    make_split, noise on): the host arrays and their tensors on the card."""
    import torch
    from posebyte_tpu_torch.scripts.train_synthetic import make_split
    host = make_split(batch, size, seed, noise=True)
    return host, {k: torch.from_numpy(v).to(DEV) for k, v in host.items()}


def conv_flops(params, imgs, family):
    """Float32 operations of the forward's convolutions on imgs, from each
    F.conv2d call's shapes: 2 per multiply-add."""
    import torch
    import torch.nn.functional as F
    from posebyte_tpu_torch.models.yolo_pose import forward_heads
    with recorded(F, "conv2d") as calls, torch.no_grad():
        forward_heads(params, imgs, family)
    total = 0
    for (x, w, *_), kw in calls:
        s, p = kw.get("stride", 1), kw.get("padding", 0)
        ho = (x.shape[2] + 2 * p - w.shape[2]) // s + 1
        wo = (x.shape[3] + 2 * p - w.shape[3]) // s + 1
        total += 2 * x.shape[0] * ho * wo * w.numel()
    return total


def profiled_ms(fn):
    """One call of fn under torch.profiler: (device busy ms, wall ms, the
    5 device items with the most ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    per_item = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_item[e.name[:60]] += e.device_time_total / 1e3
    busy = sum(per_item.values())
    top = sorted(per_item.items(), key=lambda kv: -kv[1])[:5]
    return (busy if busy > 0 else None), wall, top


def step_mismatch(got, want):
    """Worst |got - want| / (STEP_ATOL + STEP_RTOL |want|) over every
    parameter (above 1 fails), with its key."""
    worst, at = 0.0, None
    for k in want:
        a = got[k].detach().cpu().double()
        b = want[k].detach().cpu().double()
        r = float(((a - b).abs() / (STEP_ATOL + STEP_RTOL * b.abs())).max())
        if r > worst:
            worst, at = r, k
    return worst, at


def phase_train(t0):
    """yolov8n-pose from init_params in float32 on a fixed batch: TRAIN_STEPS
    steps of the trainer's optimizer chain (make_scan_train) at each of
    TRAIN_RUNS, the loss finite and falling below TRAIN_FALL x its first;
    ms per step, images/s, peak memory, the busy share of one profiled step
    and its bound (3 x the forward's conv operations at F32_OPS_S); one SGD
    step on the card and on the CPU from the same params and batch."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import set_numeric_settings
    from posebyte_tpu_torch.models import optim
    from posebyte_tpu_torch.models import train as T
    from posebyte_tpu_torch.models.yolo_pose import init_params
    from posebyte_tpu_torch.scripts.train_synthetic import make_optimizer
    set_numeric_settings()
    runs = []
    for size, batch in TRAIN_RUNS:
        host, data = train_data(size, batch)
        flat = init_params(SEED, V8)
        params = T.trainable_params(flat, DEV)
        opt = make_optimizer(1e-3, TRAIN_STEPS)
        st = opt.init(params)
        run = T.make_scan_train(V8, size, opt, batch)
        idx = torch.arange(batch, device=DEV).repeat(TRAIN_STEPS, 1)
        torch.cuda.reset_peak_memory_stats()
        params, st, warm = run(params, st, data, idx[:TRAIN_WARM])
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, st, rest = run(params, st, data, idx[TRAIN_WARM:])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / (TRAIN_STEPS - TRAIN_WARM)
        peak = torch.cuda.max_memory_allocated() / 2**20
        losses = torch.cat([warm, rest]).cpu().numpy()
        step = T.make_train_step(V8, size, opt)
        busy, wall, top = profiled_ms(lambda: step(params, st, data))
        fwd = conv_flops(params, T.to_unit(data["img"]), "v8")
        bound_ms = 3 * fwd / F32_OPS_S * 1e3
        # one SGD step on the card and on the CPU, the same params and batch
        sgd = optim.sgd(SGD_LR)
        sgd_step = T.make_train_step(V8, size, sgd)
        cards, cpus = (T.trainable_params(flat, d) for d in (DEV, "cpu"))
        p_card, _, l_card, _ = sgd_step(cards, sgd.init(cards), data)
        tc = time.perf_counter()
        p_cpu, _, l_cpu, _ = sgd_step(cpus, sgd.init(cpus), {
            k: torch.from_numpy(v) for k, v in host.items()})
        cpu_s = time.perf_counter() - tc
        worst, at = step_mismatch(p_card, p_cpu)
        loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
        runs.append({
            "input": size, "batch": batch, "first_loss": float(losses[0]),
            "last_loss": float(losses[-1]), "losses": losses.tolist(),
            "ms_per_step": ms, "images_per_s": batch / ms * 1e3,
            "peak_mem_mb": peak, "profiled_step_ms": wall,
            "device_busy_ms": busy,
            "busy_share": None if busy is None else busy / wall,
            "top_device_ms": top, "forward_conv_gflop": fwd / 1e9,
            "bound_ms": bound_ms, "bound_by": "operations",
            "sgd_loss_card": float(l_card), "sgd_loss_cpu": float(l_cpu),
            "sgd_loss_rel": loss_rel, "sgd_param_worst": worst,
            "sgd_param_worst_key": at, "cpu_step_s": cpu_s})
        bad = (not np.isfinite(losses).all()
               or not losses[-1] < TRAIN_FALL * losses[0]
               or loss_rel > STEP_RTOL_LOSS or worst > 1.0)
        if bad:
            emit("train", t0, model=V8, runs=runs)
            raise SystemExit(f"train at {size}, batch {batch}: the loss "
                             f"did not fall or the card disagrees with "
                             f"the CPU")
        del params, st, data
        torch.cuda.empty_cache()
    emit("train", t0, model=V8, dtype="float32", steps=TRAIN_STEPS,
         optimizer="clip_by_global_norm(5) + adamw(warmup cosine, 1e-3)",
         sgd_lr=SGD_LR, runs=runs)


def phase_train_resume(t0, rows, assets):
    """train_synthetic.main --resume the v8n-256 checkpoint for 10 steps at
    lr 1e-5 on the card: its save check (the file read back on the CPU,
    the loss equal) and eval_detection on the script's own validation split
    (256 frames, seed + 777000, no noise) with Kernel 1, a launch per batch
    of 32; then the saved file's detections of that split on the card and
    on the CPU, equal, and the mAP within RESUME_MAP_TOL of the metrics
    file's."""
    import io
    import numpy as np
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.scripts import train_synthetic as TS
    asset = os.path.join(assets, RESUME + ".safetensors")
    with open(os.path.join(assets, RESUME + ".metrics.json")) as f:
        want = json.load(f)["val_detection"]["mAP"]
    out = os.path.join(BUILD, "train_resume", "resumed.safetensors")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    argv = ["--resume", asset, "--size", "256", "--steps", "10",
            "--segment", "10", "--lr", "1e-5", "--n-train", "256",
            "--out", out, "--device", DEV]
    kernels = _kernel_counts()
    log = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc, main_launches = counted_run(rows, kernels,
                                        lambda: TS.main(argv))
    main_s = time.perf_counter() - t
    with open(out.replace(".safetensors", ".metrics.json")) as f:
        card_map = json.load(f)["val_detection"]
    verify = [ln for ln in log.getvalue().splitlines()
              if ln.startswith("[save-verify]")]
    params, _ = load_params(out)
    val = TS.make_split(256, 256, 777_000, noise=False)
    card, launches = counted_run(rows, kernels, lambda: TS.detect_batches(
        params, val, V8, 256, device=DEV))
    cpu = TS.detect_batches(params, val, V8, 256, device="cpu")
    valid_equal = all(np.array_equal(a.valid, b.valid)
                      for a, b in zip(card, cpu))
    kp = max(float(np.abs(a.poses[a.valid] - b.poses[b.valid]).max(
        initial=0.0)) for a, b in zip(card, cpu))
    score = max(float(np.abs(a.scores - b.scores).max())
                for a, b in zip(card, cpu))
    cpu_map = TS.detection_map(cpu, val)
    again = TS.detection_map(card, val)
    batches = 256 // 32
    emit("train_resume", t0, checkpoint=os.path.basename(asset), rc=rc,
         main_s=main_s, save_verify=verify, val_frames=256,
         map_card=card_map, map_card_again=again, map_cpu=cpu_map,
         map_want=want, detections_valid_equal=valid_equal,
         kp_err_px=kp, score_err=score, launches_main=main_launches,
         launches_detect=launches)
    if (rc != 0 or not verify or not valid_equal or kp > 1e-2
            or score > 1e-4
            or abs(card_map["mAP"] - want) > RESUME_MAP_TOL
            or abs(again["mAP"] - cpu_map["mAP"]) > 1e-9
            or main_launches != {"nms_keep": batches, "auction": 0,
                                 "tracker_chunk": 0}
            or launches["nms_keep"] != batches):
        raise SystemExit("train_resume: the resumed checkpoint's detections "
                         "or mAP disagree")


def phase_train_reid(t0, assets):
    """REID_STEPS steps of train_reid's step (info_nce_loss, Adam 2e-3) on
    the card from init_reid_head: the loss falls; eval_separation of the
    trained head on the script's validation split (128 pairs, seed +
    999000) on the card: top1_acc within REID_TOL of its metrics file's."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.models import init_reid_head, load_reid_head
    from posebyte_tpu_torch.models import optim
    from posebyte_tpu_torch.scripts import train_reid as TR
    pairs = TR.make_pairs(REID_PAIRS, 256, SEED)
    data = {k: torch.from_numpy(v).to(DEV) for k, v in pairs.items()}
    params = {k: v.to(DEV) for k, v in init_reid_head(SEED).items()}
    opt = optim.adam(2e-3)
    st = opt.init(params)
    step = TR.make_step(data, REID_PAIRS, REID_BATCH, opt)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    losses = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(REID_STEPS):
        params, st, loss = step(params, st, gen)
        losses.append(loss)
    losses = torch.stack(losses).cpu().numpy()
    ms = (time.perf_counter() - t) * 1e3 / REID_STEPS
    with open(os.path.join(assets, "reid-head-synthetic.metrics.json")) as f:
        want = json.load(f)["val"]
    val = TR.make_pairs(128, 256, 999_000)
    got = TR.eval_separation(load_reid_head(
        os.path.join(assets, HEAD_ASSET)), val, DEV)
    falls = bool(losses[-5:].mean() < losses[:5].mean())
    emit("train_reid", t0, steps=REID_STEPS, batch=REID_BATCH,
         losses=losses.tolist(), ms_per_step=ms, loss_falls=falls,
         separation=got, separation_want=want)
    if (not np.isfinite(losses).all() or not falls
            or abs(got["top1_acc"] - want["top1_acc"]) > REID_TOL):
        raise SystemExit("train_reid: the loss did not fall or the head's "
                         "separation disagrees with its metrics file")


def phase_parallel(t0, rows, params):
    """MultiStreamPipeline (PAR_STEPS steps) and MultiStreamChunkPipeline
    (one chunk of SERVE_CHUNK) on make_mesh(1), SERVE_STREAMS streams of
    1920x1080, yolov8n-pose 640 in fp32: per call Kernel 1 once, Kernel 3
    once, Kernel 2 never; ids equal to StreamServer's and
    ChunkedStreamServer's on the same frames with every stream advancing,
    and to the pipelines' run on the CPU (keypoints within 1e-2 px)."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.parallel import (MultiStreamChunkPipeline,
                                             MultiStreamPipeline, make_mesh)
    from posebyte_tpu_torch.pipeline import ChunkedStreamServer, StreamServer
    cfg = PipelineConfig(precision="fp32")
    f32 = torch.float32
    streams = serving_streams()
    frames = np.stack([np.stack(s[0][:SERVE_CHUNK]) for s in streams])
    kernels = _kernel_counts()
    one = {"nms_keep": 1, "auction": 0, "tracker_chunk": 1}

    def served(srv, k):
        for sid in range(SERVE_STREAMS):
            srv.open_stream()
            for f in frames[sid, :k]:
                srv.submit(sid, f)
        while srv.step():
            pass
        return [srv.poll(sid) for sid in range(SERVE_STREAMS)]

    def frames_per_s(ms, kind):
        """Frames over the timed calls (a warm-up call ran before them)."""
        per_call = SERVE_STREAMS * (1 if kind == "frame" else SERVE_CHUNK)
        return per_call * len(ms) / (sum(ms) / 1e3)

    res = {}
    for kind in ("frame", "chunk"):
        mesh = make_mesh(1)
        if kind == "frame":
            pipe = MultiStreamPipeline(SERVE_STREAMS, cfg, mesh, params,
                                       dtype=f32)
            cpu = MultiStreamPipeline(SERVE_STREAMS, cfg,
                                      make_mesh(1, device="cpu"), params,
                                      dtype=f32)
            warm = MultiStreamPipeline(SERVE_STREAMS, cfg, mesh, params,
                                       dtype=f32).process_frames
            calls = [lambda k=k: pipe.process_frames(frames[:, k])
                     for k in range(PAR_STEPS)]
            cpu_calls = [lambda k=k: cpu.process_frames(frames[:, k])
                         for k in range(PAR_STEPS)]
            srv = StreamServer(SERVE_STREAMS, (SERVE_H, SERVE_W), cfg, params,
                               device=DEV, dtype=f32)
            k_frames = PAR_STEPS
        else:
            pipe = MultiStreamChunkPipeline(SERVE_STREAMS, SERVE_CHUNK, cfg,
                                            mesh, params, dtype=f32)
            cpu = MultiStreamChunkPipeline(SERVE_STREAMS, SERVE_CHUNK, cfg,
                                           make_mesh(1, device="cpu"),
                                           params, dtype=f32)
            warm = MultiStreamChunkPipeline(SERVE_STREAMS, SERVE_CHUNK, cfg,
                                            mesh, params,
                                            dtype=f32).process_chunks
            calls = [lambda: pipe.process_chunks(frames)]
            cpu_calls = [lambda: cpu.process_chunks(frames)]
            srv = ChunkedStreamServer(SERVE_STREAMS, (SERVE_H, SERVE_W),
                                      SERVE_CHUNK, cfg, params, device=DEV,
                                      dtype=f32)
            k_frames = SERVE_CHUNK
        # One untimed call of a second pipeline on the same shapes first,
        # so that no timed call pays the first call's set-up; its launches
        # are not counted.
        warm(frames[:, 0] if kind == "frame" else frames)
        del warm
        torch.cuda.synchronize()
        outs, counts, ms = [], [], []
        for call in calls:
            t = time.perf_counter()
            out, n = counted_run(rows, kernels, call)
            ms.append((time.perf_counter() - t) * 1e3)
            outs.append(out)
            counts.append(n)
        host = [c() for c in cpu_calls]

        def joined(outs, key):
            return np.concatenate([o[key][:, None] if kind == "frame"
                                   else o[key] for o in outs], axis=1)

        ids, poses, emit_ = (joined(outs, k) for k in ("ids", "poses",
                                                       "emit"))
        c_ids, c_poses = joined(host, "ids"), joined(host, "poses")
        polled = served(srv, k_frames)
        srv_ids = np.stack([np.stack([o["ids"] for o in s]) for s in polled])
        kp = float(np.abs(np.where(emit_[..., None, None], poses - c_poses,
                                   0)).max())
        res[kind] = {
            "steps": len(calls), "frames_per_call": SERVE_STREAMS * (
                1 if kind == "frame" else SERVE_CHUNK),
            "ms_per_call": ms, "frames_per_s": frames_per_s(ms, kind),
            "launches_per_call": counts,
            "ids_equal_server": bool(np.array_equal(ids, srv_ids)),
            "ids_equal_cpu": bool(np.array_equal(ids, c_ids)),
            "kp_err_px_cpu": kp, "tracks": int(emit_.sum())}
        if (not res[kind]["ids_equal_server"]
                or not res[kind]["ids_equal_cpu"] or kp > 1e-2
                or any(c != one for c in counts) or not emit_.any()):
            emit("parallel", t0, failed=kind, result=res[kind])
            raise SystemExit(f"parallel ({kind}): ids or launches wrong")
        del pipe, cpu, srv
    emit("parallel", t0, mesh=1, streams=SERVE_STREAMS,
         frame_size=[SERVE_W, SERVE_H], precision="fp32",
         per_frame=res["frame"], per_chunk=res["chunk"])


def phase_dp(t0):
    """make_data_mesh(1): an NCCL group of one on the card (a FileStore
    under build/dp). make_dp_train_step equal to make_train_step bit for
    bit (SGD, the same params and batch; cuDNN and the index backward in
    their deterministic modes for both); make_dp_scan_train for DP_STEPS
    steps of the trainer's chain on its shard lowers the loss."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from posebyte_tpu_torch.models import optim
    from posebyte_tpu_torch.models import train as T
    from posebyte_tpu_torch.models.yolo_pose import init_params
    from posebyte_tpu_torch.parallel import (make_data_mesh,
                                             make_dp_scan_train,
                                             make_dp_train_step,
                                             shard_dataset)
    from posebyte_tpu_torch.scripts.train_synthetic import (make_optimizer,
                                                            make_split)
    mesh = make_data_mesh(1, device=DEV, store_path=os.path.join(
        BUILD, "dp", f"smoke{os.getpid()}.store"))
    backend = dist.get_backend()
    host, data = train_data(DP_SIZE, DP_BATCH)
    flat = init_params(SEED, V8)
    sgd = optim.sgd(SGD_LR)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        res = []
        for step in (T.make_train_step(V8, DP_SIZE, sgd),
                     T.make_train_step(V8, DP_SIZE, sgd),
                     make_dp_train_step(V8, DP_SIZE, sgd, mesh)):
            p = T.trainable_params(flat, DEV)
            res.append(step(p, sgd.init(p), data))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = det

    def equal(a, b):
        return bool(torch.equal(a[2], b[2]) and all(
            torch.equal(a[0][k], b[0][k]) for k in a[0]))

    repeat_equal, dp_equal = equal(res[0], res[1]), equal(res[0], res[2])
    shard = shard_dataset(make_split(DP_FRAMES, DP_SIZE, SEED + 1,
                                     noise=True), mesh)
    opt = make_optimizer(1e-3, DP_STEPS)
    params = T.trainable_params(flat, DEV)
    run = make_dp_scan_train(V8, DP_SIZE, opt, DP_BATCH, mesh)
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, _, losses = run(params, opt.init(params), shard, DP_STEPS,
                            seed=SEED)
    losses = losses.cpu().numpy()
    ms = (time.perf_counter() - t) * 1e3 / DP_STEPS
    falls = bool(losses[-3:].mean() < losses[:3].mean())
    dist.destroy_process_group()
    emit("dp", t0, backend=backend, world_size=mesh.world_size,
         repeat_equal=repeat_equal, dp_step_equal=dp_equal,
         loss=float(res[2][2]), scan_losses=losses.tolist(),
         scan_ms_per_step=ms, scan_loss_falls=falls)
    if not dp_equal or not np.isfinite(losses).all() or not falls:
        raise SystemExit("dp: the DP step differs from make_train_step or "
                         "the DP loop did not lower the loss")


# ---------------------------------------------------------------------------
# The decode variants, the engine, the locked engine and the debug hooks
# ---------------------------------------------------------------------------

DECODE_VARIANTS = (("post", "sort"), ("tail", "sort"), ("post", "bisect"),
                   ("post", "approx"))
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def device_times(fn, reps):
    """Device time of fn, two ways: "device_ms", the sleep-ahead time
    (utils/timing.py::device_ms; None where fn waits for the device, which
    that method cannot time), and from torch.profiler over `reps` calls
    after a warm-up: "busy_ms" per call (the device time of its kernels
    and copies), "launches" per call, and "host_syncs" per call (the
    synchronising CUDA runtime calls it made)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = launches = syncs = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.device_time_total
            launches += 1
        elif e.name in SYNC_CALLS:
            syncs += 1
    # The host blocks once ~1000 launches wait in the card's queue, behind
    # the sleep (model_device_ms): as many calls as stay below that.
    n = max(1, min(reps, int(900 * reps // max(launches, 1))))
    try:
        dev = device_ms(fn, n)
    except RuntimeError:
        dev = None
    # the last synchronize above is the timing's own
    return {"device_ms": dev, "busy_ms": busy / 1e3 / reps,
            "launches": launches / reps, "host_syncs": (syncs - 1) / reps}


def variant_config(fusion, topk, precision="bf16"):
    from posebyte_tpu_torch.core import DetectorConfig, PipelineConfig
    return PipelineConfig(detector=DetectorConfig(decode_fusion=fusion,
                                                  topk_impl=topk),
                          precision=precision)


def tracks_diff(a, b):
    """(ids equal, max keypoint difference px) of two runs' per-frame
    TrackOutput lists."""
    import numpy as np
    ids_equal, err = True, 0.0
    for x, y in zip(a, b):
        ids_equal &= [t.track_id for t in x] == [t.track_id for t in y]
        if len(x) == len(y) and x:
            err = max(err, float(np.abs(
                np.stack([t.keypoints for t in x])
                - np.stack([t.keypoints for t in y])).max()))
    return ids_equal, err


def phase_decode_variants(t0, params, rows):
    """The headline chunk (K = 128 frames of 1280x720, bf16, raw u8) through
    PosePipeline with decode_fusion "post" or "tail" and topk_impl "sort",
    "bisect" or "approx": each chunk's outputs equal to post/sort's bit for
    bit, launches per chunk nms_keep 1, tracker_chunk 1, auction 0; each
    variant's decode timed on the chunk's own head outputs (call ms and
    device_times per chunk); the per-frame path with tail and bisect over
    FRAMES frames (1 and 3 launches a frame) with post/sort's ids; tail and
    bisect in fp32 on the CPU and the card, a chunk of K = 8 and 4 frames:
    ids equal, keypoints within 1e-2 px; and layers.packed_stem (P = 4) at
    B = 8 against the plain stem on the card: the same detections."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.ops.preprocess import letterbox_flat_nhwc
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.pipeline.runner import _decode, _decode_levels
    kernels = _kernel_counts()
    frames, gt = next(make_chunks(1, CHUNK))
    ref, variants = None, {}
    for fusion, topk in DECODE_VARIANTS:
        pipe = PosePipeline(variant_config(fusion, topk), params)
        flat = pipe.stage_chunk(frames)
        outs, launches = counted_run(rows, kernels, lambda: pipe.
                                     process_chunk_device(flat, HEIGHT,
                                                          WIDTH))
        host = {k: v.cpu() for k, v in outs.items()}
        ref = ref or host
        det_cfg = pipe.config.detector
        with torch.inference_mode():
            imgs = letterbox_flat_nhwc(flat, WIDTH, HEIGHT,
                                       det_cfg.input_size, selection=True,
                                       raw=True)
            if fusion == "tail":
                maps = pipe.detector.head_maps(pipe.params, imgs)

                def dec():
                    return _decode_levels(det_cfg, maps)
            else:
                heads = pipe.detector.heads(pipe.params, imgs)

                def dec():
                    return _decode(det_cfg, *heads)
            dev, call = device_times(dec, 5), cuda_ms(dec, 5)
        variants[f"{fusion}/{topk}"] = {
            "launches": launches,
            "equal_to_post_sort": all(torch.equal(host[k], ref[k])
                                      for k in ref),
            "decode_ms_per_chunk": call,
            **{f"decode_{k}_per_chunk": v for k, v in dev.items()}}
        del pipe
    # per frame: tail + bisect against post + sort on the card
    _, fr = make_frames(FRAMES)
    per_frame = {}
    for fusion, topk in (("post", "sort"), ("tail", "bisect")):
        pipe = PosePipeline(variant_config(fusion, topk), params)
        res, launches = counted_run(rows, kernels, lambda: [
            pipe.fetch_outputs(pipe.process_frame(f), WIDTH, HEIGHT)
            for f in fr])
        per_frame[fusion] = (res, launches)
    frame_ids_equal, frame_kp = tracks_diff(per_frame["post"][0],
                                            per_frame["tail"][0])
    # CPU against the card, tail + bisect, fp32
    small, _ = next(make_chunks(1, CMP_CHUNK))
    cfg = variant_config("tail", "bisect", "fp32")
    runs = {}
    for d in ("cpu", "cuda"):
        pipe = PosePipeline(cfg, params, device=d)
        runs[d] = pipe.fetch_chunk_outputs(pipe.process_chunk(small), WIDTH,
                                           HEIGHT)
        runs[d] += [pipe.fetch_outputs(pipe.process_frame(f), WIDTH, HEIGHT)
                    for f in fr[:4]]
    cmp_ids, cmp_kp = tracks_diff(runs["cpu"], runs["cuda"])
    packed = packed_stem_check(params, frames[:8])
    emit("decode_variants", t0, chunk=CHUNK, variants=variants,
         frame_launches={k: v[1] for k, v in per_frame.items()},
         frame_tail_bisect_ids_equal=frame_ids_equal,
         frame_tail_bisect_max_kp_diff_px=frame_kp,
         cpu_vs_card_ids_equal=cmp_ids, cpu_vs_card_max_kp_diff_px=cmp_kp,
         cpu_vs_card_tracks=[len(r) for r in runs["cuda"]],
         packed_stem=packed)
    bad = [k for k, v in variants.items()
           if not v["equal_to_post_sort"] or v["launches"] != {
               "nms_keep": 1, "auction": 0, "tracker_chunk": 1}]
    want = {"nms_keep": FRAMES, "auction": 3 * FRAMES, "tracker_chunk": 0}
    if bad or any(v[1] != want for v in per_frame.values()):
        raise SystemExit(f"decode_variants: {bad or per_frame} differ from "
                         "post/sort or launch otherwise")
    if not frame_ids_equal or frame_kp != 0.0:
        raise SystemExit("decode_variants: the per-frame tail path differs "
                         "from post")
    if not cmp_ids or cmp_kp > 1e-2 or not any(runs["cuda"]):
        raise SystemExit("decode_variants: the card and the CPU disagree")
    if not packed["valid_equal"] or packed["max_kp_diff_px"] > 1e-2:
        raise SystemExit(f"decode_variants: packed_stem {packed}")


def packed_stem_check(params, frames):
    """forward_heads with packed_stem=4 against the plain stem at fp32 on
    the card, B = 8 frames letterboxed raw: the decoded, NMS'd detections'
    validity equal and keypoints within 1e-2 px; and the stem output."""
    import torch
    from posebyte_tpu_torch.core import DetectorConfig
    from posebyte_tpu_torch.models import layers as L
    from posebyte_tpu_torch.models.layers import prepare_params
    from posebyte_tpu_torch.models.weights import fold_stem_preprocess
    from posebyte_tpu_torch.models.yolo_pose import build_model_heads
    from posebyte_tpu_torch.ops.preprocess import letterbox_flat_nhwc
    from posebyte_tpu_torch.pipeline.runner import _decode, _nms
    cfg = DetectorConfig()
    p = prepare_params(fold_stem_preprocess(params), torch.float32, "cuda")
    flat = torch.from_numpy(frames.reshape(len(frames), -1)).cuda()
    with torch.inference_mode():
        imgs = letterbox_flat_nhwc(flat, WIDTH, HEIGHT, cfg.input_size,
                                   selection=True, raw=True).float()
        dets = []
        for P in (0, 4):
            heads, _ = build_model_heads(V8, torch.float32, packed_stem=P)
            dets.append(_nms(cfg, _decode(cfg, *heads(p, imgs))))
        x = imgs.permute(0, 3, 1, 2)
        stem = (L.packed_stem(p, "b0", "b1", x, 4) -
                L.conv_block(p, "b1", L.conv_block(p, "b0", x, 2), 2))
    return {"valid_equal": bool(torch.equal(dets[0].valid, dets[1].valid)),
            "detections": int(dets[0].valid.sum()),
            "max_kp_diff_px": float((dets[0].poses - dets[1].poses)
                                    .abs().max()),
            "stem_max_abs_diff": float(stem.abs().max())}


def engine_lists_diff(a, b):
    """(detection counts equal, max keypoint difference px) of two
    detect_batch results."""
    import numpy as np
    same, err = True, 0.0
    for x, y in zip(a, b):
        same &= len(x) == len(y)
        for p, q in zip(x, y):
            err = max(err, float(np.abs(p["keypoints"]
                                        - q["keypoints"]).max()))
    return same, err


def phase_engine(t0, params, qparams, rows):
    """YoloPoseEngine (yolov8n-pose 640, the normalised letterbox, the dense
    decode) on 1280x720 frames of the synthetic scene: detect (the legacy
    NMS), detect_batch of 8, detect_device_native (pose_nms: Kernel 1 once
    a call) and detect_from_device, bf16, each timed (ms per call; the
    device-native call by CUDA events, the host paths by the host's
    clock, their copies back included); the int8 engine (the calibrated
    w8a8 params) through detect_device_native over FRAMES frames: 59 Kernel
    4 launches and one Kernel 1 launch a frame, no eager quantisation; in
    fp32 the card against the CPU on 4 frames: detect_device_native's
    validity equal and keypoints within 1e-2 px, detect_batch's counts
    equal and keypoints within 1e-2 px."""
    import numpy as np
    import torch
    from posebyte_tpu_torch.models.engine import YoloPoseEngine
    kernels = _int8_counts()
    _, frames = make_frames(FRAMES)
    batch = np.stack(frames[:8])
    eng = YoloPoseEngine(V8, params=params)                 # bf16, the card
    staged = [torch.from_numpy(f.reshape(-1)).cuda() for f in frames]
    native, launches = counted_run(rows, kernels, lambda: [
        eng.detect_device_native(s, HEIGHT, WIDTH) for s in staged])
    if any(not torch.isfinite(d.poses).all() for d in native):
        raise SystemExit("engine: non-finite detections")
    times = {"detect_device_native_ms": cuda_ms(
        lambda: eng.detect_device_native(staged[0], HEIGHT, WIDTH), 20),
        "detect_device_native_device": device_times(
            lambda: eng.detect_device_native(staged[0], HEIGHT, WIDTH), 5)}
    for name, fn in (("detect_ms", lambda: eng.detect(frames[0])),
                     ("detect_batch8_ms", lambda: eng.detect_batch(batch)),
                     ("detect_from_device_ms",
                      lambda: eng.detect_from_device(staged[0], HEIGHT,
                                                     WIDTH))):
        fn()
        t = time.perf_counter()
        for _ in range(5):
            fn()
        times[name] = (time.perf_counter() - t) / 5 * 1e3
    legacy = [len(x) for x in eng.detect_batch(batch)]
    times["last_inference_ms_batch8"] = eng.get_last_inference_time()
    dets_per_frame = [int(d.valid.sum()) for d in native]
    del eng
    q = YoloPoseEngine(V8, params=qparams, precision="int8")
    _, q_launches = counted_run(rows, kernels, lambda: [
        q.detect_device_native(s, HEIGHT, WIDTH) for s in staged])
    times["int8_detect_device_native_ms"] = cuda_ms(
        lambda: q.detect_device_native(staged[0], HEIGHT, WIDTH), 20)
    del q
    engs = {d: YoloPoseEngine(V8, params=params, precision="fp32", device=d)
            for d in ("cpu", "cuda")}
    nat = {d: [e.detect_device_native(torch.from_numpy(f.reshape(-1)).to(
        d), HEIGHT, WIDTH) for f in frames[:4]] for d, e in engs.items()}
    valid_equal = all(torch.equal(a.valid, b.valid.cpu())
                      for a, b in zip(nat["cpu"], nat["cuda"]))
    nat_kp = max(float((a.poses - b.poses.cpu()).abs().max())
                 for a, b in zip(nat["cpu"], nat["cuda"]))
    counts_equal, legacy_kp = engine_lists_diff(
        *(e.detect_batch(batch[:4]) for e in engs.values()))
    emit("engine", t0, frames=FRAMES, launches=launches,
         int8_launches=q_launches, dets_per_frame=dets_per_frame,
         legacy_dets_per_frame=legacy, **times,
         cpu_vs_card_valid_equal=valid_equal,
         cpu_vs_card_max_kp_diff_px=nat_kp,
         cpu_vs_card_legacy_counts_equal=counts_equal,
         cpu_vs_card_legacy_max_kp_diff_px=legacy_kp)
    if launches != {"nms_keep": FRAMES, "auction": 0, "tracker_chunk": 0,
                    "conv_int8": 0, "eager_quantize": 0}:
        raise SystemExit(f"engine launch counts {launches}")
    if q_launches != {"nms_keep": FRAMES, "auction": 0, "tracker_chunk": 0,
                      "conv_int8": 59 * FRAMES, "eager_quantize": 0}:
        raise SystemExit(f"int8 engine launch counts {q_launches}")
    if min(dets_per_frame) < 1 or min(legacy) < 1:
        raise SystemExit("engine: no detections")
    if not (valid_equal and counts_equal) or max(nat_kp, legacy_kp) > 1e-2:
        raise SystemExit("engine: the card and the CPU disagree")


AOT_REL = 1e-3       # exported program against eager, of the largest value


def phase_aot(t0, params, qparams, rows):
    """models.aot on the card: yolov8n-pose 640 exported at bf16 and at int8
    (w8a8), batch 1, into build/aot, loaded back and run on a letterboxed
    1280x720 frame: each within AOT_REL of the eager forward_raw's largest
    value (bit-equal reported), both timed against eager forward_raw (call
    ms and device ms); the int8 program's FRAMES calls launch Kernel 4 59
    times each and its plain version never; an fp32 program exported on
    the CPU against the card's fp32 program within 1e-2 px; a card program
    refused on the CPU."""
    import torch
    from posebyte_tpu_torch.models.aot import export_engine_aot, \
        load_engine_aot
    from posebyte_tpu_torch.models.layers import prepare_params
    from posebyte_tpu_torch.models.yolo_pose import build_model
    from posebyte_tpu_torch.ops import conv_int8 as CI
    from posebyte_tpu_torch.ops.preprocess import letterbox_flat_nhwc
    root = os.path.join(BUILD, "aot")
    os.makedirs(root, exist_ok=True)
    kernels = _int8_counts()
    _, frames = make_frames(2)
    x = letterbox_flat_nhwc(torch.from_numpy(frames[1].reshape(-1)).cuda(),
                            WIDTH, HEIGHT, LETTERBOX)[None]
    out = {}
    for tag, p, dtype in (("bf16", params, torch.bfloat16),
                          ("int8", qparams, torch.bfloat16),
                          ("fp32", params, torch.float32)):
        path = os.path.join(root, f"{tag}.pt2")
        t = time.perf_counter()
        size = export_engine_aot(p, V8, path, 1, LETTERBOX, dtype)
        export_s = time.perf_counter() - t
        t = time.perf_counter()
        run = load_engine_aot(path)
        load_s = time.perf_counter() - t
        t = time.perf_counter()
        run(x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        apply_fn, _ = build_model(V8, dtype)
        prepared = prepare_params(p, dtype, "cuda")

        def eager():
            with torch.inference_mode():
                return apply_fn(prepared, x)
        plain = CI.conv_w8a8_plain
        CI.conv_w8a8_plain = None              # the program must not use it
        try:
            res, launches = counted_run(rows, kernels, lambda: [
                run(x) for _ in range(FRAMES)])
        finally:
            CI.conv_w8a8_plain = plain
        want = eager()
        err = float((res[-1] - want).abs().max())
        out[tag] = {"bytes": size, "export_s": export_s, "load_s": load_s,
                    "first_call_s": first_s, "t": time.perf_counter() - t0,
                    "launches": launches, "bit_equal": bool(torch.equal(
                        res[-1], want)),
                    "max_abs_diff": err,
                    "rel_diff": err / float(want.abs().max()),
                    "ms": cuda_ms(lambda: run(x), 20),
                    "device": device_times(lambda: run(x), 5),
                    "eager_ms": cuda_ms(eager, 20),
                    "eager_device": device_times(eager, 5)}
    cpu_path = os.path.join(root, "fp32_cpu.pt2")
    t = time.perf_counter()
    export_engine_aot(params, V8, cpu_path, 1, LETTERBOX, torch.float32,
                      device="cpu")
    cpu_out = load_engine_aot(cpu_path, device="cpu")(x.cpu())
    cpu_s = time.perf_counter() - t
    card_out = load_engine_aot(os.path.join(root, "fp32.pt2"))(x).cpu()
    cpu_err = float((cpu_out - card_out).abs().max())
    try:
        load_engine_aot(os.path.join(root, "fp32.pt2"), device="cpu")
        refused = False
    except ValueError:
        refused = True
    emit("aot", t0, programs=out, cpu_vs_card_max_abs_diff=cpu_err,
         cpu_export_and_run_s=cpu_s,
         card_program_refused_on_cpu=refused)
    want_launch = {"bf16": 0, "fp32": 0, "int8": 59 * FRAMES}
    for tag, o in out.items():
        if o["launches"]["conv_int8"] != want_launch[tag] \
                or o["launches"]["eager_quantize"] or o["launches"]["nms_keep"]:
            raise SystemExit(f"aot {tag}: launch counts {o['launches']}")
        if o["rel_diff"] > AOT_REL:
            raise SystemExit(f"aot {tag}: {o['rel_diff']} from eager")
    if cpu_err > 1e-2 or not refused:
        raise SystemExit(f"aot: CPU program {cpu_err} px from the card's, "
                         f"refused {refused}")


def phase_debug(t0, rows):
    """tracker.debug on the card: TrackerConfig's defaults, 6 people of the
    synthetic scene with keypoint noise, 8 frames of tracker_step, then per
    frame of 4 more tracker_step_debug on the card (3 Kernel 2 launches a
    call) and on the CPU from the same state and detections: integer and
    bool keys equal, float keys (poses, centres, OKS, costs) within 1e-6
    relative plus 1e-6 (CUDA's expf and the CPU's differ by an ulp);
    dump_detections
    and get_track_states equal card and CPU; one debug call inside
    utils.profiling.torch_trace, whose Chrome trace must hold the auction
    kernel's device activity by name."""
    import dataclasses
    import json as _json
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import TrackerConfig
    from posebyte_tpu_torch.core.structs import Detections, TrackerState
    from posebyte_tpu_torch.tracker import tracker_step
    from posebyte_tpu_torch.tracker.debug import (dump_detections,
                                                  get_track_states,
                                                  tracker_step_debug)
    from posebyte_tpu_torch.utils.profiling import torch_trace
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene
    cfg = TrackerConfig()
    T, D = cfg.max_tracks, cfg.max_detections
    scene = SyntheticScene(N_PERSONS, WIDTH, HEIGHT, seed=SEED)
    rng = np.random.default_rng(SEED)

    def dets():
        gt = scene.step()
        P = np.zeros((D, 17, 3), np.float32)
        P[:N_PERSONS] = gt
        P[:N_PERSONS, :, :2] += rng.normal(0, 1.5, (N_PERSONS, 17, 2))
        B = np.zeros((D, 4), np.float32)
        B[:N_PERSONS] = np.stack([P[:N_PERSONS, :, 0].min(1),
                                  P[:N_PERSONS, :, 1].min(1),
                                  P[:N_PERSONS, :, 0].max(1),
                                  P[:N_PERSONS, :, 1].max(1)], -1)
        S = np.zeros((D,), np.float32)
        S[:N_PERSONS] = rng.uniform(0.4, 1.0, N_PERSONS)
        return (P, B, S, np.arange(D) < N_PERSONS)

    def on(arrays, dev):
        return Detections(*(torch.from_numpy(np.asarray(a)).to(dev)
                            for a in arrays))

    def moved(state, dev):
        return TrackerState(**{f.name: getattr(state, f.name).to(dev)
                               for f in dataclasses.fields(state)})

    state = TrackerState.init(T, D, "cuda")
    kernels = _kernel_counts()
    for _ in range(8):
        state, _ = tracker_step(state, on(dets(), "cuda"), cfg)
    mism, rel_err, calls, matched = [], 0.0, [], []
    for _ in range(4):
        arr = dets()
        got, launches = counted_run(rows, kernels, lambda: tracker_step_debug(
            state, on(arr, "cuda"), cfg))
        calls.append(launches)
        want = tracker_step_debug(moved(state, "cpu"), on(arr, "cpu"), cfg)
        for k, v in want.items():
            if v.dtype.kind in "biu":
                ok = np.array_equal(got[k], v)
            else:
                ok = np.allclose(got[k], v, rtol=1e-6, atol=1e-6)
                rel_err = max(rel_err, float(
                    (np.abs(got[k] - v) / np.maximum(np.abs(v), 1)).max()))
            if not ok:
                mism.append(k)
        matched.append(int((got["row_assign_final"] >= 0).sum()))
        state, _ = tracker_step(state, on(arr, "cuda"), cfg)
    dump_equal = dump_detections(on(arr, "cuda")) == \
        dump_detections(on(arr, "cpu"))
    states_equal = get_track_states(state) == \
        get_track_states(moved(state, "cpu"))
    trace_dir = os.path.join(BUILD, "trace")
    with torch_trace(trace_dir) as trace:
        tracker_step_debug(state, on(arr, "cuda"), cfg)
        torch.cuda.synchronize()
    with open(trace) as fh:
        events = _json.load(fh)["traceEvents"]
    traced = sorted({e["name"][:40] for e in events
                     if e.get("cat") == "kernel" and "auction" in e["name"]})
    emit("debug", t0, launches_per_call=calls, matched_per_call=matched,
         mismatched_keys=sorted(set(mism)), max_rel_float_diff=rel_err,
         dump_equal=dump_equal, track_states_equal=states_equal,
         tracks=len(get_track_states(state)), trace_kernels=traced,
         trace_bytes=os.path.getsize(trace))
    if any(c != {"nms_keep": 0, "auction": 3, "tracker_chunk": 0}
           for c in calls):
        raise SystemExit(f"debug launch counts {calls}")
    if mism or not (dump_equal and states_equal) \
            or min(matched) < N_PERSONS - 1:
        raise SystemExit("debug: the card and the CPU disagree")
    if not traced:
        raise SystemExit("debug: torch_trace recorded no auction kernel")


def kernel_label(mangled):
    """A kernel's mangled name -> nms_keep<dominance>, nms_keep<greedy,
    register words a lane>, auction, tracker_chunk<cv>,
    tracker_chunk<kalman136> or
    conv_int8<k,stride,tile_m,input type,A fill> (its template
    arguments)."""
    import re
    m = re.search(r"conv_int8_kernelILi(\d)ELi(\d)ELi(\d+)ELi(\d)ELi(\d)E",
                  mangled)
    if m:
        src = ("int8", "bf16", "f32")[int(m.group(4))]
        fill = ("tap", "patch", "patch_async")[int(m.group(5))]
        return (f"conv_int8<{m.group(1)},{m.group(2)},{m.group(3)},{src},"
                f"{fill}>")
    if "nms_dominance_kernel" in mangled:
        return "nms_keep<dominance>"
    m = re.search(r"nms_greedy_kernelILi(\d+)E", mangled)
    if m:
        return f"nms_keep<greedy,{m.group(1)}>"
    for base in ("auction", "tracker_chunk"):
        if base + "_kernel" in mangled:
            if base == "tracker_chunk":
                return base + ("<kalman136>" if "ILb1E" in mangled
                               else "<cv>")
            return base
    return mangled


def main(argv=None):
    """No arguments: every phase. --only NAME[,NAME...]: the build, the
    kernels phase, int8_calibration and the named later phases
    (decode_variants, engine, aot, debug), then the last two lines."""
    import argparse
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--only", default="",
                    help="comma-separated later phases to run alone")
    only = set(filter(None, ap.parse_args(argv).only.split(",")))
    faulthandler.dump_traceback_later(LIMIT_S, exit=True)
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.ops import cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", t0, name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t = time.perf_counter()
    path, build_s = cuda_lib.build()
    cuda_lib.load()
    ptxas = {kernel_label(k): v for k, v in cuda_lib.ptxas_usage().items()}
    spills = sorted(k for k, v in ptxas.items()
                    if k.startswith(("conv_int8", "nms_keep", "auction",
                                     "tracker_chunk"))
                    and (v.get("spill_stores") or v.get("spill_loads")))
    emit("build", t0, build_s=build_s, cached=build_s == 0.0,
         load_s=time.perf_counter() - t, library=os.path.basename(path),
         ptxas=ptxas, conv_int8_instantiations=sum(
             k.startswith("conv_int8") for k in ptxas),
         spilling=spills)
    if spills:
        raise SystemExit(f"Kernels 1-4 spill registers in {spills}")

    rows = phase_kernels(t0)
    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets")
    params, _ = load_params(os.path.join(
        assets, "yolov8n-pose-synthetic640.safetensors"))
    if only:
        qparams = phase_int8_calibration(t0, params)
        later_phases(t0, params, qparams, rows, only)
        return finish(rows, kind)
    phase_main_path(t0, params, rows)
    phase_cpu_vs_card(t0, params)
    phase_chunk_path(t0, params, rows)
    phase_chunk_cpu_vs_card(t0, params)
    sources = reid_sources("cuda", assets)
    cases = {}                       # the Re-ID cases of both kernel phases
    phase_reid_kernels(t0, rows, sources, cases)
    phase_reid_main_path(t0, params, rows, sources)
    phase_reid_chunk_path(t0, params, rows, sources)
    phase_reid_cpu_vs_card(t0, params, sources)
    phase_kalman_kernels(t0, rows, sources, cases)
    phase_kalman_main_path(t0, params, rows)
    phase_kalman_chunk_path(t0, params, rows)
    phase_kalman_cpu_vs_card(t0, params)
    qparams = phase_int8_calibration(t0, params)
    phase_int8_kernels(t0, qparams, rows)
    phase_int8_main_path(t0, qparams, rows)
    phase_int8_chunk_path(t0, qparams, rows)
    phase_int8_cpu_vs_card(t0, qparams)
    params11, _ = load_params(os.path.join(assets, f"{V11}-synthetic640"
                                           ".safetensors"))
    phase_main_path(t0, params11, rows, V11, "v11_main_path")
    phase_cpu_vs_card(t0, params11, V11, "v11_cpu_vs_card")
    phase_chunk_path(t0, params11, rows, V11, "v11_chunk_path")
    phase_chunk_cpu_vs_card(t0, params11, V11, "v11_chunk_cpu_vs_card")
    phase_v11_int8(t0, params11, rows)
    pt_path, pt_params = phase_pt_import(t0, params11)
    phase_serving_path(t0, params, rows, "frame")
    chunked = phase_serving_path(t0, params, rows, "chunk")
    phase_serving_cpu_vs_card(t0, params, sources)
    phase_frontend(t0, chunked, rows)
    del chunked
    phase_accuracy(t0, rows, assets)
    phase_hard_clip(t0, rows, assets)
    phase_cli(t0, rows, assets, pt_path, pt_params)
    phase_train(t0)
    phase_train_resume(t0, rows, assets)
    phase_train_reid(t0, assets)
    phase_parallel(t0, rows, params)
    phase_dp(t0)
    later_phases(t0, params, qparams, rows)
    return finish(rows, kind)


def later_phases(t0, params, qparams, rows, only=None):
    """The phases of the decode variants, the engine, the locked engine and
    the debug hooks (all of them, or those named in `only`)."""
    for name, run in (("decode_variants",
                       lambda: phase_decode_variants(t0, params, rows)),
                      ("engine",
                       lambda: phase_engine(t0, params, qparams, rows)),
                      ("aot", lambda: phase_aot(t0, params, qparams, rows)),
                      ("debug", lambda: phase_debug(t0, rows))):
        if not only or name in only:
            run()


def finish(rows, kind):
    """The kernels line and the last line."""
    import torch
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "rounds", "rounds_main_path",
            "ms_n1024", "device_ms_n1024", "plain_ms_n1024",
            "bound_ms_n1024", "variants", "ms_reid", "plain_ms_reid",
            "bound_ms_reid", "bound_by_reid", "ms_kalman", "plain_ms_kalman",
            "bound_ms_kalman", "bound_by_kalman", "ms_per_frame",
            "instantiations", "ms_int8_mode", "plain_ms_int8_mode",
            "bound_ms_int8_mode", "bound_by_int8_mode",
            "yardstick_two_pass_ms", "yardstick_cudnn_bf16_ms",
            "yardstick_int_mm_ms", "ms_frame", "bound_ms_frame",
            "frame_candidates", "ms_b128", "bound_ms_b128",
            "ms_pipeline", "ms_frame_v11", "bound_ms_frame_v11",
            "frame_candidates_v11", "rounds_main_path_v11", "ms_b128_v11",
            "bound_ms_b128_v11", "ms_pipeline_v11", "v11",
            "ms_b8", "device_ms_b8", "bound_ms_b8",
            "bound_by_b8", "plain_ms_b8", "ms_b64", "device_ms_b64",
            "bound_ms_b64", "bound_by_b64", "plain_ms_b64",
            "ms_serving_k1_s8", "device_ms_serving_k1_s8",
            "bound_ms_serving_k1_s8", "bound_by_serving_k1_s8",
            "plain_ms_serving_k1_s8", "ms_serving_k8_s8",
            "device_ms_serving_k8_s8", "bound_ms_serving_k8_s8",
            "bound_by_serving_k8_s8", "plain_ms_serving_k8_s8",
            "ms_n100", "device_ms_n100", "plain_ms_n100", "bound_ms_n100",
            "ms_50x50", "device_ms_50x50", "plain_ms_50x50",
            "bound_ms_50x50", "rounds_50x50",
            "mismatches",
            "stage_split",
            "stage_split_pipeline", "stage_split_pipeline_v11",
            "stage_split_reid", "stage_split_kalman")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows.values()]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
