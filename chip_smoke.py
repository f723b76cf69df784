#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on a CUDA card: face-ID, eKYC, the
weight-only int8 FaceExtraction, checkpoint serving through the registry,
offline evaluation and video (multi-scale, TTA, tracking, AP), the
calibrated int8-activation detector, the gRPC serving runtime, and the
deployment surfaces (REST, the runtime's entry point, AOT artifacts).

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Phases, one line each (every check raises, so any failure exits non-zero
and the last line is never printed):

  1. card: name and power limit (nvidia-smi);
  2. build: the CUDA kernels, compiled from csrc/ into _build/;
  3. K1 vs plain: the NMS kernel equals the plain PyTorch NMS bit for bit,
     on random batches (ties, invalid padding) and on the detector's real
     top-128 candidates;
  4. detector parity: the full-width 640 RetinaFace on the card against the
     port's CPU path on the same weights and frames (TF32 off);
  5. main path: FacePipeline(device="cuda").extract_batch on 3 requests of 8
     frames plus extract_image on one, with the trained 640 detector, the
     seeded ResNet-18 quality head and the seeded IResNet-50 embedding; the
     NMS kernel's launch count must rise by one per detect call, K2's and
     K4's stay 0; the first request is held against the port's CPU
     pipeline;
  6. timings with CUDA events after a warm-up: the median, min and max over
     five windows of back-to-back calls, with TF32 off; K1 also on the
     device alone (20 calls replayed from a CUDA graph) at (8, 128) on the
     all-valid candidates of phase 3 and on the main path's own candidates
     at the default 0.7 threshold, beside its bound and the launch floor
     (a 1-element in-place add, replayed the same way), and split into its
     phases by two variants of csrc/nms.cu built with its measurement
     switches (phase 2 builds them);
  7. K2 vs plain: the fused ResNet-50 stem kernel against fused_stem_plain
     on letterboxed (8, 640, 640) canvases, on (2, 72, 96), (3, 70, 34) and
     (1, 2, 2) frames (partial tiles at every edge) and on all-0 and all-255
     canvases, with the config's pixel normalization and with ImageNet's (a
     nonzero mean, so the border zeroing shows);
  8. R50 detector parity: RetinaFace-ResNet50 at 640 on seeded full-width
     weights, batch 2, the fused-stem path on the card (K2) against the
     port's CPU path (TF32 off);
  9. R50 main path: FacePipeline with backbone="resnet50" on the card,
     extract_batch on 2 requests of 8 frames plus extract_image on one; K2
     must launch once per detect_batch, K1 once per detect call, K4 never; the
     first request is held against the port's CPU pipeline;
 10. DetectionServer: detect_batch and detect_stream over 3 batches of 8 on
     the R50 detector, each image equal to detect_batch called directly;
 11. R50 timings as in phase 6: detect b8, extract_batch b8, K2 per call at
     (8, 640, 640) on the device (graph replay) and from Python beside its
     bound (two TF32 products per multiply-add), the plain stem,
     detect_stream img/s;
 12. K4 vs plain: the flash-attention kernel against attention_plain in
     bf16 and f32, on strided qkv views at (8, 257, 16, 64), at the
     verify's (1, 257, 16, 64) and on (2, 17, 2, 32), (1, 1, 16, 64),
     (3, 197, 12, 64), (1, 600, 2, 64) and (8, 600, 16, 64) (K/V streamed
     through the ring, the latter over three rounds of warps);
 13. ViT parity: the full-width clip_l14 tower on seeded weights, batch 2,
     in f32 on the card (24 K4 launches) against the port's CPU path;
 14. SCRFD parity: the full-width SCRFD at 640, batch 2, maps on the card
     against the CPU; K1 equal to the plain NMS bit for bit on SCRFD's own
     top-256 candidates (the batch of two, and one single image); then
     detect_batch against __call__ per image;
 15. eKYC main path: EKYCPipeline on the card with full-width seeded models
     and bf16 towers, verify_images on 3 (card, selfie) pairs; K4 must
     launch 48 times, K1 twice and K2 never per verify; the first pair,
     with f32 towers, is held against the port's CPU pipeline;
 16. eKYC timings: verify per pair, one ViT-L/14 tower at b8 in bf16,
     SCRFD detect_batch b8, K4 per launch at (8, 257, 16, 64) bf16 against
     its plain version and F.scaled_dot_product_attention (the library
     yardstick; the port never calls it), both on the device (graph replay)
     and from Python, and on the device at the verify's (1, 257, 16, 64);
     K1 on the device at (1, 256): SCRFD's own candidates of phase 14's
     single frame, and 256 valid random boxes;
 17. K3 vs plain: the int8 dequant-matmul against int8_matmul_plain in f32
     and bf16 arithmetic at the fc's (8, 25088, 512) and (1, 25088, 512), at
     every row tile (M = 2, 9, 17, 33), ragged K (17, 4095) and N (1, 15,
     130), all-positive operands, a q one byte past a 16-byte boundary, and
     at M = 0 (no launch); every call made twice with the same bits, and a
     call captured in a CUDA graph equal to the eager one; K3's plan and
     dynamic shared memory at the fc's shape; the port's quantizer on the
     seeded IResNet-50 (53 int8 leaves, fc q (25088, 512));
 18. int8 main path: FaceExtraction(device="cuda", quantized=True) on the
     seeded full-width IResNet-50, 3 calls of 8 aligned 112x112 crops plus
     one of 1; K3 must launch once per call, K1, K2 and K4 never; the first
     call is held against the port's CPU FaceExtraction(quantized=True), and
     its cosine against the float FaceExtraction on the card is printed;
 19. the other staged modules on the card against the CPU: FaceQuality
     (ResNet-18, 4 classes), FaceQualityAssessment (1 output, no softmax)
     and FaceAntiSpoofing (four seeded MiniFASNets at 80/80/256/128) on the
     crops and on the faces phase 5 selected;
 20. int8 timings: K3 per launch in f32 and bf16 at (8, 25088, 512) and
     (1, 25088, 512), on the device with a warm L2 (20 calls on one q
     replayed from a CUDA graph; the kernels line's ``ms``) and a cold one
     (24 calls rotating over 6 copies of the fc's q, 77 MB against the 50 MB
     L2: ``cold_ms``, ``b1_cold_ms``, held against ``bound_ms``), and from
     Python, its plain version, F.linear on the dequantized f32 weight (the
     float fc, 4x the weight bytes) both ways, torch._weight_int8pack_mm in
     bf16 where this torch runs it on CUDA (the library yardstick, on the
     device as ``library_dev_ms`` and from Python as ``library_ms``); where
     K3's time goes: one cold call of a variant of csrc/int8_matmul.cu built
     with its measurement switch RSFD_K3_TIMELINE (phase 2 builds it), every
     CTA's stamps at x landed, x split, loop done, cluster summed, arrival
     counted and output written;
     FaceExtraction b8 and b1 float against int8, the weight bytes and the
     peak device memory of one call of each; FaceAntiSpoofing, FaceQuality
     and FaceQualityAssessment at b8;
 21. the kernels' own card tests: ``python -m pytest --noconftest -p
     no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py`` in a
     subprocess (tests/conftest.py imports JAX, which the card's machine
     need not have); it fails unless pytest exits 0, nothing is skipped and
     every collected test passed;
 22. checkpoint serving at full width, in a temporary RSFD_CHECKPOINT_DIR
     under _build/ with fresh registries: (a) the trained 640 detector
     written by save_imported and served as face_detection_retina.npz, its
     detect_batch torch.equal to phase 5's detector on phase 5's canvases,
     FacePipeline(registry=...) extract_batch b8 with the seeded builders'
     heads and with phase 5's heads through models=, both equal to phase 5's
     results, and the registry's statistics exact; (b) seeded state_dicts
     in every public layout at full width (insightface IResNet-50 for
     face_identification and face_id, torchvision ResNet-18 heads with 4, 2,
     2 and 1 outputs, the four Silent-Face MiniFASNets, one OpenAI CLIP
     ViT-L/14 with a 2-class head for both FAS towers, an mmdet SCRFD at the
     SCRFD-10G-KPS widths), detect_kind, import_state_dict, save_imported,
     each file's bytes and its import, save and load seconds; EKYCPipeline
     (registry=...) on 3 pairs torch.equal to the pipeline built from the
     same modules (48 K4 and 2 K1 launches per verify), the staged modules
     equal to direct ones; (c) a biubug6-layout R50 with a 7x7 stem served
     at 640, detect_batch b8 torch.equal to load_retinaface_state_dict's module
     with one K2 launch, and FaceExtraction(quantized=True, registry=...) b8
     with one K3 launch; (d) a Gallery of 100,000 seeded rows plus the
     fixture face on the card, identify b8 at k = 5 against the CPU's, and
     its time per call;
 23. offline evaluation and video on the trained 640 detector, each path
     held against the same object built on the CPU (counts equal, boxes
     within 1e-2 px, scores within 1e-4): (a) MultiScaleDetection over
     DEFAULT_BUCKETS on frames of 640x480, 1280x720 and 1920x1080, each
     routed to its bucket, one K1 launch per call, the registry counting
     every bucket's calls, ms per call per bucket; (b) TTADetection over
     the 640 and 1280 detectors with flip on the 1280x720 frame and its
     mirror, 4 K1 launches per image, the mirror's view rows equal to the
     frame's as a set and every merged box within 1 px of its mirror
     counterpart or an exact score tie between views, every single-scale
     box kept at IoU >= 0.5, ms per image; (c) VideoPipeline
     over DetectionServer(batch_size=8) on a 64-frame clip (the face moves
     4 px a frame and is gone for 3 frames): one track id on the face
     throughout, the CPU's ids, 8 K1 launches, frames per second; (d)
     ``trained_mnet64.npz`` on ``ap_eval_set.npz`` (AP >= recorded - 0.02,
     the CPU's within 1e-6) and the official WIDER protocol on 12
     composited frames whose .mat files it writes under _build/ and
     removes, images held in memory behind DetectionServer.detect_stream
     (the CPU's predictions, AP within 1e-3);
 24. the calibrated int8-activation RetinaFace (ops/quantize.py::
     quantize_retinaface, convs through torch._int_mm), each step held
     against the same module on the CPU, TF32 off: (a) the trained 640 mnet
     quantized on the card with the default calibration and on the CPU
     (amax within rtol 1e-4); on the CPU's calibration copied to the card,
     the first int8 layer's codes and int32 accumulators torch.equal to the
     CPU's, and every one of the 34 layers' on the same input; detect_batch
     on 3 batches of 8 (K1 3, K2 0, 102 int8 GEMMs), card vs CPU counts
     equal, boxes within 0.5 px, scores within 1e-3; int8 vs float on the
     fixture face IoU >= 0.5; (b) the seeded full-width R50 at 640 likewise
     (73 layers exact on the same input; 3 detect_batch calls of 8 with K2
     never launched, K1 3, 219 int8 GEMMs); (c) DetectionServer(batch_size=
     8) on 24 JPEG payloads, the loader that served printed (the native
     one, or why not), every result equal to detect_batch on the same
     canvases; (d) detect_batch b8 int8 against float for both backbones
     (CUDA events, 5 windows) and one torch.profiler call of each int8
     detector split into torch._int_mm, the quantize passes, the im2col
     passes and the rest;
 25. the serving runtime (runtime/server.py::serve with the Triton wire of
     runtime/wire.py beside the JSON facade, on a localhost port) over one
     registry on the card: phase 5's trained 640 mnet and seeded heads,
     phase 15's eKYC models with bf16 towers.  The counted run: (a) the
     reference's Triton flow, 3 x ModelConfig then ModelInfer on the
     detector (9 maps through detection_triton_view), both heads and a
     tower (24 K4), each np.array_equal to the module's forward on the
     card; (b) the facade: Extract and Detect x8 on JPEG frames (K1 +1
     each), DetectStream x24 (3 batches, K1 +3), EkycVerify x3 (K1 +2, K4
     +48 each), each equal to the direct call, and Detect and Extract from
     8 client threads at once on a dynamic-batching server (fewer batches
     than requests, K1 +1 per batch, within 1e-3 px and cosine 0.9999 of
     the direct batch); then (c) a system-shared-memory ModelInfer equal to
     the inline one and CUDA shared memory refused UNIMPLEMENTED; (d)
     TraceSetting around one Extract writes a Chrome trace naming K1's
     kernel; (e) round trips against the direct calls: ModelInfer b1 and
     b8 raw fp32 (host clock) against the forward alone (CUDA events),
     Extract, EkycVerify, and dynamic-batching Detect in img/s;
 26. the deployment surfaces: (a) the KServe-v2 REST endpoint
     (runtime/http.py, ``serve(http_port=0)``) over phase 25's registry: a
     JSON and a binary-extension infer on the detector and on the bf16
     tower (24 K4 each), each np.array_equal to the module's forward and to
     the wire's ModelInfer; health, metadata, statistics and the CUDA
     shared-memory refusal; a b8 REST infer timed against the forward; (b)
     ``python -m rs_face_detection_tpu_torch.runtime --port 0 --http-port 0
     --warmup --checkpoint-dir <dir>`` as a child process with phase 5's
     trained detector in the directory: both surfaces live and ready, one
     Extract over gRPC against phase 5's pipeline on the same JPEG (under
     the child's TF32 defaults), exit code 0 on SIGTERM; (c) AOT artifacts
     (runtime/aot.py, torch.export) of the trained 640 mnet and the seeded
     R50 (fused stem) at b8, loaded and torch.equal to detect_batch on phase
     5's canvases, and an mnet exported on the CPU and moved to the card
     (counts equal, boxes within 1e-3 px); (d) model artifacts of the bf16
     tower and the int8 face-ID head, each torch.equal to its eager forward;
     one counted call of each loaded program (K1 3, K2 1, K4 24, K3 1);
     artifact bytes against weight bytes, export and load seconds, loaded
     against eager detect b8 (CUDA events); then each kernel's custom op
     against its direct ctypes wrapper from Python, in turns (the kernels
     line's ``python_ms`` and ``wrapper_python_ms``);
then a JSON line of the kernels, with each one's bound on the card, its
time on the device as ``ms`` and from Python as ``python_ms`` (through
its custom op; ``wrapper_python_ms`` through the wrapper alone), and
{"ok": true, "device": ...} last.
Every count a phase checks is set to 0 just before its path runs.  The
main paths (phases 5, 9, 15, 18, each counted run of 22, (a)-(c) of 23,
(a)-(c) of 24, (a)+(b) of 25, (a) of 26 and the
loaded programs' calls of 26)
set all four kernels' counts to 0 and read all four after, and the kernels
line reports exactly those reads.

Frames are composited from tests/fixtures/real_face_crop.npz (the face of
tests/fixtures/real_face.jpg, box (172, 125, 372, 340), resized to 160x160)
on seeded gradient backgrounds, so no image decoder is needed.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
SEED = 0
BATCH = 8


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def make_frames(rng, n, face, h=480, w=640):
    """n (h, w, 3) uint8 BGR frames, 1-3 faces each in distinct quadrants."""
    import numpy as np

    frames = []
    for _ in range(n):
        img = gradient(rng, h, w)
        cells = [(0, 0), (w // 2, 0), (0, h // 2), (w // 2, h // 2)]
        for k in rng.permutation(4)[: int(rng.integers(1, 4))]:
            cx, cy = cells[k]
            s = int(rng.integers(90, h // 2 + 1))
            x = cx + int(rng.integers(0, w // 2 - s + 1))
            y = cy + int(rng.integers(0, h // 2 - s + 1))
            paste_face(img, face, x, y, s)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def gradient(rng, h, w):
    """An (h, w, 3) float BGR background: a seeded color, two seeded
    gradients and noise."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(40, 200, size=3).astype(np.float32)
    return (
        base
        + (yy / h)[..., None] * rng.uniform(-60, 60, size=3)
        + (xx / w)[..., None] * rng.uniform(-60, 60, size=3)
        + rng.normal(0, 6, size=(h, w, 3))
    )


def paste_face(img, face, x, y, s):
    """The fixture face resampled by index to s x s at (x, y), in place;
    returns its inclusive box."""
    import numpy as np

    rows = (np.arange(s) * face.shape[0]) // s
    cols = (np.arange(s) * face.shape[1]) // s
    img[y : y + s, x : x + s] = face[rows][:, cols]
    return (x, y, x + s - 1, y + s - 1)


def make_crops(rng, n, face, size=112):
    """n (size, size, 3) uint8 BGR aligned crops: a seeded window of the
    fixture face resampled by index, as make_frames places it, plus noise."""
    import numpy as np

    crops = []
    for _ in range(n):
        s = int(rng.integers(120, min(face.shape[:2]) + 1))
        y, x = int(rng.integers(0, face.shape[0] - s + 1)), int(rng.integers(0, face.shape[1] - s + 1))
        idx = (np.arange(size) * s) // size
        crop = face[y + idx][:, x + idx].astype(np.float32) + rng.normal(0, 4, size=(size, size, 3))
        crops.append(np.clip(crop, 0, 255).astype(np.uint8))
    return crops


def random_sorted_boxes(rng, b, k):
    """(b, k, 4) score-sorted boxes with duplicate corners (exact IoU ties)."""
    import numpy as np

    ctr = np.round(rng.uniform(0, 400, size=(b, k, 2)) / 25) * 25
    wh = np.round(rng.uniform(5, 150, size=(b, k, 2)) / 40) * 40 + 5
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


def cuda_ms(fn, iters, windows=5):
    """ms per call of `fn` by CUDA events: (median, min, max) over windows
    of `iters` back-to-back calls."""
    import statistics

    import torch

    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    return statistics.median(per_call), min(per_call), max(per_call)


def graph_ms(fn, reps=20, iters=10):
    """Device ms per call of `fn` with the host taken out: `reps` calls
    captured in one CUDA graph, replayed by cuda_ms; (median, min, max)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture (library handles, workspaces)
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return tuple(t / reps for t in cuda_ms(graph.replay, iters))


def fmt(t):
    return f"{t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f})"


#: Published peaks of one H100 SXM at 700 W: memory rate, f32 rate outside
#: the tensor cores, dense TF32 and bf16 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12


def card_bound(n_bytes, n_ops, ops_per_s):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


#: Variants of csrc/nms.cu built with its measurement switches: where K1's
#: device time goes (phase 6).  Never loaded by the port.
K1_VARIANTS = {"no_scan": ("-DRSFD_NMS_NO_SCAN",), "phase0": ("-DRSFD_NMS_NO_SCAN", "-DRSFD_NMS_NO_PHASE1")}


def build_variant(source, name, flags):
    """csrc/<source>.cu built with its measurement switches `flags` into
    _build/ beside the port's own library, loaded with ctypes."""
    import ctypes

    from rs_face_detection_tpu_torch.kernels import build

    lib = build.library_path(source)
    out = lib.with_name(f"{lib.stem}-{name}.so")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(out), str(build.CSRC_DIR / f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc failed on the {source} variant {name}: {proc.stderr[-2000:]}")
    return ctypes.CDLL(str(out))


def build_k1_variant(name):
    """(name, rsfd_nms_mask of csrc/nms.cu built with K1_VARIANTS[name])."""
    import ctypes

    fn = build_variant("nms", name, K1_VARIANTS[name]).rsfd_nms_mask
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    return name, fn


def build_k3_timeline():
    """rsfd_int8_matmul and rsfd_int8_matmul_timeline of csrc/int8_matmul.cu
    built with its measurement switch RSFD_K3_TIMELINE (phase 20).  Never
    loaded by the port."""
    import ctypes

    so = build_variant("int8_matmul", "timeline", ("-DRSFD_K3_TIMELINE",))
    so.rsfd_int8_matmul.restype = ctypes.c_int
    so.rsfd_int8_matmul.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    so.rsfd_int8_matmul_timeline.restype = ctypes.c_int
    so.rsfd_int8_matmul_timeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return so


#: The timeline variant's stamps (csrc/int8_matmul.cu, RSFD_K3_TIMELINE).
K3_MARKS = ("start", "x landed", "x split", "loop done", "cluster summed", "arrival counted", "output written")


def k3_timeline(so, x, q_copies, s, compute):
    """Per-CTA phase stamps of one cold call of the timeline variant (the
    last of 7, rotating over the copies of q): for each mark, the median and
    the max over the CTAs that stamped it, in us from the first CTA's
    start."""
    import numpy as np
    import torch

    from rs_face_detection_tpu_torch.kernels import int8_matmul as k3

    m, k = x.shape
    n = q_copies[0].shape[1]
    rows, chunks, cl = k3.launch_plan(m, k, n, *k3._card(x.device.index or 0))
    block_m = 1 if m == 1 else k3.BLOCK_M
    tiles = -(-n // k3.BLOCK_N) * -(-m // block_m)
    out = torch.empty((m, n), device=x.device)
    partial = torch.empty(max(1, (chunks // cl) * tiles * block_m * k3.BLOCK_N), device=x.device)
    for i in range(7):
        torch.cuda.synchronize()
        stream = torch.cuda.current_stream().cuda_stream
        check(so.rsfd_int8_matmul(x.data_ptr(), q_copies[i % len(q_copies)].data_ptr(), s.data_ptr(),
                                  out.data_ptr(), partial.data_ptr(), m, k, n, rows, chunks, cl, 0,
                                  int(compute == "bf16"), stream) == 0, "K3 timeline variant failed to launch")
    stamps = np.zeros((tiles * chunks, len(K3_MARKS)), np.uint64)
    check(so.rsfd_int8_matmul_timeline(stamps.ctypes.data, tiles * chunks) == 0, "K3 timeline copy failed")
    stamps = stamps.astype(np.int64)
    t0 = stamps[:, 0].min()
    result = {}
    for j, name in enumerate(K3_MARKS):
        fresh = stamps[:, j] >= t0  # the last marks come from the CTAs that reach them; others are stale
        col = (stamps[fresh, j] - t0) / 1000.0
        result[name] = (float(np.median(col)), float(col.max()))
    return result


def k1_phases_ms(variants, boxes, valid, thr):
    """K1's device time split by the variants: phase 0 with the launch (the
    variant with neither phase 1 nor the scan), phase 1 (the variant without
    the scan, less phase 0) and the scan (the kernel less that variant)."""
    import torch

    from rs_face_detection_tpu_torch.kernels import nms as knms

    keep = torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)

    def variant(fn):
        def call():
            stream = torch.cuda.current_stream().cuda_stream
            check(fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), *valid.shape, thr, stream) == 0,
                  "K1 variant failed to launch")
        return call

    full = graph_ms(lambda: knms.nms_mask_cuda(boxes, valid, thr))[0]
    no_scan = graph_ms(variant(variants["no_scan"]))[0]
    phase0 = graph_ms(variant(variants["phase0"]))[0]
    return {"kernel": full, "phase0": phase0, "phase1": no_scan - phase0, "scan": full - no_scan}


def kernel_counters():
    """Kernel name -> the wrapper module whose ``launches`` counts it."""
    from rs_face_detection_tpu_torch.kernels import attention, int8_matmul, nms, stem

    return {"nms_mask": nms, "fused_stem": stem, "flash_attention": attention, "int8_matmul": int8_matmul}


def zero_counts():
    for mod in kernel_counters().values():
        mod.launches = 0


def read_counts():
    return {name: mod.launches for name, mod in kernel_counters().items()}


def ekyc_pairs(rng, face, n):
    """n (card, selfie) pairs: the fixture face on a light document at
    400x640, and larger on a seeded 480x640 frame of make_frames."""
    import numpy as np

    pairs = []
    for _ in range(n):
        card = np.full((400, 640, 3), 0, np.uint8) + rng.integers(180, 230, size=3).astype(np.uint8)
        s = int(rng.integers(150, 260))
        y, x = int(rng.integers(20, 400 - s)), int(rng.integers(20, 300))
        paste_face(card, face, x, y, s)
        selfie = make_frames(rng, 1, face)[0]
        s = int(rng.integers(260, 420))
        y, x = int(rng.integers(0, 480 - s)), int(rng.integers(0, 640 - s))
        paste_face(selfie, face, x, y, s)
        pairs.append((card, selfie))
    return pairs


def ekyc_phases(dev, rng, face, card):
    """Phases 12-16 (K4 and the eKYC path); returns the K1 and K4 numbers
    for the kernels line.  TF32 is off throughout."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rs_face_detection_tpu_torch.kernels import attention as katt
    from rs_face_detection_tpu_torch.kernels import nms as knms
    from rs_face_detection_tpu_torch.models import weights
    from rs_face_detection_tpu_torch.models.registry import EKYC_FAMILIES
    from rs_face_detection_tpu_torch.models.vit import cast_for_serving
    from rs_face_detection_tpu_torch.ops.attention import attention_plain
    from rs_face_detection_tpu_torch.ops.image import letterbox, letterbox_u8_batch
    from rs_face_detection_tpu_torch.ops.nms import nms_mask_plain
    from rs_face_detection_tpu_torch.pipeline.detection import topk_candidates
    from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import (
        EKYCPipeline,
        EKYCResult,
        SCRFDDetection,
    )

    # 12. K4 vs plain.  Bounds: f32 2e-5 of max|v| (sums in another order);
    # bf16 1e-2 of max|v|, on the same bf16 inputs (P is rounded to bf16).
    k4_err, k4_lines = 0.0, []
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
        # (1, 257, 16, 64) is what each tower of a verify gives K4.
        # (1, 600, 2, 64): more keys than the 8 stages hold, so K/V stream;
        # (8, 600, 16, 64) streams them again in each of three rounds.
        for shape in ((8, 257, 16, 64), (1, 257, 16, 64), (2, 17, 2, 32), (1, 1, 16, 64), (3, 197, 12, 64),
                      (1, 600, 2, 64), (8, 600, 16, 64)):
            b, n, h, d = shape
            qkv = torch.from_numpy(rng.normal(size=(b, n, 3, h, d)).astype(np.float32)).to(dev, dtype)
            q, k, v = qkv.unbind(2)  # strided views of the packed tensor
            got = katt.flash_attention_cuda(q, k, v)
            want = attention_plain(q, k, v)
            torch.cuda.synchronize()
            check(got.shape == shape and got.dtype == dtype, f"K4 output {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got.float()).all()), f"K4 not finite at {shape} {dtype}")
            err = float((got.float() - want.float()).abs().max())
            limit = tol * float(v.float().abs().max())
            check(err <= limit, f"K4 != plain at {shape} {dtype}: {err} > {limit}")
            k4_err = max(k4_err, err)
            k4_lines.append(f"{str(dtype)[6:]} {shape} {err:.3g} (<= {limit:.3g})")
    print(f"phase 12 K4 vs plain (strided qkv views): {'; '.join(k4_lines)}")

    # 13. ViT parity, f32: the card (K4's f32 path) against the CPU.
    t0 = time.perf_counter()
    clip_sd = weights.init_state("clip_l14", SEED, 2)
    init_s = time.perf_counter() - t0
    vit_gpu = weights.load_model("clip_l14", clip_sd).to(dev)
    vit_cpu = weights.load_model("clip_l14", clip_sd)
    x = torch.from_numpy(rng.normal(size=(2, 3, 224, 224)).astype(np.float32))
    with torch.no_grad():
        katt.launches = 0
        probs_gpu = vit_gpu(x.to(dev))
        torch.cuda.synchronize()
        vit_launches = katt.launches
        probs_cpu = vit_cpu(x)
    check(vit_launches == 24, f"clip_l14 launched K4 {vit_launches} times, not 24")
    check(bool(torch.isfinite(probs_gpu).all()) and probs_gpu.shape == (2, 2), "ViT output not a finite (2, 2)")
    vit_err = float((probs_gpu.cpu() - probs_cpu).abs().max())
    check(vit_err <= 1e-4, f"ViT GPU vs CPU probabilities: {vit_err} > 1e-4")
    del vit_cpu, vit_gpu
    print(
        f"phase 13 ViT parity: clip_l14 (24 blocks, width 1024, 16 heads) at 224, batch 2, f32, TF32 off; "
        f"{vit_launches} K4 launches; probabilities max abs err {vit_err:.3g} (<= 1e-4); "
        f"seeded init {init_s:.1f} s on the host"
    )

    # 14. SCRFD parity at 640, batch 2.  Bound: maps within 1e-4 of their
    # magnitude (f32 sums in other orders through ~30 convolutions).
    scrfd_sd = weights.init_state("scrfd", SEED)
    det_gpu = SCRFDDetection(model=weights.load_model("scrfd", scrfd_sd), device=dev)
    det_cpu = SCRFDDetection(model=weights.load_model("scrfd", scrfd_sd), device="cpu")
    frames = make_frames(rng, 2, face, h=640, w=640)
    batch = torch.from_numpy(np.stack(frames))
    with torch.no_grad():
        maps_gpu = det_gpu.forward(batch.to(dev).float())
        maps_cpu = det_cpu.forward(batch.float())
    scrfd_rel = 0.0
    for stride, maps in maps_cpu.items():
        for key, ref in maps.items():
            got = maps_gpu[stride][key].cpu()
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()), f"bad SCRFD map {stride}/{key}")
            scrfd_rel = max(scrfd_rel, float((got - ref).abs().max()) / max(1.0, float(ref.abs().max())))
    check(scrfd_rel <= 1e-4, f"SCRFD GPU vs CPU maps: {scrfd_rel} of the magnitude > 1e-4")
    # K1 on SCRFD's own top-256 candidates, bit for bit: the two frames as a
    # batch, and one 480x640 frame through the single-image letterbox.
    iou = det_gpu.sel_cfg.iou_threshold
    single, _ = letterbox(torch.from_numpy(make_frames(rng, 1, face)[0]).to(dev), 640, 640)
    k1_err, k1_cases = 0.0, []
    with torch.no_grad():
        for imgs in (batch.to(dev).float(), single[None]):
            cand = topk_candidates(*det_gpu.decode(det_gpu.forward(imgs)), det_gpu.sel_cfg)
            got, want = knms.nms_mask_cuda(cand.boxes, cand.valid, iou), nms_mask_plain(cand.boxes, cand.valid, iou)
            torch.cuda.synchronize()
            k1_err = max(k1_err, float((got.int() - want.int()).abs().max()))
            check(torch.equal(got, want), f"K1 != plain on SCRFD's candidates {tuple(cand.valid.shape)}")
            k1_cases.append(f"{tuple(cand.valid.shape)} {int(cand.valid.sum())} valid, {int(got.sum())} kept")
    scrfd_cand = cand  # (1, 256): the single frame's candidates, timed in phase 16
    knms.launches = 0
    out = det_gpu.detect_batch(batch, torch.ones(2))
    singles = [det_gpu(f) for f in frames]
    check(knms.launches == 3, f"SCRFD launched K1 {knms.launches} times for 3 detect calls")
    batch_err, n_faces = 0.0, []
    for i, (sd, sk) in enumerate(singles):
        n = int(out.count[i])
        check(n == len(sd), f"SCRFD detect_batch found {n} faces, __call__ {len(sd)}")
        n_faces.append(n)
        if n:
            batch_err = max(
                batch_err,
                float(np.abs(out.det[i, :n].cpu().numpy() - sd).max()),
                float(np.abs(out.kps[i, :n].cpu().numpy() - sk).max()),
            )
    check(batch_err <= 1e-3, f"SCRFD detect_batch vs __call__: {batch_err} > 1e-3")
    print(
        f"phase 14 SCRFD parity: width 32, neck 32 at 640, batch 2; maps max err {scrfd_rel:.3g} of their "
        f"magnitude (<= 1e-4); K1 equal to plain (torch.equal) on SCRFD's top-256 candidates "
        f"{'; '.join(k1_cases)}; detect_batch vs __call__ faces {n_faces}, max abs err {batch_err:.3g} px"
    )

    # 15. The eKYC main path: bf16 towers, counted.
    sds = {name: scrfd_sd if fam == "scrfd" else clip_sd if fam == "clip_l14" else None
           for name, fam in EKYC_FAMILIES.items()}
    for name, fam in EKYC_FAMILIES.items():
        if sds[name] is None:
            sds[name] = weights.init_state(fam, SEED, 2)

    def models(tower_dtype):
        out = {name: weights.load_model(EKYC_FAMILIES[name], sd) for name, sd in sds.items()}
        if tower_dtype == torch.bfloat16:
            for name, fam in EKYC_FAMILIES.items():
                if fam == "clip_l14":
                    cast_for_serving(out[name])
        return out

    pipe = EKYCPipeline(models=models(torch.bfloat16), device="cuda")
    pairs = ekyc_pairs(rng, face, 3)
    pipe.verify_images(*pairs[0])  # warm-up, before the counted run
    torch.cuda.synchronize()
    zero_counts()
    results = [pipe.verify_images(c, s) for c, s in pairs]
    torch.cuda.synchronize()
    counts = read_counts()
    ekyc_nms, ekyc_att = counts["nms_mask"], counts["flash_attention"]
    check(ekyc_nms == 2 * len(pairs), f"K1 launched {ekyc_nms} times for {len(pairs)} verifies")
    check(ekyc_att == 48 * len(pairs), f"K4 launched {ekyc_att} times for {len(pairs)} verifies")
    check(counts["fused_stem"] == 0, f"K2 launched {counts['fused_stem']} times on the eKYC path")
    for r in results:
        check(isinstance(r, EKYCResult) and r.card_face_found and r.selfie_face_found, "a face was not found")
        check(np.isfinite(r.similarity) and -1.0001 <= r.similarity <= 1.0001, f"similarity {r.similarity}")
        check(r.same_person == (r.similarity >= 0.4) and r.same_ekyc == (r.similarity >= 0.3), "thresholds")
        check(all(isinstance(getattr(r, f), bool) for f in (
            "selfie_mask", "selfie_covered", "selfie_live_crop", "selfie_live_full")), "head booleans")
        check(0.0 <= r.selfie_quality <= 1.0, f"selfie quality {r.selfie_quality}")
        check(r.card_face_box.shape == (5,) and r.selfie_face_box.shape == (5,), "face boxes not (5,)")
    f32_gpu = EKYCPipeline(models=models(torch.float32), device="cuda")
    t_cpu = time.perf_counter()
    f32_cpu = EKYCPipeline(models=models(torch.float32), device="cpu")
    g, c = f32_gpu.verify_images(*pairs[0]), f32_cpu.verify_images(*pairs[0])
    cpu_s = time.perf_counter() - t_cpu
    for field in ("card_face_found", "selfie_face_found", "same_person", "same_ekyc", "selfie_mask",
                  "selfie_covered", "selfie_live_crop", "selfie_live_full"):
        check(getattr(g, field) == getattr(c, field), f"eKYC GPU vs CPU: {field} differs")
    ekyc_box = max(float(np.abs(g.card_face_box - c.card_face_box).max()),
                   float(np.abs(g.selfie_face_box - c.selfie_face_box).max()))
    ekyc_sim = abs(g.similarity - c.similarity)
    check(ekyc_box <= 1e-2, f"eKYC GPU vs CPU box: {ekyc_box} > 1e-2 px")
    check(ekyc_sim <= 1e-4, f"eKYC GPU vs CPU similarity: {ekyc_sim} > 1e-4")
    print(
        f"phase 15 eKYC main path: 3 x verify_images (card and selfie 640 wide), full-width seeded "
        f"SCRFD, IResNet-50, 2 ResNet-18 heads and 2 bf16 clip_l14 towers; K4 launches {ekyc_att} "
        f"(48 per verify), K1 launches {ekyc_nms} (2 per verify), K2 launches {counts['fused_stem']}; similarities "
        f"{[round(r.similarity, 4) for r in results]}; pair 1 with f32 towers vs the CPU pipeline "
        f"({cpu_s:.1f} s on the CPU): box max err {ekyc_box:.3g} px, similarity err {ekyc_sim:.3g}"
    )
    del f32_cpu, f32_gpu

    # 16. eKYC timings (CUDA events and the host clock, after warm-ups).
    verify_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        for c_img, s_img in pairs:
            pipe.verify_images(c_img, s_img)
        verify_s.append((time.perf_counter() - t0) * 1e3 / len(pairs))
    verify_s.sort()
    tower = pipe.heads["fas_crop"][0]
    x8 = torch.from_numpy(rng.normal(size=(8, 3, 224, 224)).astype(np.float32)).to(dev)
    with torch.no_grad():
        for _ in range(2):
            tower(x8)
        tower_ms = cuda_ms(lambda: tower(x8), 5)
    canv, _ = letterbox_u8_batch(make_frames(rng, BATCH, face), 640, 640, dev)
    det_scales = torch.ones(BATCH)
    for _ in range(2):
        det_gpu.detect_batch(canv, det_scales)
    scrfd_ms = cuda_ms(lambda: det_gpu.detect_batch(canv, det_scales), 10)
    qkv = torch.from_numpy(rng.normal(size=(8, 257, 3, 16, 64)).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, D) views of the same tensors
    for _ in range(5):
        katt.flash_attention_cuda(q, k, v)
        F.scaled_dot_product_attention(qt, kt, vt)
    # On the device (20 calls replayed from a CUDA graph) and from Python,
    # where the wrapper's host time adds in: K4, SDPA, K4, SDPA.
    k4_dev = graph_ms(lambda: katt.flash_attention_cuda(q, k, v))
    sdpa_dev = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    k4_ms = cuda_ms(lambda: katt.flash_attention_cuda(q, k, v), 200)
    k4_plain_ms = cuda_ms(lambda: attention_plain(q, k, v), 20)
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 200)
    k4_ms2 = cuda_ms(lambda: katt.flash_attention_cuda(q, k, v), 200)
    k4_dev2 = graph_ms(lambda: katt.flash_attention_cuda(q, k, v))
    sdpa_dev2 = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    # The verify's shape, on the device.
    qs, ks, vs = (t[:1] for t in (q, k, v))
    qst, kst, vst = (t.transpose(1, 2) for t in (qs, ks, vs))
    k4_dev_b1 = graph_ms(lambda: katt.flash_attention_cuda(qs, ks, vs))
    sdpa_dev_b1 = graph_ms(lambda: F.scaled_dot_product_attention(qst, kst, vst))
    # K1 at SCRFD's (1, 256): its own candidates, and 256 valid random boxes.
    k1_rand = torch.from_numpy(random_sorted_boxes(np.random.default_rng(SEED + 16), 1, 256)).to(dev)
    k1_all = torch.ones((1, 256), dtype=torch.bool, device=dev)
    k1_b1 = {
        "scrfd": graph_ms(lambda: knms.nms_mask_cuda(scrfd_cand.boxes, scrfd_cand.valid, iou)),
        "all_valid": graph_ms(lambda: knms.nms_mask_cuda(k1_rand, k1_all, iou)),
    }
    sdpa_err = float((F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2).float()
                      - katt.flash_attention_cuda(q, k, v).float()).abs().max())
    print(
        f"phase 16 eKYC verify per pair (host clock, 3 pairs x 5): median {verify_s[2]:.2f} ms "
        f"(min {verify_s[0]:.2f}, max {verify_s[-1]:.2f}) {card}"
    )
    print(f"phase 16 clip_l14 tower b8 bf16: {fmt(tower_ms)}/batch, {8 * 1000 / tower_ms[0]:.1f} img/s {card}")
    print(f"phase 16 SCRFD detect_batch b8 at 640: {fmt(scrfd_ms)}/batch, {BATCH * 1000 / scrfd_ms[0]:.1f} img/s {card}")
    b, n, h, d = q.shape
    k4_bound = card_bound(4 * b * n * h * d * 2, 4 * b * h * n * n * d, BF16_OPS_PER_S)
    print(
        f"phase 16 attention (8, 257, 16, 64) bf16 per call (bound {k4_bound[0] * 1e3:.2f} us by "
        f"{k4_bound[1]}): on the device (graph replay) K4 {fmt(k4_dev)}, scaled_dot_product_attention "
        f"{fmt(sdpa_dev)}, K4 again {fmt(k4_dev2)}, SDPA again {fmt(sdpa_dev2)}; from Python K4 {fmt(k4_ms)}, "
        f"plain {fmt(k4_plain_ms)}, SDPA {fmt(sdpa_ms)}, K4 again {fmt(k4_ms2)}; K4 vs SDPA max abs err "
        f"{sdpa_err:.3g} {card}"
    )
    print(
        f"phase 16 attention (1, 257, 16, 64) bf16 per call on the device: K4 {fmt(k4_dev_b1)}, "
        f"scaled_dot_product_attention {fmt(sdpa_dev_b1)} {card}"
    )
    print(
        f"phase 16 NMS (B=1, K=256) per call on the device (graph replay): K1 on SCRFD's candidates "
        f"({int(scrfd_cand.valid.sum())} valid) {fmt(k1_b1['scrfd'])}, on 256 valid random boxes "
        f"{fmt(k1_b1['all_valid'])} {card}"
    )
    return {
        "counts": counts,
        "nms_err": k1_err,
        "k1_b1": k1_b1,
        "sds": sds,
        "pairs": pairs,
        "k4": {
            "name": "flash_attention",
            "route": "cuda",
            "source": "rs_face_detection_tpu_torch/csrc/attention.cu",
            "replaces": "rs_face_detection_tpu/models/vit.py:35",
            "max_abs_err": k4_err,
            "ms": k4_dev[0],
            "python_ms": k4_ms[0],
            "plain_ms": k4_plain_ms[0],
            "bound_ms": k4_bound[0],
            "bound_by": k4_bound[1],
            "library_ms": sdpa_dev[0],
            "library_python_ms": sdpa_ms[0],
        },
    }


def int8_phases(dev, rng, face, card, e_sd, q_sd, fas_pairs, k3_timeline_so=None):
    """Phases 17-20 (K3 and the staged per-face modules); returns the counts
    of the int8 main path and K3's entry of the kernels line.  TF32 is off
    throughout.  ``k3_timeline_so``: build_k3_timeline's library, for where
    K3's time goes (phase 20)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rs_face_detection_tpu_torch.kernels import int8_matmul as k3
    from rs_face_detection_tpu_torch.models import weights
    from rs_face_detection_tpu_torch.models.quantized import quantize_module
    from rs_face_detection_tpu_torch.ops.quantize import int8_matmul_plain, quantize_array, quantized_bytes
    from rs_face_detection_tpu_torch.pipeline.antispoofing import FaceAntiSpoofing
    from rs_face_detection_tpu_torch.pipeline.extraction import FaceExtraction
    from rs_face_detection_tpu_torch.pipeline.quality import FaceQuality
    from rs_face_detection_tpu_torch.pipeline.quality_assessment import FaceQualityAssessment

    # 17. K3 vs plain.  Bound: 1e-5 of sum_k |x_k w_kn| per output (both
    # arithmetics round x and w alike; only the f32 summation order differs).
    # Shapes: the fc's, every row tile (M = 1, 2, 8, 9, 17, 33), ragged K
    # tails (17, 4095), ragged column tiles (N = 1, 15, 130: byte loads),
    # all-positive operands at the fc's shape (the truncating adds' worst
    # case), a q one byte past a 16-byte boundary, and M = 0.  Every call is
    # made twice and must give the same bits.
    k3_err, k3_lines = 0.0, []
    cases = [((8, 25088, 512), ""), ((1, 25088, 512), ""), ((3, 1000, 96), ""), ((5, 4095, 130), ""),
             ((2, 25088, 512), ""), ((9, 4095, 512), ""), ((17, 1000, 96), ""), ((33, 25088, 512), ""),
             ((5, 17, 96), ""), ((3, 1000, 1), ""), ((3, 1000, 15), ""), ((8, 25088, 512), "positive"),
             ((5, 1000, 96), "misaligned q"), ((0, 25088, 512), "")]
    for compute in ("f32", "bf16"):
        for (m, k, n), kind in cases:
            if kind == "positive":
                x = torch.from_numpy(rng.uniform(0, 1, size=(m, k)).astype(np.float32)).to(dev)
                q_np, s_np = quantize_array(rng.uniform(0, 0.05, size=(k, n)).astype(np.float32))
            else:
                x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
                q_np, s_np = quantize_array(rng.normal(0, 0.05, size=(k, n)).astype(np.float32))
            q, s = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
            if kind == "misaligned q":
                q = torch.empty(q.numel() + 1, dtype=torch.int8, device=dev)[1:].view(k, n).copy_(q)
                check(q.is_contiguous() and q.data_ptr() % 16 == 1, "the misaligned q is not one byte off")
            before = k3.launches
            got = k3.int8_matmul_cuda(x, q, s, compute)
            again = k3.int8_matmul_cuda(x, q, s, compute)
            want = int8_matmul_plain(x, q, s, compute)
            torch.cuda.synchronize()
            check(got.shape == (m, n) and got.dtype == torch.float32, f"K3 output {tuple(got.shape)} {got.dtype}")
            check(k3.launches == before + 2 * (m > 0), f"K3 launched {k3.launches - before} times at M = {m}")
            if m == 0:
                k3_lines.append(f"{compute} {(m, k, n)} empty, no launch")
                continue
            check(torch.equal(got, again), f"K3 repeat differs at {(m, k, n)} {compute}")
            check(bool(torch.isfinite(got).all()), f"K3 not finite at {(m, k, n)} {compute}")
            if compute == "f32":
                xa, wa = x.abs(), (q.float() * s).abs()
            else:
                xa, wa = x.bfloat16().float().abs(), (q.bfloat16() * s.bfloat16()).float().abs()
            bound = 1e-5 * (xa @ wa)
            err = (got - want).abs()
            check(bool((err <= bound).all()), f"K3 != plain at {(m, k, n)} {kind} {compute}: {float(err.max())}")
            k3_err = max(k3_err, float(err.max()))
            label = f"{compute} {(m, k, n)}{' ' + kind if kind else ''}"
            k3_lines.append(f"{label} {float(err.max()):.3g} ({float((err / bound).max()):.2g} of the bound)")
    # A call captured in a CUDA graph gives the eager call's bits.
    x = torch.from_numpy(rng.normal(size=(8, 25088)).astype(np.float32)).to(dev)
    q_np, s_np = quantize_array(rng.normal(0, 0.05, size=(25088, 512)).astype(np.float32))
    q, s = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
    for compute in ("f32", "bf16"):
        eager = k3.int8_matmul_cuda(x, q, s, compute)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k3.int8_matmul_cuda(x, q, s, compute)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = k3.int8_matmul_cuda(x, q, s, compute)
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(captured, eager), f"K3 captured in a CUDA graph differs from the eager call ({compute})")
    k3_plan = k3.launch_plan(8, 25088, 512, *k3._card(torch.cuda.current_device()))
    k3_lines.append(
        f"graph replay equals eager in f32 and bf16; plan at (8, 25088, 512): {k3_plan[0]} rows x {k3_plan[1]} "
        f"chunks in clusters of {k3_plan[2]}, {k3.smem_bytes(8, k3_plan[0], 'f32')} B of dynamic shared memory")
    int8_model = quantize_module(weights.load_model("iresnet50", e_sd))
    q_leaves = [key for key in int8_model.state_dict() if key.endswith(".weight_q")]
    fc_q = int8_model.fc.weight_q
    check(len(q_leaves) == 53 and tuple(fc_q.shape) == (25088, 512) and fc_q.dtype == torch.int8,
          f"quantized IResNet-50: {len(q_leaves)} int8 leaves, fc q {tuple(fc_q.shape)}")
    print(
        f"phase 17 K3 vs plain (max abs err, <= 1e-5 of sum |x w|): {'; '.join(k3_lines)}; "
        f"IResNet-50 quantizer: {len(q_leaves)} int8 leaves, fc q {tuple(fc_q.shape)} int8"
    )

    # 18. The int8 FaceExtraction main path, counted.
    crops = make_crops(rng, 3 * BATCH + 1, face)
    fe8 = FaceExtraction(device="cuda", quantized=True)
    check(torch.equal(fe8.model.fc.weight_q.cpu(), fc_q), "FaceExtraction's seeded fc is not the quantizer's")
    fe8(crops[:BATCH])  # warm-up, before the counted run
    torch.cuda.synchronize()
    zero_counts()
    embs = [fe8(crops[i * BATCH : (i + 1) * BATCH]) for i in range(3)] + [fe8(crops[3 * BATCH :])]
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["int8_matmul"] == 4, f"K3 launched {counts['int8_matmul']} times for 4 calls")
    check(counts["nms_mask"] == counts["fused_stem"] == counts["flash_attention"] == 0,
          f"the int8 path launched another kernel: {counts}")
    for e, size in zip(embs, (BATCH, BATCH, BATCH, 1)):
        check(e.shape == (size, 512) and np.isfinite(e).all(), f"int8 embeddings {e.shape}")
        check(bool(np.all(np.abs(np.linalg.norm(e, axis=1) - 1.0) <= 1e-4)), "int8 embedding norm not 1")
    t_cpu = time.perf_counter()
    ref = FaceExtraction(model=weights.load_model("iresnet50", e_sd), device="cpu", quantized=True)(crops[:BATCH])
    cpu_s = time.perf_counter() - t_cpu
    int8_err = float(np.abs(embs[0] - ref).max())
    check(int8_err <= 1e-4, f"int8 FaceExtraction GPU vs CPU: {int8_err} > 1e-4")
    fe32 = FaceExtraction(model=weights.load_model("iresnet50", e_sd), device="cuda")
    cos = np.sum(fe32(crops[:BATCH]) * embs[0], axis=1)
    check(bool((cos > 0.99).all()), f"int8 vs float cosine {cos.min()} <= 0.99")
    print(
        f"phase 18 int8 main path: FaceExtraction(quantized=True) on the seeded IResNet-50, 3 x 8 crops + 1; "
        f"launches {counts}; call 1 vs the CPU int8 FaceExtraction ({cpu_s:.1f} s on the CPU): max abs err "
        f"{int8_err:.3g} (<= 1e-4); int8 vs float on the card: min cosine {cos.min():.6f} (> 0.99)"
    )

    # 19. The other staged modules, card vs CPU.  Bounds: probabilities and
    # live scores within 1e-4; assessment scores within 1e-4 of their
    # magnitude; classes and flags equal unless a score is within 1e-3 of
    # its threshold.
    fqa_sd = weights.init_state("resnet18_classifier", SEED, 1)
    stages = {}
    for dev_name in ("cuda", "cpu"):
        stages[dev_name] = (
            FaceQuality(model=weights.load_model("resnet18_classifier", q_sd), device=dev_name),
            FaceQualityAssessment(model=weights.load_model("resnet18_classifier", fqa_sd, softmax=False),
                                  device=dev_name),
            FaceAntiSpoofing(device=dev_name),
        )
    fas_imgs = [img for img, _ in fas_pairs]
    fas_boxes = [box for _, box in fas_pairs]
    outs = {}
    for dev_name, (fq, fqa, fas) in stages.items():
        outs[dev_name] = (fq.probabilities(crops[:BATCH]), fq(crops[:BATCH]), fqa(crops[:BATCH]),
                          fas(fas_imgs, fas_boxes))
    (gp, (_, gc), (gs, gf), (gl, gls)), (cp, (_, cc), (cs, cf), (cl, cls)) = outs["cuda"], outs["cpu"]
    fq_err = float(np.abs(gp - cp).max())
    fqa_err = float(np.abs(np.asarray(gs) - np.asarray(cs)).max()) / max(1.0, float(np.abs(cs).max()))
    fas_err = float(np.abs(gls - cls).max())
    check(fq_err <= 1e-4 and gc == cc, f"FaceQuality GPU vs CPU: {fq_err}, classes {gc} vs {cc}")
    thr_fqa = stages["cpu"][1].cfg.threshold
    check(fqa_err <= 1e-4 and all(a == b or abs(s - thr_fqa) < 1e-3 for a, b, s in zip(gf, cf, cs)),
          f"FaceQualityAssessment GPU vs CPU: {fqa_err}")
    thr_fas = stages["cpu"][2].cfg.threshold
    check(fas_err <= 1e-4 and all(a == b or abs(s - thr_fas) < 1e-3 for a, b, s in zip(gl, cl, cls)),
          f"FaceAntiSpoofing GPU vs CPU: {fas_err}")
    check(all(np.isfinite(v).all() for v in (gp, np.asarray(gs), gls)), "a staged module gave a non-finite value")
    print(
        f"phase 19 staged modules, card vs CPU: FaceQuality probabilities {fq_err:.3g}, classes {gc}; "
        f"FaceQualityAssessment scores {fqa_err:.3g} of their magnitude, flags {gf}; FaceAntiSpoofing on "
        f"{len(fas_pairs)} selected faces live scores {fas_err:.3g}, liveness {gl.tolist()}"
    )

    # 20. Timings (TF32 off), at the fc's own int8 weight.
    q, s = fe8.model.fc.weight_q, fe8.model.fc.weight_scale
    x8 = torch.from_numpy(rng.normal(size=(BATCH, q.shape[0])).astype(np.float32)).to(dev)
    x1 = x8[:1].contiguous()
    w32 = (q.float() * s).t().contiguous()  # the float fc's (512, 25088) weight
    for x in (x8, x1):
        for compute in ("f32", "bf16"):
            for _ in range(5):
                k3.int8_matmul_cuda(x, q, s, compute)
    # K3 and the float fc both ways: back to back from Python (what a caller
    # pays; on a slow host the wrapper's own time sets the pace) and as 20
    # calls replayed from one CUDA graph (the device's time).
    # Cold L2: 24 calls replayed from one graph rotating over 6 copies of the
    # fc's q (77 MB, more than the 50 MB L2), as the real path finds q after
    # the int8 convolutions' dequantization has evicted it.
    q_copies = [q.clone() for _ in range(6)]
    k3_ms, k3_dev, k3_cold = {}, {}, {}
    for m, x in ((8, x8), (1, x1)):
        for c in ("f32", "bf16"):
            k3_ms[m, c] = cuda_ms(lambda x=x, c=c: k3.int8_matmul_cuda(x, q, s, c), 200)
            k3_dev[m, c] = graph_ms(lambda x=x, c=c: k3.int8_matmul_cuda(x, q, s, c))
            turn = iter(range(10**9))
            k3_cold[m, c] = graph_ms(lambda x=x, c=c: k3.int8_matmul_cuda(x, q_copies[next(turn) % 6], s, c), reps=24)
    timeline = {}
    if k3_timeline_so is not None:
        for m, x in ((8, x8), (1, x1)):
            timeline[m] = k3_timeline(k3_timeline_so, x, q_copies, s, "f32")
            stamps = "; ".join(f"{name} {med:.2f}/{mx:.2f}" for name, (med, mx) in timeline[m].items())
            print(f"phase 20 K3 ({m}, 25088, 512) f32 where the time goes (the RSFD_K3_TIMELINE variant, one cold "
                  f"call, us from the first CTA's start, median/max over the CTAs): {stamps} {card}")
    del q_copies
    plain_ms = {c: cuda_ms(lambda c=c: int8_matmul_plain(x8, q, s, c), 50) for c in ("f32", "bf16")}
    linear_ms = cuda_ms(lambda: F.linear(x8, w32), 200)
    linear_dev = graph_ms(lambda: F.linear(x8, w32))
    k3_again = graph_ms(lambda: k3.int8_matmul_cuda(x8, q, s, "f32"))
    try:
        qt, sb, xb = q.t().contiguous(), s.bfloat16(), x8.bfloat16()
        lib_out = torch._weight_int8pack_mm(xb, qt, sb)
        lib_err = float((lib_out.float() - int8_matmul_plain(x8, q, s, "bf16")).abs().max())
        lib_ms = cuda_ms(lambda: torch._weight_int8pack_mm(xb, qt, sb), 200)
        lib_dev = graph_ms(lambda: torch._weight_int8pack_mm(xb, qt, sb))
        lib_line = (f"torch._weight_int8pack_mm bf16 on the device {fmt(lib_dev)}, from Python {fmt(lib_ms)} "
                    f"(vs plain bf16 max abs err {lib_err:.3g})")
    except Exception as exc:  # no CUDA kernel in this torch: no library yardstick
        lib_ms, lib_dev, lib_line = None, None, f"torch._weight_int8pack_mm: {type(exc).__name__}"
    m, k, n = x8.shape[0], q.shape[0], q.shape[1]
    k3_bound = card_bound(m * k * 4 + k * n + n * 4 + m * n * 4, 2 * m * k * n, F32_OPS_PER_S)
    k3_b1_bound = card_bound(k * 4 + k * n + n * 4 + n * 4, 2 * k * n, F32_OPS_PER_S)
    print(
        f"phase 20 K3 (8, 25088, 512) per call (bound {k3_bound[0] * 1e3:.2f} us by {k3_bound[1]}): on the "
        f"device (graph replay) warm L2 f32 {fmt(k3_dev[8, 'f32'])}, bf16 {fmt(k3_dev[8, 'bf16'])}, f32 again "
        f"{fmt(k3_again)}; cold L2 f32 {fmt(k3_cold[8, 'f32'])} ({k3_cold[8, 'f32'][0] / k3_bound[0]:.2f}x the "
        f"bound), bf16 {fmt(k3_cold[8, 'bf16'])}; from Python f32 {fmt(k3_ms[8, 'f32'])}, bf16 "
        f"{fmt(k3_ms[8, 'bf16'])}; plain f32 {fmt(plain_ms['f32'])}, bf16 {fmt(plain_ms['bf16'])}; {lib_line} {card}"
    )
    print(
        f"phase 20 K3 (1, 25088, 512) per call (bound {k3_b1_bound[0] * 1e3:.2f} us by {k3_b1_bound[1]}): on the "
        f"device warm L2 f32 {fmt(k3_dev[1, 'f32'])}, bf16 {fmt(k3_dev[1, 'bf16'])}; cold L2 f32 "
        f"{fmt(k3_cold[1, 'f32'])}, bf16 {fmt(k3_cold[1, 'bf16'])}; from Python f32 {fmt(k3_ms[1, 'f32'])}, bf16 "
        f"{fmt(k3_ms[1, 'bf16'])} {card}"
    )
    print(
        f"phase 20 float fc F.linear (8, 25088) x (512, 25088) f32 (4x K3's weight bytes): on the device "
        f"{fmt(linear_dev)}; from Python {fmt(linear_ms)} {card}"
    )
    for label, fe in (("float", fe32), ("int8", fe8)):
        for b in (BATCH, 1):
            batch = crops[:b]
            fe(batch)
            t = cuda_ms(lambda: fe(batch), 10)
            print(f"phase 20 FaceExtraction {label} b{b}: {fmt(t)}/call, {b * 1000 / t[0]:.1f} img/s {card}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fe(crops[:BATCH])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(
            f"phase 20 FaceExtraction {label}: weights {quantized_bytes(fe.model)} bytes resident; one b8 call "
            f"peaks {peak} bytes allocated, {peak - base} above the bytes held before it"
        )
    fq, fqa, fas = stages["cuda"]
    fas_ms = cuda_ms(lambda: fas(fas_imgs, fas_boxes), 5)
    fq_ms = cuda_ms(lambda: fq(crops[:BATCH]), 10)
    fqa_ms = cuda_ms(lambda: fqa(crops[:BATCH]), 10)
    print(f"phase 20 FaceAntiSpoofing b{len(fas_pairs)} (4 MiniFASNets): {fmt(fas_ms)}/call {card}")
    print(f"phase 20 FaceQuality b8: {fmt(fq_ms)}/call; FaceQualityAssessment b8: {fmt(fqa_ms)}/call {card}")
    return {
        "counts": counts,
        "k3": {
            "name": "int8_matmul",
            "route": "cuda",
            "source": "rs_face_detection_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "rs_face_detection_tpu/ops/quantize.py:210",
            "max_abs_err": k3_err,
            "ms": k3_dev[8, "f32"][0],
            "cold_ms": k3_cold[8, "f32"][0],
            "b1_cold_ms": k3_cold[1, "f32"][0],
            "bf16_cold_ms": k3_cold[8, "bf16"][0],
            "python_ms": k3_ms[8, "f32"][0],
            "plain_ms": plain_ms["f32"][0],
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
            "cold_over_bound": k3_cold[8, "f32"][0] / k3_bound[0],
            "library_ms": None if lib_ms is None else lib_ms[0],
            "library_dev_ms": None if lib_dev is None else lib_dev[0],
            "timeline_us": {f"b{m}": t for m, t in timeline.items()},
        },
    }


#: The widths of insightface's SCRFD-10G-KPS (configs/scrfd/scrfd_10g_bnkps.py)
#: as the importer expresses them: the deep stem 28/28/56, BasicBlock stages
#: (3, 4, 2, 3) of planes (56, 88, 88, 224), the PAFPN from stage 1 at 56
#: channels, a 3-conv BatchNorm head of 80 channels, 2 anchors, keypoints.
#: The importer (the JAX package's, which the port mirrors) takes one head
#: tower shared by the strides, with separate cls and reg stacks, and conv
#: shortcuts; the 10G config shares cls with reg, keeps one tower per stride
#: and average-pools its shortcuts (ResNetV1e), which it cannot express.
SCRFD_10G = dict(
    deep_stem=True, stem_channels=(28, 28, 56), block="basic", stage_blocks=(3, 4, 2, 3),
    stage_planes=(56, 88, 88, 224), neck_in_start=1, neck_out=56, num_levels=3, stacked_convs=3,
    head_channels=80, num_anchors=2, use_kps=True, head_norm="bn", gn_groups=32,
)


def checkpoint_phase(dev, rng, face, card, p5):
    """Phase 22: checkpoint serving at full width, in a temporary
    RSFD_CHECKPOINT_DIR under _build/ with fresh registries.  ``p5``: phase
    5's config, detector weights, pipeline, requests and its first request's
    results.  Returns
    the launch counts of its counted runs and its seconds."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from rs_face_detection_tpu_torch.configs import FaceAntiSpoofingConfig
    from rs_face_detection_tpu_torch.kernels import build
    from rs_face_detection_tpu_torch.models import checkpoint_io, weights
    from rs_face_detection_tpu_torch.models.checkpoint_maps import load_retinaface_state_dict
    from rs_face_detection_tpu_torch.models.registry import standard_registry
    from rs_face_detection_tpu_torch.models.scrfd_import import SCRFDImportSpec, init_scrfd_imported
    from rs_face_detection_tpu_torch.ops.image import letterbox_u8_batch
    from rs_face_detection_tpu_torch.ops.matching import Gallery, search
    from rs_face_detection_tpu_torch.pipeline.antispoofing import FaceAntiSpoofing
    from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
    from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import EKYCPipeline
    from rs_face_detection_tpu_torch.pipeline.extraction import FaceExtraction
    from rs_face_detection_tpu_torch.pipeline.face_pipeline import FacePipeline
    from rs_face_detection_tpu_torch.pipeline.quality import FaceQuality
    from rs_face_detection_tpu_torch.pipeline.quality_assessment import FaceQualityAssessment

    t_phase = time.perf_counter()
    cfg, pipe5 = p5["cfg"], p5["pipe"]
    env = checkpoint_io.CHECKPOINT_DIR_ENV
    saved_env = os.environ.get(env)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="checkpoints-", dir=build.BUILD_DIR)
    totals = dict.fromkeys(kernel_counters(), 0)
    files = {}  # name -> [bytes, import s, save s, load s]

    def counted(fn):
        torch.cuda.synchronize()
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        for k, v in counts.items():
            totals[k] += v
        return out, counts

    def save(directory, name, model, meta, import_s, links=(), label=None):
        path = os.path.join(directory, f"{name}.npz")
        t0 = time.perf_counter()
        checkpoint_io.save_imported(path, model, meta)
        files[label or name] = [os.path.getsize(path), import_s, time.perf_counter() - t0, None]
        for other in links:  # one file serves both names
            os.symlink(path, os.path.join(directory, f"{other}.npz"))

    def load(registry, names):
        for name in names:
            t0 = time.perf_counter()
            registry.load(name)
            torch.cuda.synchronize()
            files[name][3] = time.perf_counter() - t0

    def canvases(frames):
        width, height = cfg.detection.image_size
        imgs, scales = letterbox_u8_batch(frames, width, height, dev)
        return imgs, torch.from_numpy(np.asarray(scales, np.float32))

    def same_result(a, b):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                if not (x is not None and y is not None and np.array_equal(x, y)):
                    return False
            elif x != y:
                return False
        return True

    def stats(registry, name):
        st = registry.statistics(name)
        return st.inference_count, st.execution_count, st.batch_size_counts

    try:
        os.environ[env] = root
        # (a) The trained detector through the registry.
        t0 = time.perf_counter()
        det_model = weights.load_model("retinaface_mobilenet025", p5["det_sd"])
        det_meta = {"family": "retinaface", "backbone": "mobilenet025", "stem_s2d": False, "image_size": [640, 640]}
        save(root, cfg.detection.model_name, det_model, det_meta, time.perf_counter() - t0)
        check(os.listdir(root) == [f"{cfg.detection.model_name}.npz"], f"phase 22: {os.listdir(root)}")
        reg_a = standard_registry(device=dev)
        load(reg_a, [cfg.detection.model_name])
        det = RetinaFaceDetection(cfg.detection, device=dev, registry=reg_a)
        check(det.model is reg_a.get(cfg.detection.model_name), "phase 22: the detector is not the registry's")
        for k, v in det.model.state_dict().items():
            check(torch.equal(v.cpu(), p5["det_sd"][k].to(v.dtype)), f"phase 22: served detector {k} != the fixture's")
        batches = [canvases(req) for req in p5["requests"]]
        served, k1a = counted(lambda: [det.detect_batch(c, s) for c, s in batches])
        check(k1a["nms_mask"] == len(batches), f"phase 22: K1 launched {k1a['nms_mask']} for {len(batches)} detects")
        for (c, s), got in zip(batches, served):
            want = pipe5.face_detection.detect_batch(c, s)
            check(all(torch.equal(g, w) for g, w in zip(got, want)), "phase 22: served detector != phase 5's")
        seeded = FacePipeline(cfg, device=dev, registry=reg_a)
        for mine, theirs in ((seeded.quality_model, pipe5.quality_model), (seeded.embedding_model, pipe5.embedding_model)):
            check(all(torch.equal(a, b) for a, b in zip(mine.state_dict().values(), theirs.state_dict().values())),
                  "phase 22: a seeded builder's head != phase 5's")
        seeded_out, _ = counted(lambda: seeded.extract_batch(p5["requests"][0]))
        heads5 = {cfg.quality.model_name: pipe5.quality_model, cfg.identification.model_name: pipe5.embedding_model}
        mixed = FacePipeline(cfg, models=heads5, device=dev, registry=reg_a)
        mixed_out, _ = counted(lambda: mixed.extract_batch(p5["requests"][0]))
        check(all(same_result(g, w) for g, w in zip(mixed_out, p5["results0"])), "phase 22: (a) != phase 5's results")
        check(all(same_result(g, w) for g, w in zip(seeded_out, p5["results0"])), "phase 22: seeded heads != phase 5")
        k = sum(r.facial_feature is not None for r in seeded_out)
        det_stats = stats(reg_a, cfg.detection.model_name)
        check(det_stats == (2 * BATCH, 2, {BATCH: 2}), f"phase 22: detector statistics {det_stats}")
        for name in (cfg.quality.model_name, cfg.identification.model_name):
            check(stats(reg_a, name) == ((k, 1, {k: 1}) if k else (0, 0, {})), f"phase 22: {name} {stats(reg_a, name)}")
        fixture_emb = next(r.facial_feature for r in mixed_out if r.facial_feature is not None)
        print(
            f"phase 22 (a) trained detector served from {cfg.detection.model_name}.npz "
            f"({files[cfg.detection.model_name][0]} bytes, f32): detect_batch on phase 5's 3 x 8 canvases "
            f"torch.equal to phase 5's detector ({k1a['nms_mask']} K1 launches); FacePipeline(registry=...) "
            f"extract_batch b8 with the seeded builders' heads (equal to phase 5's) and with phase 5's heads "
            f"through models=: equal to phase 5's results ({k} faces embedded); statistics {det_stats}"
        )

        # (b) Every public layout at full width, imported, saved and served.
        fas_cfg = FaceAntiSpoofingConfig()
        spec_10g = SCRFDImportSpec(**SCRFD_10G)

        def public(name):
            """(seeded state_dict in the public key layout, kind, import keywords, linked names)."""
            np_sd = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
            if name == "face_identification":
                return np_sd(weights.init_state("iresnet50", 11)), "iresnet", {}, ("face_id",)
            classifiers = {"face_quality": (12, 4), "face_attribute": (13, 2), "face_quality_vp": (14, 2),
                           "face_quality_assetment": (15, 1)}
            if name in classifiers:
                seed, n = classifiers[name]
                return np_sd(weights.init_state("resnet18_classifier", seed, n)), "resnet18", \
                    {"softmax": n != 1}, ()
            if name in fas_cfg.model_names:
                i = fas_cfg.model_names.index(name)
                size = fas_cfg.image_sizes[i][0]
                return np_sd(weights.init_state("minifasnet", 16 + i, 3, image_size=size)), "minifas", {}, ()
            if name == "face_anti_spoofing_crop_l14":
                sd = weights.init_state("clip_l14", 20, 2)
                return ({(k if k.startswith("head.") else f"visual.{k}"): v.numpy() for k, v in sd.items()},
                        "clip_visual", {}, ("face_anti_spoofing_fi_l14",))
            if name == "scrfd":
                return np_sd(init_scrfd_imported(spec_10g, seed=21).state_dict()), "scrfd", {}, ()
            raise AssertionError(name)

        names = ["face_identification", "face_quality", "face_attribute", "face_quality_vp",
                 "face_quality_assetment", *fas_cfg.model_names, "face_anti_spoofing_crop_l14", "scrfd"]
        kinds, sds = {}, {}
        for name in names:
            sd, kind, kw, links = public(name)
            sds[name] = sd
            kinds[name] = checkpoint_io.detect_kind(sd)
            check(kinds[name] == kind, f"phase 22: detect_kind named {kinds[name]} for {name}'s {kind}")
            t0 = time.perf_counter()
            model, meta = checkpoint_io.import_state_dict(sd, kind="auto", **kw)
            save(root, name, model, meta, time.perf_counter() - t0, links)
            for other in links:
                files[other] = [name, None, None, None]
            del model
        reg_b = standard_registry(device=dev)
        served_names = [cfg.detection.model_name, *names, "face_id", "face_anti_spoofing_fi_l14"]
        load(reg_b, served_names)
        for name, sd in sds.items():  # the served weights are the public tensors
            for key, v in reg_b.get(name).state_dict().items():
                if key.endswith("num_batches_tracked"):
                    continue
                ref = sd[key if key in sd else f"visual.{key}"]
                check(torch.equal(v.cpu(), torch.from_numpy(np.asarray(ref)).to(v.dtype)), f"phase 22: {name} {key}")
        del sds, sd
        check(type(reg_b.get("scrfd")).__name__ == "SCRFDImportedNet", "phase 22: scrfd is not the mmdet network")
        check(reg_b.get("face_anti_spoofing_fi_l14").conv1.weight.dtype == torch.bfloat16, "phase 22: tower not bf16")

        pairs = ekyc_pairs(rng, face, 3)
        ekyc_names = ("scrfd", "face_id", "face_attribute", "face_quality_vp", "face_anti_spoofing_crop_l14",
                      "face_anti_spoofing_fi_l14")
        direct = EKYCPipeline(models={n: reg_b.get(n) for n in ekyc_names}, device=dev)
        direct.verify_images(*pairs[0])  # warm-up, outside the counted run and the statistics
        want = [direct.verify_images(c, s) for c, s in pairs]
        ekyc = EKYCPipeline(device=dev, registry=reg_b)
        got, ekyc_counts = counted(lambda: [ekyc.verify_images(c, s) for c, s in pairs])
        check(all(same_result(g, w) for g, w in zip(got, want)), "phase 22: EKYCPipeline(registry=...) != direct")
        check(ekyc_counts["flash_attention"] == 48 * len(pairs) and ekyc_counts["nms_mask"] == 2 * len(pairs)
              and ekyc_counts["fused_stem"] == ekyc_counts["int8_matmul"] == 0, f"phase 22: eKYC {ekyc_counts}")
        check(stats(reg_b, "scrfd") == (2 * len(pairs), 2 * len(pairs), {1: 2 * len(pairs)}),
              f"phase 22: scrfd statistics {stats(reg_b, 'scrfd')}")
        crops = make_crops(rng, BATCH, face)
        fas_imgs, fas_boxes = [img for img, _ in p5["fas_pairs"]], [box for _, box in p5["fas_pairs"]]
        staged = [
            (FaceQuality(device=dev, registry=reg_b), FaceQuality(model=reg_b.get("face_quality"), device=dev),
             lambda m: m.probabilities(crops)),
            (FaceQualityAssessment(device=dev, registry=reg_b),
             FaceQualityAssessment(model=reg_b.get("face_quality_assetment"), device=dev), lambda m: m(crops)),
            (FaceAntiSpoofing(device=dev, registry=reg_b),
             FaceAntiSpoofing(models=[reg_b.get(n) for n in fas_cfg.model_names], device=dev),
             lambda m: m(fas_imgs, fas_boxes)),
        ]
        for mine, theirs, call in staged:
            a, b = call(mine), call(theirs)
            check(all(np.array_equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else np.array_equal(a, b),
                  f"phase 22: {type(mine).__name__}(registry=...) != direct")
        check(stats(reg_b, "face_quality") == (BATCH, 1, {BATCH: 1}), f"phase 22: {stats(reg_b, 'face_quality')}")
        full = FacePipeline(cfg, device=dev, registry=reg_b)
        full_out, full_counts = counted(lambda: full.extract_batch(p5["requests"][0]))
        check(all(r.facial_feature is None or np.isfinite(r.facial_feature).all() for r in full_out),
              "phase 22: FacePipeline on the imported heads gave a non-finite embedding")
        print(
            f"phase 22 (b) {len(names)} public state_dicts at full width (seeded tensors), detect_kind "
            f"{sorted(set(kinds.values()))}, imported, saved and served by a fresh registry: EKYCPipeline(registry="
            f"...) 3 x verify_images torch.equal to the pipeline built from the same modules; launches {ekyc_counts}; "
            f"scrfd statistics {stats(reg_b, 'scrfd')}; FaceQuality, FaceQualityAssessment and FaceAntiSpoofing "
            f"equal to direct; FacePipeline on the served detector and heads, launches {full_counts}; SCRFD at the "
            f"SCRFD-10G-KPS widths {SCRFD_10G['stem_channels']}/{SCRFD_10G['stage_planes']}/neck "
            f"{SCRFD_10G['neck_out']}/head {SCRFD_10G['head_channels']}, one tower shared by the strides with "
            f"separate cls and reg stacks and conv shortcuts (the importer's form; the 10G config shares cls with "
            f"reg per stride and average-pools its shortcuts)"
        )
        for name, (size, import_s, save_s, load_s) in files.items():
            if isinstance(size, str):  # a symlink to another name's file
                print(f"phase 22 file {name}.npz: a link to {size}.npz; registry load {load_s:.3f} s {card}")
            else:
                print(f"phase 22 file {name}.npz: {size} bytes; import {import_s:.3f} s, save {save_s:.3f} s, "
                      f"registry load {load_s:.3f} s {card}")

        # (c) The R50 and int8 paths.
        r50_dir = tempfile.mkdtemp(prefix="r50-", dir=root)
        r50_sd = {k: v.numpy() for k, v in weights.init_state("retinaface_resnet50", 22).items()}
        r50_sd["body.conv1.weight"] = (rng.standard_normal((64, 3, 7, 7)) / np.sqrt(147)).astype(np.float32)
        check(checkpoint_io.detect_kind(r50_sd) == "retinaface_resnet50", "phase 22: R50 kind")
        t0 = time.perf_counter()
        r50_model, r50_meta = checkpoint_io.import_state_dict(r50_sd)
        save(r50_dir, cfg.detection.model_name, r50_model, r50_meta, time.perf_counter() - t0, label="r50")
        r50_cfg = dataclasses.replace(cfg.detection, backbone="resnet50")
        os.environ[env] = r50_dir
        reg_c = standard_registry(device=dev, detection=r50_cfg)
        r50_det = RetinaFaceDetection(r50_cfg, device=dev, registry=reg_c)
        os.environ[env] = root
        ref_det = RetinaFaceDetection(
            r50_cfg, weights.load_model("retinaface_resnet50", load_retinaface_state_dict(r50_sd, "resnet50")),
            device=dev,
        )
        c, s = batches[1]
        r50_out, r50_counts = counted(lambda: r50_det.detect_batch(c, s))
        check(r50_counts["fused_stem"] == 1 and r50_counts["nms_mask"] == 1, f"phase 22: R50 {r50_counts}")
        check(all(torch.equal(g, w) for g, w in zip(r50_out, ref_det.detect_batch(c, s))),
              "phase 22: the served R50 != load_retinaface_state_dict's")
        fe = FaceExtraction(device=dev, quantized=True, registry=reg_b)
        emb, fe_counts = counted(lambda: fe(crops))
        check(fe_counts["int8_matmul"] == 1, f"phase 22: int8 FaceExtraction {fe_counts}")
        check(np.array_equal(emb, FaceExtraction(model=reg_b.get("face_identification"), device=dev, quantized=True)(crops)),
              "phase 22: int8 FaceExtraction(registry=...) != direct")
        k_full = sum(r.facial_feature is not None for r in full_out)
        check(stats(reg_b, "face_identification")[0] == k_full + BATCH, "phase 22: face_identification statistics")
        print(
            f"phase 22 (c) biubug6-layout R50 (7x7 stem) imported ({files['r50'][0]} bytes) "
            f"and served at 640: detect_batch b8 torch.equal to load_retinaface_state_dict's module, launches "
            f"{r50_counts}; FaceExtraction(quantized=True, registry=...) b8 on the served IResNet-50, launches "
            f"{fe_counts}, equal to the direct int8 module"
        )

        # (d) Gallery on the card against the CPU (TF32 off).
        n_rows = 100_000
        rows = rng.standard_normal((n_rows, 512)).astype(np.float32)
        galleries = (Gallery(512, device=dev), Gallery(512, device="cpu"))
        t0 = time.perf_counter()
        for g in galleries:
            for i in range(n_rows):
                g.enroll(i, rows[i])
            g.enroll("fixture", fixture_emb)
        enroll_s = (time.perf_counter() - t0) / 2
        picks = rng.choice(n_rows, BATCH - 1, replace=False)
        probes = np.concatenate([fixture_emb[None], rows[picks] + 0.3 * rng.standard_normal((BATCH - 1, 512))])
        probes = probes.astype(np.float32)
        got, want = galleries[0].identify(probes, -1.0, 5), galleries[1].identify(probes, -1.0, 5)
        check(got[0][0][0] == "fixture" and want[0][0][0] == "fixture", "phase 22: the fixture face did not find itself")
        unit = probes / np.linalg.norm(probes, axis=1, keepdims=True)
        matrix = np.concatenate([rows / np.linalg.norm(rows, axis=1, keepdims=True), fixture_emb[None] / np.linalg.norm(fixture_emb)])
        swaps, gal_err = 0, 0.0
        for q, (g, w) in enumerate(zip(got, want)):
            for (gl, gs), (wl, ws) in zip(g, w):
                gal_err = max(gal_err, abs(gs - ws))
                if gl != wl:  # a swap of candidates whose scores lie within 1e-5
                    swaps += 1
                    cpu_score = float(matrix[n_rows if gl == "fixture" else gl] @ unit[q])
                    check(abs(cpu_score - ws) <= 1e-5, f"phase 22: Gallery label {gl} vs {wl} at probe {q}")
        check(gal_err <= 1e-5, f"phase 22: Gallery scores card vs CPU {gal_err} > 1e-5")
        galleries[0].identify(probes, -1.0, 5)
        t0 = time.perf_counter()
        for _ in range(20):
            galleries[0].identify(probes, -1.0, 5)
        identify_ms = (time.perf_counter() - t0) / 20 * 1e3
        probes_dev = torch.from_numpy(unit).to(dev)
        search_ms = cuda_ms(lambda: search(probes_dev, galleries[0]._matrix, 5), 10)
        search_bound = card_bound((n_rows + 1) * 512 * 4 + probes.nbytes, 2 * BATCH * 512 * (n_rows + 1), F32_OPS_PER_S)
        print(
            f"phase 22 (d) Gallery of {n_rows} seeded rows + the fixture face ({(n_rows + 1) * 512 * 4} bytes f32 on "
            f"the card), identify b8 at k = 5, TF32 off: labels equal to the CPU's ({swaps} swaps of candidates "
            f"within 1e-5), scores max abs err {gal_err:.3g} (<= 1e-5), the fixture face first at "
            f"{got[0][0][1]:.6f}; enroll {enroll_s:.2f} s; identify {identify_ms:.3f} ms/call (host clock, 20 calls); "
            f"search on the device {fmt(search_ms)} (bound {search_bound[0]:.4f} ms by {search_bound[1]}) {card}"
        )
    finally:
        if saved_env is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = saved_env
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 22 checkpoint serving: {seconds:.1f} s in all; launches {totals} {card}")
    return {"counts": totals, "seconds": seconds}



def place_faces(rng, face, h, w, n_faces, sizes):
    """An (h, w, 3) uint8 frame with n_faces copies of the fixture face of
    sides in ``sizes``, one per column of the frame, and their (n, 4)
    inclusive boxes."""
    import numpy as np

    img = gradient(rng, h, w)
    cell = w // n_faces
    boxes = []
    for i in range(n_faces):
        s = int(rng.integers(sizes[0], min(sizes[1], cell, h) + 1))
        x = i * cell + int(rng.integers(0, cell - s + 1))
        boxes.append(paste_face(img, face, x, int(rng.integers(0, h - s + 1)), s))
    return np.clip(img, 0, 255).astype(np.uint8), np.asarray(boxes, np.float32)


def same_detections(got, want, what):
    """Counts equal, boxes and landmarks within 1e-2 px, scores within 1e-4;
    returns the largest box or landmark error."""
    import numpy as np

    (gd, gk), (wd, wk) = got, want
    check(gd.shape == wd.shape, f"{what}: {len(gd)} detections on the card, {len(wd)} on the CPU")
    if not len(wd):
        return 0.0
    box = float(max(np.abs(gd[:, :4] - wd[:, :4]).max(), np.abs(gk - wk).max()))
    score = float(np.abs(gd[:, 4] - wd[:, 4]).max())
    check(box <= 1e-2 and score <= 1e-4, f"{what}: card vs CPU box {box} px, score {score}")
    return box


#: Phase 23 (c): the clip's length, its gap (frames without the face) and the
#: face's side and speed in px per frame.
CLIP_FRAMES, CLIP_GAP, CLIP_FACE, CLIP_STEP = 64, (30, 31, 32), 160, 4


def offline_phase(dev, rng, face, card, det_sd):
    """Phase 23: detection beyond the fixed 640 serving call, each run on the
    card and by the same objects built on the CPU (plain NMS), TF32 off: (a)
    MultiScaleDetection over DEFAULT_BUCKETS, (b) two-size flip TTA, (c) a
    64-frame VideoPipeline over DetectionServer(batch_size=8), (d) AP on the
    fixture eval set and the official WIDER protocol on a set the phase
    writes under _build/.  Returns the launch counts of (a)-(c)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from scipy.io import savemat

    from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
    from rs_face_detection_tpu_torch.kernels import build
    from rs_face_detection_tpu_torch.models import weights
    from rs_face_detection_tpu_torch.models.registry import DETECTION_OUTPUT_SPEC, ModelRegistry, ModelSpec
    from rs_face_detection_tpu_torch.ops.eval import evaluate_detector
    from rs_face_detection_tpu_torch.ops.image import letterbox_u8_batch
    from rs_face_detection_tpu_torch.ops.wider_split import evaluate_wider_official, find_split_mats
    from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
    from rs_face_detection_tpu_torch.pipeline.multiscale import DEFAULT_BUCKETS, MultiScaleDetection
    from rs_face_detection_tpu_torch.pipeline.tracking import IouTracker, VideoPipeline, iou_matrix_np
    from rs_face_detection_tpu_torch.pipeline.tta import TTADetection, flip_detections
    from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer
    from rs_face_detection_tpu_torch.utils.fixtures import load_ap_eval_set, load_trained_detector

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    both = (dev, cpu)

    def box_iou(a, b):
        return float(iou_matrix_np(np.asarray(a, np.float32)[None, :4], np.asarray(b, np.float32)[None, :4])[0, 0])

    family = "retinaface_mobilenet025"
    cfg = FaceDetectionConfig()
    counts = {}

    def served_registry(device):
        reg = ModelRegistry(device)
        reg.register(ModelSpec(cfg.model_name, (640, 640, 3), DETECTION_OUTPUT_SPEC), weights.load_model(family, det_sd))
        return reg

    def stats(reg):
        st = reg.statistics(cfg.model_name)
        return st.inference_count, st.execution_count, dict(st.batch_size_counts)

    # (a) MultiScaleDetection: one frame per bucket.
    regs = {d: served_registry(d) for d in both}
    multi = {d: MultiScaleDetection(DEFAULT_BUCKETS, cfg, registry=regs[d], device=d) for d in both}
    check(len({id(det.model) for det in multi[dev].detectors.values()}) == 1, "phase 23 (a): the buckets hold two modules")
    frames = {
        (h, w): place_faces(rng, face, h, w, 3, (90, h // 2))[0] for h, w in ((480, 640), (720, 1280), (1080, 1920))
    }
    for frame in frames.values():  # warm-up
        multi[dev](frame)
    torch.cuda.synchronize()
    stats0 = stats(regs[dev])
    zero_counts()
    got = {hw: multi[dev](frame) for hw, frame in frames.items()}
    torch.cuda.synchronize()
    counts["multiscale"] = read_counts()
    stats1 = stats(regs[dev])
    check(counts["multiscale"] == {"nms_mask": 3, "fused_stem": 0, "flash_attention": 0, "int8_matmul": 0},
          f"phase 23 (a): launches {counts['multiscale']} for 3 calls")
    check(stats1[0] - stats0[0] == 3 and stats1[2].get(1, 0) - stats0[2].get(1, 0) == 3,
          f"phase 23 (a): statistics {stats0} -> {stats1} for one call per bucket")
    routed = [multi[dev].pick_bucket(h, w) for h, w in frames]
    check(routed == list(DEFAULT_BUCKETS), f"phase 23 (a): routed to {routed}")
    errs = [same_detections(got[hw], multi[cpu](frame), f"phase 23 (a) {hw[1]}x{hw[0]}") for hw, frame in frames.items()]
    found = sum(len(d) for d, _ in got.values())
    check(found >= len(frames), f"phase 23 (a): {found} faces in {len(frames)} frames")
    bucket_ms = {hw: cuda_ms(lambda: multi[dev](frame), 5) for hw, frame in frames.items()}
    print(
        f"phase 23 (a) MultiScaleDetection {list(DEFAULT_BUCKETS)} on the trained 640 detector: 640x480, 1280x720, "
        f"1920x1080 routed to {routed}; {found} faces; card vs CPU max box err {max(errs):.3g} px; K1 launches "
        f"{counts['multiscale']['nms_mask']} for 3 calls; statistics {stats0} -> {stats1}; ms per call: "
        + "; ".join(f"{w}x{h} {fmt(t)}" for (h, w), t in bucket_ms.items()) + f" {card}"
    )

    # (b) TTA over the 640 and 1280 square detectors, with flip, merge "nms".
    def tta_on(d):
        base = RetinaFaceDetection(cfg, weights.load_model(family, det_sd), d)
        big = RetinaFaceDetection(dataclasses.replace(cfg, image_size=(1280, 1280)), base.model, d)
        return TTADetection([base, big], flip=True, merge="nms")

    tta = {d: tta_on(d) for d in both}
    frame = frames[(720, 1280)]
    mirror = np.ascontiguousarray(frame[:, ::-1])
    tta[dev](frame)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    out = tta[dev](frame)
    out_mirror = tta[dev](mirror)
    torch.cuda.synchronize()
    counts["tta"] = read_counts()
    check(counts["tta"]["nms_mask"] == 8 and sum(counts["tta"].values()) == 8,
          f"phase 23 (b): launches {counts['tta']} for 2 images of 4 views")
    tta_err = max(same_detections(out, tta[cpu](frame), "phase 23 (b) TTA"),
                  same_detections(out_mirror, tta[cpu](mirror), "phase 23 (b) TTA, mirrored"))
    check(len(out[0]) >= 1, "phase 23 (b): TTA found no face")
    # Mirror invariance.  The mirror's views are the frame's views in another
    # order, so their rows agree as a set.  The merged boxes agree within 1 px
    # except where two views score a face exactly alike (saturated at 1.0):
    # the merge keeps the first in view order, and the two runs see the
    # views in mirrored order.
    width = frame.shape[1]
    rows = lambda d: d[np.lexsort(d.T[::-1])]  # noqa: E731
    views = tta[dev].views(frame)[0]
    views_m = flip_detections(*tta[dev].views(mirror), width)[0]
    check(views.shape == views_m.shape, f"phase 23 (b): {len(views)} view rows, {len(views_m)} mirrored")
    views_err = float(np.abs(rows(views) - rows(views_m)).max()) if len(views) else 0.0
    check(views_err <= 1e-3, f"phase 23 (b): the mirror's view rows differ by {views_err} px")
    unflipped = flip_detections(*out_mirror, width)[0]
    check(unflipped.shape == out[0].shape, f"phase 23 (b): {len(unflipped)} faces mirrored, {len(out[0])} not")
    within, ties = 0, 0
    for a in out[0]:
        b = max(unflipped, key=lambda r: box_iou(a, r))
        if float(np.abs(a - b).max()) <= 1.0:
            within += 1
            continue
        tied = a[4] == b[4] and all(float(np.abs(views - r).max(axis=1).min()) <= 1e-3 for r in (a, b))
        check(tied, f"phase 23 (b): merged box {a} has no mirror counterpart within 1 px nor a tie ({b})")
        ties += 1
    single = tta[dev].detectors[0](frame)[0]
    check(len(single) >= 1, "phase 23 (b): single-scale found no face")
    iou = min(max(box_iou(a, b) for b in out[0]) for a in single)
    check(iou >= 0.5, f"phase 23 (b): a single-scale box has IoU {iou} < 0.5 with every TTA box")
    tta_ms = cuda_ms(lambda: tta[dev](frame), 3)
    print(
        f"phase 23 (b) TTADetection 640+1280 with flip, merge nms, on the 1280x720 frame and its mirror: "
        f"{len(out[0])} faces; card vs CPU max box err {tta_err:.3g} px; mirror invariance: the {len(views)} view rows "
        f"equal within {views_err:.3g} px, merged boxes {within} within 1 px and {ties} exact score ties between "
        f"views (each a row of both runs' views); every single-scale box kept at IoU >= {iou:.3f}; K1 launches {counts['tta']['nms_mask']} for 2 images; "
        f"ms per image {fmt(tta_ms)} {card}"
    )

    # (c) VideoPipeline over DetectionServer(batch_size=8): one face moving
    # CLIP_STEP px a frame, gone for the frames of CLIP_GAP.
    background = gradient(rng, 480, 640)
    clip, truth = [], []
    for i in range(CLIP_FRAMES):
        img = background.copy()
        if i not in CLIP_GAP:
            truth.append(paste_face(img, face, 40 + CLIP_STEP * i, 120, CLIP_FACE))
        else:
            truth.append(None)
        clip.append(np.clip(img, 0, 255).astype(np.uint8))

    video_dets = {d: RetinaFaceDetection(cfg, weights.load_model(family, det_sd), d) for d in both}

    def run_clip(d):
        with DetectionServer(video_dets[d], batch_size=BATCH) as server:
            return list(VideoPipeline(server, IouTracker()).run(iter(clip)))

    run_clip(dev)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    tracks = run_clip(dev)
    torch.cuda.synchronize()
    counts["video"] = read_counts()
    check(counts["video"]["nms_mask"] == CLIP_FRAMES // BATCH and sum(counts["video"].values()) == CLIP_FRAMES // BATCH,
          f"phase 23 (c): launches {counts['video']} for {CLIP_FRAMES // BATCH} batches")
    check([i for i, _ in tracks] == list(range(CLIP_FRAMES)), "phase 23 (c): frames out of order")
    face_ids = set()
    for (i, active), box in zip(tracks, truth):
        on_face = [t.track_id for t in active if box is not None and box_iou(t.box, box) >= 0.5]
        if box is not None and i > 0:
            check(len(on_face) == 1, f"phase 23 (c): frame {i}: {len(on_face)} tracks on the face")
        face_ids.update(on_face)
    check(face_ids == {0}, f"phase 23 (c): the face's track ids {face_ids}")
    video_err = 0.0
    for (i, mine), (_, ref) in zip(tracks, run_clip(cpu)):
        check([t.track_id for t in mine] == [t.track_id for t in ref], f"phase 23 (c): frame {i}: ids differ")
        for a, b in zip(mine, ref):
            video_err = max(video_err, float(np.abs(a.box - b.box).max()))
    check(video_err <= 1e-2, f"phase 23 (c): card vs CPU track boxes {video_err} px")
    clip_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_clip(dev)
        clip_s.append(time.perf_counter() - t0)
    fps = sorted(CLIP_FRAMES / s for s in clip_s)
    # Where a streamed batch's time goes: the stream without the tracker,
    # staging a batch (upload and uint8 letterbox, as the server's producer
    # thread does it) and detect_batch on staged canvases, each alone.
    with DetectionServer(video_dets[dev], batch_size=BATCH) as server:
        stream_ms = cuda_ms(lambda: [None for _ in server.detect_stream(iter(clip))], 1)
    chunk = clip[:BATCH]
    stage_ms = cuda_ms(lambda: letterbox_u8_batch(chunk, 640, 640, dev), 5)
    canvases, scales = letterbox_u8_batch(chunk, 640, 640, dev)
    scales = torch.tensor(scales, device=dev)
    detect_ms = cuda_ms(lambda: video_dets[dev].detect_batch(canvases, scales), 10)
    print(
        f"phase 23 (c) VideoPipeline over DetectionServer(batch_size={BATCH}), {CLIP_FRAMES} frames of 640x480, the "
        f"face moving {CLIP_STEP} px a frame and gone in frames {CLIP_GAP}: one track id {sorted(face_ids)} on the face "
        f"throughout, re-matched after the gap; card vs CPU: the same ids, track boxes within {video_err:.3g} px; K1 "
        f"launches {counts['video']['nms_mask']}; frames per second (host clock, a new server and tracker per run, "
        f"5 runs): median {fps[2]:.1f} (min {fps[0]:.1f}, max {fps[4]:.1f}); the stream alone "
        f"{fmt(stream_ms)} per clip ({CLIP_FRAMES * 1000 / stream_ms[0]:.1f} frames/s); per batch of {BATCH}: staging "
        f"(upload and uint8 letterbox) {fmt(stage_ms)}, detect_batch {fmt(detect_ms)} {card}"
    )

    # (d) Accuracy: the fixture detector's AP on the fixture eval set, then
    # the official protocol on a WIDER-format set of composited frames.
    dataset, recorded = load_ap_eval_set(os.path.join(FIXTURES, "ap_eval_set.npz"))
    ckpt64 = os.path.join(FIXTURES, "trained_mnet64.npz")
    ap = {d: evaluate_detector(load_trained_detector(ckpt64, device=d), dataset) for d in both}
    check(ap[dev]["ap"] >= recorded["ap"] - 0.02, f"phase 23 (d): AP {ap[dev]} < recorded {recorded['ap']} - 0.02")
    check(abs(ap[dev]["ap"] - ap[cpu]["ap"]) <= 1e-6 and ap[dev]["num_gt"] == ap[cpu]["num_gt"],
          f"phase 23 (d): AP card {ap[dev]} vs CPU {ap[cpu]}")
    event, names, images, boxes = "0--Smoke", [], {}, []
    for i in range(12):
        img, b = place_faces(rng, face, 480, 640, 1 + i % 3, (60, 240))
        names.append(f"frame_{i:02d}")
        images[f"{event}/{names[-1]}"] = img
        boxes.append(np.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0] + 1, b[:, 3] - b[:, 1] + 1], 1).astype(float))

    def cell(entries):
        out = np.empty((len(entries), 1), dtype=object)
        for i, e in enumerate(entries):
            out[i, 0] = e
        return out

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="wider-", dir=build.BUILD_DIR)
    try:
        gt_mat = os.path.join(root, "wider_face_val.mat")
        savemat(gt_mat, {"event_list": cell([event]), "file_list": cell([cell(names)]),
                         "face_bbx_list": cell([cell(boxes)])})
        for split, min_side in (("easy", 160), ("medium", 100), ("hard", 0)):
            keep = [np.array([j + 1.0 for j, b in enumerate(bb) if b[3] >= min_side], float).reshape(-1, 1)
                    for bb in boxes]
            savemat(os.path.join(root, f"wider_{split}_val.mat"),
                    {"event_list": cell([event]), "file_list": cell([cell(names)]), "gt_list": cell([cell(keep)])})
        images_root = os.path.join(root, "images")
        by_path = {os.path.join(images_root, f"{k}.jpg"): img for k, img in images.items()}
        eval_cfg = dataclasses.replace(cfg, confidence_threshold=0.02, max_candidates=256)
        wider, preds = {}, {}
        for d in both:
            det = RetinaFaceDetection(eval_cfg, weights.load_model(family, det_sd), d)
            preds[d] = []
            with DetectionServer(det, batch_size=BATCH) as server:
                def detect_many(paths, server=server, out=preds[d]):
                    for batch in server.detect_stream(by_path[p] for p in paths):
                        out.extend(batch)
                        yield from batch

                if d == dev:
                    zero_counts()
                wider[d] = evaluate_wider_official(detect_many, images_root, gt_mat, find_split_mats(root))
                if d == dev:
                    torch.cuda.synchronize()
                    wider_counts = read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not os.path.exists(root), "phase 23 (d): the WIDER set was not removed")
    check(wider_counts["nms_mask"] == 2, f"phase 23 (d): launches {wider_counts} for 12 images at batch {BATCH}")
    check(len(preds[dev]) == len(preds[cpu]) == len(images), "phase 23 (d): images missing from the sweep")
    wider_err = max(same_detections(g, c, "phase 23 (d)") for g, c in zip(preds[dev], preds[cpu]))
    ap_diff = 0.0
    for split in ("easy", "medium", "hard"):
        g, c = wider[dev][split], wider[cpu][split]
        ap_diff = max(ap_diff, abs(g["ap"] - c["ap"]))
        check(abs(g["ap"] - c["ap"]) <= 1e-3 and g["num_kept_faces"] == c["num_kept_faces"],
              f"phase 23 (d): {split} card {g} vs CPU {c}")
        # A floor for the sanity of the sweep only: the fixture detector was
        # trained on other backgrounds, and the check that counts is the CPU's.
        check(g["ap"] >= 0.5 and g["num_kept_faces"] > 0, f"phase 23 (d): {split} {g}")
    print(
        f"phase 23 (d) accuracy: trained_mnet64 on ap_eval_set AP {ap[dev]['ap']:.4f} (recorded "
        f"{recorded['ap']:.4f}, gate >= recorded - 0.02), card - CPU {ap[dev]['ap'] - ap[cpu]['ap']:.3g}; official "
        f"WIDER protocol on 12 composited 640x480 frames written under _build/ and removed, the trained 640 "
        f"detector at 0.02 with 256 candidates through DetectionServer.detect_stream ({wider_counts['nms_mask']} K1 "
        f"launches): "
        + ", ".join(f"{s} {wider[dev][s]['ap']:.6f} ({wider[dev][s]['num_kept_faces']:.0f} faces)" for s in wider[dev])
        + f"; card vs CPU: predictions within {wider_err:.3g} px, AP within {ap_diff:.3g} (bound 1e-3) {card}"
    )
    seconds = time.perf_counter() - t_phase
    print(f"phase 23 offline evaluation and video: {seconds:.1f} s in all {card}")
    return counts


def detections_of(out, n):
    """(det, kps) numpy rows per image of a PaddedDetections."""
    det, kps, cnt = (t.cpu().numpy() for t in (out.det, out.kps, out.count))
    return [(det[i, : cnt[i]], kps[i, : cnt[i]]) for i in range(n)]


def int8_card_vs_cpu(cpu_model, dev_model, x):
    """The CPU's int8-activation module and its copy on the card, on one
    input: per layer, the CPU's input quantized and convolved on both
    devices (``equal``: codes and int32 accumulators torch.equal at every
    layer); and each device's own forward, whose codes may flip where a
    float layer rounds a value to another last bit (``flipped`` of
    ``codes``, by at most ``step``)."""
    import torch

    from rs_face_detection_tpu_torch.models.quantized import Int8ActConv2d
    from rs_face_detection_tpu_torch.ops.int8_conv import int8_conv2d, quantize_activation

    dev_convs = dict(dev_model.named_modules())
    report = {"layers": 0, "equal": True, "codes": 0, "flipped": 0, "step": 0.0}
    cpu_codes, hooks = {}, []

    def on_cpu(name):
        def run(mod, args):
            card = dev_convs[name]
            xq = quantize_activation(args[0], mod.amax)
            xq_dev = quantize_activation(args[0].to(card.amax.device), card.amax)
            acc = int8_conv2d(xq, mod.weight_q, mod.stride, mod.padding)
            acc_dev = int8_conv2d(xq_dev, card.weight_q, card.stride, card.padding)
            report["layers"] += 1
            report["equal"] &= torch.equal(xq_dev.cpu(), xq) and torch.equal(acc_dev.cpu(), acc)
            cpu_codes[name] = xq
        return run

    def on_dev(name):
        def run(mod, args):
            d = (quantize_activation(args[0], mod.amax).cpu().int() - cpu_codes[name].int()).abs()
            report["codes"] += d.numel()
            report["flipped"] += int((d > 0).sum())
            report["step"] = max(report["step"], float(d.max()))
        return run

    for model, hook in ((cpu_model, on_cpu), (dev_model, on_dev)):
        hooks += [m.register_forward_pre_hook(hook(n)) for n, m in model.named_modules()
                  if isinstance(m, Int8ActConv2d)]
    try:
        with torch.no_grad():
            cpu_model(x.cpu())
            dev_model(x)
    finally:
        for h in hooks:
            h.remove()
    return report


def int8_profile(fn, warm=2):
    """torch.profiler over one call of ``fn`` after ``warm`` calls, with the
    int8 convs' quantize and im2col passes in scopes of their own: device ms
    of aten::_int_mm, of the quantize passes, of the im2col passes, of
    everything else, the device's busy time and the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from rs_face_detection_tpu_torch.models import quantized
    from rs_face_detection_tpu_torch.ops import int8_conv

    quantize, patches = quantized.quantize_activation, int8_conv._patches

    def scoped(name, f):
        def run(*args, **kwargs):
            with record_function(name):
                return f(*args, **kwargs)
        return run

    quantized.quantize_activation = scoped("int8::quantize", quantize)
    int8_conv._patches = scoped("int8::im2col", patches)
    try:
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        quantized.quantize_activation, int8_conv._patches = quantize, patches

    def device_us(evt, own):
        for attr in (("self_device_time_total", "self_cuda_time_total") if own
                     else ("device_time_total", "cuda_time_total")):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    # Host-side events only: a kernel's time is its launching op's own
    # device time, and a scope's is that of the ops under it (the scopes'
    # device-side annotations are left out, so nothing counts twice).
    events = [e for e in prof.events() if str(getattr(e, "device_type", "CPU")).endswith("CPU")]

    def total(name):
        return sum(device_us(e, False) for e in events if e.name == name) / 1e3

    busy = sum(device_us(e, True) for e in events) / 1e3
    int_mm, quant, im2col = total("aten::_int_mm"), total("int8::quantize"), total("int8::im2col")
    return {"int_mm": int_mm, "quantize": quant, "im2col": im2col, "rest": busy - int_mm - quant - im2col,
            "busy": busy, "wall": wall}


def int8_detect_phase(dev, rng, face, card, det_sd, size=640):
    """Phase 24: the calibrated int8-activation RetinaFace on the card, each
    step held against the same module on the CPU, TF32 off: (a) the trained
    mnet quantized on the card (default calibration) and on the CPU, (b) the
    seeded full-width R50, (c) DetectionServer on JPEG bytes, (d) timings.
    Returns the launch counts of the counted runs."""
    import copy

    import cv2
    import numpy as np
    import torch

    from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
    from rs_face_detection_tpu_torch.models import weights
    from rs_face_detection_tpu_torch.models.quantized import Int8ActConv2d
    from rs_face_detection_tpu_torch.ops import int8_conv
    from rs_face_detection_tpu_torch.ops.image import letterbox_u8_batch
    from rs_face_detection_tpu_torch.ops.quantize import quantize_retinaface
    from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
    from rs_face_detection_tpu_torch.pipeline.tracking import iou_matrix_np
    from rs_face_detection_tpu_torch.runtime import native
    from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer
    from rs_face_detection_tpu_torch.utils.image_io import decode_image_bytes

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    image_size = (size, size)
    counts = {}

    def amax_of(model):
        return {n: float(m.amax) for n, m in model.named_modules() if isinstance(m, Int8ActConv2d)}

    def amax_rel(a, b):
        return max(abs(a[k] - b[k]) / b[k] for k in b)

    def canvases_of(frames):
        canvases, scales = letterbox_u8_batch(frames, size, size, dev)
        return canvases, torch.tensor(scales, dtype=torch.float32, device=dev)

    def model_input(det, canvases):
        """The detector's network input for uint8 canvases, as forward makes it."""
        from rs_face_detection_tpu_torch.ops.image import bgr_to_rgb, normalize

        c = det.cfg
        x = normalize(bgr_to_rgb(canvases.float()), tuple(m * c.pixel_scale for m in c.pixel_means),
                      tuple(1.0 / s for s in c.pixel_stds)) / c.pixel_scale
        return x.permute(0, 3, 1, 2).contiguous()

    # (a) the trained mnet: calibrate on the card and on the CPU
    family = "retinaface_mobilenet025"
    cfg = FaceDetectionConfig(image_size=image_size)
    mnet_float = weights.load_model(family, det_sd)
    t0 = time.perf_counter()
    q_dev = quantize_retinaface(mnet_float, image_size, device=dev)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    q_cpu = quantize_retinaface(mnet_float, image_size, device="cpu")
    n_int8 = len(amax_of(q_dev))
    check(n_int8 == 34 and not mnet_float.quant, f"phase 24 (a): {n_int8} int8 convs, float model quant {mnet_float.quant}")
    mnet_amax = amax_rel(amax_of(q_dev), amax_of(q_cpu))
    check(mnet_amax <= 1e-4, f"phase 24 (a): card vs CPU amax rtol {mnet_amax} > 1e-4")
    q_cpu_dev = copy.deepcopy(q_cpu).to(dev)  # the CPU's calibration on the card
    frames = [place_faces(rng, face, 480, 640, int(rng.integers(1, 4)), (90, 240))[0] for _ in range(3 * BATCH)]
    batches = [canvases_of(frames[i * BATCH : (i + 1) * BATCH]) for i in range(3)]
    det_float = RetinaFaceDetection(cfg, mnet_float, device=dev)
    det_q = RetinaFaceDetection(cfg, q_dev, device=dev)
    x0 = model_input(det_q, batches[0][0][:2])
    first = q_cpu.body.stage1[0][0]
    first_dev = q_cpu_dev.body.stage1[0][0]
    check(isinstance(first, Int8ActConv2d) and first.weight_q.shape[1:] == (3, 3, 3), "phase 24 (a): first int8 conv")
    codes_cpu = int8_conv.quantize_activation(x0.cpu(), first.amax)
    codes_dev = int8_conv.quantize_activation(x0, first_dev.amax)
    acc_cpu = int8_conv.int8_conv2d(codes_cpu, first.weight_q, first.stride, first.padding)
    int8_conv.int_mm_calls = 0
    acc_dev = int8_conv.int8_conv2d(codes_dev, first_dev.weight_q, first_dev.stride, first_dev.padding)
    torch.cuda.synchronize()
    check(int8_conv.int_mm_calls == 1, "phase 24 (a): the first layer did not run torch._int_mm on the card")
    check(torch.equal(codes_dev.cpu(), codes_cpu) and torch.equal(acc_dev.cpu(), acc_cpu),
          "phase 24 (a): the first int8 layer's codes or int32 accumulators differ, card vs CPU")
    layers = int8_card_vs_cpu(q_cpu, q_cpu_dev, model_input(det_q, batches[0][0]))
    check(layers["layers"] == 34 and layers["equal"], f"phase 24 (a): per-layer card vs CPU {layers}")
    check(layers["flipped"] <= 0.005 * layers["codes"], f"phase 24 (a): card vs CPU codes {layers}")
    # the counted main path: 3 detect_batch calls of 8 on the card's own calibration
    det_q.detect_batch(*batches[0])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    int8_conv.int_mm_calls = 0
    outs = [det_q.detect_batch(*b) for b in batches]
    torch.cuda.synchronize()
    counts["int8_detect_mnet"] = read_counts()
    mnet_int_mm = int8_conv.int_mm_calls
    check(counts["int8_detect_mnet"] == {"nms_mask": 3, "fused_stem": 0, "flash_attention": 0, "int8_matmul": 0},
          f"phase 24 (a): launches {counts['int8_detect_mnet']} for 3 detect_batch calls")
    check(mnet_int_mm == 3 * 34, f"phase 24 (a): {mnet_int_mm} int8 GEMMs for 3 calls of 34 int8 convs")
    # card vs CPU on one module (the CPU's calibration): the same network
    # input, but each device's own float layers (depthwise convs, BatchNorm)
    # may round a value to another last bit, and where it sits at a rounding
    # boundary the next int8 conv gets the neighbouring code.
    det_cpu_on_dev = RetinaFaceDetection(cfg, q_cpu_dev, device=dev)
    det_cpu = RetinaFaceDetection(cfg, q_cpu, device=cpu)
    with torch.no_grad():
        maps_dev = det_cpu_on_dev.forward(batches[0][0].float())
        maps_cpu = det_cpu.forward(batches[0][0].cpu().float())
    map_err = {}
    for key in ("score", "bbox", "landmark"):
        d = torch.cat([(maps_dev[st][key].cpu() - maps_cpu[st][key]).abs().reshape(-1) for st in maps_cpu])
        map_err[key] = (round(float(d.max()), 4), round(float(torch.quantile(d, 0.999)), 6))
    found = matched = strong = 0
    box_err = 0.0
    for canvases, scales in batches:
        got = detections_of(det_cpu_on_dev.detect_batch(canvases, scales), BATCH)
        want = detections_of(det_cpu.detect_batch(canvases.cpu(), scales.cpu()), BATCH)
        for (gd, _), (wd, _) in zip(got, want):
            found += len(gd)
            if len(gd) == len(wd) and len(wd):
                box_err = max(box_err, float(np.abs(gd[:, :4] - wd[:, :4]).max()))
            for row in wd[wd[:, 4] >= 0.9]:  # a confident CPU face is found on the card
                strong += 1
                ious = iou_matrix_np(row[None, :4].astype(np.float32), gd[:, :4].astype(np.float32)) if len(gd) else [[0.0]]
                matched += int(np.max(ious) >= 0.5)
    check(matched == strong and found >= 3 * BATCH,
          f"phase 24 (a): {matched} of {strong} confident CPU faces found on the card, {found} faces")
    # int8 against float on the fixture face
    frame, boxes = place_faces(rng, face, 480, 640, 1, (160, 240))
    fd, _ = det_float(frame)
    qd, _ = det_q(frame)
    check(len(fd) >= 1 and len(qd) >= 1, f"phase 24 (a): float found {len(fd)}, int8 {len(qd)} on the fixture face")
    iou = float(iou_matrix_np(qd[:1, :4].astype(np.float32), fd[:1, :4].astype(np.float32))[0, 0])
    check(iou >= 0.5, f"phase 24 (a): int8 vs float IoU {iou} < 0.5")
    print(
        f"phase 24 (a) int8 mnet at {size}: trained 640 detector quantized on the card ({n_int8} int8 convs, "
        f"default calibration, {calib_s:.2f} s) and on the CPU: amax rtol {mnet_amax:.3g} (<= 1e-4); on the "
        f"CPU's calibration, every int8 layer's codes and int32 accumulators card == CPU on the same input "
        f"({layers['layers']} layers, {layers['codes']} codes, torch.equal); detect_batch 3 x 8 on the card: K1 "
        f"{counts['int8_detect_mnet']['nms_mask']}, K2 {counts['int8_detect_mnet']['fused_stem']}, "
        f"torch._int_mm {mnet_int_mm}; card vs CPU on one module, 8 canvases: {layers['flipped']} of "
        f"{layers['codes']} codes flipped (<= 0.5%), by at most {layers['step']:.0f} (downstream of a flip, codes move by more), maps (max, 99.9th percentile of "
        f"abs err) {map_err}; 3 x 8 detections: {found} faces on the card, {matched} of {strong} CPU faces at >= 0.9 "
        f"found at IoU >= 0.5, max box err {box_err:.3g} px where the counts agree; int8 vs float on the fixture "
        f"face IoU {iou:.4f} (>= 0.5) {card}"
    )

    # (b) the seeded full-width R50 at 640, b8
    r50_family = "retinaface_resnet50"
    rcfg = FaceDetectionConfig(backbone="resnet50", image_size=image_size)
    r50_float = weights.load_model(r50_family, weights.init_state(r50_family, SEED))
    r50_q = quantize_retinaface(r50_float, image_size, device=dev)
    r50_q_cpu = quantize_retinaface(r50_float, image_size, device="cpu")
    n_r50 = len(amax_of(r50_q))
    r50_amax = amax_rel(amax_of(r50_q), amax_of(r50_q_cpu))
    check(n_r50 == 73 and r50_amax <= 1e-4, f"phase 24 (b): {n_r50} int8 convs, amax rtol {r50_amax}")
    r50_det_q = RetinaFaceDetection(rcfg, r50_q, device=dev)
    check(r50_det_q.stem_consts is None, "phase 24 (b): the int8 R50 folded the fused stem")
    r50_q_cpu_dev = copy.deepcopy(r50_q_cpu).to(dev)
    r50_layers = int8_card_vs_cpu(r50_q_cpu, r50_q_cpu_dev, model_input(r50_det_q, batches[0][0][:2]))
    check(r50_layers["layers"] == 73 and r50_layers["equal"], f"phase 24 (b): per-layer card vs CPU {r50_layers}")
    r50_det_q.detect_batch(*batches[0])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    int8_conv.int_mm_calls = 0
    r50_outs = [r50_det_q.detect_batch(*b) for b in batches]
    torch.cuda.synchronize()
    counts["int8_detect_r50"] = read_counts()
    r50_int_mm = int8_conv.int_mm_calls
    check(counts["int8_detect_r50"] == {"nms_mask": 3, "fused_stem": 0, "flash_attention": 0, "int8_matmul": 0},
          f"phase 24 (b): launches {counts['int8_detect_r50']} for 3 detect_batch calls (K2 must stay 0)")
    check(r50_int_mm == 3 * 73, f"phase 24 (b): {r50_int_mm} int8 GEMMs for 3 calls of 73 int8 convs")
    for out in r50_outs:
        check(bool(torch.isfinite(out.det).all()) and bool(torch.isfinite(out.kps).all()), "phase 24 (b): non-finite rows")
    two = (batches[0][0][:2], batches[0][1][:2])
    r50_dev_rows = detections_of(RetinaFaceDetection(rcfg, r50_q_cpu_dev, device=dev).detect_batch(*two), 2)
    r50_cpu_rows = detections_of(RetinaFaceDetection(rcfg, r50_q_cpu, device=cpu).detect_batch(
        two[0].cpu(), two[1].cpu()), 2)
    r50_box = max([float(np.abs(g[:, :4] - w[:, :4]).max()) for (g, _), (w, _) in zip(r50_dev_rows, r50_cpu_rows)
                   if len(g) == len(w) and len(w)] or [0.0])
    same_counts = sum(len(g) == len(w) for (g, _), (w, _) in zip(r50_dev_rows, r50_cpu_rows))
    print(
        f"phase 24 (b) int8 R50 at {size}, seeded full width, b8: {n_r50} int8 convs, amax card vs CPU rtol "
        f"{r50_amax:.3g} (<= 1e-4); on the CPU's calibration every int8 layer's codes and int32 accumulators "
        f"card == CPU on the same input ({r50_layers['layers']} layers, {r50_layers['codes']} codes); detect_batch "
        f"3 x 8: K2 {counts['int8_detect_r50']['fused_stem']}, K1 {counts['int8_detect_r50']['nms_mask']}, "
        f"torch._int_mm {r50_int_mm}; whole detector card vs CPU (one module, codes free to flip where an f32 "
        f"epilogue differs in its last bit), 2 frames: {r50_layers['flipped']} of {r50_layers['codes']} codes "
        f"flipped, by at most {r50_layers['step']:.0f}; {same_counts}/2 with equal counts, max box difference there "
        f"{r50_box:.3g} px {card}"
    )

    # (c) DetectionServer on JPEG bytes
    payloads = []
    for f in frames:
        ok, jpg = cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 90])
        check(ok, "phase 24 (c): cv2.imencode failed")
        payloads.append(jpg.tobytes())
    with DetectionServer(det_q, batch_size=BATCH) as server:
        loader = "native" if server._native is not None else "cv2"
        zero_counts()
        served = [r for i in range(0, len(payloads), BATCH) for r in server.detect_batch(payloads[i : i + BATCH])]
        torch.cuda.synchronize()
        counts["int8_detect_server"] = read_counts()
        batches_by = dict(server.loader_batches)
    check(batches_by[loader] == 3, f"phase 24 (c): loader batches {batches_by}")
    direct = []
    for i in range(0, len(payloads), BATCH):
        chunk = payloads[i : i + BATCH]
        if loader == "native":
            imgs, scales, ok = native.decode_letterbox_batch(chunk, size, size)
            canvases, scales = torch.from_numpy(imgs).to(dev), torch.from_numpy(scales).to(dev)
        else:
            canvases, scales = canvases_of([decode_image_bytes(p) for p in chunk])
        direct += detections_of(det_q.detect_batch(canvases, scales), len(chunk))
    check(len(served) == len(direct), f"phase 24 (c): {len(served)} results for {len(direct)} payloads")
    for (gd, gk), (wd, wk) in zip(served, direct):
        check(np.array_equal(gd, wd) and np.array_equal(gk, wk), "phase 24 (c): served != detect_batch on its canvases")
    check(counts["int8_detect_server"]["nms_mask"] == 3 and counts["int8_detect_server"]["fused_stem"] == 0,
          f"phase 24 (c): launches {counts['int8_detect_server']}")
    why = "" if loader == "native" else f" (the native loader did not build: {server.native_unavailable})"
    print(
        f"phase 24 (c) DetectionServer(int8 mnet, batch_size=8) on 24 JPEG payloads: loader {loader}{why}; "
        f"batches {batches_by}; {sum(len(d) for d, _ in served)} faces, every result equal to detect_batch on the "
        f"same canvases; K1 {counts['int8_detect_server']['nms_mask']} {card}"
    )

    # (d) timings: detect b8, int8 against float, CUDA events, TF32 off
    r50_det_f = RetinaFaceDetection(rcfg, r50_float, device=dev)
    canvases, scales = batches[0]
    timing = {}
    for name, det in (("mnet float", det_float), ("mnet int8", det_q), ("R50 float", r50_det_f),
                      ("R50 int8", r50_det_q)):
        det.detect_batch(canvases, scales)
        timing[name] = cuda_ms(lambda det=det: det.detect_batch(canvases, scales), 5)
    prof = int8_profile(lambda: r50_det_q.detect_batch(canvases, scales))
    mnet_prof = int8_profile(lambda: det_q.detect_batch(canvases, scales))
    print(
        f"phase 24 (d) detect_batch b8 at {size} (ms per call, median/min/max over 5 windows of 5): "
        + "; ".join(f"{k} {fmt(t)}" for k, t in timing.items())
        + f"; int8/float mnet {timing['mnet int8'][0] / timing['mnet float'][0]:.3f}, R50 "
        f"{timing['R50 int8'][0] / timing['R50 float'][0]:.3f} {card}"
    )
    for name, p in (("R50", prof), ("mnet", mnet_prof)):
        print(
            f"phase 24 (d) int8 {name} detect_batch b8, one call under torch.profiler: device busy "
            f"{p['busy']:.4f} of {p['wall']:.4f} ms wall; torch._int_mm {p['int_mm']:.4f} ms, quantize passes "
            f"{p['quantize']:.4f} ms, im2col passes {p['im2col']:.4f} ms, the rest {p['rest']:.4f} ms {card}"
        )
    print(f"phase 24 int8-activation detection: {time.perf_counter() - t_phase:.1f} s in all {card}")
    return counts


GPU_TESTS = ("-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-m", "gpu", "-rs",
             "tests/test_torch_kernels_gpu.py")


def host_ms(fn, n, windows=5):
    """ms per call of `fn` on the host clock, each window ending in a device
    sync: (median, min, max) over windows of `n` calls."""
    import statistics

    import torch

    per_call = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(per_call), min(per_call), max(per_call)


#: The eKYC tower that phases 25 and 26 serve (a bf16 clip_l14).
TOWER = "face_anti_spoofing_crop_l14"


def serving_registry(dev, p5, ekyc):
    """The registry of phases 25 and 26, on the card: phase 5's trained 640
    mnet and seeded heads and phase 15's eKYC models, the clip_l14 towers
    cast to bf16 for serving."""
    import torch

    from rs_face_detection_tpu_torch.models import weights
    from rs_face_detection_tpu_torch.models.registry import DETECTION_OUTPUT_SPEC, EKYC_FAMILIES, ModelRegistry, ModelSpec
    from rs_face_detection_tpu_torch.models.vit import cast_for_serving

    cfg = p5["cfg"]
    det_name, q_name, e_name = cfg.detection.model_name, cfg.quality.model_name, cfg.identification.model_name
    width, height = cfg.detection.image_size
    reg = ModelRegistry(dev)
    reg.register(ModelSpec(det_name, (height, width, 3), DETECTION_OUTPUT_SPEC, BATCH),
                 weights.load_model("retinaface_mobilenet025", p5["det_sd"]))
    reg.register(ModelSpec(q_name, (112, 112, 3), "(B, 4) class probabilities"),
                 weights.load_model("resnet18_classifier", p5["q_sd"]))
    reg.register(ModelSpec(e_name, (112, 112, 3), "(B, 512) embedding"),
                 weights.load_model(cfg.identification.backbone, p5["e_sd"]))
    sizes = {"scrfd": 640, "face_id": 112, "face_attribute": 128, "face_quality_vp": 112}
    for name, fam in EKYC_FAMILIES.items():
        model = weights.load_model(fam, ekyc["sds"][name])
        if fam == "clip_l14":
            cast_for_serving(model)
        size = sizes.get(name, 224)
        reg.register(ModelSpec(name, (size, size, 3), "seeded"), model)
    check(reg.get(TOWER).conv1.weight.dtype == torch.bfloat16, "phases 25-26: the tower is not bf16")
    return reg


def direct_forward(dev, reg, cfg, name, x):
    """The registry module's own forward on the card, as the wire returns
    it: a list of float32 arrays (the detector's 9 maps in the Triton
    view)."""
    import torch

    from rs_face_detection_tpu_torch.runtime.wire import detection_triton_view

    module = reg.get(name)
    dtype = next(module.parameters()).dtype
    with torch.inference_mode():
        out = module(torch.from_numpy(x).to(dev, dtype))
    if isinstance(out, dict):
        maps = {s: {k: v.float().cpu().numpy() for k, v in m.items()} for s, m in out.items()}
        return detection_triton_view(maps, cfg.detection.feat_strides)
    return [out.float().cpu().numpy()]


def serving_phase(dev, card, p5, ekyc, reg):
    """Phase 25: the serving runtime on the card.  ``reg``
    (serving_registry) served by runtime/server.py::serve on a localhost
    port with the Triton wire beside the facade; a second server with
    dynamic batching on the same registry.  The counted run is every request
    of (a) and (b); each reply is then held against the direct call on the
    card.  (c) shared memory, (d) TraceSetting, (e) timings.  TF32 off.
    Returns the counted run's launch counts."""
    import shutil
    import threading

    import cv2
    import grpc
    import numpy as np
    import torch

    from rs_face_detection_tpu_torch.kernels.build import BUILD_DIR
    from rs_face_detection_tpu_torch.ops.image import letterbox_u8_batch
    from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import EKYCPipeline
    from rs_face_detection_tpu_torch.runtime.server import FacePipelineClient, ekyc_reply, extract_reply, serve
    from rs_face_detection_tpu_torch.runtime.shm import SharedRegion
    from rs_face_detection_tpu_torch.runtime.wire import TritonWireClient
    from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer
    from rs_face_detection_tpu_torch.utils.image_io import decode_image_bytes

    t_phase = time.perf_counter()
    cfg = p5["cfg"]
    det_name, q_name, e_name = cfg.detection.model_name, cfg.quality.model_name, cfg.identification.model_name
    width, height = cfg.detection.image_size
    tower = TOWER
    ekyc_pipe = EKYCPipeline(registry=reg, device=dev)
    server = serve(None, reg, port=0, ekyc_pipeline=ekyc_pipe, stream_batch_size=BATCH, max_workers=8)
    dyn = serve(None, reg, port=0, dynamic_batching=True, batch_delay_ms=10.0, stream_batch_size=BATCH,
                max_workers=8, triton_wire=False)
    wc = TritonWireClient(f"localhost:{server._rsfd_port}", timeout_s=300)
    fc = FacePipelineClient("localhost", server._rsfd_port, timeout_s=300)
    dc = FacePipelineClient("localhost", dyn._rsfd_port, timeout_s=300)
    trace_root = BUILD_DIR / f"trace_{os.getpid()}"
    try:
        pipe = server._rsfd_servicer.pipeline
        frames = p5["frames"][: 3 * BATCH]
        jpegs = [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes() for f in frames]
        pair_jpegs = [tuple(cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes() for im in pair)
                      for pair in ekyc["pairs"]]
        canvas, _ = letterbox_u8_batch(frames[:BATCH], width, height, dev)
        x_det = np.ascontiguousarray(canvas.cpu().numpy()[..., ::-1].transpose(0, 3, 1, 2)).astype(np.float32)
        rng = np.random.default_rng(SEED + 25)
        x_q, x_e = (rng.normal(size=(1, 3, 112, 112)).astype(np.float32) for _ in range(2))
        x_t = rng.normal(size=(1, 3, 224, 224)).astype(np.float32)

        def dynamic(client, verb, payloads):
            """Every payload from its own thread at once; the replies in order."""
            out = [None] * len(payloads)
            barrier = threading.Barrier(len(payloads))

            def one(i):
                barrier.wait()
                out[i] = getattr(client, verb)(payloads[i])

            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(payloads))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return out

        def batcher_stats():
            meta = dc.server_metadata()
            return (meta.get("dynamic_batching_stats") or {"batches": 0, "requests": 0, "batch_size_counts": {}},
                    meta.get("extract_dynamic_batching_stats") or {"batches": 0, "requests": 0, "batch_size_counts": {}})

        # warm-up of every verb (lazy pipelines, cuDNN and cuBLAS handles), not counted
        wc.model_infer(det_name, x_det[:1], use_raw=True)
        wc.model_infer(tower, x_t, use_raw=True)
        fc.extract(jpegs[0])
        fc.detect(jpegs[0])
        list(fc.detect_stream(jpegs[:BATCH]))
        fc.ekyc_verify(*pair_jpegs[0])
        dc.detect(jpegs[0])
        dc.extract(jpegs[0])
        torch.cuda.synchronize()

        # the counted run: (a) the reference's flow over the Triton wire, (b) the facade
        steps = {}
        zero_counts()

        def step(name):
            torch.cuda.synchronize()
            steps[name] = read_counts()

        configs = {n: wc.model_config(n) for n in (det_name, q_name, e_name)}
        det_inputs = configs[det_name]["input"][0]
        out_names = [o["name"] for o in configs[det_name]["output"]]
        check(det_inputs["dims"] == [1, 3, height, width] and len(out_names) == 9, f"phase 25: {configs[det_name]}")
        wire = {
            det_name: wc.model_infer(det_name, x_det[:1], input_name=det_inputs["name"], requested_outputs=out_names),
            q_name: wc.model_infer(q_name, x_q),
            e_name: wc.model_infer(e_name, x_e, use_raw=True),
        }
        step("a_stages")
        wire[tower] = wc.model_infer(tower, x_t, use_raw=True)
        step("a_tower")
        extract_replies = [fc.extract(j) for j in jpegs[:BATCH]]
        step("b_extract")
        detect_replies = [fc.detect(j) for j in jpegs[:BATCH]]
        step("b_detect")
        stream_replies = list(fc.detect_stream(jpegs))
        step("b_stream")
        verify_replies = [fc.ekyc_verify(c, s) for c, s in pair_jpegs]
        step("b_verify")
        before = batcher_stats()
        dyn_detect = dynamic(dc, "detect", jpegs[:BATCH])
        step("b_dyn_detect")
        dyn_extract = dynamic(dc, "extract", jpegs[BATCH : 2 * BATCH])
        step("b_dyn_extract")
        after = batcher_stats()
        counts = read_counts()

        names = list(steps)
        delta = {n: {k: steps[n][k] - (steps[names[i - 1]][k] if i else 0) for k in counts}
                 for i, n in enumerate(names)}
        batches = [a["batches"] - b["batches"] for a, b in zip(after, before)]
        requests = [a["requests"] - b["requests"] for a, b in zip(after, before)]
        want_k1 = {"a_stages": 0, "a_tower": 0, "b_extract": BATCH, "b_detect": BATCH, "b_stream": 3,
                   "b_verify": 2 * len(pair_jpegs), "b_dyn_detect": batches[0], "b_dyn_extract": batches[1]}
        want_k4 = {"a_tower": 24, "b_verify": 48 * len(pair_jpegs)}
        for n in names:
            check(delta[n]["nms_mask"] == want_k1[n], f"phase 25 {n}: K1 launched {delta[n]['nms_mask']}, want {want_k1[n]}")
            check(delta[n]["flash_attention"] == want_k4.get(n, 0), f"phase 25 {n}: K4 launched {delta[n]['flash_attention']}")
            check(delta[n]["fused_stem"] == delta[n]["int8_matmul"] == 0, f"phase 25 {n}: K2 or K3 launched {delta[n]}")
        check(requests == [BATCH, BATCH] and all(0 < b < BATCH for b in batches),
              f"phase 25: dynamic batching did not coalesce: {batches} batches for {requests} requests")

        # (a) each output equal to the registry module's own forward on the card
        for name, x in ((det_name, x_det[:1]), (q_name, x_q), (e_name, x_e), (tower, x_t)):
            got = [arr for _, _, arr in wire[name]]
            want = direct_forward(dev, reg, cfg, name, x)
            check(len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want)),
                  f"phase 25 (a): ModelInfer on {name} != its forward on the card")
        check([n for n, _, _ in wire[det_name]] == out_names, "phase 25 (a): output names")

        # (b) each reply equal to the direct call on the card
        for j, reply in zip(jpegs, extract_replies):
            check(reply == extract_reply(pipe.extract(j)), "phase 25 (b): Extract != FacePipeline.extract")
        for j, reply in zip(jpegs, detect_replies):
            det, kps = pipe.face_detection(decode_image_bytes(j))
            check(reply == {"boxes": det.tolist(), "keypoints": kps.tolist()}, "phase 25 (b): Detect != direct")
        with DetectionServer(pipe.face_detection, batch_size=BATCH) as direct_server:
            stream_direct = [r for i in range(0, len(jpegs), BATCH) for r in direct_server.detect_batch(jpegs[i : i + BATCH])]
            dyn_direct = direct_server.detect_batch(jpegs[:BATCH])
        check(stream_replies == [{"boxes": d.tolist(), "keypoints": k.tolist()} for d, k in stream_direct],
              "phase 25 (b): DetectStream != DetectionServer.detect_batch")
        dyn_err, dyn_cos = 0.0, 1.0
        for reply, (d, k) in zip(dyn_detect, dyn_direct):
            got_d, got_k = np.asarray(reply["boxes"]).reshape(d.shape), np.asarray(reply["keypoints"]).reshape(k.shape)
            if d.size:
                dyn_err = max(dyn_err, float(np.abs(got_d - d).max()), float(np.abs(got_k - k).max()))
        for reply, r in zip(dyn_extract, pipe.extract_batch(jpegs[BATCH : 2 * BATCH])):
            want = extract_reply(r)
            check(reply["face_count"] == want["face_count"] and reply["face_quality"] == want["face_quality"]
                  and (reply["selected_face_box"] is None) == (want["selected_face_box"] is None),
                  "phase 25 (b): dynamic Extract != extract_batch")
            if want["selected_face_box"] is not None:
                dyn_err = max(dyn_err, float(np.abs(np.subtract(reply["selected_face_box"], want["selected_face_box"])).max()))
                dyn_cos = min(dyn_cos, float(np.dot(reply["facial_feature"], want["facial_feature"])))
        check(dyn_err <= 1e-3 and dyn_cos >= 0.9999, f"phase 25 (b): dynamic batching box err {dyn_err}, cos {dyn_cos}")
        for (c, s), reply in zip(pair_jpegs, verify_replies):
            check(reply == ekyc_reply(ekyc_pipe.verify(c, s)), "phase 25 (b): EkycVerify != EKYCPipeline.verify")
        faces = sum(r["face_count"] for r in extract_replies)
        print(
            f"phase 25 (a)+(b) serving runtime over gRPC on localhost (grpcio {grpc.__version__}): Triton wire "
            f"3 x ModelConfig, ModelInfer on {det_name} (9 maps), {q_name}, {e_name} and the bf16 tower "
            f"{tower}, each np.array_equal to the module's forward on the card; facade Extract x{BATCH} "
            f"({faces} faces), Detect x{BATCH}, DetectStream x{len(jpegs)} (3 batches of {BATCH}), EkycVerify "
            f"x{len(pair_jpegs)}: equal to the direct calls; dynamic batching, {BATCH} clients at once: Detect "
            f"{batches[0]} batches {after[0]['batch_size_counts']}, Extract {batches[1]} batches "
            f"{after[1]['batch_size_counts']} (cumulative), max box err {dyn_err:.3g} px, min cosine {dyn_cos:.6f}; "
            f"launches per step {delta}"
        )

        # (c) shared memory
        key = f"rsfd_smoke_{os.getpid()}"
        with SharedRegion.create(key, 1 << 22) as region:
            region.write_array(x_q)
            wc.system_shared_memory_register("smoke", key, 1 << 22)
            ((_, shape, ref),) = wc.model_infer_shm(q_name, x_q, "smoke", output_region=("smoke", 1 << 20),
                                                    requested_outputs=["output"])
            shm_out = region.read_array(np.float32, shape, 1 << 20)
            wc.system_shared_memory_unregister("smoke")
        check(np.array_equal(shm_out, wire[q_name][0][2]), "phase 25 (c): shared-memory ModelInfer != inline")
        try:
            wc.cuda_shared_memory_register("gpu", b"\0" * 64, 0, 1 << 20)
            check(False, "phase 25 (c): CUDA shared memory was registered")
        except grpc.RpcError as e:
            check(e.code() == grpc.StatusCode.UNIMPLEMENTED, f"phase 25 (c): CUDA shm refused with {e.code()}")

        # (d) TraceSetting around one Extract
        check(wc.trace_setting() == {"trace_level": ["OFF"]}, "phase 25 (d): a trace is already on")
        started = fc.trace_setting("start", trace_dir=str(trace_root))
        fc.extract(jpegs[0])
        stopped = fc.trace_setting("stop")
        check(started.get("active") and stopped == {"active": False, "dir": str(trace_root)}, f"phase 25 (d): {stopped}")
        trace_file = trace_root / "trace.json"
        trace_text = trace_file.read_text()
        check("nms_mask_kernel" in trace_text, "phase 25 (d): K1's kernel is not in the trace")
        print(f"phase 25 (c) shared-memory ModelInfer on {q_name} equal to the inline one; CUDA shared memory "
              f"refused UNIMPLEMENTED; (d) TraceSetting start/stop around one Extract: {trace_file.stat().st_size} "
              f"bytes of Chrome trace, K1's nms_mask_kernel in it")

        # (e) timings, TF32 off: host clock for round trips, CUDA events for the forward alone
        module = reg.get(det_name)
        x1, x8 = (torch.from_numpy(x_det[:b]).to(dev) for b in (1, BATCH))
        with torch.inference_mode():
            fwd = {b: cuda_ms(lambda x=x: module(x), 10) for b, x in ((1, x1), (BATCH, x8))}
        rt = {b: host_ms(lambda b=b: wc.model_infer(det_name, x_det[:b], use_raw=True), 10 if b == 1 else 3)
              for b in (1, BATCH)}
        ext_wire = host_ms(lambda: [fc.extract(j) for j in jpegs[:BATCH]], 1)
        ext_direct = host_ms(lambda: [pipe.extract(j) for j in jpegs[:BATCH]], 1)
        ver_wire = host_ms(lambda: [fc.ekyc_verify(c, s) for c, s in pair_jpegs], 1)
        ver_direct = host_ms(lambda: [ekyc_pipe.verify(c, s) for c, s in pair_jpegs], 1)
        dyn_rates, sizes0 = [], batcher_stats()[0]["batch_size_counts"]
        for _ in range(5):
            t0 = time.perf_counter()
            dynamic(dc, "detect", jpegs[:BATCH] * 4)
            dyn_rates.append(4 * BATCH / (time.perf_counter() - t0))
        sizes1 = batcher_stats()[0]["batch_size_counts"]
        coalesced = {k: v - sizes0.get(k, 0) for k, v in sizes1.items() if v - sizes0.get(k, 0)}
        dyn_rates.sort()
        per = lambda t, n: (t[0] / n, t[1] / n, t[2] / n)  # noqa: E731
        print(f"phase 25 (e) ModelInfer round trip {det_name} raw fp32 b1: {fmt(rt[1])}, b{BATCH}: {fmt(rt[BATCH])}; "
              f"the forward alone on the device b1 {fmt(fwd[1])}, b{BATCH} {fmt(fwd[BATCH])} {card}")
        print(f"phase 25 (e) Extract per 640x480 JPEG over the wire {fmt(per(ext_wire, BATCH))}, "
              f"FacePipeline.extract direct {fmt(per(ext_direct, BATCH))} {card}")
        print(f"phase 25 (e) EkycVerify per pair over the wire {fmt(per(ver_wire, len(pair_jpegs)))}, "
              f"EKYCPipeline.verify direct {fmt(per(ver_direct, len(pair_jpegs)))} {card}")
        print(f"phase 25 (e) Detect with dynamic batching, {BATCH} clients x 4 requests, 5 windows: "
              f"{dyn_rates[2]:.1f} img/s (min {dyn_rates[0]:.1f}, max {dyn_rates[-1]:.1f}); batch sizes {coalesced} {card}")
    finally:
        for c in (wc, fc, dc):
            c.close()
        server.stop(0)
        dyn.stop(0)
        shutil.rmtree(trace_root, ignore_errors=True)
    print(f"phase 25 serving runtime: {time.perf_counter() - t_phase:.1f} s in all {card}")
    return {"serving": counts}


def read_lines(proc, pattern, timeout_s):
    """Lines of a child's stdout, read on a thread of their own: ((the first
    match of ``pattern``, the host clock when its line was read), the lines
    so far), or (None, lines) when the child exits or ``timeout_s`` passes
    first."""
    import queue
    import re
    import threading

    lines, found = [], queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.append(line)
            m = re.search(pattern, line)
            if m:
                found.put((m, time.perf_counter()))
        found.put(None)

    threading.Thread(target=pump, daemon=True).start()
    try:
        return found.get(timeout=timeout_s), lines
    except queue.Empty:
        return None, lines


def deployment_phase(dev, card, reg, p26):
    """Phase 26: the deployment surfaces on the card.  (a) the KServe-v2
    REST endpoint over phase 25's registry; (b) the runtime's entry point as
    a child process; (c) AOT detect artifacts of the trained 640 mnet and
    the seeded R50, and an mnet exported on the CPU served on the card; (d)
    model artifacts of the bf16 tower and the int8 face-ID head; then each
    custom op against its direct wrapper from Python.  TF32 off but in (b).
    The child of (b) starts first and comes up while (c)+(d) export; every
    timing is taken after it has stopped.
    Returns the counted runs' launches (``http``: the REST infers; ``aot``:
    one call of each loaded program) and the custom ops' host times."""
    import shutil
    import signal
    import tempfile

    import cv2
    import numpy as np
    import torch

    from rs_face_detection_tpu_torch.kernels import attention as katt
    from rs_face_detection_tpu_torch.kernels import build
    from rs_face_detection_tpu_torch.kernels import int8_matmul as k3
    from rs_face_detection_tpu_torch.kernels import nms as knms
    from rs_face_detection_tpu_torch.kernels import stem as kstem
    from rs_face_detection_tpu_torch.models import checkpoint_io, weights
    from rs_face_detection_tpu_torch.models.quantized import quantize_module
    from rs_face_detection_tpu_torch.ops.attention import attention
    from rs_face_detection_tpu_torch.ops.nms import nms_mask
    from rs_face_detection_tpu_torch.ops.quantize import int8_matmul
    from rs_face_detection_tpu_torch.ops.stem import fused_stem
    from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
    from rs_face_detection_tpu_torch.runtime.aot import export_detector, export_model, load_detector, load_model
    from rs_face_detection_tpu_torch.runtime.http import TritonHTTPClient, _HttpContext
    from rs_face_detection_tpu_torch.runtime.server import FacePipelineClient, extract_reply, serve
    from rs_face_detection_tpu_torch.runtime.wire import TritonWireClient

    t_phase = time.perf_counter()
    cfg = p26["cfg"]
    det_name = cfg.detection.model_name
    rng = np.random.default_rng(SEED + 26)
    canvas = p26["canvas"]
    x_det = np.ascontiguousarray(canvas.cpu().numpy()[..., ::-1].transpose(0, 3, 1, 2)).astype(np.float32)
    x_t = rng.normal(size=(1, 3, 224, 224)).astype(np.float32)

    # (b) the runtime's entry point as a child process, on phase 5's trained detector; it
    # starts now and is asked after (c)+(d) have exported and loaded their artifacts
    root = tempfile.mkdtemp(prefix="runtime-", dir=build.BUILD_DIR)
    det_meta = {"family": "retinaface", "backbone": "mobilenet025", "stem_s2d": False, "image_size": [640, 640]}
    checkpoint_io.save_imported(os.path.join(root, f"{det_name}.npz"),
                                weights.load_model("retinaface_mobilenet025", p26["det_sd"]), det_meta)
    jpeg = cv2.imencode(".jpg", p26["frames"][0], [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
    t_child = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rs_face_detection_tpu_torch.runtime", "--port", "0", "--http-port", "0",
         "--warmup", "--checkpoint-dir", root],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        # (c) + (d): artifacts, eager references first, then one counted call of each loaded program
        rcfg = dataclasses.replace(cfg.detection, backbone="resnet50")
        detectors = {
            "mnet": RetinaFaceDetection(cfg.detection, reg.get(det_name), device=dev),
            "r50": RetinaFaceDetection(rcfg, weights.load_model("retinaface_resnet50", p26["r50_sd"]), device=dev),
            "mnet_cpu": RetinaFaceDetection(cfg.detection, weights.load_model("retinaface_mobilenet025", p26["det_sd"]),
                                            device="cpu"),
        }
        tower = reg.get(TOWER)
        head = quantize_module(weights.load_model(cfg.identification.backbone, p26["e_sd"])).to(dev).eval()
        x_tower = torch.from_numpy(rng.normal(size=(BATCH, 3, 224, 224)).astype(np.float32)).to(dev, torch.bfloat16)
        x_face = torch.from_numpy(rng.normal(size=(BATCH, 3, 112, 112)).astype(np.float32)).to(dev)
        exports = {
            "mnet": lambda: export_detector(detectors["mnet"], batch_size=BATCH),
            "r50": lambda: export_detector(detectors["r50"], batch_size=BATCH),
            "mnet_cpu": lambda: export_detector(detectors["mnet_cpu"], batch_size=BATCH),
            "tower": lambda: export_model(tower, (BATCH, 3, 224, 224), name=TOWER, dtype=torch.bfloat16),
            "int8_head": lambda: export_model(head, (BATCH, 3, 112, 112), name=cfg.identification.model_name),
        }
        blobs, loaded, secs = {}, {}, {}
        for key, export in exports.items():
            t0 = time.perf_counter()
            blobs[key] = export()
            t1 = time.perf_counter()
            loaded[key] = (load_model if key in ("tower", "int8_head") else load_detector)(blobs[key], device=dev)
            secs[key] = (t1 - t0, time.perf_counter() - t1)
        check(loaded["mnet_cpu"].meta["device"] == "cpu" and loaded["mnet_cpu"].device == loaded["mnet"].device,
              "phase 26 (c): the CPU artifact was not moved to the card")
        check(loaded["r50"].meta["stem"] == "fused", f"phase 26 (c): the R50 exported the {loaded['r50'].meta['stem']} stem")
        states = {key: (det.model if key != "mnet_cpu" else detectors["mnet"].model).state_dict()
                  for key, det in detectors.items()}
        states.update(tower=tower.state_dict(), int8_head=head.state_dict())
        scales = torch.ones(BATCH, device=dev)
        inputs = {key: (canvas, scales) for key in detectors}
        inputs.update(tower=(x_tower,), int8_head=(x_face,))
        with torch.inference_mode():
            live = {key: detectors[key if key != "mnet_cpu" else "mnet"].detect_batch(canvas, scales) for key in detectors}
            live = {key: (v.det, v.kps, v.count) for key, v in live.items()}
            live.update(tower=tower(x_tower), int8_head=head(x_face))
        for key in loaded:  # warm-up of each program, not counted
            loaded[key](states[key], *inputs[key])
        torch.cuda.synchronize()
        zero_counts()
        outs = {key: loaded[key](states[key], *inputs[key]) for key in loaded}
        torch.cuda.synchronize()
        aot_counts = read_counts()
        want_counts = {"nms_mask": 3, "fused_stem": 1, "flash_attention": 24, "int8_matmul": 1}
        check(aot_counts == want_counts, f"phase 26 (c)+(d): loaded programs launched {aot_counts}, want {want_counts}")
        for key in ("mnet", "r50"):
            check(all(torch.equal(g, w) for g, w in zip(outs[key], live[key])), f"phase 26 (c): loaded {key} != detect_batch")
        for key in ("tower", "int8_head"):
            check(torch.equal(outs[key], live[key]), f"phase 26 (d): loaded {key} != its eager forward")
        moved, ref = outs["mnet_cpu"], live["mnet"]
        check(torch.equal(moved[2], ref[2]), f"phase 26 (c): CPU-exported counts {moved[2].tolist()} != {ref[2].tolist()}")
        moved_err = 0.0
        for i, n in enumerate(ref[2].tolist()):
            if n:
                moved_err = max(moved_err, float((moved[0][i, :n, :4] - ref[0][i, :n, :4]).abs().max()),
                                float((moved[1][i, :n] - ref[1][i, :n]).abs().max()))
        check(moved_err <= 1e-3, f"phase 26 (c): CPU-exported boxes {moved_err} px from the live detect_batch")
        moved_equal = all(torch.equal(g, w) for g, w in zip(moved, ref))
        weight_bytes = {key: sum(t.numel() * t.element_size() for t in st.values()) for key, st in states.items()}
        sizes = "; ".join(f"{key} {len(blobs[key])} bytes against {weight_bytes[key]} weight bytes, export "
                          f"{secs[key][0]:.2f} s, load {secs[key][1]:.2f} s" for key in blobs)
        print(f"phase 26 (c)+(d) AOT artifacts (torch.export), b{BATCH}: loaded trained mnet and seeded R50 (fused stem) "
              f"torch.equal to detect_batch on phase 5's canvases, the bf16 tower and the int8 face-ID head torch.equal "
              f"to their eager forwards; the mnet exported on the CPU and moved to the card: counts equal, boxes within "
              f"{moved_err:.3g} px, bit-equal {moved_equal}; launches in one call of each program {aot_counts}; {sizes}")
        # (b), continued: the child, up by now
        up, lines = read_lines(proc, r"serving on :(\d+)", 300)
        check(up is not None, f"phase 26 (b): the entry point never served: {''.join(lines)[-3000:]}")
        m, up_s = up[0], up[1] - t_child
        http_port = int(next(ln.split(":")[-1] for ln in lines if "KServe-v2 HTTP endpoint on" in ln))
        client = FacePipelineClient(port=int(m.group(1)), timeout_s=300)
        try:
            check(client.server_live() and client.server_ready(), "phase 26 (b): gRPC not live and ready")
            child = TritonHTTPClient(port=http_port, timeout_s=300)
            check(child.server_live() and child.server_ready(), "phase 26 (b): REST not live and ready")
            reply = client.extract(jpeg)
        finally:
            client.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    check(rc == 0, f"phase 26 (b): the entry point exited {rc} on SIGTERM")
    # The child runs with a new process's defaults (cuDNN TF32 on, matmul
    # TF32 off): phase 5's pipeline on the same JPEG under the same.
    saved_tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        want = extract_reply(p26["pipe"].extract(jpeg))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    check(reply.get("face_count") == want["face_count"] and reply["face_quality"] == want["face_quality"]
          and (reply["selected_face_box"] is None) == (want["selected_face_box"] is None),
          f"phase 26 (b): Extract from the entry point {reply} != phase 5's pipeline {want}")
    box_err, cos = 0.0, 1.0
    if want["selected_face_box"] is not None:
        box_err = float(np.abs(np.subtract(reply["selected_face_box"], want["selected_face_box"])).max())
        cos = float(np.dot(reply["facial_feature"], want["facial_feature"]))
    check(box_err <= 1e-2 and cos >= 0.9999, f"phase 26 (b): box err {box_err}, cosine {cos}")
    print(f"phase 26 (b) python -m rs_face_detection_tpu_torch.runtime --port 0 --http-port 0 --warmup "
          f"--checkpoint-dir <phase 5's detector>: up with its warm-up Extract in {up_s:.1f} s, gRPC and REST live "
          f"and ready, Extract on one JPEG frame: {reply['face_count']} faces, box err {box_err:.3g} px, cosine "
          f"{cos:.6f} against phase 5's pipeline, bit-equal {reply == want}; exit code {rc} on SIGTERM {card}")

    # (a) REST over phase 25's registry
    server = serve(None, reg, port=0, http_port=0, max_workers=8)
    rest = TritonHTTPClient(port=server._rsfd_http_port, timeout_s=300)
    wc = TritonWireClient(f"localhost:{server._rsfd_port}", timeout_s=300)
    try:
        for name, x in ((det_name, x_det[:1]), (TOWER, x_t)):  # warm-up, not counted
            rest.infer(name, x)
        torch.cuda.synchronize()
        zero_counts()
        served = {(name, binary): rest.infer(name, x, binary=binary)
                  for name, x in ((det_name, x_det[:1]), (TOWER, x_t)) for binary in (False, True)}
        torch.cuda.synchronize()
        http_counts = read_counts()
        check(http_counts["flash_attention"] == 2 * 24 and http_counts["nms_mask"] == 0
              and http_counts["fused_stem"] == http_counts["int8_matmul"] == 0,
              f"phase 26 (a): launches {http_counts}, want 24 K4 per tower infer and nothing else")
        for (name, binary), outs in served.items():
            x = x_det[:1] if name == det_name else x_t
            got = [arr for _, _, arr in outs]
            want = direct_forward(dev, reg, cfg, name, x)
            over_wire = [arr for _, _, arr in wc.model_infer(name, x, use_raw=True)]
            check(len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want)),
                  f"phase 26 (a): REST infer on {name} (binary {binary}) != its forward on the card")
            check(all(np.array_equal(g, w) for g, w in zip(got, over_wire)),
                  f"phase 26 (a): REST infer on {name} (binary {binary}) != the wire's ModelInfer")
        check(rest.server_live() and rest.server_ready() and rest.model_ready(TOWER), "phase 26 (a): not live and ready")
        check(rest.model_metadata(TOWER)["platform"] == "pytorch_libtorch", "phase 26 (a): metadata")
        (stats,) = rest.model_statistics(TOWER)
        check(stats["inference_count"] >= 3, f"phase 26 (a): statistics {stats}")
        status = rest._request("POST", "/v2/cudasharedmemory/region/gpu0/register", b'{"byte_size": 64}',
                               ok_statuses=(501,))[0]
        check(status == 501, f"phase 26 (a): CUDA shared memory answered {status}")
        module = reg.get(det_name)
        x8 = torch.from_numpy(x_det).to(dev)
        with torch.inference_mode():
            fwd8 = cuda_ms(lambda: module(x8), 10)
        rest8 = host_ms(lambda: rest.infer(det_name, x_det), 3)
        # The wire servicer both protocols share, in-process: no transport, no codec.
        request = {"model_name": det_name, "model_version": "", "id": "", "parameters": {}, "outputs": [],
                   "inputs": [{"name": "data", "datatype": "FP32", "shape": list(x_det.shape), "parameters": {},
                               "contents": None}], "raw_input_contents": [x_det.tobytes()]}
        servicer8 = host_ms(lambda: server._rsfd_wire.model_infer(request, _HttpContext()), 3)
    finally:
        wc.close()
        server.stop(0)
    print(f"phase 26 (a) KServe-v2 REST on localhost over phase 25's registry: JSON and binary infers on {det_name} "
          f"(9 maps) and the bf16 tower {TOWER}, each np.array_equal to the module's forward and to the wire's "
          f"ModelInfer; launches {http_counts}; health, metadata, statistics ({stats['inference_count']} inferences "
          f"of the tower) and the CUDA shared-memory refusal (501) as in the tests")
    print(f"phase 26 (a) REST infer {det_name} b{BATCH} binary fp32: {fmt(rest8)} (host clock); the wire servicer's "
          f"model_infer in-process on the same request {fmt(servicer8)} (host clock); the forward alone {fmt(fwd8)} "
          f"{card}")

    t_aot = {}
    for key, iters in (("mnet", 20), ("r50", 5)):
        det = detectors[key]
        t_aot[key] = (cuda_ms(lambda det=det: det.detect_batch(canvas, scales), iters),
                      cuda_ms(lambda key=key: loaded[key](states[key], canvas, scales), iters))
        print(f"phase 26 (c) {key} detect b{BATCH}: eager detect_batch {fmt(t_aot[key][0])}, loaded program "
              f"{fmt(t_aot[key][1])} (CUDA events) {card}")

    # each custom op against its direct wrapper from Python, in turns
    cand = p26["real_cand"]
    qkv = torch.from_numpy(rng.normal(size=(BATCH, 257, 3, 16, 64)).astype(np.float32)).to(dev, torch.bfloat16)
    x3 = torch.from_numpy(rng.normal(size=(BATCH, 25088)).astype(np.float32)).to(dev)
    q3 = torch.from_numpy(rng.integers(-127, 128, (25088, 512), dtype=np.int8)).to(dev)
    s3 = torch.from_numpy(rng.uniform(1e-4, 1e-3, 512).astype(np.float32)).to(dev)
    calls = {
        "nms_mask": (nms_mask, knms.nms_mask_cuda, (cand.boxes, cand.valid, 0.45), 200),
        "fused_stem": (fused_stem, kstem.fused_stem_cuda, (canvas, *detectors["r50"].stem_consts), 20),
        "flash_attention": (attention, katt.flash_attention_cuda, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]), 100),
        "int8_matmul": (int8_matmul, k3.int8_matmul_cuda, (x3, q3, s3, "f32"), 100),
    }
    op_ms = {}
    for name, (op, wrapper, args, iters) in calls.items():
        check(torch.equal(op(*args), wrapper(*args)), f"phase 26: the {name} op != its wrapper")
        w1 = cuda_ms(lambda: wrapper(*args), iters)
        o1 = cuda_ms(lambda: op(*args), iters)
        o2 = cuda_ms(lambda: op(*args), iters)
        w2 = cuda_ms(lambda: wrapper(*args), iters)
        op_ms[name] = (min(o1, o2), min(w1, w2))
    print("phase 26 custom ops from Python (CUDA events over back-to-back calls; the op through torch's "
          "dispatcher, then the direct ctypes wrapper): " + "; ".join(
              f"{name} op {fmt(o)}, wrapper {fmt(w)}" for name, (o, w) in op_ms.items()) + f" {card}")
    print(f"phase 26 deployment surfaces: {time.perf_counter() - t_phase:.1f} s in all {card}")
    return {"http": http_counts, "aot": aot_counts, "op_python_ms": op_ms}


def gpu_tests_phase(card):
    """Phase 21: the kernels' own card tests in a subprocess, without
    tests/conftest.py (it imports JAX).  Passes only if pytest exits 0,
    nothing was skipped and every collected test passed."""
    import re

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *GPU_TESTS], cwd=HERE, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""  # "== 72 passed, 1 warning in 20.1s =="
    collected = re.search(r"collected (\d+) items?", proc.stdout)
    passed = re.search(r"(\d+) passed", summary)
    n_collected = int(collected.group(1)) if collected else 0
    n_passed = int(passed.group(1)) if passed else 0
    ok = proc.returncode == 0 and n_collected > 0 and n_passed == n_collected and "skipped" not in summary
    if not ok:
        print("\n".join(lines[-60:]) + proc.stderr[-4000:], file=sys.stderr)
    check(ok, f"kernel card tests: rc {proc.returncode}, {n_passed} passed of {n_collected} collected")
    print(
        f"phase 21 kernel card tests (python {' '.join(GPU_TESTS)}): rc {proc.returncode}, "
        f"{n_passed} passed of {n_collected} collected, none skipped, in {time.perf_counter() - t0:.1f} s {card}"
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from rs_face_detection_tpu_torch.kernels import build
    from rs_face_detection_tpu_torch.kernels import nms as knms
    from rs_face_detection_tpu_torch.kernels import stem as kstem
    from rs_face_detection_tpu_torch.models import weights
    from rs_face_detection_tpu_torch.ops.image import letterbox_u8_batch
    from rs_face_detection_tpu_torch.ops.nms import nms_mask_plain
    from rs_face_detection_tpu_torch.ops.stem import fold_stem_params, fused_stem, fused_stem_plain
    from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
    from rs_face_detection_tpu_torch.pipeline.face_pipeline import (
        FaceExtractionResult,
        FacePipeline,
        FacePipelineConfig,
        FaceQualityClass,
    )
    from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer

    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"phase 1 card: torch {torch.__version__}, CUDA {torch.version.cuda}, name and power limit:")
    print(smi)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = ("nms", "stem", "attention", "int8_matmul")
    with ThreadPoolExecutor(max_workers=len(sources) + len(K1_VARIANTS) + 1) as pool:
        variant_jobs = [pool.submit(build_k1_variant, name) for name in K1_VARIANTS]
        k3_job = pool.submit(build_k3_timeline)
        list(pool.map(build.build, sources))
        k1_variants = dict(job.result() for job in variant_jobs)
        k3_timeline_so = k3_job.result()
    report = []
    for name in sources:
        build.load(name)
        log = build.build_logs.get(name, "").splitlines()
        ptxas = [ln.split("ptxas info    : ")[-1].strip() for ln in log if "registers" in ln or "spill" in ln]
        report.append(f"csrc/{name}.cu: {'; '.join(ptxas)}")
    built = ", ".join(f"csrc/{name}.cu" for name in sources)
    print(f"phase 2 build: {built} in {time.perf_counter() - t0:.2f} s; {' | '.join(report)}")

    # 3. K1 vs plain, bit for bit
    max_err = 0.0
    cases = 0
    for k in (100, 128, 1000):
        boxes = torch.from_numpy(random_sorted_boxes(rng, 32, k)).to(dev)
        valid = torch.from_numpy(rng.uniform(size=(32, k)) > 0.2).to(dev)
        got, want = knms.nms_mask_cuda(boxes, valid, 0.45), nms_mask_plain(boxes, valid, 0.45)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got.int() - want.int()).abs().max()))
        check(torch.equal(got, want), f"K1 != plain at B=32 K={k}")
        cases += 1
    face = np.load(os.path.join(FIXTURES, "real_face_crop.npz"))["face"]
    cfg = FacePipelineConfig()
    det_family = "retinaface_mobilenet025"
    det_sd = weights.state_dict_from_jax(det_family, os.path.join(FIXTURES, "trained_real640.npz"))
    frames = make_frames(rng, 4 * BATCH, face)
    width, height = cfg.detection.image_size
    canvas = torch.zeros((BATCH, height, width, 3), dtype=torch.uint8, device=dev)
    canvas[:, :480] = torch.from_numpy(np.stack(frames[:BATCH])).to(dev)
    valid_rows = []
    for thr in (0.02, 0.0):
        det = RetinaFaceDetection(
            dataclasses.replace(cfg.detection, confidence_threshold=thr),
            weights.load_model(det_family, det_sd), device=dev,
        )
        cand = det.candidates(canvas)
        valid_rows.append(int(cand.valid.sum()))
        got = knms.nms_mask_cuda(cand.boxes, cand.valid, 0.45)
        want = nms_mask_plain(cand.boxes, cand.valid, 0.45)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got.int() - want.int()).abs().max()))
        check(torch.equal(got, want), f"K1 != plain on real candidates (threshold {thr})")
        cases += 1
    check(valid_rows[1] == BATCH * cfg.detection.max_candidates, "threshold 0 left invalid rows")
    real_cand = cand  # (8, 128), every row valid: the timing input below
    print(
        f"phase 3 K1 vs plain: {cases} cases equal (torch.equal); real (8, 128) candidates "
        f"valid rows {valid_rows[0]}/1024 at threshold 0.02, {valid_rows[1]}/1024 at 0.0"
    )

    # 4. detector parity, GPU vs CPU, TF32 off
    saved_tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det_gpu = RetinaFaceDetection(cfg.detection, weights.load_model(det_family, det_sd), device=dev)
    det_cpu = RetinaFaceDetection(cfg.detection, weights.load_model(det_family, det_sd), device="cpu")
    with torch.no_grad():
        maps_gpu = det_gpu.forward(canvas.float())
        maps_cpu = det_cpu.forward(canvas.cpu().float())
    parity = 0.0
    for stride, maps in maps_cpu.items():
        for key, ref in maps.items():
            got = maps_gpu[stride][key].cpu()
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()), f"bad map {stride}/{key}")
            parity = max(parity, float((got - ref).abs().max()))
    check(parity <= 1e-3, f"detector GPU vs CPU max abs err {parity} > 1e-3")
    print(
        f"phase 4 detector parity (cudnn.allow_tf32=False, matmul.allow_tf32=False): "
        f"8 frames at 640, per-stride maps max abs err {parity:.3g} <= 1e-3"
    )

    # 5. the main path (TF32 stays off)
    q_sd = weights.init_state("resnet18_classifier", SEED)
    e_sd = weights.init_state(cfg.identification.backbone, SEED)

    def models():
        return {
            cfg.detection.model_name: weights.load_model(det_family, det_sd),
            cfg.quality.model_name: weights.load_model("resnet18_classifier", q_sd),
            cfg.identification.model_name: weights.load_model(cfg.identification.backbone, e_sd),
        }

    pipe = FacePipeline(cfg, models=models(), device="cuda")
    pipe.extract_batch(frames[:BATCH])  # warm-up, before the counted run
    torch.cuda.synchronize()
    zero_counts()
    requests = [frames[i * BATCH : (i + 1) * BATCH] for i in range(3)]
    results = [pipe.extract_batch(r) for r in requests]
    single = pipe.extract_image(frames[3 * BATCH])
    torch.cuda.synchronize()
    by_path = {"mobilenet025": read_counts()}
    main_launches = by_path["mobilenet025"]["nms_mask"]
    check(main_launches == 4, f"NMS kernel launched {main_launches} times for 4 detect calls")
    check(by_path["mobilenet025"]["fused_stem"] == 0 and by_path["mobilenet025"]["flash_attention"] == 0,
          f"the mnet path launched K2 or K4: {by_path['mobilenet025']}")
    flat = [r for req in results for r in req] + [single]
    selected = 0
    for r in flat:
        check(isinstance(r, FaceExtractionResult) and isinstance(r.face_count, int), "bad result")
        if r.selected_face_box is None:
            check(r.facial_feature is None, "feature without a selected face")
            continue
        selected += 1
        feat = r.facial_feature
        check(feat.shape == (512,) and np.isfinite(feat).all(), "embedding not a finite (512,)")
        check(abs(float(np.linalg.norm(feat)) - 1.0) <= 1e-4, "embedding norm not 1")
        check(isinstance(r.face_quality, FaceQualityClass), "quality not a FaceQualityClass")
        check(0.0 <= r.quality_score <= 1.0, "quality score outside [0, 1]")
        check(r.selected_face_box.shape == (5,), "selected box not (5,)")
    if selected == 0:  # still run warp + quality + embed on the card
        m = np.concatenate([np.eye(2, dtype=np.float32), np.zeros((2, 1), np.float32)], 1)
        from rs_face_detection_tpu_torch.ops.image import warp_affine

        faces = warp_affine(canvas[:1].float(), torch.from_numpy(m)[None].to(dev), 112, 112)
        probs, emb = pipe.heads(faces)
        check(bool(torch.isfinite(emb).all()), "tail on template landmarks not finite")
    cpu_pipe = FacePipeline(cfg, models=models(), device="cpu")
    agree_box, agree_cos = 0.0, 1.0
    for g, c in zip(results[0], cpu_pipe.extract_batch(requests[0])):
        check(g.face_count == c.face_count, f"face count GPU {g.face_count} vs CPU {c.face_count}")
        check((g.selected_face_box is None) == (c.selected_face_box is None), "selection differs")
        if c.selected_face_box is not None:
            agree_box = max(agree_box, float(np.abs(g.selected_face_box - c.selected_face_box).max()))
            agree_cos = min(agree_cos, float(np.dot(g.facial_feature, c.facial_feature)))
            check(g.face_quality == c.face_quality, "quality class differs")
    check(agree_box <= 1e-2 and agree_cos >= 0.9999, f"GPU vs CPU: box {agree_box}, cos {agree_cos}")
    print(
        f"phase 5 main path: 3 x extract_batch(8) + extract_image(1) at 640x480; "
        f"faces found {sum(r.face_count for r in flat)}, selected {selected}/25; "
        f"NMS launches {main_launches} for 4 detect calls; request 1 vs CPU pipeline: "
        f"box max err {agree_box:.3g} px, min embedding cosine {agree_cos:.6f}"
    )

    # 6. timings (CUDA events, after a warm-up; TF32 off as above)
    scales = torch.ones(BATCH)
    for _ in range(3):
        det_gpu.detect_batch(canvas, scales)
    det_ms = cuda_ms(lambda: det_gpu.detect_batch(canvas, scales), 20)
    ext_ms = cuda_ms(lambda: pipe.extract_batch(requests[0]), 5)
    b8 = real_cand
    main_cand = det_gpu.candidates(canvas)  # the main path's own, at the default 0.7 threshold
    floor_x = torch.zeros(1, device=dev)
    k_dev = graph_ms(lambda: knms.nms_mask_cuda(b8.boxes, b8.valid, 0.45))
    k_dev_main = graph_ms(lambda: knms.nms_mask_cuda(main_cand.boxes, main_cand.valid, 0.45))
    floor_dev = graph_ms(lambda: floor_x.add_(1))
    k_ms = cuda_ms(lambda: knms.nms_mask_cuda(b8.boxes, b8.valid, 0.45), 200)
    p_ms = cuda_ms(lambda: nms_mask_plain(b8.boxes, b8.valid, 0.45), 20)
    # K1's bound at (8, 128): boxes, valid and keep once each; about 15 f32
    # operations per IoU that greedy NMS needs (each kept box against the
    # later valid ones, this run's data).
    keep = knms.nms_mask_cuda(b8.boxes, b8.valid, 0.45)
    later_valid = torch.flip(torch.cumsum(torch.flip(b8.valid.int(), [1]), 1), [1]) - b8.valid.int()
    k1_ious = int((later_valid * keep.int()).sum())
    k1_bound = card_bound(b8.boxes.numel() * 4 + 2 * b8.valid.numel(), 15 * k1_ious, F32_OPS_PER_S)
    main_keep = knms.nms_mask_cuda(main_cand.boxes, main_cand.valid, 0.45)
    print(f"phase 6 detect b8: {fmt(det_ms)}/batch, {BATCH * 1000 / det_ms[0]:.1f} img/s {card}")
    print(f"phase 6 extract_batch b8: {fmt(ext_ms)}/batch, {BATCH * 1000 / ext_ms[0]:.1f} img/s {card}")
    print(f"phase 6 NMS (B=8, K=128) per call, all 1024 rows valid ({int(keep.sum())} kept): K1 on the device "
          f"(graph replay) {fmt(k_dev)}, from Python {fmt(k_ms)}; plain {fmt(p_ms)}; bound "
          f"{k1_bound[0]:.7f} ms by {k1_bound[1]}; launch floor (1-element add, graph replay) "
          f"{fmt(floor_dev)} {card}")
    print(f"phase 6 NMS (B=8, K=128) on the main path's candidates at threshold "
          f"{cfg.detection.confidence_threshold} ({int(main_cand.valid.sum())} valid, {int(main_keep.sum())} "
          f"kept): K1 on the device (graph replay) {fmt(k_dev_main)} {card}")
    # Where K1's time goes, on those two inputs and on random boxes (sparse:
    # most are kept) at (8, 128) and SCRFD's (1, 256).
    prng = np.random.default_rng(SEED + 6)
    k1_inputs = {"(8, 128) all valid": (b8.boxes, b8.valid), "(8, 128) main path": (main_cand.boxes, main_cand.valid)}
    for shape in ((8, 128), (1, 256)):
        k1_inputs[f"{shape} random"] = (
            torch.from_numpy(random_sorted_boxes(prng, *shape)).to(dev), torch.ones(shape, dtype=torch.bool, device=dev))
    k1_phases, parts = {}, []
    for label, (bx, vd) in k1_inputs.items():
        k1_phases[label] = k1_phases_ms(k1_variants, bx, vd, 0.45)
        kept = int(knms.nms_mask_cuda(bx, vd, 0.45).sum())
        parts.append(f"{label} ({int(vd.sum())} valid, {kept} kept): " + ", ".join(
            f"{name} {t:.4f}" for name, t in k1_phases[label].items()))
    print(f"phase 6 K1 where the time goes, ms on the device (phase 0 includes the launch): {'; '.join(parts)} {card}")

    # 7. K2 vs plain (TF32 stays off).  Bound: 1e-5 of the output's
    # magnitude -- 192 f32 products summed in another order.
    r50_cfg = FacePipelineConfig(detection=dataclasses.replace(cfg.detection, backbone="resnet50"))
    rcfg = r50_cfg.detection
    r50_canvas, _ = letterbox_u8_batch(frames[:BATCH], width, height, dev)
    wrng = np.random.default_rng(SEED + 7)
    stem_params = [
        torch.from_numpy(wrng.normal(size=(4, 4, 12, 64)).astype(np.float32) / np.float32(np.sqrt(192.0))),
        torch.from_numpy(wrng.uniform(0.5, 1.5, 64).astype(np.float32)),
        torch.from_numpy(wrng.normal(0, 0.1, 64).astype(np.float32)),
        torch.from_numpy(wrng.normal(0, 0.1, 64).astype(np.float32)),
        torch.from_numpy(wrng.uniform(0.5, 1.5, 64).astype(np.float32)),
    ]
    norms = {
        "config": (rcfg.pixel_means, rcfg.pixel_stds, rcfg.pixel_scale),
        "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 255.0),
    }
    k2_cases = {
        "letterboxed (8, 640, 640)": r50_canvas,
        "(2, 72, 96)": torch.from_numpy(wrng.integers(0, 256, (2, 72, 96, 3), dtype=np.uint8)).to(dev),
        "(3, 70, 34)": torch.from_numpy(wrng.integers(0, 256, (3, 70, 34, 3), dtype=np.uint8)).to(dev),
        "(1, 2, 2)": torch.from_numpy(wrng.integers(0, 256, (1, 2, 2, 3), dtype=np.uint8)).to(dev),
        "all-0 (1, 640, 640)": torch.zeros((1, height, width, 3), dtype=torch.uint8, device=dev),
        "all-255 (1, 640, 640)": torch.full((1, height, width, 3), 255, dtype=torch.uint8, device=dev),
    }
    k2_err, k2_lines = 0.0, []
    for norm_name, (means, stds, pscale) in norms.items():
        consts = [c.to(dev) for c in fold_stem_params(*stem_params, means, stds, pscale)]
        for case, imgs in k2_cases.items():
            got = kstem.fused_stem_cuda(imgs, *consts)
            want = fused_stem_plain(imgs, *consts)
            torch.cuda.synchronize()
            check(got.shape == want.shape, f"K2 shape {tuple(got.shape)} != {tuple(want.shape)}")
            check(bool(torch.isfinite(got).all()), f"K2 not finite on {case}")
            err = float((got - want).abs().max())
            bound = 1e-5 * max(1.0, float(want.abs().max()))
            check(err <= bound, f"K2 != plain on {case} ({norm_name}): {err} > {bound}")
            k2_err = max(k2_err, err)
            k2_lines.append(f"{case} {norm_name} {err:.3g}")
    k2_consts = consts  # ImageNet normalization: the timing input below
    print(f"phase 7 K2 vs plain (max abs err <= 1e-5 x max|plain|): {'; '.join(k2_lines)}")

    # 8. R50 detector parity, GPU (K2 stem) vs CPU (plain stem), batch 2
    r50_family = "retinaface_resnet50"
    r50_sd = weights.init_state(r50_family, SEED)
    r50_gpu = RetinaFaceDetection(rcfg, weights.load_model(r50_family, r50_sd), device=dev)
    r50_cpu = RetinaFaceDetection(rcfg, weights.load_model(r50_family, r50_sd), device="cpu")
    with torch.no_grad():
        kstem.launches = 0
        maps_gpu = r50_gpu.model.forward_pooled(fused_stem(r50_canvas[:2], *r50_gpu.stem_consts))
        torch.cuda.synchronize()
        check(kstem.launches == 1, "the R50 detector did not go through K2")
        maps_cpu = r50_cpu.model.forward_pooled(fused_stem(r50_canvas[:2].cpu(), *r50_cpu.stem_consts))
    # Bounds: box and landmark maps within 5e-5 of their magnitude (f32 sums
    # in other orders through ~60 convolutions); scores within 1e-3, since on
    # seeded weights the logits behind them are O(100) and a probability
    # moves by up to a quarter of its logit's error.
    r50_err = {"score": 0.0, "bbox": 0.0, "landmark": 0.0}
    r50_mag = dict(r50_err)
    for stride, maps in maps_cpu.items():
        for key, ref in maps.items():
            got = maps_gpu[stride][key].cpu()
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()), f"bad R50 map {stride}/{key}")
            r50_err[key] = max(r50_err[key], float((got - ref).abs().max()))
            r50_mag[key] = max(r50_mag[key], float(ref.abs().max()))
    r50_rel = {k: r50_err[k] / max(1.0, r50_mag[k]) for k in ("bbox", "landmark")}
    check(r50_err["score"] <= 1e-3, f"R50 GPU vs CPU scores: {r50_err['score']} > 1e-3")
    check(max(r50_rel.values()) <= 5e-5, f"R50 GPU vs CPU maps: {r50_rel} of the magnitude > 5e-5")
    print(
        f"phase 8 R50 detector parity (TF32 off): 2 frames at 640, max abs err score "
        f"{r50_err['score']:.3g} (<= 1e-3), bbox {r50_err['bbox']:.3g} of max {r50_mag['bbox']:.4g}, "
        f"landmark {r50_err['landmark']:.3g} of max {r50_mag['landmark']:.4g} (<= 5e-5 of the magnitude)"
    )

    # 9. the R50 main path
    def r50_models():
        return {
            rcfg.model_name: weights.load_model(r50_family, r50_sd),
            cfg.quality.model_name: weights.load_model("resnet18_classifier", q_sd),
            cfg.identification.model_name: weights.load_model(cfg.identification.backbone, e_sd),
        }

    r50_pipe = FacePipeline(r50_cfg, models=r50_models(), device="cuda")
    r50_pipe.extract_batch(frames[:BATCH])  # warm-up, before the counted run
    torch.cuda.synchronize()
    zero_counts()
    r50_requests = [frames[i * BATCH : (i + 1) * BATCH] for i in range(2)]
    r50_results = [r50_pipe.extract_batch(r) for r in r50_requests]
    r50_single = r50_pipe.extract_image(frames[2 * BATCH])
    torch.cuda.synchronize()
    by_path["resnet50"] = read_counts()
    r50_nms_launches, r50_stem_launches = by_path["resnet50"]["nms_mask"], by_path["resnet50"]["fused_stem"]
    check(r50_stem_launches == 2, f"K2 launched {r50_stem_launches} times for 2 detect_batch calls")
    check(r50_nms_launches == 3, f"K1 launched {r50_nms_launches} times for 3 detect calls")
    check(by_path["resnet50"]["flash_attention"] == 0, f"the R50 path launched K4: {by_path['resnet50']}")
    r50_flat = [r for req in r50_results for r in req] + [r50_single]
    r50_selected = 0
    for r in r50_flat:
        check(isinstance(r, FaceExtractionResult) and isinstance(r.face_count, int), "bad R50 result")
        if r.selected_face_box is None:
            check(r.facial_feature is None, "R50: feature without a selected face")
            continue
        r50_selected += 1
        feat = r.facial_feature
        check(feat.shape == (512,) and np.isfinite(feat).all(), "R50: embedding not a finite (512,)")
        check(abs(float(np.linalg.norm(feat)) - 1.0) <= 1e-4, "R50: embedding norm not 1")
        check(isinstance(r.face_quality, FaceQualityClass), "R50: quality not a FaceQualityClass")
    if r50_selected == 0:  # still run warp + quality + embed on the card
        from rs_face_detection_tpu_torch.ops.image import warp_affine

        m = np.concatenate([np.eye(2, dtype=np.float32), np.zeros((2, 1), np.float32)], 1)
        faces = warp_affine(r50_canvas[:1].float(), torch.from_numpy(m)[None].to(dev), 112, 112)
        _, emb = r50_pipe.heads(faces)
        check(bool(torch.isfinite(emb).all()), "R50: tail on template landmarks not finite")
    t_cpu = time.perf_counter()
    r50_cpu_pipe = FacePipeline(r50_cfg, models=r50_models(), device="cpu")
    r50_box, r50_cos = 0.0, 1.0
    for g, c in zip(r50_results[0], r50_cpu_pipe.extract_batch(r50_requests[0])):
        check(g.face_count == c.face_count, f"R50 face count GPU {g.face_count} vs CPU {c.face_count}")
        check((g.selected_face_box is None) == (c.selected_face_box is None), "R50 selection differs")
        if c.selected_face_box is not None:
            r50_box = max(r50_box, float(np.abs(g.selected_face_box - c.selected_face_box).max()))
            r50_cos = min(r50_cos, float(np.dot(g.facial_feature, c.facial_feature)))
            check(g.face_quality == c.face_quality, "R50 quality class differs")
    check(r50_box <= 1e-2 and r50_cos >= 0.9999, f"R50 GPU vs CPU: box {r50_box}, cos {r50_cos}")
    print(
        f"phase 9 R50 main path: 2 x extract_batch(8) + extract_image(1) at 640x480, seeded weights; "
        f"faces found {sum(r.face_count for r in r50_flat)}, selected {r50_selected}/17; "
        f"K2 launches {r50_stem_launches} for 2 detect_batch calls, K1 launches {r50_nms_launches} "
        f"for 3 detect calls; request 1 vs CPU pipeline ({time.perf_counter() - t_cpu:.1f} s on the "
        f"CPU): box max err {r50_box:.3g} px, min embedding cosine {r50_cos:.6f}"
    )

    # 10. DetectionServer on the R50 detector, against detect_batch called directly
    stream_frames = frames[: 3 * BATCH]
    direct = []
    for i in range(0, len(stream_frames), BATCH):
        canvases, det_scales = letterbox_u8_batch(stream_frames[i : i + BATCH], width, height, dev)
        out = r50_gpu.detect_batch(canvases, torch.tensor(det_scales))
        det_np, kps_np, cnt = (t.cpu().numpy() for t in (out.det, out.kps, out.count))
        direct += [(det_np[j, : cnt[j]], kps_np[j, : cnt[j]]) for j in range(len(det_scales))]
    with DetectionServer(r50_gpu, batch_size=BATCH) as server:
        served = [r for i in range(0, len(stream_frames), BATCH) for r in server.detect_batch(stream_frames[i : i + BATCH])]
        streamed = [r for b in server.detect_stream(iter(stream_frames)) for r in b]
        server_err = 0.0
        for name, results in (("detect_batch", served), ("detect_stream", streamed)):
            check(len(results) == len(direct), f"{name} returned {len(results)} results")
            for (gd, gk), (wd, wk) in zip(results, direct):
                check(gd.shape == wd.shape, f"{name}: {len(gd)} faces vs {len(wd)} from detect_batch")
                if len(wd):
                    server_err = max(server_err, float(np.abs(gd - wd).max()), float(np.abs(gk - wk).max()))
        check(server_err <= 1e-3, f"DetectionServer vs detect_batch: {server_err} > 1e-3")
        print(
            f"phase 10 DetectionServer (R50, batch 8): detect_batch and detect_stream over 3 batches "
            f"equal detect_batch per image, max abs err {server_err:.3g} "
            f"({sum(len(d) for d, _ in direct)} faces)"
        )

        # 11. R50 timings (TF32 off)
        r50_scales = torch.ones(BATCH)
        for _ in range(2):
            r50_gpu.detect_batch(r50_canvas, r50_scales)
        r50_det_ms = cuda_ms(lambda: r50_gpu.detect_batch(r50_canvas, r50_scales), 5)
        r50_ext_ms = cuda_ms(lambda: r50_pipe.extract_batch(r50_requests[0]), 3)
        # K2 on the device (20 calls replayed from a CUDA graph) and from
        # Python, back to back, where the wrapper's host time adds in.
        k2_dev = graph_ms(lambda: kstem.fused_stem_cuda(r50_canvas, *k2_consts))
        k2_ms = cuda_ms(lambda: kstem.fused_stem_cuda(r50_canvas, *k2_consts), 20)
        stem_plain_ms = cuda_ms(lambda: fused_stem_plain(r50_canvas, *k2_consts), 20)
        k2_ms2 = cuda_ms(lambda: kstem.fused_stem_cuda(r50_canvas, *k2_consts), 20)
        k2_dev2 = graph_ms(lambda: kstem.fused_stem_cuda(r50_canvas, *k2_consts))
        stream_s = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_out = sum(len(b) for b in server.detect_stream(iter(stream_frames)))
            stream_s.append(time.perf_counter() - t0)
        check(n_out == len(stream_frames), "detect_stream lost frames")
    rate = sorted(len(stream_frames) / t for t in stream_s)
    print(f"phase 11 R50 detect b8: {fmt(r50_det_ms)}/batch, {BATCH * 1000 / r50_det_ms[0]:.1f} img/s {card}")
    print(
        f"phase 11 R50 extract_batch b8: {fmt(r50_ext_ms)}/batch, "
        f"{BATCH * 1000 / r50_ext_ms[0]:.1f} img/s {card}"
    )
    kb, kh, kw = r50_canvas.shape[:3]
    k2_bytes = r50_canvas.numel() + kb * 64 * ((kh // 2 - 1) // 2 + 1) * ((kw // 2 - 1) // 2 + 1) * 4
    k2_macs = kb * (kh // 2) * (kw // 2) * 64 * 192  # 192 multiply-adds per conv output
    # The kernel's arithmetic: two TF32 products per multiply-add (exact
    # pixel values times the weights split in two halves) on the tensor
    # cores.  3xTF32 and the f32 FMA pipes are printed beside it.
    k2_bound = card_bound(k2_bytes, 2 * 2 * k2_macs, TF32_OPS_PER_S)
    k2_3x_bound = card_bound(k2_bytes, 3 * 2 * k2_macs, TF32_OPS_PER_S)
    k2_fma_bound = card_bound(k2_bytes, 2 * k2_macs, F32_OPS_PER_S)
    print(
        f"phase 11 stem (8, 640, 640) per call (bound {k2_bound[0]:.4f} ms by {k2_bound[1]}, two TF32 products "
        f"per multiply-add at 495 TFLOP/s; {k2_3x_bound[0]:.4f} ms as 3xTF32, {k2_fma_bound[0]:.4f} ms as f32 "
        f"FMAs): K2 on the device (graph replay) {fmt(k2_dev)}, "
        f"again {fmt(k2_dev2)}; from Python {fmt(k2_ms)}, again {fmt(k2_ms2)}; plain {fmt(stem_plain_ms)} {card}"
    )
    print(
        f"phase 11 DetectionServer.detect_stream R50 b8, 3 batches from host frames: "
        f"{rate[2]:.1f} img/s (min {rate[0]:.1f}, max {rate[-1]:.1f}) {card}"
    )
    ekyc = ekyc_phases(dev, rng, face, card)
    by_path["ekyc"] = ekyc["counts"]
    fas_pairs = [(f, r.selected_face_box) for f, r in zip(frames, flat) if r.selected_face_box is not None]
    check(len(fas_pairs) > 0, "phase 5 selected no face for the anti-spoofing phase")
    int8 = int8_phases(dev, rng, face, card, e_sd, q_sd, fas_pairs[:BATCH], k3_timeline_so)
    by_path["int8_extract"] = int8["counts"]
    p5 = {"cfg": cfg, "det_sd": det_sd, "pipe": pipe, "requests": requests, "results0": flat[:BATCH],
          "fas_pairs": fas_pairs[:BATCH]}
    by_path["checkpoint_serving"] = checkpoint_phase(dev, rng, face, card, p5)["counts"]
    # Phase 23 draws its frames from a generator of its own, so that they do
    # not change when an earlier phase draws more or less.
    by_path.update(offline_phase(dev, np.random.default_rng(SEED + 23), face, card, det_sd))
    by_path.update(int8_detect_phase(dev, np.random.default_rng(SEED + 24), face, card, det_sd))
    p25 = dict(p5, q_sd=q_sd, e_sd=e_sd, frames=frames)
    reg = serving_registry(dev, p25, ekyc)
    by_path.update(serving_phase(dev, card, p25, ekyc, reg))
    deploy = deployment_phase(dev, card, reg, dict(p25, canvas=canvas, real_cand=real_cand, r50_sd=r50_sd))
    by_path.update(http=deploy["http"], aot=deploy["aot"])
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    check(not jax_mods, f"JAX was imported: {jax_mods[:5]}")
    ref_mods = sorted(m for m in sys.modules if m.split(".")[0] == "rs_face_detection_tpu")
    check(not ref_mods, f"the JAX package was imported: {ref_mods[:5]}")

    gpu_tests_phase(card)

    entries = [
        {
            "name": "nms_mask",
            "route": "cuda",
            "source": "rs_face_detection_tpu_torch/csrc/nms.cu",
            "replaces": "rs_face_detection_tpu/ops/nms_pallas.py:110",
            "max_abs_err": max(max_err, ekyc["nms_err"]),
            "ms": k_dev[0],
            "python_ms": k_ms[0],
            "plain_ms": p_ms[0],
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
            "launch_floor_ms": floor_dev[0],
            "phases_ms": k1_phases["(8, 128) all valid"],
            "main_candidates_ms": k_dev_main[0],
            "b1_k256_scrfd_ms": ekyc["k1_b1"]["scrfd"][0],
            "b1_k256_all_valid_ms": ekyc["k1_b1"]["all_valid"][0],
        },
        {
            "name": "fused_stem",
            "route": "cuda",
            "source": "rs_face_detection_tpu_torch/csrc/stem.cu",
            "replaces": "rs_face_detection_tpu/ops/stem_pallas.py:214",
            "max_abs_err": k2_err,
            "ms": k2_dev[0],
            "python_ms": k2_ms[0],
            "plain_ms": stem_plain_ms[0],
            "bound_ms": k2_bound[0],
            "bound_by": k2_bound[1],
            "bound_basis": "2 TF32 tensor-core products per multiply-add at 495 TFLOP/s",
            "tf32x3_bound_ms": k2_3x_bound[0],
            "f32_fma_bound_ms": k2_fma_bound[0],
            "library_ms": None,
        },
        ekyc["k4"],
        int8["k3"],
    ]
    for entry in entries:  # launches as counted on each main path's run
        entry["launches_by_path"] = {path: counts[entry["name"]] for path, counts in by_path.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        # From Python through the custom op, as every path calls it now, and
        # through the ctypes wrapper alone (phase 26, in turns).
        entry["python_ms"], entry["wrapper_python_ms"] = (t[0] for t in deploy["op_python_ms"][entry["name"]])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
