#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on a CUDA card: face-ID, eKYC and
the weight-only int8 FaceExtraction.

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
     (3, 1000, 96) and (5, 4095, 130), and at M = 0 (no launch); the port's
     quantizer on the seeded IResNet-50 (53 int8 leaves, fc q (25088, 512));
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
     (1, 25088, 512), on the device (20 calls replayed from a CUDA graph;
     the kernels line's time) and from Python, its plain version, F.linear
     on the dequantized f32 weight (the float fc, 4x the weight bytes) both
     ways, torch._weight_int8pack_mm in bf16 where this torch runs it on
     CUDA (the library yardstick);
     FaceExtraction b8 and b1 float against int8, the weight bytes and the
     peak device memory of one call of each; FaceAntiSpoofing, FaceQuality
     and FaceQualityAssessment at b8;
 21. the kernels' own card tests: ``python -m pytest --noconftest -p
     no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py`` in a
     subprocess (tests/conftest.py imports JAX, which the card's machine
     need not have); it fails unless pytest exits 0, nothing is skipped and
     every collected test passed;
then a JSON line of the kernels, with each one's bound on the card, its
time on the device as ``ms`` and from Python as ``python_ms``, and
{"ok": true, "device": ...} last.
Every count a phase checks is set to 0 just before its path runs.  The
four main paths (phases 5, 9, 15 and 18) set all four kernels' counts to 0
and read all four after, and the kernels line reports exactly those reads.

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

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for _ in range(n):
        base = rng.uniform(40, 200, size=3).astype(np.float32)
        img = (
            base
            + (yy / h)[..., None] * rng.uniform(-60, 60, size=3)
            + (xx / w)[..., None] * rng.uniform(-60, 60, size=3)
            + rng.normal(0, 6, size=(h, w, 3))
        )
        cells = [(0, 0), (w // 2, 0), (0, h // 2), (w // 2, h // 2)]
        for k in rng.permutation(4)[: int(rng.integers(1, 4))]:
            cx, cy = cells[k]
            s = int(rng.integers(90, h // 2 + 1))
            x = cx + int(rng.integers(0, w // 2 - s + 1))
            y = cy + int(rng.integers(0, h // 2 - s + 1))
            rows = (np.arange(s) * face.shape[0]) // s
            cols = (np.arange(s) * face.shape[1]) // s
            img[y : y + s, x : x + s] = face[rows][:, cols]
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


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


def build_k1_variant(name):
    """(name, rsfd_nms_mask of csrc/nms.cu built with K1_VARIANTS[name])."""
    import ctypes

    from rs_face_detection_tpu_torch.kernels import build

    lib = build.library_path("nms")
    out = lib.with_name(f"{lib.stem}-{name}.so")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *K1_VARIANTS[name], "-o", str(out), str(build.CSRC_DIR / "nms.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc failed on the K1 variant {name}: {proc.stderr[-2000:]}")
    fn = ctypes.CDLL(str(out)).rsfd_nms_mask
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    return name, fn


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
        idx = (np.arange(s) * face.shape[0]) // s
        card[y : y + s, x : x + s] = face[idx][:, idx]
        selfie = make_frames(rng, 1, face)[0]
        s = int(rng.integers(260, 420))
        y, x = int(rng.integers(0, 480 - s)), int(rng.integers(0, 640 - s))
        idx = (np.arange(s) * face.shape[0]) // s
        selfie[y : y + s, x : x + s] = face[idx][:, idx]
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
    from rs_face_detection_tpu_torch.models.vit import cast_for_serving
    from rs_face_detection_tpu_torch.ops.attention import attention_plain
    from rs_face_detection_tpu_torch.ops.image import letterbox, letterbox_u8_batch
    from rs_face_detection_tpu_torch.ops.nms import nms_mask_plain
    from rs_face_detection_tpu_torch.pipeline.detection import topk_candidates
    from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import (
        DEFAULT_FAMILIES,
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
           for name, fam in DEFAULT_FAMILIES.items()}
    for name, fam in DEFAULT_FAMILIES.items():
        if sds[name] is None:
            sds[name] = weights.init_state(fam, SEED, 2)

    def models(tower_dtype):
        out = {name: weights.load_model(DEFAULT_FAMILIES[name], sd) for name, sd in sds.items()}
        if tower_dtype == torch.bfloat16:
            for name, fam in DEFAULT_FAMILIES.items():
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


def int8_phases(dev, rng, face, card, e_sd, q_sd, fas_pairs):
    """Phases 17-20 (K3 and the staged per-face modules); returns the counts
    of the int8 main path and K3's entry of the kernels line.  TF32 is off
    throughout."""
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
    k3_err, k3_lines = 0.0, []
    for compute in ("f32", "bf16"):
        for m, k, n in ((8, 25088, 512), (1, 25088, 512), (3, 1000, 96), (5, 4095, 130), (0, 25088, 512)):
            x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
            q_np, s_np = quantize_array(rng.normal(0, 0.05, size=(k, n)).astype(np.float32))
            q, s = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
            before = k3.launches
            got = k3.int8_matmul_cuda(x, q, s, compute)
            want = int8_matmul_plain(x, q, s, compute)
            torch.cuda.synchronize()
            check(got.shape == (m, n) and got.dtype == torch.float32, f"K3 output {tuple(got.shape)} {got.dtype}")
            check(k3.launches == before + (m > 0), f"K3 launched {k3.launches - before} times at M = {m}")
            if m == 0:
                k3_lines.append(f"{compute} {(m, k, n)} empty, no launch")
                continue
            check(bool(torch.isfinite(got).all()), f"K3 not finite at {(m, k, n)} {compute}")
            if compute == "f32":
                xa, wa = x.abs(), (q.float() * s).abs()
            else:
                xa, wa = x.bfloat16().float().abs(), (q.bfloat16() * s.bfloat16()).float().abs()
            bound = 1e-5 * (xa @ wa)
            err = (got - want).abs()
            check(bool((err <= bound).all()), f"K3 != plain at {(m, k, n)} {compute}: {float(err.max())}")
            k3_err = max(k3_err, float(err.max()))
            k3_lines.append(f"{compute} {(m, k, n)} {float(err.max()):.3g} ({float((err / bound).max()):.2g} of the bound)")
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
    k3_ms, k3_dev = {}, {}
    for m, x in ((8, x8), (1, x1)):
        for c in ("f32", "bf16"):
            k3_ms[m, c] = cuda_ms(lambda x=x, c=c: k3.int8_matmul_cuda(x, q, s, c), 200)
            k3_dev[m, c] = graph_ms(lambda x=x, c=c: k3.int8_matmul_cuda(x, q, s, c))
    plain_ms = {c: cuda_ms(lambda c=c: int8_matmul_plain(x8, q, s, c), 50) for c in ("f32", "bf16")}
    linear_ms = cuda_ms(lambda: F.linear(x8, w32), 200)
    linear_dev = graph_ms(lambda: F.linear(x8, w32))
    k3_again = graph_ms(lambda: k3.int8_matmul_cuda(x8, q, s, "f32"))
    try:
        qt, sb, xb = q.t().contiguous(), s.bfloat16(), x8.bfloat16()
        lib_out = torch._weight_int8pack_mm(xb, qt, sb)
        lib_err = float((lib_out.float() - int8_matmul_plain(x8, q, s, "bf16")).abs().max())
        lib_ms = cuda_ms(lambda: torch._weight_int8pack_mm(xb, qt, sb), 200)
        lib_line = f"torch._weight_int8pack_mm bf16 {fmt(lib_ms)} (vs plain bf16 max abs err {lib_err:.3g})"
    except Exception as exc:  # no CUDA kernel in this torch: no library yardstick
        lib_ms, lib_line = None, f"torch._weight_int8pack_mm: {type(exc).__name__}"
    m, k, n = x8.shape[0], q.shape[0], q.shape[1]
    k3_bound = card_bound(m * k * 4 + k * n + n * 4 + m * n * 4, 2 * m * k * n, F32_OPS_PER_S)
    print(
        f"phase 20 K3 (8, 25088, 512) per call (bound {k3_bound[0] * 1e3:.2f} us by {k3_bound[1]}): on the "
        f"device (graph replay) f32 {fmt(k3_dev[8, 'f32'])}, bf16 {fmt(k3_dev[8, 'bf16'])}, f32 again "
        f"{fmt(k3_again)}; from Python f32 {fmt(k3_ms[8, 'f32'])}, bf16 {fmt(k3_ms[8, 'bf16'])}; plain f32 "
        f"{fmt(plain_ms['f32'])}, bf16 {fmt(plain_ms['bf16'])}; {lib_line} {card}"
    )
    print(
        f"phase 20 K3 (1, 25088, 512) per call: on the device f32 {fmt(k3_dev[1, 'f32'])}, bf16 "
        f"{fmt(k3_dev[1, 'bf16'])}; from Python f32 {fmt(k3_ms[1, 'f32'])}, bf16 {fmt(k3_ms[1, 'bf16'])} {card}"
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
            "python_ms": k3_ms[8, "f32"][0],
            "plain_ms": plain_ms["f32"][0],
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
            "library_ms": None if lib_ms is None else lib_ms[0],
        },
    }


GPU_TESTS = ("-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-m", "gpu", "-rs",
             "tests/test_torch_kernels_gpu.py")


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
    with ThreadPoolExecutor(max_workers=len(sources) + len(K1_VARIANTS)) as pool:
        variant_jobs = [pool.submit(build_k1_variant, name) for name in K1_VARIANTS]
        list(pool.map(build.build, sources))
        k1_variants = dict(job.result() for job in variant_jobs)
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
    int8 = int8_phases(dev, rng, face, card, e_sd, q_sd, fas_pairs[:BATCH])
    by_path["int8_extract"] = int8["counts"]
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
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
