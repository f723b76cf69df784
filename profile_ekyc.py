#!/usr/bin/env python3
"""Where the eKYC path's time goes on a CUDA card.

Run from the root of a checkout, with one card:

    python3 profile_ekyc.py

It sits beside chip_smoke.py and takes its seed and inputs from it.  Builds
the models of chip_smoke.py's eKYC phase (full-width seeded SCRFD,
IResNet-50, two ResNet-18 heads and two clip_l14 towers in bf16; TF32 off)
and, after a warm-up, measures three workloads: one clip_l14 tower at b8,
SCRFD ``detect_batch`` at b8 on 640x640 canvases, and ``verify_images`` on
one (card, selfie) pair.  For each it prints the host wall time per call
(calls ending in a synchronize, unprofiled), the device busy time per call
(the sum of the CUDA kernels and copies that torch.profiler records over
the same number of calls), the idle share 1 - busy / wall, the number of
device operations per call, and the device time of the heaviest kernels.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))


def profile(name, fn, calls, card):
    import torch
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    n_ops = 0
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            by_name[event.name] += event.time_range.elapsed_us() / 1e3 / calls
            n_ops += 1
    busy = sum(by_name.values())
    print(
        f"{name}: wall {wall:.3f} ms/call, device busy {busy:.3f} ms/call, idle share "
        f"{1.0 - busy / wall:.3f}, {n_ops / calls:.0f} device ops/call {card}"
    )
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {100 * ms / busy:5.1f}%  {ms:.4f} ms  {kname[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_ekyc: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from rs_face_detection_tpu_torch.ops.image import letterbox_u8_batch
    from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import EKYCPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = "[" + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0] + "]"
    rng = np.random.default_rng(chip_smoke.SEED)
    face = np.load(os.path.join(ROOT, "tests", "fixtures", "real_face_crop.npz"))["face"]
    pipe = EKYCPipeline(device="cuda")
    det = pipe.detection
    tower = pipe.heads["fas_crop"][0]
    x8 = torch.from_numpy(rng.normal(size=(8, 3, 224, 224)).astype(np.float32)).cuda()
    canvases, _ = letterbox_u8_batch(chip_smoke.make_frames(rng, 8, face), 640, 640, torch.device("cuda"))
    scales = torch.ones(8)
    card_img, selfie = chip_smoke.ekyc_pairs(rng, face, 1)[0]
    with torch.no_grad():
        profile("clip_l14 tower b8 bf16", lambda: tower(x8), 5, card)
        profile("SCRFD detect_batch b8 at 640", lambda: det.detect_batch(canvases, scales), 5, card)
    profile("verify_images, one pair", lambda: pipe.verify_images(card_img, selfie), 5, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
