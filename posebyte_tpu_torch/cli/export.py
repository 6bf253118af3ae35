"""export_engine on the port: convert a checkpoint to the JAX package's
safetensors format, with int8 calibration, after posebyte_tpu/cli/export.py
(reference: src/export_engine.cpp:20-98, `-m model -o out -p
{fp32,fp16,int8} [-b batch] [-c calib]`): import the weights (.pt or
.safetensors), quantise and calibrate for int8, write the safetensors file
(either package loads it), then run one forward on the device at (batch,
size) and print its time, as the JAX package warms its compile cache.
--aot PATH also writes the locked engine: the forward with the weights
baked in, exported by torch.export for the device (models/aot.py; the JAX
package writes StableHLO).

Usage:
  python -m posebyte_tpu_torch.cli.export -m yolov8n-pose.pt \\
      -o out.safetensors [-p {fp32,bf16,int8}] [-b BATCH] [-c calib_dir] \\
      [--aot engine.pt2] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    from .demo import add_device_flag
    p = argparse.ArgumentParser(prog="export_engine")
    p.add_argument("-m", "--model", required=True,
                   help="Ultralytics .pt checkpoint or .safetensors")
    p.add_argument("-o", "--output", required=True,
                   help="output .safetensors path")
    p.add_argument("-p", "--precision", default="bf16",
                   choices=["fp32", "fp16", "bf16", "int8"],
                   help="fp16 is accepted as an alias for bf16")
    p.add_argument("-b", "--batch", type=int, default=1,
                   help="batch of the warm forward")
    p.add_argument("-c", "--calib", default="",
                   help="calibration image directory (int8; needs cv2)")
    p.add_argument("--calib-cache", default="",
                   help="int8 activation-scale cache file: loaded if it "
                        "exists (no image calibration), written after "
                        "calibrating otherwise")
    p.add_argument("--calib-method", default="percentile",
                   choices=["percentile", "entropy"],
                   help="int8 activation calibration: percentile (99.9th "
                        "percentile, the default) or entropy (the "
                        "reference's KL clip search)")
    p.add_argument("--allow-synthetic-calib", action="store_true",
                   help="permit int8 calibration on synthetic frames when "
                        "no images or cache are given (unvalidated scales;"
                        " default is weight-only int8)")
    p.add_argument("--size", type=int, default=640,
                   help="input size (default 640)")
    p.add_argument("--no-compile", action="store_true",
                   help="skip the warm forward")
    p.add_argument("--aot", default="",
                   help="also write a locked engine (torch.export, the "
                        "weights baked in, for the device) to this path")
    add_device_flag(p)
    args = p.parse_args(argv)

    from .demo import load_model_params, resolve
    device = resolve(args.device)

    import torch
    from ..core.device import set_numeric_settings
    from ..models.weights import save_params

    # Calibration runs the model before any pipeline exists: the numeric
    # settings (TF32 off) come first, as a pipeline would set them.
    set_numeric_settings()
    precision = {"fp16": "bf16"}.get(args.precision, args.precision)
    params, name = load_model_params(args.model)

    if precision == "int8":
        from ..models.quant import calibrate_and_quantize
        params = calibrate_and_quantize(
            params, name, args.calib, args.size,
            cache_path=args.calib_cache,
            synthetic_fallback=args.allow_synthetic_calib,
            method=args.calib_method, device=device)

    save_params(params, args.output, name)
    size_mb = os.path.getsize(args.output) / 1e6
    print(f"[export] saved {name} ({precision}) -> {args.output} "
          f"({size_mb:.1f} MB)")

    if args.aot:
        from ..models.aot import export_engine_aot
        dt = torch.float32 if precision == "fp32" else torch.bfloat16
        size = export_engine_aot(params, name, args.aot, args.batch,
                                 args.size, dt, device)
        print(f"[export] AOT engine -> {args.aot} ({size / 1e6:.1f} MB)")

    if not args.no_compile:
        from ..models.layers import prepare_params
        from ..models.yolo_pose import MODEL_CONFIGS, forward_heads
        dtype = torch.float32 if precision == "fp32" else torch.bfloat16
        prepared = prepare_params(params, dtype, device)
        x = torch.zeros((args.batch, args.size, args.size, 3), dtype=dtype,
                        device=device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            forward_heads(prepared, x, MODEL_CONFIGS[name].family)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"[export] warm forward ({args.batch}x{args.size}, "
              f"{device.type}): {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
