#!/usr/bin/env python3
"""Where the port's int8 forward spends its time, on the CUDA card, with
the float32 model beside it. ``--model mlp`` (the default):
MnistMLP(512, 256) with seeded weights, PTQ'd as ``chip_smoke.py`` does
it (quantize_model, calibrate on 4 seeded (8, 784) batches, freeze,
int8_swap), forwards at batch 8192. ``--model resnet50``: resnet50(1000),
NHWC, as ``chip_smoke.py`` ``[int8:resnet50]`` PTQs it (4 seeded (8, 3,
224, 224) batches; 53 Conv2D and the head swapped), forwards at batch
32; the 20 kernels with the most device time are printed.

For each model it runs a warm-up, times ``--iters`` forwards on the host
clock with the profiler off, then profiles as many more with
torch.profiler, and prints: host wall ms per forward (profiler off, and
on), device busy ms per forward (the sum of CUDA kernel and memcpy
times), the device's idle share against the profiler-off wall time,
device ops per forward, and every kernel with its device time.

    python3 tools/torch_int8_mlp_profile.py [--iters 50]
        [--model mlp resnet50]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

def profile_model(torch, model, x, name, iters, top=None):
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(5):                       # warm-up
            model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"[{name}] {iters} forwards at batch {x.shape[0]}: host wall "
          f"{1e3 * plain_wall / iters:.4f} ms per forward (profiler on: "
          f"{1e3 * wall / iters:.4f}), device busy "
          f"{busy_us / 1e3 / iters:.4f} ms per forward, device idle share "
          f"{1 - busy_us / 1e6 / plain_wall:.3f}, "
          f"{launches / iters:.1f} device ops per forward")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{name}]   {e.self_device_time_total / 1e3 / iters:8.4f} "
              f"ms/forward x{e.count // iters:3d}  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--model", nargs="+", default=["mlp"],
                    choices=["mlp", "resnet50"])
    args = ap.parse_args()
    from paddle_tpu_torch import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"[card] {smi.stdout.strip()}")
    for name in args.model:
        fmodel, model, x, want = setup(torch, name)
        with torch.no_grad():
            swapped = quant.int8_swap(model, quant.freeze(model))
        if swapped != want:
            print(f"int8_swap swapped {swapped} layers, not {want}",
                  file=sys.stderr)
            return 1
        top = None if name == "mlp" else 20
        profile_model(torch, model, x, f"int8:{name}", args.iters, top)
        profile_model(torch, fmodel, x, f"float32:{name}", args.iters, top)
        del fmodel, model
        torch.cuda.empty_cache()
    return 0


def setup(torch, name):
    """(float model, calibrated quantized model, input, layers to swap)."""
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.models.mnist import MnistMLP

    if name == "mlp":
        def make():
            return MnistMLP(512, 256, device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(9)).eval()
        rng = torch.Generator().manual_seed(10)
        calib = [torch.randn(8, 784, generator=rng).to("cuda")
                 for _ in range(4)]
        x = torch.randn(8192, 784, generator=rng).to("cuda")
        want = 3
    else:
        def make():
            return resnet.resnet50(1000, data_format="NHWC", device="cuda",
                                   generator=torch.Generator(
                                       device="cuda").manual_seed(12)).eval()
        rng = torch.Generator(device="cuda").manual_seed(13)
        calib = [torch.randn(8, 3, 224, 224, generator=rng, device="cuda")
                 for _ in range(4)]
        x = torch.randn(32, 3, 224, 224, generator=rng, device="cuda")
        want = 54
    fmodel, model = make(), quant.quantize_model(make())
    quant.calibrate(model, calib)
    return fmodel, model, x, want


if __name__ == "__main__":
    sys.exit(main())
