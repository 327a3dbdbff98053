#!/usr/bin/env python3
"""Where the port's int8 MnistMLP forward spends its time, on the CUDA
card: MnistMLP(512, 256) with seeded weights, PTQ'd as ``chip_smoke.py``
does it (quantize_model, calibrate on 4 seeded (8, 784) batches, freeze,
int8_swap), then forwards at batch 8192; the float32 MnistMLP beside it.

For each model it runs a warm-up, times ``--iters`` forwards on the host
clock with the profiler off, then profiles as many more with
torch.profiler, and prints: host wall ms per forward (profiler off, and
on), device busy ms per forward (the sum of CUDA kernel and memcpy
times), the device's idle share against the profiler-off wall time,
device ops per forward, and every kernel with its device time.

    python3 tools/torch_int8_mlp_profile.py [--iters 50]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BATCH = 8192


def profile_model(torch, model, x, name, iters):
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
    print(f"[{name}] {iters} forwards at batch {BATCH}: host wall "
          f"{1e3 * plain_wall / iters:.4f} ms per forward (profiler on: "
          f"{1e3 * wall / iters:.4f}), device busy "
          f"{busy_us / 1e3 / iters:.4f} ms per forward, device idle share "
          f"{1 - busy_us / 1e6 / plain_wall:.3f}, "
          f"{launches / iters:.1f} device ops per forward")
    for e in sorted(events, key=lambda e: -e.self_device_time_total):
        print(f"[{name}]   {e.self_device_time_total / 1e3 / iters:8.4f} "
              f"ms/forward x{e.count // iters:3d}  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.models.mnist import MnistMLP

    torch.backends.cuda.matmul.allow_tf32 = False

    def mlp():
        return MnistMLP(512, 256, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(9)).eval()

    fmodel, model = mlp(), quant.quantize_model(mlp())
    rng = torch.Generator().manual_seed(10)
    calib = [torch.randn(8, 784, generator=rng).to("cuda")
             for _ in range(4)]
    x = torch.randn(BATCH, 784, generator=rng).to("cuda")
    quant.calibrate(model, calib)
    with torch.no_grad():
        swapped = quant.int8_swap(model, quant.freeze(model))
    if swapped != 3:
        print(f"int8_swap swapped {swapped} layers, not 3", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"[card] {smi.stdout.strip()}")
    profile_model(torch, model, x, "int8", args.iters)
    profile_model(torch, fmodel, x, "float32", args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
