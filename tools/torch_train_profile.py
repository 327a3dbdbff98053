#!/usr/bin/env python3
"""Where a training step of the port spends its time, on the CUDA card:
bench_gpt's configuration (bench.py:411-440) — GPTConfig.small() with
remat, max_position 1024, float32 (TF32 off), seeded random weights, one
(8, 1024) batch of seeded ids — under Trainer with Adam(1e-3).

It runs two warm-up steps, times ``--steps`` steps on the host clock with
the profiler off (each ends in a synchronize), then profiles as many more
with torch.profiler, and prints: host wall ms per step (profiler off,
and on), device busy ms per step (the sum of CUDA kernel and memcpy
times), the device's idle share against the profiler-off wall time,
device ops per step, device ms per step by kind (the three flash
kernels, GEMMs, everything else), and the kernels with the most device
time.

    python3 tools/torch_train_profile.py [--steps 5]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

KINDS = (("flash forward", ("flash_fwd_kernel",)),
         ("flash dq", ("flash_dq_kernel",)),
         ("flash dk/dv", ("flash_dkv_kernel",)),
         ("GEMM", ("gemm", "xmma", "cutlass", "splitKreduce")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other (elementwise, reductions, copies)"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"[card] {smi.stdout.strip()}")
    cfg = gpt.GPTConfig.small()
    cfg.max_position, cfg.remat = 1024, True
    model = gpt.GPTForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(5))
    ids = torch.randint(0, cfg.vocab_size, (8, 1024),
                        generator=torch.Generator().manual_seed(6)).cuda()
    trainer = Trainer(model, optimizer.Adam(1e-3),
                      lambda m, batch, g: (m.forward_loss(batch), {}))

    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_step(ids)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(2)                                          # warm-up
    plain_wall = run(args.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run(args.steps)
    n = args.steps
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    ops = sum(e.count for e in events)
    print(f"[train] {n} steps: host wall {1e3 * plain_wall / n:.3f} ms per "
          f"step (profiler on: {1e3 * wall / n:.3f}), device busy "
          f"{busy_us / 1e3 / n:.3f} ms per step, device idle share "
          f"{1 - busy_us / 1e6 / plain_wall:.3f}, {ops / n:.1f} device ops "
          f"per step, {8 * 1024 * n / plain_wall:.1f} tokens/s")
    by_kind = {}
    for e in events:
        k = kind_of(e.key)
        t, c = by_kind.get(k, (0.0, 0))
        by_kind[k] = (t + e.self_device_time_total, c + e.count)
    for k, (t, c) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"[train]   {t / 1e3 / n:9.3f} ms/step ({100 * t / busy_us:5.1f}"
              f"%) x{c // n:5d}  {k}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[train]   {e.self_device_time_total / 1e3 / n:9.3f} ms/step "
              f"x{e.count // n:4d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
