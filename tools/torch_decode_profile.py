#!/usr/bin/env python3
"""Where a decode tick of the port's serving arena spends its time, on the
CUDA card: GPTConfig.small() (float32, seeded random weights) in
BatchedDecoder(slots=8, capacity=2048), contiguous, paged
(pages=8*32+8, page_size=64) and paged with int8 KV (kv_dtype="int8"),
8 requests of 32 prompt tokens kept busy, at each ``--decode-steps``
k (a tick of k steps; 1 by default).

For each mode and k it runs a warm-up, times ``--ticks`` decode ticks on
the host clock with the profiler off, then profiles as many more with
torch.profiler, and prints: host wall ms per tick (profiler off, and
on) and per token, device busy ms per tick (the sum of CUDA kernel and
memcpy times), the device's idle share against the profiler-off wall
time, device ops per tick, and the kernels with the most device time.

    python3 tools/torch_decode_profile.py [--ticks 20] [--decode-steps 1 4]

``--interleave R`` instead compares decode_steps=1 with decode_steps=4 on
the host clock, contiguous and paged: two full arenas side by side, R
rounds in the order k=1, k=4, k=4, k=1 (then reversed), each timing 32
tokens a slot (32 ticks of k=1 or 8 of k=4), and prints every round's
host ms per token and the medians, since single host-clock readings of
a tick spread by 15-25% in one process on the card's machine.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def profile_mode(torch, model, mode, kw, ticks, k=1):
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import BatchedDecoder

    dec = BatchedDecoder(model, slots=8, capacity=2048, decode_steps=k,
                         **kw)
    mode = f"{mode} k={k}"
    rng = torch.Generator().manual_seed(2)
    for _ in range(8):
        dec.submit(torch.randint(1, 32000, (32,), generator=rng).tolist(),
                   (2 * ticks + 8) * k)
    with torch.inference_mode():
        dec._admit()
        for _ in range(4):                       # warm-up ticks
            dec._step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            dec._step()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                dec._step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"[{mode}] {ticks} ticks: host wall "
          f"{1e3 * plain_wall / ticks:.3f} ms per tick (profiler on: "
          f"{1e3 * wall / ticks:.3f}), {1e3 * plain_wall / ticks / (8 * k):.4f}"
          f" ms per token, device busy "
          f"{busy_us / 1e3 / ticks:.3f} ms per tick, device idle share "
          f"{1 - busy_us / 1e6 / plain_wall:.3f}, "
          f"{launches / ticks:.1f} device ops per tick")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[{mode}]   {e.self_device_time_total / 1e3 / ticks:8.4f} "
              f"ms/tick x{e.count // ticks:3d}  {e.key[:90]}")


def interleave(torch, model, mode, kw, rounds):
    from paddle_tpu_torch.serving import BatchedDecoder

    decs = {}
    for k in (1, 4):
        decs[k] = BatchedDecoder(model, slots=8, capacity=2048,
                                 decode_steps=k, **kw)
        rng = torch.Generator().manual_seed(2)
        for _ in range(8):
            decs[k].submit(
                torch.randint(1, 32000, (32,), generator=rng).tolist(),
                32 * (rounds + 2))
    per_token = {1: [], 4: []}
    order = [1, 4, 4, 1, 4, 1, 1, 4]
    with torch.inference_mode():
        for k, dec in decs.items():
            dec._admit()
            for _ in range(32 // k):             # a warm-up round
                dec._step()
        for r in range(rounds):
            k = order[r % len(order)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(32 // k):
                decs[k]._step()
            torch.cuda.synchronize()
            per_token[k].append(1e3 * (time.perf_counter() - t0) / 256)
    med = {k: sorted(v)[len(v) // 2] for k, v in per_token.items()}
    print(f"[{mode} interleaved] host ms per token, {rounds} rounds of 32 "
          f"tokens a slot: k=1 {[round(x, 4) for x in per_token[1]]}, k=4 "
          f"{[round(x, 4) for x in per_token[4]]}; medians k=1 "
          f"{med[1]:.4f}, k=4 {med[4]:.4f} ({med[4] / med[1]:.3f}x)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--decode-steps", type=int, nargs="+", default=[1])
    ap.add_argument("--interleave", type=int, default=0)
    args = ap.parse_args()
    from paddle_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = gpt.GPTForCausalLM(gpt.GPTConfig.small(), generator=gen).eval()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"[card] {smi.stdout.strip()}")
    paged = dict(pages=8 * 32 + 8, page_size=64)
    if args.interleave:
        interleave(torch, model, "contiguous", {}, args.interleave)
        interleave(torch, model, "paged", paged, args.interleave)
        interleave(torch, model, "paged-int8", dict(paged, kv_dtype="int8"),
                   args.interleave)
        return 0
    for k in args.decode_steps:
        profile_mode(torch, model, "contiguous", {}, args.ticks, k)
        profile_mode(torch, model, "paged", paged, args.ticks, k)
        profile_mode(torch, model, "paged-int8",
                     dict(paged, kv_dtype="int8"), args.ticks, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
