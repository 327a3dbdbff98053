#!/usr/bin/env python3
"""Float32 accuracy of the flash-attention kernels on the CUDA card,
against a float64 reference. For each of chip_smoke.py's flash cases,
and a longer walk (B=1, T=2048, H=12, Hkv=1: dk/dv sum over 12 x 2048
query rows), the same inputs go through the forward
(``flash_attention_fwd``: o and lse), its plain version and a float64
version of the same formulas; then the kernel's lse and delta go
through the backward pair (``flash_attention_dq``,
``flash_attention_dkv``), their plain versions and the float64 formulas.
Printed per case: the max abs error of o, lse, dq, dk and dv for kernel
against float64, plain against float64, and kernel against plain (what
chip_smoke.py holds to 1e-4), with the largest |dv|; last, each
output's worst ratio of the kernel's error to the plain version's.

    python3 tools/torch_flash_accuracy.py [--tree DIR]

--tree: the checkout whose ``paddle_tpu_torch`` is measured (default:
this one), so that a commit and its parent, unpacked with ``git
archive``, can be compared on the same card. The cases and inputs come
from this checkout's chip_smoke.py.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG_WALK = (1, 2048, 2048, 12, 1, 64, True, None, False)


def forward64(FK, q, k, v, kw):
    """o and lse in float64 from the forward's formulas: the masked
    softmax over the live keys; a row with none gets o = 0 and lse equal
    to the kernels' float32 -1e30."""
    import torch

    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q5 = q.double().reshape(b, tq, hkv, g, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", q5, k.double()) * kw["scale"]
    keep = FK._keep(b, tq, tk, kw["causal"], kw["window"], kw["kv_mask"],
                    q.device)
    s = torch.where(keep, s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    live = torch.isfinite(m)
    p = torch.exp(s - torch.where(live, m, 0.0))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqt,btkd->bkgqd", p, v.double()) / torch.where(
        live, l, 1.0)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d)
    dead = torch.tensor(FK.NEG_INF, dtype=torch.float32).double()
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)),
                      dead)[..., 0]
    return o, lse.reshape(b, h, tq)


def reference64(FK, q, k, v, do, lse, delta, kw):
    """dq, dk, dv in float64 from the kernels' formulas: p = exp(s - lse)
    where the entry is kept and the row has a live key, ds = p * (dp -
    delta) * scale, dk and dv summed over each GQA group."""
    import torch

    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q5 = q.double().reshape(b, tq, hkv, g, d)
    do5 = do.double().reshape(b, tq, hkv, g, d)
    k64, v64 = k.double(), v.double()
    s = torch.einsum("bqkgd,btkd->bkgqt", q5, k64) * kw["scale"]
    keep = FK._keep(b, tq, tk, kw["causal"], kw["window"], kw["kv_mask"],
                    q.device)
    lse5 = lse.double().reshape(b, hkv, g, tq)[..., None]
    p = torch.where(keep & (lse5 > FK.NEG_INF / 2), torch.exp(s - lse5),
                    0.0)
    del s
    dp = torch.einsum("bqkgd,btkd->bkgqt", do5, v64)
    ds = p * (dp - delta.double().reshape(b, hkv, g, tq)[..., None]) \
        * kw["scale"]
    del dp
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k64).reshape(b, tq, h, d)
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, q5)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p, do5)
    return dq, dk, dv


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE, help="checkout whose "
                    "paddle_tpu_torch is measured (default: this one)")
    ap.add_argument("--seed", type=int, default=4)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import paddle_tpu_torch
    from paddle_tpu_torch.ops.kernels import flash_attention as FK

    if not os.path.abspath(paddle_tpu_torch.__file__).startswith(tree):
        print(f"paddle_tpu_torch came from {paddle_tpu_torch.__file__}, "
              f"not {tree}", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}; tree {tree}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    names = ("o", "lse", "dq", "dk", "dv")
    worst = dict.fromkeys(names, 0.0)
    for case in CS.FLASH_CASES + [LONG_WALK]:
        q, k, v, do, km = CS.flash_inputs(torch, case, torch.float32, gen)
        kw = CS.flash_kw(case, km)
        o, lse = FK.flash_attention_fwd(q, k, v, **kw)
        fwd_plain = FK.flash_attention_fwd_plain(q, k, v, **kw)
        fwd_ref = forward64(FK, q, k, v, kw)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        args_ = (q, k, v, do, lse, delta)
        kern = (o, lse, FK.flash_attention_dq(*args_, **kw),
                *FK.flash_attention_dkv(*args_, **kw))
        plain = (*fwd_plain, FK.flash_attention_dq_plain(*args_, **kw),
                 *FK.flash_attention_dkv_plain(*args_, **kw))
        ref = (*fwd_ref, *reference64(FK, *args_, kw))

        def err(xs, ys):
            return [(x.double() - y.double()).abs().max().item()
                    for x, y in zip(xs, ys)]

        ek, ep, ekp = err(kern, ref), err(plain, ref), err(kern, plain)
        for n, a, b in zip(names, ek, ep):
            worst[n] = max(worst[n], a / b if b else float("inf"))

        def fmt(es):
            return " ".join(f"{n} {e:.3e}" for n, e in zip(names, es))

        print(f"[acc] {case}: kernel-f64 {fmt(ek)} | plain-f64 {fmt(ep)} "
              f"| kernel-plain {fmt(ekp)} | max |dv| "
              f"{ref[4].abs().max().item():.2f}", flush=True)
        del args_, kern, plain, ref, fwd_plain, fwd_ref, q, k, v, do, o, \
            lse, delta
        torch.cuda.empty_cache()
    print("[acc] worst kernel-f64 / plain-f64: " + " ".join(
        f"{n} {r:.2f}" for n, r in worst.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
