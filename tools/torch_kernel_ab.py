#!/usr/bin/env python3
"""Times the decode-attention, int8 and flash-attention kernels, the
serving arenas and the int8 MnistMLP forward of the ``paddle_tpu_torch``
package found in one checkout, on the CUDA card, so that two checkouts
(a commit and its parent, say, unpacked with ``git archive``) can be
compared inside one run on the same card. Run each tree in its own
process, in the order parent, change, change, parent:

    python3 tools/torch_kernel_ab.py --tree path/to/parent
    python3 tools/torch_kernel_ab.py            # this checkout

Kernel times are CUDA-event means over ``--iters`` launches, the L2
flushed (a 256 MB write) before each, by two methods that differ in one
step: "flush" opens the event window right after the flush is queued
(the host's time in the wrapper before its launch falls inside the
window once the flush has ended), "sleep" queues a 100k-cycle device
sleep after the flush, so the card is still busy when the wrapper
launches (chip_smoke.py's method). Both are printed for every kernel.

Measured, each at the shapes chip_smoke.py uses:
- the three decode forms (B=8, cap=2048, H=12, Hkv=4, D=64, float32;
  int8 pools quantized from the same floats) at three sets of cursors:
  chip_smoke.py's (0-2047, paged: last row parked), a serving tick's
  (40-75, one live chunk of the split per row) and long contexts
  (1280-2000);
- quant_matmul at MNIST's three layer shapes (batch 8192, per-channel,
  float32 out), through its public (K, N) entry point, and quant_linear
  where the tree has it;
- the int8 MnistMLP(512, 256) PTQ forward at batch 8192 and the float32
  one: host wall ms per forward back to back (--iters forwards, one
  synchronize at the end) and the event times;
- BatchedDecoder serving GPTConfig.small() (float32, weights seed 0):
  contiguous, paged and paged int8, each with chip_smoke.py's 16 short
  requests (prompts of 8-48 tokens) and with 8 long ones (1200-1900
  tokens), max_new 32: tokens/s, ms per tick and a digest of the tokens,
  for each of --serve-repeats runs;
- the host time per decode-wrapper call: --iters calls queued back to
  back with no synchronize between them;
- the flash-attention kernels at the training shape (B=8, T=1024, H=12,
  Hkv=4, D=64, causal), float32 and bfloat16: the forward, dq, dk/dv and
  the whole backward as the training step runs it (delta = rowsum(do *
  o), dq, dk/dv), beside torch's scaled_dot_product_attention backward
  alone on a kept graph (a yardstick the port never calls), and the
  kernels' max abs error against their plain versions (the forward's o
  and lse, the backward's dq, dk and dv).

Prints one line per number and, last, one JSON object of them all.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

B, CAP, H, HKV, D, PS = 8, 2048, 12, 4, 64, 64
PAGES = B * CAP // PS + 8
CURSORS = {
    "smoke": ([0, 63, 64, 700, 1023, 1024, 1777, 2047],
              [0, 63, 64, 700, 1024, 1777, 2047, CAP]),
    "serving": ([40, 45, 50, 55, 60, 65, 70, 75],
                [40, 45, 50, 55, 60, 65, 70, 75]),
    "long": ([1280, 1400, 1500, 1600, 1700, 1800, 1900, 2000],
             [1280, 1400, 1500, 1600, 1700, 1800, 1900, 2000]),
}
MNIST_SHAPES = [(8192, 784, 512), (8192, 512, 256), (8192, 256, 10)]


def time_ms(torch, fn, flush, sleep, n):
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        if sleep:
            torch.cuda._sleep(100_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / n


def both(torch, fn, flush, n):
    return {"flush": time_ms(torch, fn, flush, False, n),
            "sleep": time_ms(torch, fn, flush, True, n)}


def decode_rows(torch, flush, n, out):
    from paddle_tpu_torch.ops.kernels import decode_attention as K
    from paddle_tpu_torch.quant.ops import absmax_encode

    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = rand(B, 1, H, D)
    k, v = rand(B, CAP, HKV, D), rand(B, CAP, HKV, D)
    kp, vp = rand(PAGES, PS, HKV, D), rand(PAGES, PS, HKV, D)
    table = torch.randperm(PAGES, generator=gen, device="cuda")
    table = table[:B * (CAP // PS)].reshape(B, CAP // PS).to(torch.int32)
    kq, ks = absmax_encode(kp, axis=-1)
    vq, vs = absmax_encode(vp, axis=-1)
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    for label, (tc, tp) in CURSORS.items():
        t_c = torch.tensor(tc, dtype=torch.int32, device="cuda")
        t_p = torch.tensor(tp, dtype=torch.int32, device="cuda")
        cases = {
            "decode_attention": lambda: K.decode_attention(q, k, v, t_c),
            "decode_attention_paged": lambda: K.decode_attention_paged(
                q, kp, vp, table, t_p),
            "decode_attention_paged_quant":
                lambda: K.decode_attention_paged_quant(
                    q, kq, ks, vq, vs, table, t_p),
        }
        for name, fn in cases.items():
            key = f"{name}@{label}"
            out[key] = both(torch, fn, flush, n)
            # host time per call: n calls queued back to back
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            out[key]["host_us"] = 1e6 * (time.perf_counter() - t0) / n
            torch.cuda.synchronize()
            print(f"[ab] {key}: flush {out[key]['flush']:.4f} ms, sleep "
                  f"{out[key]['sleep']:.4f} ms; host "
                  f"{out[key]['host_us']:.1f} us per call", flush=True)


def gemm_rows(torch, flush, n, out):
    from paddle_tpu_torch.ops.kernels import quant_matmul as QM

    gen = torch.Generator(device="cuda").manual_seed(11)
    for m, k, nn in MNIST_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        b = torch.randint(-127, 128, (k, nn), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        sa = torch.rand((1,), generator=gen, device="cuda") * 0.01
        sb = torch.rand((nn,), generator=gen, device="cuda") * 0.01
        key = f"quant_matmul@{m}x{k}x{nn}"
        out[key] = both(torch, lambda: QM.quant_matmul(a, b, sa, sb), flush,
                        n)
        print(f"[ab] {key}: flush {out[key]['flush']:.4f} ms, sleep "
              f"{out[key]['sleep']:.4f} ms", flush=True)
        if hasattr(QM, "quant_linear"):
            x = torch.randn(m, k, generator=gen, device="cuda") * 2
            bias = torch.randn(nn, generator=gen, device="cuda")
            w = QM.pack_weight(b)
            key = f"quant_linear@{m}x{k}x{nn}"
            out[key] = both(torch, lambda: QM.quant_linear(
                x, w, sa, sb, bias, True), flush, n)
            print(f"[ab] {key}: flush {out[key]['flush']:.4f} ms, sleep "
                  f"{out[key]['sleep']:.4f} ms", flush=True)


def mlp_rows(torch, flush, n, out):
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.models.mnist import MnistMLP

    def mlp():
        return MnistMLP(512, 256, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(9)).eval()

    fmodel, model = mlp(), quant.quantize_model(mlp())
    rng = torch.Generator().manual_seed(10)
    calib = [torch.randn(8, 784, generator=rng).to("cuda")
             for _ in range(4)]
    x = torch.randn(8192, 784, generator=rng).to("cuda")
    quant.calibrate(model, calib)
    with torch.no_grad():
        quant.int8_swap(model, quant.freeze(model))
        for name, mod in (("int8", model), ("float32", fmodel)):
            for _ in range(5):
                mod(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                mod(x)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / n
            key = f"mnist_forward_{name}"
            out[key] = dict(both(torch, lambda: mod(x), flush, n),
                            host_wall=wall)
            print(f"[ab] {key}: host wall {wall:.4f} ms per forward; "
                  f"events flush {out[key]['flush']:.4f} ms, sleep "
                  f"{out[key]['sleep']:.4f} ms", flush=True)


def flash_rows(torch, flush, n, out):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as FK

    b, t, h, hkv, d = 8, 1024, 12, 4, 64
    kw = dict(causal=True, scale=d ** -0.5, window=None, kv_mask=None)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(7)

        def rand(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(
                dtype)

        q, k, v = rand(b, t, h, d), rand(b, t, hkv, d), rand(b, t, hkv, d)
        do = rand(b, t, h, d)
        o, lse = FK.flash_attention_fwd(q, k, v, **kw)

        def delta():
            return (do.float() * o.float()).sum(-1).transpose(
                1, 2).contiguous()

        dl = delta()

        def whole_bwd():
            dl = delta()
            FK.flash_attention_dq(q, k, v, do, lse, dl, **kw)
            FK.flash_attention_dkv(q, k, v, do, lse, dl, **kw)

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        dot = do.transpose(1, 2)
        cases = {
            "flash_attention_fwd": lambda: FK.flash_attention_fwd(q, k, v,
                                                                  **kw),
            "flash_attention_dq": lambda: FK.flash_attention_dq(
                q, k, v, do, lse, dl, **kw),
            "flash_attention_dkv": lambda: FK.flash_attention_dkv(
                q, k, v, do, lse, dl, **kw),
            "flash_backward": whole_bwd,
            "sdpa_backward": lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True),
        }
        dname = str(dtype).split(".")[-1]
        for name, fn in cases.items():
            key = f"{name}@{dname}"
            out[key] = both(torch, fn, flush, n)
            print(f"[ab] {key}: flush {out[key]['flush']:.4f} ms, sleep "
                  f"{out[key]['sleep']:.4f} ms", flush=True)
        o_p, lse_p = FK.flash_attention_fwd_plain(q, k, v, **kw)
        err = max((o.float() - o_p.float()).abs().max().item(),
                  (lse - lse_p).abs().max().item())
        out[f"flash_forward_err@{dname}"] = err
        print(f"[ab] flash_forward_err@{dname}: o/lse max abs err against "
              f"the plain version {err:.3e}", flush=True)
        del o_p, lse_p
        dq = FK.flash_attention_dq(q, k, v, do, lse, dl, **kw)
        dk, dv = FK.flash_attention_dkv(q, k, v, do, lse, dl, **kw)
        dq_p = FK.flash_attention_dq_plain(q, k, v, do, lse, dl, **kw)
        dk_p, dv_p = FK.flash_attention_dkv_plain(q, k, v, do, lse, dl,
                                                  **kw)
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in ((dq, dq_p), (dk, dk_p), (dv, dv_p)))
        out[f"flash_backward_err@{dname}"] = err
        print(f"[ab] flash_backward_err@{dname}: dq/dk/dv max abs err "
              f"against the plain versions {err:.3e}", flush=True)
        del sdpa_out


def serving_rows(torch, out, repeats):
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import BatchedDecoder

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = gpt.GPTForCausalLM(gpt.GPTConfig.small(), generator=gen).eval()
    rng = torch.Generator().manual_seed(1)
    lens = torch.randint(8, 49, (16,), generator=rng).tolist()
    short = [torch.randint(1, 32000, (n,), generator=rng).tolist()
             for n in lens]
    rng = torch.Generator().manual_seed(3)
    lens = torch.randint(1200, 1901, (8,), generator=rng).tolist()
    long = [torch.randint(1, 32000, (n,), generator=rng).tolist()
            for n in lens]
    paged = dict(pages=B * 32 + 8, page_size=PS)
    modes = {"contiguous": {}, "paged": paged,
             "paged-int8": dict(paged, kv_dtype="int8")}
    for mode, kw in modes.items():
        warm = BatchedDecoder(model, slots=8, capacity=CAP, device="cuda",
                              **kw)
        warm.submit(short[0], 2)
        warm.run()
        del warm
        for label, prompts in (("short", short), ("long", long)):
            key = f"serve_{mode}@{label}"
            out[key] = []
            for _ in range(repeats):
                dec = BatchedDecoder(model, slots=8, capacity=CAP,
                                     device="cuda", **kw)
                rids = [dec.submit(p, 32) for p in prompts]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = dec.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                toks = [int(x) for r in rids for x in res[r]]
                row = dict(
                    tokens_per_s=len(toks) / wall,
                    ms_per_tick=1e3 * dec.tick_seconds / dec.tick_count,
                    ticks=dec.tick_count,
                    digest=hashlib.sha256(
                        str(toks).encode()).hexdigest()[:12])
                out[key].append(row)
                print(f"[ab] {key}: {row['tokens_per_s']:.1f} tokens/s, "
                      f"{row['ms_per_tick']:.3f} ms per tick over "
                      f"{row['ticks']} ticks, tokens {row['digest']}",
                      flush=True)
                del dec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose paddle_tpu_torch "
        "is timed (default: this one)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--serve-repeats", type=int, default=1,
                    help="served runs of each arena and prompt set")
    ap.add_argument("--sections", default="decode,gemm,mlp,serve,flash",
                    help="comma-separated subset of decode,gemm,mlp,serve,"
                    "flash")
    args = ap.parse_args()
    sections = set(args.sections.split(","))
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import paddle_tpu_torch

    if not os.path.abspath(paddle_tpu_torch.__file__).startswith(tree):
        print(f"paddle_tpu_torch came from {paddle_tpu_torch.__file__}, "
              f"not {tree}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}; tree {tree}", flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = {"tree": tree, "card": smi}
    if "decode" in sections:
        decode_rows(torch, flush, args.iters, out)
    if "gemm" in sections:
        gemm_rows(torch, flush, args.iters, out)
    if "mlp" in sections:
        mlp_rows(torch, flush, args.iters, out)
    if "serve" in sections:
        serving_rows(torch, out, args.serve_repeats)
    if "flash" in sections:
        flash_rows(torch, flush, args.iters, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
