#!/usr/bin/env python3
"""Tile shapes of the flash-attention forward kernel on the CUDA card.

Builds text variants of ``paddle_tpu_torch/csrc/flash_attention.cu``
that differ only in the forward's D = 64 tiles (``FwdTiles``: the query
rows a block owns, the width of the key tiles it walks, the blocks an SM
its launch bound asks for, the key tiles in shared memory at once, one
computed while the others load; for both input types), and two that
change how float32 splits its operands into TF32 hi and lo parts: at
every warp's fragment load (the backward's way) instead of once per
block and tile, and q too once per block (a second q tile in shared
memory). All variants build at once (one ``nvcc`` each, ``-Xptxas
-v``), and each is loaded in place of the package's library, so the
forward runs through its own wrapper.
Printed per variant: ptxas's registers, spills and barriers of the D = 64
forward, the max abs error of o and lse against the plain version over
chip_smoke.py's D = 64 flash cases (float32 and bfloat16), and the
forward's CUDA-event time at the training shape (B=8, T=1024, H=12,
Hkv=4, D=64, causal; L2 flushed and a 100k-cycle device sleep before
each launch, as chip_smoke.py times), float32 and bfloat16, in
``--rounds`` rounds over all variants in turn. Last, one JSON object.

    python3 tools/torch_flash_tiles.py [--iters 30] [--rounds 2]
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRUCT = re.compile(r"struct FwdTiles \{\n(.*?)\n\};", re.S)
TRAIN = (8, 1024, 1024, 12, 4, 64, True, None, False)

# float32 split at every warp's fragment load, as the backward does,
# instead of once per block and tile into hi and lo planes
SPLIT_PER_WARP = [
    ("  constexpr bool kSplit = sizeof(T) == 4;\n",
     "  constexpr bool kSplit = false;\n"),
    ("(sizeof(T) == 4 ? 2 * F::walk * LD * 4 : 0);  // lo planes", "0;"),
]
# float32 q split once into hi and lo planes too (a second q tile after
# the first)
Q_SPLIT_ONCE = [
    ("return sizeof(T) * (F::rows + 2 * F::stages * F::walk) * LD +",
     "return sizeof(T) * (2 * F::rows + 2 * F::stages * F::walk) * LD +"),
    ("  T* k_s = q_s + BR * LD;                   // S x KT x LD\n",
     "  T* k_s = q_s + 2 * BR * LD;\n"),
    ("      split_planes<D, NT>(vs, vl_s, KT);\n",
     "      split_planes<D, NT>(vs, vl_s, KT);\n"
     "      if (j == j_lo) split_planes<D, NT>(q_s, q_s + BR * LD, BR);\n"),
    ("template <int D, int NS>\n"
     "__device__ __forceinline__ void product_nt_planes(",
     "template <int D, int NS, int QLO>\n"
     "__device__ __forceinline__ void product_nt_planes("),
    ("    const M::A xa = M::load_a(xp + kk);\n",
     "    M::A xa;\n"
     "    ldsm4(xa.hi, xp + kk);\n"
     "    ldsm4(xa.lo, xp + QLO * LD + kk);\n"),
    ("product_nt_planes<D, NS>(s,", "product_nt_planes<D, NS, BR>(s,"),
]


def patched(src, patches, name):
    for old, new in patches:
        if old not in src:
            raise SystemExit(f"the {name} patch no longer applies: {old!r}")
        src = src.replace(old, new, 1)
    return src


def variants(src):
    """name -> source text. The tile overrides apply at D = 64 only."""
    m = STRUCT.search(src)
    if m is None:
        raise SystemExit("FwdTiles not found in the source")

    def tiles(**over):
        body = m.group(1)
        for key, val in over.items():
            body, n = re.subn(
                rf"(static constexpr int {key} = )([^;]*);",
                lambda g: f"{g.group(1)}D == 64 ? {val} : ({g.group(2)});",
                body)
            if n != 1:
                raise SystemExit(f"FwdTiles has no {key}")
        return src[:m.start(1)] + body + src[m.end(1):]

    out = {"shipped": src,
           "split_per_warp": patched(src, SPLIT_PER_WARP, "per-warp split"),
           "q_split_once": patched(src, Q_SPLIT_ONCE, "q-split"),
           "rows128_walk32": tiles(walk=32),
           "rows128_walk64": tiles(walk=64),
           "rows64_walk32": tiles(rows=64, walk=32, blocks=3),
           "stages3": tiles(stages=3)}
    return out


def build(nvcc, flags, name, text, outdir):
    src = os.path.join(outdir, f"{name}.cu")
    lib = os.path.join(outdir, f"{name}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([nvcc, *flags, "-o", lib, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    return name, lib, proc.returncode, proc.stdout


def fwd64_ptxas(log):
    """ptxas's lines for the D = 64 forward instances."""
    lines = log.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "Function properties for" in line and "flash_fwd_kernel" in line \
                and "Li64E" in line:
            keep.append(line.split("for ")[-1].strip())
            keep += [x.strip() for x in lines[i + 1:i + 3]]
    return keep


def time_ms(torch, fn, flush, n):
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(100_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as FK

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = CS.nvidia_smi_line()
    print(f"[card] {smi}", flush=True)

    with open(_build.CSRC / "flash_attention.cu") as f:
        texts = variants(f.read())
    outdir = os.path.join(HERE, "build", "flash_tiles")
    os.makedirs(outdir, exist_ok=True)
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(
            lambda kv: build(_build.nvcc(), _build.NVCC_FLAGS, kv[0], kv[1],
                             outdir), texts.items()))
    libs, out = {}, {"card": smi, "variants": {}}
    for name, lib, rc, log in built:
        if rc != 0:
            print(f"[tiles] {name}: nvcc failed (rc {rc})\n{log[-4000:]}",
                  flush=True)
            out["variants"][name] = {"build": f"failed rc {rc}"}
            continue
        libs[name] = lib
        ptx = fwd64_ptxas(log)
        out["variants"][name] = {"ptxas": ptx}
        print(f"[tiles] {name}: " + " | ".join(ptx), flush=True)

    def use(name):
        lib = ctypes.CDLL(libs[name])
        _build._loaded["flash_attention"] = lib
        return lib

    cases = [c for c in CS.FLASH_CASES if c[5] == 64]
    for name in libs:
        use(name)
        err = {}
        for dname in ("float32", "bfloat16"):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(4)
            worst = 0.0
            for case in cases:
                q, k, v, _, km = CS.flash_inputs(torch, case,
                                                 getattr(torch, dname), gen)
                kw = CS.flash_kw(case, km)
                o, lse = FK.flash_attention_fwd(q, k, v, **kw)
                o_p, lse_p = FK.flash_attention_fwd_plain(q, k, v, **kw)
                worst = max(worst,
                            (o.float() - o_p.float()).abs().max().item(),
                            (lse - lse_p).abs().max().item())
            err[dname] = worst
        out["variants"][name]["max_abs_err"] = err
        print(f"[tiles] {name}: o/lse max abs err against plain over "
              f"{len(cases)} D=64 cases: float32 {err['float32']:.3e}, "
              f"bfloat16 {err['bfloat16']:.3e}", flush=True)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    inputs = {}
    for dname in ("float32", "bfloat16"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        q, k, v, _, _ = CS.flash_inputs(torch, TRAIN, getattr(torch, dname),
                                        gen)
        inputs[dname] = (q, k, v)
    kw = CS.flash_kw(TRAIN, None)
    for r in range(args.rounds):
        for name in libs:
            use(name)
            for dname, (q, k, v) in inputs.items():
                ms = time_ms(torch, lambda: FK.flash_attention_fwd(
                    q, k, v, **kw), flush, args.iters)
                out["variants"][name].setdefault(f"ms@{dname}", []).append(
                    ms)
                print(f"[tiles] round {r} {name} {dname}: forward {ms:.4f} "
                      f"ms at {TRAIN[:6]} causal", flush=True)
    print(f"[card] {smi}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
