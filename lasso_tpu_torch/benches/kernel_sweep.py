"""Device time of the port's CUDA kernels K1 (mont_mul), K2 (mont_mul_lm)
and K3 (padd) at given shapes, and sweeps of K2's and K3's block shapes.

    python3 lasso_tpu_torch/benches/kernel_sweep.py [--root DIR] [--sweep]
        [--padd-shape K,N ...] [--iters N]

Needs one CUDA card.  For each shape it first holds the kernel against its
plain PyTorch version (limb for limb), then times it two ways:
  device_ms     the kernel's own device time per launch: torch.profiler's
                self device time of the kernel, summed over a loop of
                launches and divided by their count;
  host_loop_ms  CUDA events around the same loop of wrapper calls, divided
                by the count: this includes the wrapper's host work, which
                sets the time when the kernel is shorter than it;
  plain_ms      (K2 and K3) a short loop of the plain PyTorch version on
                the card, for the kernel table.
K2's main-path shape also gets `dispatch_loop_ms`, the same loop through
TFp.mul_lm, the call the unfused curve path makes.
`--root DIR` imports `lasso_tpu_torch` from DIR instead of the checkout
that holds this script (to time another commit's kernels on the same card,
in turns); `--sweep` also builds mont_mul_lm.cu with each block shape in
K2_SWEEP and padd.cu with each block size x __launch_bounds__ minimum of
blocks per SM in K3_SWEEP, and times those variants at the kernel's shapes.
Prints one JSON object per line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

# The large shapes, and the main paths' dominant ones (chip_smoke.py phases
# 6 and 8): the flagship prove's and the fused jolt-demo prove's, by elements
# and, for K3, by calls.
K1_SHAPES = [(1 << 20, False), (65536, True), (1 << 19, False)]  # (n, b is [16])
# K2: (K, n, field, b is [16, 1]); the unfused jolt-demo prove's most called
# shape, the latency floor (one warp, one product per thread) and the large
# shapes
K2_SHAPES = [(4, 512, "Fp", False), (1, 32, "Fp", False),
             (4, 1 << 20, "Fr", False), (4, 1 << 20, "Fp", False),
             (4, 1 << 20, "Fr", True), (4, 1 << 20, "Fp", True)]
K3_SHAPES = [(1, 1 << 16), (256, 128), (1, 512), (1, 1)]  # [K, 4, 16, n]
# K2: (threads per block, columns per thread at large launches)
K2_SWEEP = [(t, c) for t in (64, 128, 256) for c in (1, 2)]
K3_SWEEP = [(t, b) for t in (64, 128, 256) for b in (1, 2, 4)]


def device_us(event) -> float:
    """A profiler event's own device time, in microseconds."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def device_ms(fn, iters: int, kernel: str, attempts: int = 3) -> float:
    """The kernel's own device time per launch: the profiler's self device
    time of the kernels named `kernel` over `iters` calls of fn (after one
    warm-up call), divided by their count.  A profiling session now and
    then reports no kernel at all; it is then run again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in evs)
        us = sum(device_us(e) for e in evs)
        if count and us > 0:
            return us / count / 1e3
    raise RuntimeError(f"the profiler saw no device time of {kernel}")


def host_loop_ms(fn, iters: int) -> float:
    """CUDA events around `iters` calls of fn, per call: the wrapper's host
    work included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def points(k: int, n: int, dev, seed: int):
    """Two [k, 4, 16, n] batches of points drawn from multiples of G, their
    negations and the identity (every case of the addition law)."""
    import numpy as np
    import torch

    from lasso_tpu_torch.curve import tcurve
    from lasso_tpu_torch.curve.host import GENERATOR, Point

    pts = [GENERATOR.mul(i) for i in range(1, 65)]
    pool = tcurve.from_host_points(
        pts + [p.neg() for p in pts] + [Point.identity()], dev)
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, 129, size=(2, k * n)), device=dev)
    return [pool[..., i].reshape(4, 16, k, n).permute(2, 0, 1, 3).contiguous()
            for i in idx]


def limbs(n: int, field, dev, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    x[:, 15] %= field.p_limbs[-1]
    return torch.as_tensor(x.astype(np.int32), device=dev)


def lm_plain(fc, a, b, field):
    """K2's plain version, a batch slice at a time when the operands are
    large (its int64 product columns take ~4 KB per element)."""
    import torch

    k, _, n = (a if a.dim() == 3 else b).shape
    per = max(1, (1 << 20) // n)

    def part(x, lo):  # a [16, 1] constant goes whole to every slice
        return x if x.dim() == 2 else x[lo:lo + per]
    return torch.cat([fc.mont_mul_lm_plain(part(a, lo), part(b, lo), field)
                      for lo in range(0, k, per)])


def ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def build_variants(fc, name: str, variants: dict) -> dict:
    """The kernel source `name` built once per variant: a copy with each
    (old, new) replacement of the variant made, all nvcc at once, into the
    git-ignored build directory.  Returns {variant: (lib, ptxas)}."""
    out_dir = os.path.join(fc._build_dir(), "sweep")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(fc.CSRC, fc.SOURCES[name])) as f:
        src = f.read()
    procs = []
    for key, edits in variants.items():
        tag = "_".join(str(x) for x in key)
        text = src
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{fc.SOURCES[name]} no longer states "
                                   f"{old!r} as the sweep expects")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}_{tag}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}_{tag}.so")
        cmd = [fc._nvcc(), *fc.NVCC_FLAGS, "-I", fc.CSRC, "-o", so, cu]
        procs.append((key, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {key}:\n{log[-4000:]}")
        libs[key] = (ctypes.CDLL(so), ptxas_lines(log))
    return libs


def build_padd_variants(fc, variants) -> dict:
    """padd.cu with its block size and __launch_bounds__ set to each
    (threads, min_blocks)."""
    libs = build_variants(fc, "padd", {
        (t, b): [("constexpr int kThreads = 128;",
                  f"constexpr int kThreads = {t};"),
                 ("__launch_bounds__(kThreads)",
                  f"__launch_bounds__(kThreads, {b})")]
        for t, b in variants})
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for lib, _ in libs.values():
        lib.lasso_padd.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.lasso_padd.restype = ctypes.c_int
    return libs


def build_lm_variants(fc, variants) -> dict:
    """mont_mul_lm.cu with each (threads, cols) block shape."""
    libs = build_variants(fc, "mont_mul_lm", {
        (t, c): [("constexpr int kThreads = 128;",
                  f"constexpr int kThreads = {t};"),
                 ("constexpr int kCols = 2;", f"constexpr int kCols = {c};")]
        for t, c in variants})
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for lib, _ in libs.values():
        lib.lasso_mont_mul_lm.argtypes = [vp, vp, vp, i64, i64, ctypes.c_int,
                                          ctypes.c_int, vp]
        lib.lasso_mont_mul_lm.restype = ctypes.c_int
    return libs


def limb_major(k: int, n: int, field, dev, seed: int):
    """[k, 16, n] canonical limbs of `field`."""
    return limbs(k * n, field, dev, seed).reshape(k, n, 16).transpose(
        1, 2).contiguous()


def time_k2(fc, field, args, dev, variants) -> bool:
    """K2 at K2_SHAPES: held against its plain version, then timed, and
    each sweep variant likewise.  Returns False on a mismatch."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    for k, n, fname, bconst in K2_SHAPES:
        f = field[fname]
        a = limb_major(k, n, f, dev, 4)
        b = (limb_major(1, 1, f, dev, 5)[0] if bconst
             else limb_major(k, n, f, dev, 5))
        want = lm_plain(fc, a, b, fname)
        if not torch.equal(fc.mont_mul_lm_cuda(a, b, fname), want):
            print(f"FAIL: K2 {fname} [{k},16,{n}] differs", flush=True)
            return False
        call = lambda: fc.mont_mul_lm_cuda(a, b, fname)  # noqa: E731
        row = {"kernel": "mont_mul_lm", "variant": "built", "field": fname,
               "shape": [[k, 16, n], [16, 1] if bconst else [k, 16, n]],
               "equal": True,
               "device_ms": device_ms(call, args.iters, "mont_mul_lm_kernel"),
               "host_loop_ms": host_loop_ms(call, args.iters),
               "plain_ms": host_loop_ms(lambda: lm_plain(fc, a, b, fname), 3)}
        if (k, n, fname, bconst) == K2_SHAPES[0]:
            row["dispatch_loop_ms"] = host_loop_ms(
                lambda: f.mul_lm(a, b), args.iters)
        print(json.dumps(row), flush=True)
        for (t, c), (lib, regs) in variants.items():
            out = torch.empty_like(a)

            def launch(lib=lib, out=out):
                rc = lib.lasso_mont_mul_lm(a.data_ptr(), b.data_ptr(),
                                           out.data_ptr(), k, n,
                                           2 if bconst else 0,
                                           fc.FIELD_IDS[fname], stream)
                if rc:
                    raise RuntimeError(f"K2 variant launch: cudaError {rc}")

            launch()
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": "mont_mul_lm", "field": fname,
                "variant": {"threads": t, "cols": c},
                "ptxas": regs, "shape": row["shape"],
                "equal": bool(torch.equal(out, want)),
                "device_ms": device_ms(launch, args.iters,
                                       "mont_mul_lm_kernel")}), flush=True)
        del a, b, want
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--padd-shape", action="append", default=[],
                    help="another K3 shape to time, as K,N")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(args.root or os.path.join(here, "..", "..")))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    from lasso_tpu_torch.field.tfield import TFp, TFr
    from lasso_tpu_torch.ops import field_cuda as fc

    dev = torch.device("cuda")
    tree = os.path.dirname(os.path.dirname(os.path.abspath(fc.__file__)))
    src = hashlib.sha256()
    # a parent tree from before K4 names its one header HEADER
    headers = list(getattr(fc, "HEADERS", None) or [fc.HEADER])
    for name in headers + sorted(fc.SOURCES.values()):
        with open(os.path.join(fc.CSRC, name), "rb") as f:
            src.update(f.read())
    build_s = fc.build()
    ptxas = {name: ptxas_lines(fc.build_log(name)) for name in fc.SOURCES}
    print(json.dumps({"tree": tree, "sources_sha256": src.hexdigest()[:16],
                      "card": torch.cuda.get_device_name(0),
                      "build_s": round(build_s, 2), "ptxas": ptxas}),
          flush=True)

    for n, bconst in K1_SHAPES:
        for field in (TFr, TFp):
            a = limbs(n, field, dev, 1)
            b = limbs(1, field, dev, 2)[0] if bconst else limbs(n, field, dev, 2)
            got = fc.mont_mul_cuda(a, b, field.name)
            want = fc.mont_mul_plain(a, b, field.name)
            if not torch.equal(got, want):
                print(f"FAIL: K1 {field.name} n={n} differs", flush=True)
                return 1
            del want
            call = lambda: fc.mont_mul_cuda(a, b, field.name)  # noqa: E731
            print(json.dumps({
                "kernel": "mont_mul", "field": field.name,
                "shape": [[n, 16], [16] if bconst else [n, 16]],
                "equal": True,
                "device_ms": device_ms(call, args.iters, "mont_mul_kernel"),
                "host_loop_ms": host_loop_ms(call, args.iters)}), flush=True)

    lm_variants = build_lm_variants(fc, K2_SWEEP) if args.sweep else {}
    if not time_k2(fc, {"Fr": TFr, "Fp": TFp}, args, dev, lm_variants):
        return 1

    shapes = K3_SHAPES + [tuple(int(x) for x in s.split(","))
                          for s in args.padd_shape]
    variants = build_padd_variants(fc, K3_SWEEP) if args.sweep else {}
    stream = torch.cuda.current_stream().cuda_stream
    for k, n in shapes:
        p, q = points(k, n, dev, 3)
        want = fc.padd_plain(p, q)
        if not torch.equal(fc.padd_cuda(p, q), want):
            print(f"FAIL: K3 [{k},4,16,{n}] differs", flush=True)
            return 1
        call = lambda: fc.padd_cuda(p, q)  # noqa: E731
        print(json.dumps({
            "kernel": "padd", "variant": "built", "shape": [k, 4, 16, n],
            "equal": True, "device_ms": device_ms(call, args.iters,
                                                  "padd_kernel"),
            "host_loop_ms": host_loop_ms(call, args.iters),
            "plain_ms": host_loop_ms(lambda: fc.padd_plain(p, q), 3)}),
            flush=True)
        for (t, b), (lib, regs) in variants.items():
            out = torch.empty_like(p)

            def launch(lib=lib, out=out):
                rc = lib.lasso_padd(p.data_ptr(), q.data_ptr(), out.data_ptr(),
                                    k, n, stream)
                if rc:
                    raise RuntimeError(f"padd variant launch: cudaError {rc}")

            launch()
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": "padd", "variant": {"threads": t, "min_blocks": b},
                "ptxas": regs, "shape": [k, 4, 16, n],
                "equal": bool(torch.equal(out, want)),
                "device_ms": device_ms(launch, args.iters, "padd_kernel")}),
                flush=True)
        del p, q, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
