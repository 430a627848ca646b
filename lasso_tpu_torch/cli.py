"""Bench CLI (port of cli.py; reference: src/main.rs).

    python -m lasso_tpu_torch.cli --name jolt-demo [--chart] [--s-max 16]

--chart prints the texray-style nested span chart instead of per-pass lines.
--device picks where the passes run: the card (`cuda`, the default) or the
CPU (`cpu`).  LASSO_TPU_PALLAS_PADD=0 selects the unfused curve path.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lasso-tpu-torch")
    parser.add_argument("--name", required=True,
                        choices=["jolt-demo", "halo2-comparison"])
    parser.add_argument("--chart", action="store_true",
                        help="print a span-duration chart after the run")
    parser.add_argument("--s-min", type=int, default=None,
                        help="min log2 sparsity (default: suite default)")
    parser.add_argument("--s-max", type=int, default=None,
                        help="max log2 sparsity (default: suite default)")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the passes (default: cuda)")
    args = parser.parse_args(argv)

    from lasso_tpu_torch.benches.bench import SUITES
    from lasso_tpu_torch.utils.tracing import print_span_tree

    s_range = None
    if args.s_min is not None or args.s_max is not None:
        lo = args.s_min if args.s_min is not None else 10
        hi = args.s_max if args.s_max is not None else lo
        s_range = [1 << k for k in range(lo, hi + 1, 2)]

    results = SUITES[args.name](s_range, device=args.device)
    for r in results:
        print(f"{r.name}: commit {r.commit_s * 1e3:.1f}ms  "
              f"prove {r.prove_s * 1e3:.1f}ms  "
              f"verify {r.verify_s * 1e3:.1f}ms", flush=True)
    if args.chart:
        print_span_tree(file=sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
