"""Smoke run of the PyTorch/CUDA port (lasso_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one line and any failure exits non-zero:
  1. device and build: the card's name and power limit, and the seconds to
     build every CUDA kernel from lasso_tpu_torch/csrc (one nvcc per source,
     all started together);
  2. K1 (Montgomery multiply) against its plain PyTorch version on the card,
     Fr and Fp, n = 2^20, limb for limb, then at the ragged n = 1, 7, 257
     and 2^20 - 3 with a broadcast constant on either side and the edge
     values 0, 1 and p-1;
  3. K3 (fused Edwards add) against its plain version, n = 2^16 points
     including P+P, P+identity and P+(-P), limbs and compressed bytes, and
     K = 3 batches of the ragged n = 1 and 129;
  4. the golden and_4d / or_4d / xor_4d proofs on the card: proof and
     commitment sha256 and lengths must equal tests/fixtures/golden_proofs.json;
  5. the flagship main path: AND, C=1, M=2^16, s=2^14 (the halo2-comparison
     shape): commit, prove twice (the second timed, with kernel launch
     counts reset just before it, and a span breakdown), verify, reject a
     tampered proof, check the l-variate commitment rows against the host
     Pippenger, and profile one more prove for the card's busy share;
  6. each kernel held against its plain version at the main path's own
     dominant shape; then K5 (field add/sub, column sums and their finish)
     against its plain version on the same card inputs, Fr and Fp, limb for
     limb, at the prove's shapes: add and sub of the halves of [2, 2^16, 16]
     and [16, 2^16, 16] (strided views, read in place), of [2^15, 16] and
     one broadcast [16] element on either side, of odd n = 2^15 + 3 and of
     n = 1, with the edge values 0, 1 and p-1; the column sums of [2^15, 16]
     (its value also against the host) and of the transposed [2^15, 16, 16]
     products, and their finish; each timed (Fr) on copies of its inputs
     taken in turn, enough that a loop reads three times the L2;
  7. K2 (limb-major Montgomery multiply) against its plain version and the
     host oracle, Fr and Fp, K=4 stacked operands of n = 2^20 and a
     broadcast [16, 1] constant; then at n = 1, K = 1 and ragged n (one
     column or a pair per thread) with the constant on either side and the
     edge values 0, 1 and p-1; and K2's ptxas registers and spills (a
     spill fails the run);
  8. the bench CLI's main path on the unfused curve configuration
     (LASSO_TPU_PALLAS_PADD=0): `lasso_tpu_torch.cli` jolt-demo, AND, C=8,
     M=2^16, s=2^16, with launch counts (K2 > 0, K3 = 0) and its spans; then
     the same instance proven once unfused and once fused (each launching
     K5), whose proof and commitment bytes must be identical, and one more fused prove under
     the profiler for the card's busy share and K1's and K3's launches,
     device time and dominant shapes; K1 and K3 held against their plain
     versions at those shapes;
  9. K2 held against its plain version and the host oracle at the shape
     that carried the most elements in the unfused jolt-demo prove, timed
     there through its wrapper and through TFp.mul_lm (`dispatch_loop_ms`),
     and at its latency floor, Fp [1, 16, 32] (one warp, one product per
     thread);
 10. the device-resident transcript: K4 (keccak-f[1600]) against its plain
     version and the host keccak on random states and the all-zero state,
     timed beside the host's native keccak; then the flagship and the fused
     jolt-demo proven on the host transcript route and the device one in
     turns (host, device, device, host), with their bytes equal on both
     routes, prove_s and K1/K3/K4 launches per prove, and one profiled
     host-route prove of each for the card's busy share (the device
     route's are phase 5's and phase 8's profiled proves).  Every device-route prove
     here runs its device-transcript rounds (the sumcheck, grand-product
     and fused opening-proof paths) under
     torch.cuda.set_sync_debug_mode("error"): a host sync inside them fails
     the run;
 11. the multi-device prover (prove(..., mesh=), lasso_tpu_torch/parallel):
     the flagship proven as ranks spawned on the card, (a) one NCCL rank
     and (b) four gloo ranks sharing it, each rank densifying, committing
     and proving twice (the second timed); every rank's proof and
     commitment bytes must equal phase 5's, rank 0's single-device verify
     must accept, and every rank's prove must launch K1, K3, K4 and K5.  Each
     rank's peak device memory is printed twice: from its densify on
     (every rank densifies the whole instance) and from its shard's commit
     on.  Four ranks on one card check correctness and per-rank dispatch,
     not scaling;
 12. the reference's public API at full width (public_api_phase): a
     DensePolynomial of 2^19 values (the jolt-demo's merged lookup table)
     and of 2^16 (the flagship's M) bound variable by variable from the top
     and from the bottom to evaluate()'s value, with evaluate_device's limbs
     equal to the plain version's on a CPU copy and, at 2^16, to the host
     evaluate_host; a GrandProductCircuit on 2^16 leaves against the host
     product and the batched circuit; and merge, split, clone, to_ints,
     indexing, Subtables.lookup_polys and combine_eq_device on phase 5's
     flagship instance, combine_eq_device equal to the combine function
     prove uses.  Then the `kernels` JSON line, the card line, and the final
     status line.

Phases 4, 5 and 8 run on the device transcript route, the default on a
card (LASSO_TPU_DEVICE_TRANSCRIPT unset); phase 10 sets it to 0 for the
host route.

Every kernel time is given twice: `device_ms`, the kernel's own device time
per launch (torch.profiler's self device time over a loop of launches,
divided by their count), and `host_loop_ms`, CUDA events around the same
loop of wrapper calls, which includes the wrapper's host work and measures
that instead when the kernel is shorter.  `bound_ms` is the larger of the
bytes over the memory rate and the 32-bit integer instructions the function
needs (multiplies for K1-K3, logic operations for K4, which issue at the
same rate) over the card's rate for them; K5's is its bytes alone, a
broadcast operand counted once.  K4 also gets `latency_bound_ms`, its 24
dependent rounds' shortest instruction chain.

Needs one CUDA card; it imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM memory rate and L2 size (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
# 32-bit integer multiplies issue at 64 per clock per SM on compute
# capability 9.0 (CUDA C Programming Guide, arithmetic instruction
# throughput); main() sets the rate from the card's SM count and maximum SM
# clock (132 x 64 x 1980 MHz = 16.7e12/s on an H100 SXM)
INT_MUL_PER_CLOCK_PER_SM = 64
PEAK_OPS_PER_S = None
W = 16
# 32-bit multiply instructions per Montgomery product (8x8 words, CIOS:
# 2*8*8 + 8 wide products, two instructions each) and per point addition
K1_OPS = 2 * (2 * 8 * 8 + 8)
K3_OPS = 11 * K1_OPS
# one keccak-f[1600] permutation: per round theta 55 (column parities 20,
# D 5 rotations + 5 XORs, 25 XORs into the state), rho 24 rotations, chi 75
# (NOT, AND, XOR per lane) and iota 1 64-bit operations (FIPS 202, 3.2),
# each two 32-bit instructions, over 24 rounds
K4_OPS = 24 * (55 + 24 + 75 + 1) * 2
# K4's latency bound: the 24 rounds depend on each other, and each round's
# longest chain is at least 6 dependent 32-bit instructions (the column
# parity as two 3-input XORs, the 1-bit rotation of D, the theta XOR, the
# rho rotation, chi as one 3-input logic op), each issued at least 4 cycles
# after the one it waits on (the dependent-issue latency of integer ALU
# instructions since Volta: Jia et al., "Dissecting the NVIDIA Volta GPU
# Architecture via Microbenchmarking", 2018); no memory latency or launch
K4_CHAIN_CYCLES = 24 * 6 * 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k5_launches(counts) -> int:
    """K5's launches among a prove's launch counts: add/sub, sums and
    finishes."""
    return counts["field_addsub"] + counts["field_sum"]


def walk_into(totals, sp) -> None:
    """Add each span's inclusive ms under its name, recursively."""
    totals[sp.name] += sp.duration * 1e3
    for ch in sp.children:
        walk_into(totals, ch)


def random_limbs(rng, n: int, field):
    """n canonical elements of `field` as [n, 16] limbs: uniform limbs with
    the top limb kept below the modulus' top limb, plus 0, 1 and p-1."""
    import numpy as np

    top = field.p_limbs[-1]
    limbs = rng.integers(0, 1 << 16, size=(n, W), dtype=np.int64)
    limbs[:, W - 1] %= top
    if n >= 3:
        limbs[0] = 0
        limbs[1] = field.mont_one
        limbs[2] = np.asarray(field.p_limbs)
        limbs[2, 0] -= 1
    return limbs.astype(np.int32)


def public_api_phase(dev, dense, strategy, r_flag, card, rng) -> dict:
    """Phase 12: the reference's public API on `dev` at full width.  (a) A
    DensePolynomial from_u64 of 2^19 values (the jolt-demo's merged lookup
    table, alpha*s = 8*2^16) and of 2^16 (the flagship's M), bound to one
    element variable by variable from the top and, at the reversed point,
    from the bottom; both must equal evaluate() there, evaluate_device's
    limbs must equal the plain version's on a CPU copy, and at 2^16 the
    host evaluate_host.  (b) A GrandProductCircuit on 2^16 leaves: 16
    layers, the host product as its root, and layer 0's halves equal to
    the batched circuit's.  (c) merge, split, clone, to_ints, indexing and
    Subtables.lookup_polys / combine_eq_device on the flagship instance
    `dense` (strategy, point r_flag).  Prints one line per part; returns
    each part's K1 launches."""
    import numpy as np
    import torch

    from lasso_tpu_torch.field.tfield import TFr
    from lasso_tpu_torch.ops import field_cuda
    from lasso_tpu_torch.poly.dense import (DensePolynomial, eq_table,
                                            evaluate_host)
    from lasso_tpu_torch.subprotocols.grand_product import (
        BatchedGrandProductCircuit, GrandProductCircuit)
    from lasso_tpu_torch.subtables.container import Subtables

    p = TFr.host.p
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def scalars(n):
        return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]

    def enc(xs, device):
        return [TFr.encode_scalar(x, device) for x in xs]

    launches = {}
    # -- (a) a dense polynomial at two widths
    for label, log_n in (("jolt_demo_merged_2^19", 19), ("flagship_m_2^16", 16)):
        field_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        vals = rng.integers(0, 2**63, size=1 << log_n, dtype=np.uint64)
        poly = DensePolynomial.from_u64(vals, dev)
        point = scalars(log_n)
        top = poly
        for x in enc(point, dev):
            top = top.bound_var_top(x)
        bot = poly
        for x in enc(point[::-1], dev):
            bot = bot.bound_var_bot(x)
        value = poly.evaluate(point)
        limbs = poly.evaluate_device(enc(point, dev))
        sync()
        card_s = time.perf_counter() - t0
        launches[label] = field_cuda.launch_counts["mont_mul"]
        if (len(top), len(bot)) != (1, 1) or top[0] != value or \
                bot[0] != value:
            fail(f"phase 12 (a) {label}: the bound polynomials differ from "
                 "evaluate()")
        if TFr.decode(limbs[None]) != [value]:
            fail(f"phase 12 (a) {label}: evaluate_device differs from evaluate")
        t1 = time.perf_counter()
        plain = DensePolynomial(poly.z.cpu()).evaluate_device(
            enc(point, "cpu"))
        cpu_s = time.perf_counter() - t1
        if not torch.equal(plain, limbs.cpu()):
            fail(f"phase 12 (a) {label}: evaluate_device's limbs differ from "
                 "the plain version's on the CPU")
        host = ""
        if log_n == 16:
            t1 = time.perf_counter()
            if evaluate_host([int(v) for v in vals], point) != value:
                fail(f"phase 12 (a) {label}: evaluate differs from "
                     "evaluate_host")
            host = f" evaluate_host=equal host_s={time.perf_counter() - t1:.3f}"
        print(f"phase 12 (a) dense polynomial {label}: device={poly.z.device} "
              f"bound_var_top x{log_n} == bound_var_bot x{log_n} == evaluate "
              f"== evaluate_device, limbs == plain version on the CPU{host} "
              f"card_s={card_s:.3f} cpu_plain_s={cpu_s:.3f} "
              f"wall_s={time.perf_counter() - t0:.3f} "
              f"k1_launches={launches[label]} card: {card}", flush=True)

    # -- (b) a grand-product circuit on 2^16 leaves
    field_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    leaves = [1 + x % (p - 1) for x in scalars(1 << 16)]  # nonzero
    z = DensePolynomial.from_ints(leaves, dev).z
    circuit = GrandProductCircuit(z)
    root = circuit.evaluate()
    batched = BatchedGrandProductCircuit(z[None])
    halves = (torch.equal(circuit.left_vec(0), batched.left_layers[0][0])
              and torch.equal(circuit.right_vec(0), batched.right_layers[0][0])
              and torch.equal(circuit.left_vec(0), z[: 1 << 15]))
    sync()
    card_s = time.perf_counter() - t0
    launches["grand_product_2^16"] = field_cuda.launch_counts["mont_mul"]
    want = 1
    for x in leaves:
        want = want * x % p
    if circuit.num_layers != 16 or root != want or not halves:
        fail(f"phase 12 (b): num_layers={circuit.num_layers}, "
             f"root == host product: {root == want}, halves equal: {halves}")
    print(f"phase 12 (b) GrandProductCircuit 2^16 leaves: device={z.device} "
          "num_layers=16 evaluate == host product, left_vec(0)/right_vec(0) "
          f"== the batched circuit's layer-0 halves card_s={card_s:.3f} "
          f"wall_s={time.perf_counter() - t0:.3f} "
          f"k1_launches={launches['grand_product_2^16']} card: {card}",
          flush=True)

    # -- (c) the small methods on the flagship instance
    field_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    subtables = Subtables(strategy, dense.dim_usize, dense.s)
    eq = eq_table(r_flag, dev)
    zs = subtables.stack_with_eq(eq)
    comb = subtables.combine_eq_device(zs)
    prove_comb = strategy.comb_eq_device()(zs)  # what prove hands the sumcheck
    claim = subtables.compute_sumcheck_claim(eq)
    comb_sum = TFr.decode(TFr.sum(comb)[None])[0]
    l_poly = dense.combined_l_variate_polys
    merged = DensePolynomial.merge(dense.dim + dense.read)
    lo, hi = l_poly.split(dense.s)
    twin = dense.combined_log_m_variate_polys.clone()
    sync()
    card_s = time.perf_counter() - t0
    launches["flagship_small_methods"] = field_cuda.launch_counts["mont_mul"]
    if not torch.equal(comb, prove_comb) or comb_sum != claim:
        fail("phase 12 (c): combine_eq_device differs from the combine "
             "function prove uses, or its sum from the sumcheck claim")
    if not (torch.equal(merged.z, l_poly.z) and torch.equal(lo.z, dense.dim[0].z)
            and torch.equal(hi.z, dense.read[0].z)
            and twin is not dense.combined_log_m_variate_polys
            and torch.equal(twin.z, dense.combined_log_m_variate_polys.z)):
        fail("phase 12 (c): merge, split or clone differs from the "
             "densified polynomials")
    addrs = dense.dim_usize[0].tolist()
    counters, read_want = [0] * dense.m, []
    for a in addrs:
        read_want.append(counters[a])
        counters[a] += 1
    table = strategy.materialize_subtables()[0]
    polys = subtables.lookup_polys
    if len(polys) != strategy.num_memories or \
            polys[0].to_ints() != [int(table[a]) for a in addrs]:
        fail("phase 12 (c): lookup_polys differ from the gathered table")
    if dense.dim[0].to_ints() != addrs or dense.read[0].to_ints() != read_want:
        fail("phase 12 (c): to_ints of dim/read differs from the host counters")
    final = dense.final[0]
    for k in (0, addrs[0], addrs[-1], dense.m - 1):
        if final[k] != counters[k]:
            fail(f"phase 12 (c): final[{k}] differs from the host counter")
    print(f"phase 12 (c) flagship small methods: lookup_polys == gathered "
          "table, combine_eq_device == prove's combine function (limbs) and "
          "sums to the sumcheck claim, merge(dim+read) == the l-variate "
          "polynomial, split == (dim, read), clone, to_ints == host "
          f"counters, final[k] == host counters card_s={card_s:.3f} "
          f"wall_s={time.perf_counter() - t0:.3f} "
          f"k1_launches={launches['flagship_small_methods']} card: {card}",
          flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run "
              "needs a CUDA card", flush=True)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    import lasso_tpu_torch.subtables.bitwise  # noqa: F401 (registers AND/OR/XOR)
    import lasso_tpu_torch.subtables.lt  # noqa: F401
    import lasso_tpu_torch.subtables.range_check  # noqa: F401
    from lasso_tpu_torch import cli
    from lasso_tpu_torch.benches import bench
    from lasso_tpu_torch.benches.kernel_sweep import (device_ms, device_us,
                                                      host_loop_ms, lm_plain)
    from lasso_tpu_torch.curve import tcurve
    from lasso_tpu_torch.curve.host import GENERATOR, Point, msm_host
    from lasso_tpu_torch.field import tfield
    from lasso_tpu_torch.field.tfield import TFp, TFr, unpack_ints
    from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
    from lasso_tpu_torch.lasso.surge import (SparsePolyCommitmentGens,
                                             SparsePolynomialEvaluationProof)
    from lasso_tpu_torch.ops import field_cuda
    from lasso_tpu_torch.subprotocols.dot_product import _gens_device
    from lasso_tpu_torch.subtables.base import get_strategy
    from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
    from lasso_tpu_torch.transcript.random_tape import RandomTape
    from lasso_tpu_torch.utils import tracing
    from lasso_tpu_torch.utils.errors import LassoError
    from lasso_tpu_torch.utils.fixtures import gen_indices, gen_random_point
    from lasso_tpu_torch.utils.serialize import (serialize_commitment,
                                                 serialize_proof)

    dev = torch.device("cuda")
    tcurve.set_fused_padd(True)  # phases 1-6: the fused curve path (K3)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    global PEAK_OPS_PER_S
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clock = max_sm_clock_hz()
    PEAK_OPS_PER_S = sms * INT_MUL_PER_CLOCK_PER_SM * sm_clock
    rng = np.random.default_rng(20241016)
    t_start = time.perf_counter()
    # every timed shape of every kernel: name -> [{shape, device_ms, ...}]
    timed = collections.defaultdict(list)

    def elapsed() -> str:
        return f"t={time.perf_counter() - t_start:.0f}s"

    def record(name, shape, dev_ms, loop_ms, plain_ms, bytes_moved, ops):
        bnd, by = bound_ms(bytes_moved, ops)
        timed[name].append({"shape": shape, "device_ms": dev_ms,
                            "host_loop_ms": loop_ms, "plain_ms": plain_ms,
                            "bound_ms": bnd, "bound_by": by})
        return (f"device_ms={dev_ms:.4f} host_loop_ms={loop_ms:.4f} "
                f"plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} ({by})")

    # -- 1. device and build ---------------------------------------------------
    build_s = field_cuda.build()
    regs = {}
    for name in field_cuda.SOURCES:
        log = field_cuda.build_log(name)
        regs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
    print(f"phase 1 [{elapsed()}] device+build: card={card!r} kind={kind!r} sms={sms} "
          f"max_sm_clock_mhz={sm_clock / 1e6:.0f} "
          f"int_mul_peak_per_s={PEAK_OPS_PER_S:.4g} "
          f"build_s={build_s:.2f} ptxas={json.dumps(regs)}", flush=True)

    # -- 2. K1 against its plain version ---------------------------------------
    k1 = {"max_abs_err": 0}
    for field in (TFr, TFp):
        n = 1 << 20
        a = torch.as_tensor(random_limbs(rng, n, field), device=dev)
        b = torch.as_tensor(random_limbs(rng, n, field), device=dev)
        b[0] = b[1]  # 0 * 1
        b[2] = a[2]  # (p-1) * (p-1)
        got = field_cuda.mont_mul_cuda(a, b, field.name)
        want = field_cuda.mont_mul_plain(a, b, field.name)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        if err:
            fail(f"K1 {field.name}: kernel differs from plain by {err}")
        p, r_inv = field.host.p, field.host.r_inv
        sa, sb, sg = (unpack_ints(x[:64]) for x in (a, b, got))
        if any(g != x * y * r_inv % p for g, x, y in zip(sg, sa, sb)):
            fail(f"K1 {field.name}: kernel differs from the host oracle")
        call = lambda: field_cuda.mont_mul_cuda(a, b, field.name)  # noqa: E731
        times = record("mont_mul", [[n, W], [n, W], field.name],
                       device_ms(call, 50, "mont_mul_kernel"),
                       host_loop_ms(call, 20),
                       host_loop_ms(lambda: field_cuda.mont_mul_plain(
                           a, b, field.name), 3),
                       3 * 64 * n, K1_OPS * n)
        print(f"phase 2 [{elapsed()}] K1 {field.name}: n={n} equal=True max_abs_err={err} "
              f"{times}", flush=True)
        del a, b, got, want

        # ragged n, a broadcast constant on either side, 0 / 1 / p-1 pairs
        for n in (1, 7, 257, (1 << 20) - 3):
            a = torch.as_tensor(random_limbs(rng, n, field), device=dev)
            b = torch.as_tensor(random_limbs(rng, n, field), device=dev)
            if n >= 9:  # every edge value of a against every one of b
                a[3:9] = a[[0, 1, 2, 0, 1, 2]]
                b[3:9] = b[[1, 2, 0, 2, 0, 1]]
            cases = [(a, b)] + [(x, y) for r in range(min(n, 3))
                                for x, y in ((a, b[r]), (b[r], a))]
            for x, y in cases:
                got = field_cuda.mont_mul_cuda(x, y, field.name)
                want = field_cuda.mont_mul_plain(x, y, field.name)
                err = int((got.to(torch.int64) - want.reshape(got.shape)
                           .to(torch.int64)).abs().max())
                if err:
                    fail(f"K1 {field.name} n={n} {list(x.shape)}x"
                         f"{list(y.shape)}: differs from plain by {err}")
            del a, b, got, want, cases, x, y
        print(f"phase 2 [{elapsed()}] K1 {field.name}: ragged n=(1, 7, 257, 2^20-3) with "
              f"[16] constants on either side and 0/1/p-1 pairs: equal=True",
              flush=True)

    # -- 3. K3 against its plain version ---------------------------------------
    pool_n = 4096
    host_pts = [GENERATOR]
    for _ in range(pool_n - 1):
        host_pts.append(host_pts[-1].add(GENERATOR))
    pool_host = host_pts + [p.neg() for p in host_pts] + [Point.identity()]
    pool = tcurve.from_host_points(pool_host, dev)  # [4, W, 2*pool_n + 1]
    n3 = 1 << 16
    p_idx = rng.integers(0, pool_n, size=n3)
    q_idx = rng.integers(0, 2 * pool_n + 1, size=n3)
    kind_of = rng.integers(0, 4, size=n3)
    q_idx = np.where(kind_of == 1, p_idx, q_idx)              # P + P
    q_idx = np.where(kind_of == 2, 2 * pool_n, q_idx)         # P + identity
    q_idx = np.where(kind_of == 3, p_idx + pool_n, q_idx)     # P + (-P)
    pp = pool[..., torch.as_tensor(p_idx, device=dev)][None].contiguous()
    qq = pool[..., torch.as_tensor(q_idx, device=dev)][None].contiguous()
    got = field_cuda.padd_cuda(pp, qq)
    want = field_cuda.padd_plain(pp, qq)
    torch.cuda.synchronize()
    k3_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if k3_err:
        fail(f"K3: kernel differs from plain by {k3_err}")
    got_c = tcurve.compress_points_device(got[0]).cpu().numpy()
    want_c = tcurve.compress_points_device(want[0]).cpu().numpy()
    if not np.array_equal(got_c, want_c):
        fail("K3: compressed bytes differ from the plain version's")
    for j in range(256):
        h = pool_host[p_idx[j]].add(pool_host[q_idx[j]])
        if bytes(got_c[j].astype(np.uint8)) != h.to_compressed_bytes():
            fail(f"K3: point {j} differs from the host oracle")
    call = lambda: field_cuda.padd_cuda(pp, qq)  # noqa: E731
    times = record("padd", [1, 4, W, n3], device_ms(call, 50, "padd_kernel"),
                   host_loop_ms(call, 20),
                   host_loop_ms(lambda: field_cuda.padd_plain(pp, qq), 3),
                   3 * 256 * n3, K3_OPS * n3)
    print(f"phase 3 [{elapsed()}] K3: n={n3} equal=True max_abs_err={k3_err} "
          f"compressed_equal=True cases=(P+Q, P+P, P+O, P-P) {times}",
          flush=True)
    # ragged n in K = 3 batches, every case of the addition law
    for n in (1, 129):
        sel = [p_idx[:3 * n], q_idx[:3 * n]]
        pp, qq = (pool[..., torch.as_tensor(i, device=dev)]
                  .reshape(4, W, 3, n).permute(2, 0, 1, 3).contiguous()
                  for i in sel)
        err = int((field_cuda.padd_cuda(pp, qq).to(torch.int64)
                   - field_cuda.padd_plain(pp, qq).to(torch.int64)).abs().max())
        if err:
            fail(f"K3 at [3, 4, 16, {n}]: differs from plain by {err}")
    print(f"phase 3 [{elapsed()}] K3: ragged [3,4,16,1] and [3,4,16,129]: equal=True",
          flush=True)
    del pp, qq, got, want, pool

    # -- 4. golden proofs on the card -------------------------------------------
    with open(os.path.join(HERE, "tests", "fixtures", "golden_proofs.json")) as f:
        golden = json.load(f)

    def prove_bytes(strategy_name, c, log_m, log_s, options=None):
        m, s = 1 << log_m, 1 << log_s
        strategy = get_strategy(strategy_name, c, m, **(options or {}))
        nz = gen_indices(s, m, c)
        r = gen_random_point(log_s)
        dense = DensifiedRepresentation(nz, log_m, c, device=dev)
        gens = SparsePolyCommitmentGens.new(
            b"gens_sparse_poly", c, s, strategy.num_memories, log_m, device=dev)
        comm = dense.commit(gens)
        proof = SparsePolynomialEvaluationProof.prove(
            dense, r, gens, strategy, ProofTranscript(b"example"),
            RandomTape(b"proof"))
        return proof, comm, dense, gens, r, strategy

    def entry(proof, comm):
        pb, cb = serialize_proof(proof), serialize_commitment(comm)
        return {"proof_sha256": hashlib.sha256(pb).hexdigest(),
                "proof_len": len(pb),
                "commitment_sha256": hashlib.sha256(cb).hexdigest(),
                "commitment_len": len(cb)}

    goldens = {  # (strategy, C, log M, log s, options)
        "and_4d": ("and", 4, 4, 4, {}), "or_4d": ("or", 4, 4, 4, {}),
        "xor_4d": ("xor", 4, 4, 4, {}), "lt_4d": ("lt", 4, 4, 4, {}),
        "lt_4d_big_s": ("lt", 4, 4, 7, {}),
        "range_3d": ("range_check", 3, 8, 4, {"log_r": 40})}
    for name, args in goldens.items():
        proof, comm, _, gens, r, _ = prove_bytes(*args)
        got_e = entry(proof, comm)
        if got_e != golden[name]:
            fail(f"golden {name}: {got_e} != {golden[name]}")
        proof.verify(comm, r, gens, ProofTranscript(b"example"))
    print(f"phase 4 [{elapsed()}] golden: " + " ".join(f"{n}=equal" for n in goldens)
          + " (proof+commitment sha256 and lengths; verify accepted)",
          flush=True)

    # -- 5. the flagship main path -----------------------------------------------
    log_m, log_s = 16, 14
    m, s = 1 << log_m, 1 << log_s
    strategy = get_strategy("and", 1, m)
    nz = gen_indices(s, m, 1)
    r = gen_random_point(log_s)
    t0 = time.perf_counter()
    dense = DensifiedRepresentation(nz, log_m, 1, device=dev)
    gens = SparsePolyCommitmentGens.new(
        b"gens_sparse_poly", 1, s, strategy.num_memories, log_m, device=dev)
    comm = dense.commit(gens)
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    flagship_public = (comm, r, gens)  # phase 10 proves this again

    # every l-variate commitment row against the native host Pippenger
    z = dense.combined_l_variate_polys.z
    cols = z.shape[0] // len(comm.l_variate_polys_commitment.C)
    bases = tcurve.to_host_points(
        _gens_device(gens.gens_combined_l_variate.gens.gens_n, dev)[..., :cols])
    rows = TFr.decode(z)
    for i, c_pt in enumerate(comm.l_variate_polys_commitment.C):
        if msm_host(bases, rows[i * cols:(i + 1) * cols]) != c_pt:
            fail(f"flagship commitment row {i} differs from the host MSM")

    t0 = time.perf_counter()
    SparsePolynomialEvaluationProof.prove(
        dense, r, gens, strategy, ProofTranscript(b"example"),
        RandomTape(b"proof"))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    shapes = {"mont_mul": collections.Counter(), "padd": collections.Counter()}
    orig_mm, orig_pa = field_cuda.mont_mul_cuda, field_cuda.padd_cuda

    def rec_mm(a, b, field):
        shapes["mont_mul"][(tuple(a.shape), tuple(b.shape), field)] += 1
        return orig_mm(a, b, field)

    def rec_pa(p, q):
        shapes["padd"][tuple(p.shape)] += 1
        return orig_pa(p, q)

    field_cuda.reset_launch_counts()
    field_cuda.mont_mul_cuda, field_cuda.padd_cuda = rec_mm, rec_pa
    tracing.reset_spans()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = SparsePolynomialEvaluationProof.prove(
        dense, r, gens, strategy, ProofTranscript(b"example"),
        RandomTape(b"proof"))
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    field_cuda.mont_mul_cuda, field_cuda.padd_cuda = orig_mm, orig_pa
    prove_counts = dict(field_cuda.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    spans = collections.Counter()
    for root in tracing.span_tree():
        walk_into(spans, root)
    if min(prove_counts["mont_mul"], prove_counts["padd"],
           prove_counts["keccak"], prove_counts["field_addsub"],
           prove_counts["field_sum"]) <= 0:
        fail(f"flagship prove did not launch every kernel: {prove_counts}")

    field_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    proof.verify(comm, r, gens, ProofTranscript(b"example"))
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    verify_counts = dict(field_cuda.launch_counts)

    pb = serialize_proof(proof)
    proof.primary_sumcheck.claimed_evaluation = (
        proof.primary_sumcheck.claimed_evaluation + 1) % (2**252)
    try:
        proof.verify(comm, r, gens, ProofTranscript(b"example"))
    except (LassoError, AssertionError):
        rejected = True
    else:
        rejected = False
    if not rejected:
        fail("flagship: verify accepted a tampered proof")
    print(f"phase 5 [{elapsed()}] flagship AND C=1 M=2^16 s=2^14: commit_s={commit_s:.3f} "
          f"first_prove_s={first_s:.3f} prove_s={prove_s:.3f} "
          f"verify_s={verify_s:.3f} prove_peak_mem_gib={peak_gib:.3f} "
          f"verify=accepted tampered=rejected "
          f"commit_rows_vs_host=equal proof_len={len(pb)} "
          f"proof_sha256={hashlib.sha256(pb).hexdigest()} "
          f"prove_launches={json.dumps(prove_counts)} "
          f"verify_launches={json.dumps(verify_counts)}", flush=True)
    print(f"phase 5 [{elapsed()}] prove spans (inclusive ms, summed by name): "
          + json.dumps({k: round(v, 1) for k, v in spans.most_common(16)}),
          flush=True)

    # one more prove under torch.profiler: the device's busy share and the
    # device ops that take its time (profiling slows the host side, so the
    # wall time here is not the prove time above)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        SparsePolynomialEvaluationProof.prove(
            dense, r, gens, strategy, ProofTranscript(b"example"),
            RandomTape(b"proof"))
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3

    # kernel events only: a CPU op's device time repeats its kernels'
    kernels_ev = sorted((e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA
                         and device_us(e) > 0),
                        key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in kernels_ev) / 1e3
    ours = {name: sum(device_us(e) for e in kernels_ev if name in e.key) / 1e3
            for name in ("mont_mul_kernel", "padd_kernel")}
    top = {e.key[:60]: [round(device_us(e) / 1e3, 2), e.count]
           for e in kernels_ev[:6]}
    if busy_ms > 0:
        busy = (f"device_busy_ms={busy_ms:.1f} profiled_wall_ms="
                f"{prof_wall_ms:.1f} busy_share_profiled="
                f"{busy_ms / prof_wall_ms:.3f} busy_share_of_prove_s="
                f"{busy_ms / (prove_s * 1e3):.3f} kernel_launches="
                f"{sum(e.count for e in kernels_ev)} k1_ms={ours['mont_mul_kernel']:.2f} "
                f"k3_ms={ours['padd_kernel']:.2f}")
    else:
        busy = "device time not measured (the profiler saw no device time)"
    print(f"phase 5 [{elapsed()}] profiled prove: {busy} top_kernels(ms, calls)="
          f"{json.dumps(top)}", flush=True)

    # -- 6. each kernel at the main path's dominant shape ----------------------
    def dominant(counter):
        """The shape key that carried the most elements over a prove."""
        def elems(key):
            dims = key[:2] if isinstance(key[0], tuple) else (key,)
            return max(int(np.prod(d)) for d in dims)
        return max(counter.items(), key=lambda kv: kv[1] * elems(kv[0]))[0]

    pool = tcurve.from_host_points(pool_host, dev)

    def k1_at(key, what):
        """K1 against its plain version at a recorded (a, b, field) shape,
        then timed; returns the phase line's text and the row."""
        mm_a, mm_b, mm_f = key
        fmm = TFr if mm_f == "Fr" else TFp
        n_mm = max(int(np.prod(mm_a)), int(np.prod(mm_b))) // W
        a = torch.as_tensor(random_limbs(rng, int(np.prod(mm_a)) // W, fmm),
                            device=dev).reshape(mm_a)
        b = torch.as_tensor(random_limbs(rng, int(np.prod(mm_b)) // W, fmm),
                            device=dev).reshape(mm_b)
        err = int((field_cuda.mont_mul_cuda(a, b, mm_f).to(torch.int64)
                   - field_cuda.mont_mul_plain(a, b, mm_f).reshape(-1, W)
                   .to(torch.int64)).abs().max())
        if err:
            fail(f"K1 at the {what} shape {mm_a} x {mm_b}: differs by {err}")
        call = lambda: field_cuda.mont_mul_cuda(a, b, mm_f)  # noqa: E731
        text = record("mont_mul", [list(mm_a), list(mm_b), mm_f],
                      device_ms(call, 100, "mont_mul_kernel"),
                      host_loop_ms(call, 50),
                      host_loop_ms(lambda: field_cuda.mont_mul_plain(
                          a, b, mm_f), 10),
                      (a.numel() + b.numel() + n_mm * W) * 4, K1_OPS * n_mm)
        return text, timed["mont_mul"][-1]

    def k3_at(shape, what):
        """K3 against its plain version at a recorded [K, 4, 16, n] shape
        (random points of the pool), then timed."""
        kk, _, _, nn = shape
        sel = torch.as_tensor(
            rng.integers(0, 2 * pool_n + 1, size=(2, kk * nn)), device=dev)
        pp, qq = (pool[..., i].reshape(4, W, kk, nn).permute(2, 0, 1, 3)
                  .contiguous() for i in sel)
        err = int((field_cuda.padd_cuda(pp, qq).to(torch.int64)
                   - field_cuda.padd_plain(pp, qq).to(torch.int64)).abs().max())
        if err:
            fail(f"K3 at the {what} shape {shape}: differs by {err}")
        call = lambda: field_cuda.padd_cuda(pp, qq)  # noqa: E731
        text = record("padd", list(shape), device_ms(call, 100, "padd_kernel"),
                      host_loop_ms(call, 50),
                      host_loop_ms(lambda: field_cuda.padd_plain(pp, qq), 10),
                      3 * 256 * kk * nn, K3_OPS * kk * nn)
        return text, timed["padd"][-1]

    mm_key, pa_shape = dominant(shapes["mont_mul"]), dominant(shapes["padd"])
    k1_times, k1_main = k1_at(mm_key, "flagship main-path")
    k3_times, k3_main = k3_at(pa_shape, "flagship main-path")
    print(f"phase 6 [{elapsed()}] main-path shapes: K1 {mm_key[2]} {list(mm_key[0])}x"
          f"{list(mm_key[1])} calls={shapes['mont_mul'][mm_key]} equal=True "
          f"{k1_times}; K3 {list(pa_shape)} "
          f"calls={shapes['padd'][pa_shape]} equal=True {k3_times}; "
          f"distinct_shapes K1={len(shapes['mont_mul'])} "
          f"K3={len(shapes['padd'])} k3_most_called="
          f"{[[list(k), c] for k, c in shapes['padd'].most_common(4)]}",
          flush=True)

    # K5 at the prove's shapes: the halves of [2, 2^16, 16] and [16, 2^16,
    # 16] (the grand products' binds and round evals, read in place), one
    # broadcast [16] element, odd n and n = 1; column sums of [2^15, 16] and
    # of the transposed [2^15, 16, 16] products, and their finish
    k5_err = 0

    def rotated(fn, make, nbytes):
        """A call of fn on the inputs make() returns, made afresh up to 64
        times and taken in turn over calls: enough copies that a timed loop
        reads three L2 caches' worth, so that each call reads memory."""
        copies = [make() for _ in range(min(64, -(-3 * L2_BYTES // nbytes)))]
        cyc = itertools.cycle(copies)
        return lambda: fn(*next(cyc))

    def k5_check(got, want, what):
        nonlocal k5_err
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        k5_err = max(k5_err, err)
        if err:
            fail(f"K5 {what}: differs from plain by {err}")

    def k5_addsub(field, make, what, timed_too):
        """K5's add and sub of the operands make() returns against the plain
        version on the same inputs, both orders where one broadcasts; then
        timed on fresh copies, the same views (Fr)."""
        c = field.consts(dev)
        a, b = make()
        texts = []
        for sub in (False, True):
            plain = tfield._sub_plain if sub else tfield._add_plain
            for x, y in ((a, b), (b, a)) if b.dim() == 1 else ((a, b),):
                k5_check(field_cuda.add_sub_cuda(x, y, sub, field.name),
                         plain(x, y, c), f"{field.name} {what} sub={sub}")
            if not timed_too:
                continue
            # bytes moved: each operand read once (a broadcast one once in
            # all), the result written once
            nbytes = (a.numel() + b.numel()
                      + torch.broadcast_shapes(a.shape, b.shape).numel()) * 4
            call = rotated(lambda x, y: field_cuda.add_sub_cuda(  # noqa: B023
                x, y, sub, field.name), make, nbytes)
            texts.append(f"{what} {'sub' if sub else 'add'} " + record(
                "field_arith", ["sub" if sub else "add", what, field.name],
                device_ms(call, 100, "field_addsub_kernel"),
                host_loop_ms(call, 50),
                host_loop_ms(lambda: plain(a, b, c), 10),  # noqa: B023
                nbytes, 0))
        return texts

    k5_lines = []
    for field in (TFr, TFp):
        for rows in (2, 16):
            st = torch.as_tensor(random_limbs(rng, rows << 16, field),
                                 device=dev).reshape(rows, 1 << 16, W)
            k5_lines += k5_addsub(
                field, lambda t=st: (lambda u: (u[:, 1 << 15:], u[:, :1 << 15]))(
                    t.clone()), f"halves of [{rows},2^16,16]", field is TFr)
        for n in (1 << 15, (1 << 15) + 3, 1):
            a = torch.as_tensor(random_limbs(rng, n, field), device=dev)
            b = torch.as_tensor(random_limbs(rng, n, field), device=dev)
            if n >= 9:  # every edge value of a against every one of b
                a[3:9] = a[[0, 1, 2, 0, 1, 2]]
                b[3:9] = b[[1, 2, 0, 2, 0, 1]]
            if n == 1 << 15:
                b, what = b[2], "[2^15,16] and one [16]"
            else:
                what = f"[{n},16] and [{n},16]"
            k5_lines += k5_addsub(
                field, lambda a=a, b=b: (a.clone(), b.clone()), what,
                field is TFr)

        prods = torch.as_tensor(random_limbs(rng, 16 << 15, field),
                                device=dev).reshape(16, 1 << 15, W)
        for x, what in ((prods[0], "[2^15,16]"),
                        (prods.movedim(1, 0), "[2^15,16,16] (transposed)")):
            n, m = x.shape[0], x.numel() // (x.shape[0] * W)
            cols = field_cuda.sum_columns_cuda(x)
            k5_check(cols, tfield._sum_columns_plain(x),
                     f"{field.name} column sum {what}")
            got = field_cuda.finish_sum_cuda(cols, field.name)
            k5_check(got, tfield._finish_sum_plain(field, cols),
                     f"{field.name} finish of {what}")
            if m == 1:  # the value, against the host
                want = sum(unpack_ints(x)) % field.host.p
                if unpack_ints(got.reshape(1, W)) != [want]:
                    fail(f"K5 {field.name} sum {what}: differs from the host")
            if field is not TFr:
                continue
            # bytes moved: the rows read once, the wide columns written once
            nbytes = n * m * W * 4 + m * (W + 3) * 8
            # (a clone keeps the transposed view's strides)
            call = rotated(field_cuda.sum_columns_cuda,
                           lambda x=x: (x.clone(),), nbytes)
            k5_lines.append(f"column sum of {what} " + record(
                "field_arith", ["sum", what, field.name],
                device_ms(call, 100, "field_sum_kernel"),
                host_loop_ms(call, 50),
                host_loop_ms(lambda: tfield._sum_columns_plain(x),  # noqa: B023
                             10), nbytes, 0))
            # the wide columns read once, the elements written once
            nbytes = m * ((W + 3) * 8 + W * 4)
            call = rotated(lambda w: field_cuda.finish_sum_cuda(  # noqa: B023
                w, field.name), lambda w=cols: (w.clone(),), nbytes)
            k5_lines.append(f"finish of {what} " + record(
                "field_arith", ["finish", what, field.name],
                device_ms(call, 100, "field_finish_kernel"),
                host_loop_ms(call, 50),
                host_loop_ms(lambda: tfield._finish_sum_plain(  # noqa: B023
                    field, cols), 10), nbytes, 0))
        del st, a, b, prods, x, cols, got
    k5_main = timed["field_arith"][0]
    print(f"phase 6 [{elapsed()}] K5 (Fr and Fp, add and sub, both orders "
          f"of a broadcast element) equal=True max_abs_err={k5_err}; timed "
          f"Fr: " + "; ".join(k5_lines), flush=True)

    # -- 7. K2 against its plain version ---------------------------------------
    def limb_major(field, k, n, elems=None):
        """[k, 16, n] limbs: `elems` ([k*n, 16] element-major) or random
        canonical ones."""
        if elems is None:
            elems = torch.as_tensor(random_limbs(rng, k * n, field), device=dev)
        return elems.reshape(k, n, W).transpose(1, 2).contiguous()

    def k2_check(a, b, field, what):
        got = field_cuda.mont_mul_lm_cuda(a, b, field)
        want = lm_plain(field_cuda, a, b, field)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            fail(f"K2 {field} {what}: kernel differs from plain by {err}")
        return err

    def k2_oracle(a, b, field, what):
        """K2 against the host's a*b*2^-256 mod p on batch 0's first 32
        columns (a [16, 1] constant stands for every column)."""
        got = field_cuda.mont_mul_lm_cuda(a, b, field.name)

        def cols(x):
            x = x[0] if x.dim() == 3 else x
            return unpack_ints(x[:, :32].T)
        xa, xb, xg = cols(a), cols(b), cols(got)
        xa, xb = (x * len(xg) if len(x) == 1 else x for x in (xa, xb))
        p, r_inv = field.host.p, field.host.r_inv
        if any(g != x * y * r_inv % p for x, y, g in zip(xa, xb, xg)):
            fail(f"K2 {field.name} {what}: kernel differs from the host oracle")

    def k2_ptxas():
        """K2's registers per instantiation and its spilled bytes."""
        regs_used, spilled = [], 0
        for ln in regs["mont_mul_lm"]:
            words = ln.replace(",", "").split()
            if "registers" in words:
                regs_used.append(int(words[words.index("registers") - 1]))
            spilled += sum(int(words[i - 2]) for i, w in enumerate(words)
                           if w == "spill")  # "<N> bytes spill stores"
        return regs_used, spilled

    k2_regs, k2_spilled = k2_ptxas()
    if k2_spilled:
        fail(f"K2 spills {k2_spilled} bytes: {regs['mont_mul_lm']}")
    k2 = {"max_abs_err": 0}
    k2_n, k2_k = 1 << 20, 4
    for field in (TFr, TFp):
        a = limb_major(field, k2_k, k2_n)
        b = limb_major(field, k2_k, k2_n)
        const = b[1, :, 2:3].contiguous()  # one [16, 1] element
        k2["max_abs_err"] = max(k2_check(a, b, field.name, "stacked"),
                                k2_check(a, const, field.name, "broadcast"))
        k2_oracle(a, b, field, "stacked")
        k2_oracle(a, const, field, "broadcast")
        elems = k2_k * k2_n
        texts = []
        for y, y_shape, y_bytes in ((b, [k2_k, W, k2_n], 64 * elems),
                                    (const, [W, 1], 64)):
            call = lambda: field_cuda.mont_mul_lm_cuda(  # noqa: E731
                a, y, field.name)
            texts.append(record(
                "mont_mul_lm", [[k2_k, W, k2_n], y_shape, field.name],
                device_ms(call, 50, "mont_mul_lm_kernel"),
                host_loop_ms(call, 20),
                host_loop_ms(lambda: lm_plain(field_cuda, a, y, field.name), 2),
                2 * 64 * elems + y_bytes, K1_OPS * elems))
        print(f"phase 7 [{elapsed()}] K2 {field.name}: shape=[{k2_k},16,{k2_n}] equal=True "
              f"host_oracle=equal max_abs_err=0 {texts[0]}; broadcast [16,1] "
              f"constant: equal=True {texts[1]}", flush=True)
        del a, b, const

        # n = 1, K = 1, ragged n (one column or a pair per thread), the
        # constant on either side, 0 / 1 / p-1 against each other
        for k, n in ((1, 1), (4, 1), (1, 33), (3, 1001), (3, (1 << 16) + 2),
                     (2, (1 << 16) + 1)):
            ea = torch.as_tensor(random_limbs(rng, k * n, field), device=dev)
            eb = torch.as_tensor(random_limbs(rng, k * n, field), device=dev)
            if k * n >= 9:
                ea[3:9] = ea[[0, 1, 2, 0, 1, 2]]
                eb[3:9] = eb[[1, 2, 0, 2, 0, 1]]
            a, b = limb_major(field, k, n, ea), limb_major(field, k, n, eb)
            consts = [eb[r].reshape(W, 1) for r in range(min(k * n, 3))]
            for x, y in [(a, b)] + [(a, c) for c in consts] + [
                    (c, a) for c in consts]:
                k2_check(x, y, field.name, f"at [{k},16,{n}] x {list(y.shape)}")
        print(f"phase 7 [{elapsed()}] K2 {field.name}: [1,16,1] [4,16,1] [1,16,33] "
              f"[3,16,1001] [3,16,2^16+2] [2,16,2^16+1] with [16,1] constants "
              f"on either side and 0/1/p-1 pairs: equal=True", flush=True)
    print(f"phase 7 [{elapsed()}] K2 ptxas: registers={k2_regs} spill_bytes={k2_spilled} "
          f"({len(k2_regs)} instantiations)", flush=True)
    torch.cuda.empty_cache()

    # -- 8. the bench CLI on the unfused curve path (jolt-demo) -----------------
    os.environ["LASSO_TPU_PALLAS_PADD"] = "0"
    tcurve.set_fused_padd(None)  # read the switch as a user sets it
    if tcurve._use_fused_padd():
        fail("LASSO_TPU_PALLAS_PADD=0 did not select the unfused curve path")
    jd_log_s = 16
    field_cuda.reset_launch_counts()
    tracing.reset_spans()
    t0 = time.perf_counter()
    rc = cli.main(["--name", "jolt-demo", "--s-min", str(jd_log_s),
                   "--s-max", str(jd_log_s)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_counts = dict(field_cuda.launch_counts)
    if rc != 0:
        fail(f"jolt-demo CLI exited with {rc}")
    if cli_counts["mont_mul_lm"] <= 0 or cli_counts["mont_mul"] <= 0:
        fail(f"jolt-demo did not launch K1 and K2: {cli_counts}")
    if cli_counts["padd"] != 0:
        fail(f"jolt-demo launched K3 on the unfused path: {cli_counts}")
    (root,) = tracing.span_tree()
    cli_times = {ch.name: ch.duration for ch in root.children
                 if ch.name in ("commit", "prove", "verify")}
    jd_spans = collections.Counter()
    for ch in root.children:
        walk_into(jd_spans, ch)
    print(f"phase 8 [{elapsed()}] jolt-demo CLI (AND C=8 M=2^16 s=2^{jd_log_s}, unfused): "
          f"rc=0 verify=accepted wall_s={cli_s:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in cli_times.items())
          + f" launches={json.dumps(cli_counts)}", flush=True)
    print(f"phase 8 [{elapsed()}] jolt-demo spans (inclusive ms, summed by name): "
          + json.dumps({k: round(v, 1) for k, v in jd_spans.most_common(14)}),
          flush=True)

    # the same instance once more unfused, then fused: identical bytes
    jd = bench.make_instance("and", 8, 1 << 16, 1 << jd_log_s, dev)
    k2_shapes = collections.Counter()
    orig_lm = field_cuda.mont_mul_lm_cuda

    def rec_lm(a, b, field):
        k2_shapes[(tuple(a.shape), tuple(b.shape), field)] += 1
        return orig_lm(a, b, field)

    runs = {}
    for label, fused in (("unfused", False), ("fused", True)):
        tcurve.set_fused_padd(fused)
        field_cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        comm = jd.dense.commit(jd.gens)
        torch.cuda.synchronize()
        c_s = time.perf_counter() - t0
        if not fused:
            field_cuda.mont_mul_lm_cuda = rec_lm
        field_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        proof = bench.prove(jd)
        torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        field_cuda.mont_mul_lm_cuda = orig_lm
        p_counts = dict(field_cuda.launch_counts)
        t0 = time.perf_counter()
        proof.verify(comm, jd.r, jd.gens, ProofTranscript(b"example"))
        torch.cuda.synchronize()
        v_s = time.perf_counter() - t0
        runs[label] = {"entry": entry(proof, comm), "commit_s": c_s,
                       "prove_s": p_s, "verify_s": v_s,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "prove_launches": p_counts}
        del proof, comm
    # one more fused prove under torch.profiler (device activity only): the
    # card's busy share, and K1's and K3's launches, device time and shapes.
    # An unfused prove launches about ten times as many kernels, and
    # processing their trace would outlast the run's limit.
    tcurve.set_fused_padd(True)
    jd_shapes = {"mont_mul": collections.Counter(),
                 "padd": collections.Counter()}

    def jd_mm(a, b, field):
        jd_shapes["mont_mul"][(tuple(a.shape), tuple(b.shape), field)] += 1
        return orig_mm(a, b, field)

    def jd_pa(p, q):
        jd_shapes["padd"][tuple(p.shape)] += 1
        return orig_pa(p, q)

    field_cuda.reset_launch_counts()
    field_cuda.mont_mul_cuda, field_cuda.padd_cuda = jd_mm, jd_pa
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bench.prove(jd)
        torch.cuda.synchronize()
        jd_prof_ms = (time.perf_counter() - t0) * 1e3
    field_cuda.mont_mul_cuda, field_cuda.padd_cuda = orig_mm, orig_pa
    jd_counts = dict(field_cuda.launch_counts)
    if min(jd_counts["mont_mul"], jd_counts["padd"],
           jd_counts["field_addsub"], jd_counts["field_sum"]) <= 0:
        fail(f"fused jolt-demo prove did not launch K1, K3 and K5: "
             f"{jd_counts}")
    jd_kernels = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    jd_busy_ms = sum(device_us(e) for e in jd_kernels) / 1e3
    jd_ms = {name: sum(device_us(e) for e in jd_kernels if name in e.key) / 1e3
             for name in ("mont_mul_kernel", "padd_kernel")}
    jd_mm_key, jd_pa_shape = (dominant(jd_shapes["mont_mul"]),
                              dominant(jd_shapes["padd"]))
    if jd_busy_ms <= 0:
        fail("the profiler saw no device time in the fused jolt-demo prove")
    print(f"phase 8 [{elapsed()}] jolt-demo profiled fused prove: device_busy_ms="
          f"{jd_busy_ms:.1f} profiled_wall_ms={jd_prof_ms:.1f} "
          f"busy_share_profiled={jd_busy_ms / jd_prof_ms:.3f} "
          f"busy_share_of_prove_s="
          f"{jd_busy_ms / (runs['fused']['prove_s'] * 1e3):.3f} "
          f"kernel_launches={sum(e.count for e in jd_kernels)} "
          f"launches={json.dumps(jd_counts)} "
          f"k1_ms={jd_ms['mont_mul_kernel']:.2f} "
          f"k3_ms={jd_ms['padd_kernel']:.2f} "
          f"k1_dominant={jd_mm_key[2]} {list(jd_mm_key[0])}x"
          f"{list(jd_mm_key[1])} ({jd_shapes['mont_mul'][jd_mm_key]} calls, "
          f"{len(jd_shapes['mont_mul'])} shapes) "
          f"k3_dominant={list(jd_pa_shape)} "
          f"({jd_shapes['padd'][jd_pa_shape]} calls, "
          f"{len(jd_shapes['padd'])} shapes) k3_most_called="
          f"{[[list(k), c] for k, c in jd_shapes['padd'].most_common(4)]}",
          flush=True)
    os.environ.pop("LASSO_TPU_PALLAS_PADD")
    tcurve.set_fused_padd(True)
    if runs["unfused"]["entry"] != runs["fused"]["entry"]:
        fail(f"jolt-demo: unfused and fused bytes differ: {runs}")
    u_counts = runs["unfused"]["prove_launches"]
    if (min(u_counts["mont_mul_lm"], u_counts["field_addsub"],
            u_counts["field_sum"]) <= 0 or u_counts["padd"] != 0):
        fail(f"jolt-demo unfused prove: wrong kernels {u_counts}")
    for label, run in runs.items():
        print(f"phase 8 [{elapsed()}] jolt-demo {label}: commit_s={run['commit_s']:.3f} "
              f"prove_s={run['prove_s']:.3f} verify_s={run['verify_s']:.3f} "
              f"verify=accepted peak_mem_gib={run['peak_gib']:.3f} "
              f"prove_launches={json.dumps(run['prove_launches'])}",
              flush=True)
    print(f"phase 8 [{elapsed()}] jolt-demo bytes: unfused == fused "
          f"proof_len={runs['fused']['entry']['proof_len']} "
          f"proof_sha256={runs['fused']['entry']['proof_sha256']} "
          f"commitment_sha256={runs['fused']['entry']['commitment_sha256']}",
          flush=True)
    del jd
    torch.cuda.empty_cache()
    jd_k1_times, _ = k1_at(jd_mm_key, "fused jolt-demo")
    jd_k3_times, _ = k3_at(jd_pa_shape, "fused jolt-demo")
    print(f"phase 8 [{elapsed()}] jolt-demo fused main-path shapes: K1 {jd_mm_key[2]} "
          f"{list(jd_mm_key[0])}x{list(jd_mm_key[1])} equal=True "
          f"{jd_k1_times}; K3 {list(jd_pa_shape)} equal=True {jd_k3_times}",
          flush=True)

    # -- 9. K2 at the unfused jolt-demo prove's dominant shape -----------------
    (lm_a, lm_b, lm_f), lm_calls = max(
        k2_shapes.items(),
        key=lambda kv: kv[1] * max(np.prod(kv[0][0]), np.prod(kv[0][1])))
    flm = TFr if lm_f == "Fr" else TFp

    def k2_at(a_shape, b_shape, field, dispatch=False):
        """K2 at [K, 16, n] or [16, 1] operand shapes: held against its
        plain version and the host oracle, then timed (`dispatch`: also a
        loop through TField.mul_lm, the unfused curve path's call)."""
        a, b = (limb_major(field, s[0], s[2]) if len(s) == 3
                else limb_major(field, 1, 1)[0] for s in (a_shape, b_shape))
        err = k2_check(a, b, field.name, f"at {a_shape} x {b_shape}")
        k2_oracle(a, b, field, f"at {a_shape} x {b_shape}")
        out_shape = a_shape if len(a_shape) == 3 else b_shape
        n_lm = int(np.prod(out_shape)) // W
        call = lambda: field_cuda.mont_mul_lm_cuda(a, b, field.name)  # noqa: E731
        text = record("mont_mul_lm", [list(a_shape), list(b_shape), field.name],
                      device_ms(call, 100, "mont_mul_lm_kernel"),
                      host_loop_ms(call, 50),
                      host_loop_ms(lambda: lm_plain(field_cuda, a, b,
                                                    field.name), 5),
                      (a.numel() + b.numel() + n_lm * W) * 4, K1_OPS * n_lm)
        if dispatch:
            loop = host_loop_ms(lambda: field.mul_lm(a, b), 50)
            timed["mont_mul_lm"][-1]["dispatch_loop_ms"] = loop
            text += f" dispatch_loop_ms={loop:.4f}"
        return err, text

    err2, k2_times = k2_at(lm_a, lm_b, flm, dispatch=True)
    k2_main = timed["mont_mul_lm"][-1]
    _, floor_times = k2_at((1, W, 32), (1, W, 32), TFp)
    print(f"phase 9 [{elapsed()}] main-path shape: K2 {lm_f} {list(lm_a)}x{list(lm_b)} "
          f"calls={lm_calls} equal=True host_oracle=equal {k2_times}; "
          f"distinct_shapes K2={len(k2_shapes)}", flush=True)
    print(f"phase 9 [{elapsed()}] K2 latency floor: Fp [1,16,32]x[1,16,32] (one warp, one "
          f"product per thread) equal=True host_oracle=equal {floor_times}; "
          f"ptxas registers={k2_regs} spill_bytes={k2_spilled}", flush=True)

    # -- 10. the device-resident transcript ----------------------------------
    from lasso_tpu_torch.subprotocols import (dot_product, grand_product,
                                              sumcheck)
    from lasso_tpu_torch.transcript.device_strobe import (keccak_f1600_plain,
                                                          keccak_f1600_state)
    from lasso_tpu_torch.utils import keccak as host_keccak

    states = rng.integers(0, 256, size=(1024, 200)).astype(np.int32)
    states[0] = 0
    st_dev = torch.as_tensor(states, device=dev)
    want = keccak_f1600_plain(st_dev)
    got = field_cuda.keccak_cuda(st_dev.clone())
    torch.cuda.synchronize()
    k4_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if k4_err:
        fail(f"K4: kernel differs from plain by {k4_err}")
    for i in range(32):
        ref = bytearray(states[i].astype(np.uint8).tobytes())
        host_keccak.keccak_f1600(ref)
        if bytes(got[i].cpu().numpy().astype(np.uint8)) != bytes(ref):
            fail(f"K4: state {i} differs from the host keccak")
    # the main path's launch: one [200] state
    one = st_dev[1].clone()
    if not torch.equal(keccak_f1600_state(one.clone()),
                       keccak_f1600_plain(one)):
        fail("K4: a single [200] state differs from the plain version")
    # 200 int32 bytes read and written
    times = record("keccak", [200],
                   device_ms(lambda: keccak_f1600_state(one), 200,
                             "keccak_kernel"),
                   host_loop_ms(lambda: keccak_f1600_state(one), 200),
                   host_loop_ms(lambda: keccak_f1600_plain(one), 5),
                   2 * 200 * 4, K4_OPS)
    k4_main = timed["keccak"][-1]
    k4_main["latency_bound_ms"] = K4_CHAIN_CYCLES / sm_clock * 1e3
    state = bytearray(200)
    t0 = time.perf_counter()
    for _ in range(2000):
        host_keccak.keccak_f1600(state)
    host_us = (time.perf_counter() - t0) / 2000 * 1e6
    print(f"phase 10 [{elapsed()}] K4: 1024 states (incl. all-zero) and one [200] "
          f"state equal=True host_keccak=equal max_abs_err={k4_err} {times} "
          f"latency_bound_ms={k4_main['latency_bound_ms']:.6f} "
          f"host_native_keccak_us={host_us:.3f}", flush=True)
    del st_dev, want, got

    # the device-transcript rounds, each under the sync check
    def sync_checked(fn):
        def run(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    checked = [(sumcheck, "_prove_arbitrary_device"),
               (sumcheck, "_prove_cubic_batched_device"),
               (grand_product, "_prove_layers_device"),
               (dot_product, "_device_dppl")]
    originals = [getattr(mod, name) for mod, name in checked]

    def prove_route(route, prove_fn, profiled=False):
        """One prove on `route` ("0": host transcript; "1": device, with
        its rounds under the sync check): (proof, prove_s, launches,
        profiler text or None)."""
        os.environ["LASSO_TPU_DEVICE_TRANSCRIPT"] = route
        if route == "1":
            for (mod, name), fn in zip(checked, originals):
                setattr(mod, name, sync_checked(fn))
        try:
            field_cuda.reset_launch_counts()
            torch.cuda.synchronize()
            if profiled:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    proof = prove_fn()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                ev = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and device_us(e) > 0]
                busy = sum(device_us(e) for e in ev) / 1e3
                k4_ms = sum(device_us(e) for e in ev
                            if "keccak_kernel" in e.key) / 1e3
                text = (f"device_busy_ms={busy:.1f} profiled_wall_ms="
                        f"{wall * 1e3:.1f} busy_share_profiled="
                        f"{busy / (wall * 1e3):.3f} kernel_launches="
                        f"{sum(e.count for e in ev)} k4_ms={k4_ms:.2f}")
                if busy <= 0:
                    fail("the profiler saw no device time")
            else:
                t0 = time.perf_counter()
                proof = prove_fn()
                torch.cuda.synchronize()
                wall, text = time.perf_counter() - t0, None
        finally:
            for (mod, name), fn in zip(checked, originals):
                setattr(mod, name, fn)
            os.environ.pop("LASSO_TPU_DEVICE_TRANSCRIPT")
        counts = dict(field_cuda.launch_counts)
        if (counts["keccak"] > 0) != (route == "1"):
            fail(f"route {route}: K4 launches {counts['keccak']}")
        return proof, wall, counts, text

    flagship_prove = lambda: SparsePolynomialEvaluationProof.prove(  # noqa: E731
        dense, r, gens, strategy, ProofTranscript(b"example"),
        RandomTape(b"proof"))
    jd = bench.make_instance("and", 8, 1 << 16, 1 << jd_log_s, dev)
    jd_comm = jd.dense.commit(jd.gens)
    route_runs = {}
    for cfg, prove_fn, public, want_sha in (
            ("flagship", flagship_prove, flagship_public,
             hashlib.sha256(pb).hexdigest()),
            ("jolt_demo_fused", lambda: bench.prove(jd),
             (jd_comm, jd.r, jd.gens),
             runs["fused"]["entry"]["proof_sha256"])):
        for i, route in enumerate(("0", "1", "1", "0")):
            proof, wall, counts, _ = prove_route(route, prove_fn)
            got_sha = hashlib.sha256(serialize_proof(proof)).hexdigest()
            if got_sha != want_sha:
                fail(f"{cfg} route {route}: proof sha256 {got_sha} != "
                     f"{want_sha}")
            if i in (1, 3):  # one proof of each route
                proof.verify(*public, ProofTranscript(b"example"))
            route_runs.setdefault(cfg, []).append((route, wall, counts))
            print(f"phase 10 [{elapsed()}] {cfg} {['host', 'device'][int(route)]} route "
                  f"(turn {i + 1}): prove_s={wall:.3f} proof_sha256={got_sha}"
                  f" launches={json.dumps(counts)}", flush=True)
            del proof
        # the device route's profiled prove is phase 5's (flagship) and
        # phase 8's (fused jolt-demo)
        _, wall, counts, text = prove_route("0", prove_fn, True)
        print(f"phase 10 [{elapsed()}] {cfg} host route profiled prove: "
              f"{text} launches={json.dumps(counts)}", flush=True)
    print(f"phase 10 [{elapsed()}] routes: flagship and jolt-demo bytes equal on both "
          "routes; the device-transcript rounds ran under "
          "set_sync_debug_mode('error') with no host sync", flush=True)
    del jd, jd_comm
    k4_launches = {f"{cfg}_device_prove": route_runs[cfg][1][2]["keccak"]
                   for cfg in route_runs}

    # -- 11. the multi-device prover: the flagship as ranks on the card -------
    from lasso_tpu_torch.entry import Spec, prove_instances
    from lasso_tpu_torch.parallel.launch import spawn

    want = (pb, serialize_commitment(flagship_public[0]))  # phase 5's bytes
    del gens, flagship_prove  # phase 12 reads `dense` again
    torch.cuda.empty_cache()
    sharded_launches = {}
    for label, ranks, backend in (("nccl_1rank", 1, "nccl"),
                                  ("gloo_4ranks", 4, "gloo")):
        t0 = time.perf_counter()
        results = spawn(prove_instances, ranks, backend, "cuda:0",
                        [Spec("and", 1, 1 << log_m, 1 << log_s)], 2)
        spawn_s = time.perf_counter() - t0
        per_rank = []
        for rank, (res,) in enumerate(results):
            if (res["proof"], res["commitment"]) != want:
                fail(f"phase 11 {label}: rank {rank}'s proof or commitment "
                     "bytes differ from phase 5's")
            if min(res["launches"][k] for k in (
                    "mont_mul", "padd", "keccak", "field_addsub",
                    "field_sum")) <= 0:
                fail(f"phase 11 {label}: rank {rank} launches "
                     f"{res['launches']}")
            per_rank.append({
                "rank": rank, "commit_s": round(res["commit_s"], 3),
                "prove_s": [round(t, 3) for t in res["prove_s"]],
                "launches": res["launches"],
                "peak_mem_gib": round(res["peak_mem_bytes"] / 2**30, 3),
                "shard_peak_mem_gib": round(
                    res["shard_peak_mem_bytes"] / 2**30, 3)})
        if not results[0][0]["verified"]:
            fail(f"phase 11 {label}: rank 0 did not verify")
        for k in ("mont_mul", "padd", "keccak", "field_arith"):
            sharded_launches.setdefault(k, {})[
                f"flagship_sharded_{label}_prove_per_rank"] = [
                    k5_launches(r["launches"]) if k == "field_arith"
                    else r["launches"][k] for r in per_rank]
        print(f"phase 11 [{elapsed()}] flagship sharded {label} "
              f"(backend={backend}, ranks={ranks}, all on cuda:0): "
              f"spawn_s={spawn_s:.1f} proof_sha256="
              f"{hashlib.sha256(results[0][0]['proof']).hexdigest()} "
              "proof+commitment bytes == phase 5's on every rank, "
              f"verify=accepted (rank 0) per_rank={json.dumps(per_rank)}",
              flush=True)
    print(f"phase 11 [{elapsed()}] card: {card_line()} (ranks sharing one "
          "card: correctness and per-rank dispatch, not scaling)", flush=True)

    # -- 12. the reference's public API at full width --------------------------
    t12 = time.perf_counter()
    api_launches = public_api_phase(dev, dense, strategy, r, card_line(),
                                    np.random.default_rng(20241018))
    print(f"phase 12 [{elapsed()}] public API: phase_s="
          f"{time.perf_counter() - t12:.1f} k1_launches="
          f"{json.dumps(api_launches)}", flush=True)
    del dense

    def kernel_row(name, source, replaces, launches, err, main, by_path):
        """The kernels line's entry: the contract's keys at the main path's
        shape ("ms" is the kernel's device time per launch there), then
        every timed shape and the launches on each path."""
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "equal": True, "max_abs_err": err, "ms": main["device_ms"],
                "host_loop_ms": main["host_loop_ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                "shape": main["shape"], "launches_by_path": by_path,
                "timed": timed[name.split()[0]]}

    kernels = {"kernels": [
        kernel_row("mont_mul (K1)", "lasso_tpu_torch/csrc/mont_mul.cu",
                   "lasso_tpu/ops/field_pallas.py:95",
                   prove_counts["mont_mul"], k1["max_abs_err"], k1_main,
                   {"flagship_prove": prove_counts["mont_mul"],
                    "jolt_demo_fused_prove": jd_counts["mont_mul"],
                    **sharded_launches["mont_mul"],
                    **{f"public_api_{k}": v for k, v in api_launches.items()}}),
        kernel_row("mont_mul_lm (K2)", "lasso_tpu_torch/csrc/mont_mul_lm.cu",
                   "lasso_tpu/ops/field_pallas.py:112",
                   cli_counts["mont_mul_lm"], max(k2["max_abs_err"], err2),
                   k2_main,
                   {"jolt_demo_unfused_cli_pass": cli_counts["mont_mul_lm"],
                    "jolt_demo_unfused_prove": u_counts["mont_mul_lm"]}),
        kernel_row("padd (K3)", "lasso_tpu_torch/csrc/padd.cu",
                   "lasso_tpu/ops/field_pallas.py:234",
                   prove_counts["padd"], k3_err, k3_main,
                   {"flagship_prove": prove_counts["padd"],
                    "jolt_demo_fused_prove": jd_counts["padd"],
                    **sharded_launches["padd"]}),
        kernel_row("keccak (K4)", "lasso_tpu_torch/csrc/keccak.cu",
                   "lasso_tpu/transcript/device_strobe.py:78",
                   prove_counts["keccak"], k4_err, k4_main,
                   {"flagship_prove": prove_counts["keccak"],
                    "jolt_demo_fused_prove": jd_counts["keccak"],
                    "jolt_demo_unfused_cli_pass": cli_counts["keccak"],
                    **k4_launches, **sharded_launches["keccak"]}),
        kernel_row("field_arith (K5)", "lasso_tpu_torch/csrc/field_arith.cu",
                   "none: the reference leaves these chains to XLA",
                   k5_launches(prove_counts), k5_err, k5_main,
                   {"flagship_prove": k5_launches(prove_counts),
                    "jolt_demo_fused_prove": k5_launches(jd_counts),
                    "jolt_demo_unfused_prove": k5_launches(u_counts),
                    **sharded_launches["field_arith"]}),
    ]}
    kernels["kernels"][-2]["latency_bound_ms"] = k4_main["latency_bound_ms"]
    print(json.dumps(kernels), flush=True)
    print(f"card: {card_line()} total_s={time.perf_counter() - t_start:.1f}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
