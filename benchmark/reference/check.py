"""The comparison that decides a run's `correct`: one pass's outputs against
the reference, as four counts, each with the limit 0.

  densify_mismatch   entries of the two committed tables (dims ++ read_ts,
                     final_ts) whose limbs differ from the reference's
  commit_mismatch    commitments (of the two) whose Hyrax rows are not the
                     Pedersen commitments of the reference's tables
  claim_mismatch     1 if the proof's claimed evaluation is not the sparse
                     polynomial's value at r
  proof_rejected     1 if the reference verifier refuses the proof (the
                     primary sumcheck, both grand-product arguments, the
                     hash layer and every Hyrax opening)

The claim and the verifier follow the configuration's subtable strategy,
its module in `benchmark/reference/strategies/` found by name.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import curve, lasso, strategies
from benchmark.reference.gens import generators

LIMITS = {"densify_mismatch": 0, "commit_mismatch": 0, "claim_mismatch": 0,
          "proof_rejected": 0}


def _decompress_all(points: list[bytes]):
    """The points, or None if one is no point of the curve."""
    try:
        return [curve.decompress(p) for p in points]
    except ValueError:
        return None


def judge(indices: np.ndarray, r: list[int], log_m: int, strategy: str,
          out: dict, transcript_label: bytes, gens_label: bytes, weights_rng,
          notes: list[str]) -> dict[str, int]:
    """Counts for one pass of the subtable strategy named `strategy`.
    `out` holds the program's outputs as plain data: `tables` (two int32
    [n, 16] limb arrays), `commitment` (two lists of compressed rows) and
    `proof` (the proof's fields, or None if the program gave none).  Each
    check's failure is described in `notes`."""
    strat = strategies.strategy(strategy)
    s_raw, c = indices.shape
    s = lasso.next_pow2(s_raw)
    counts = dict.fromkeys(LIMITS, 0)

    want = lasso.combined_tables(indices, log_m)
    for name, w, got in zip(("dims++read_ts", "final_ts"), want, out["tables"]):
        if got.shape != (w.size, 16):
            counts["densify_mismatch"] += w.size
            notes.append(f"densify: {name} has shape {got.shape}, "
                         f"expected ({w.size}, 16)")
            continue
        bad = int(np.count_nonzero(
            (got != lasso.montgomery_limbs(w)).any(axis=1)))
        counts["densify_mismatch"] += bad
        if bad:
            notes.append(f"densify: {bad} of {w.size} {name} entries differ")

    widest = max(1 << lasso.factored(lasso.log2(w.size))[1] for w in want)
    widest = max(widest, 1 << lasso.factored(
        lasso.log2(lasso.next_pow2(strat.num_memories(c) * s)))[1])
    stream = generators(gens_label, widest + 2)

    rows = []
    for name, w, got in zip(("l-variate", "log_m-variate"), want,
                            out["commitment"]):
        pts = _decompress_all(got)
        rows.append(pts)
        if pts is None or not lasso.rows_match(w, pts, stream, weights_rng):
            counts["commit_mismatch"] += 1
            notes.append(f"commitment: the {name} rows are not the reference's")

    proof = out["proof"]
    if proof is None:  # the program gave no proof: it failed
        counts["claim_mismatch"] = counts["proof_rejected"] = 1
        notes.append("no proof")
        return counts
    claim = lasso.evaluation(indices, r, log_m, strat)
    if proof["primary_sumcheck"]["claimed_evaluation"] != claim:
        counts["claim_mismatch"] = 1
        notes.append("claim: the claimed evaluation is not the reference's")

    if rows[0] is None or rows[1] is None:
        counts["proof_rejected"] = 1
        notes.append("verify: a commitment row is no curve point")
        return counts
    try:
        lasso.verify(proof, rows[0], rows[1], r, s, c, log_m, stream,
                     transcript_label, strat)
    except (lasso.Rejected, ValueError, KeyError, IndexError, TypeError,
            ZeroDivisionError) as e:
        counts["proof_rejected"] = 1
        notes.append(f"verify: rejected at {type(e).__name__}: {e}")
    return counts
