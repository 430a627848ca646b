"""Phase tracing of the port (lasso_tpu_torch/utils/tracing.py) on the CPU.

A small AND instance is proven on the device-transcript route with tracing
off, with LASSO_TPU_TRACE=1 and under the CPU profiler.  Its proof and
commitment bytes are pinned here (sha256 and length, as read with tracing
off) and must not depend on tracing.  Off, no dispatch mode is active
inside a span, every span's `counts` stays empty, and only the five spans
whose time a per-layer metric reads synchronize the device.  Traced, two
proves after a first count the same in every span, the primary sumcheck's
rounds open one span of each phase a round, none of which waits for the
device, each synchronizing span counts its one sync and no other span
counts one, and the chart merges same-named siblings with their counts.
Under the profiler every span's name is a `record_function` range.  The
root store stays bounded without a reset.
"""

import hashlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lasso_tpu_torch.subtables.bitwise  # noqa: F401 (register strategies)
from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
from lasso_tpu_torch.lasso.surge import (SparsePolyCommitmentGens,
                                         SparsePolynomialEvaluationProof)
from lasso_tpu_torch.subtables.base import get_strategy
from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
from lasso_tpu_torch.transcript.random_tape import RandomTape
from lasso_tpu_torch.utils import tracing
from lasso_tpu_torch.utils.fixtures import gen_indices, gen_random_point
from lasso_tpu_torch.utils.serialize import (serialize_commitment,
                                             serialize_proof)

# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

# AND, C=2, M=2^4, s=2^4: every span of the device route (grand-product
# layers and round phases, Bullet rounds, MSMs) at a size whose prove
# under the CPU profiler stays near a minute
C, LOG_M, S = 2, 4, 16
# the bytes with tracing off, the same before spans counted
PINNED = {
    "proof": ("59ac6836720a8828406725e596f8a79fd753ea18c5bd0cd7bce91d623db33b02",
              5936),
    "commitment": (
        "8e8070e720904953a7e6411ec54fd099c175715faa0084ca748df0491ef335c0",
        424),
}
SYNCED = {"Densify", "Subtables.commit", "Sumcheck.prove",
          "BatchedGrandProductArgument.prove", "DotProductProofLog.prove"}
# the phases of each round of the primary sumcheck on the device route
ARBITRARY = ("Sumcheck.arbitrary_evals", "Sumcheck.arbitrary_challenge",
             "Sumcheck.arbitrary_bind")


def _digest(b: bytes):
    return hashlib.sha256(b).hexdigest(), len(b)


def _prove():
    """(proof digest, commitment digest, the span roots) of one densify,
    commit and prove."""
    strategy = get_strategy("and", C, 1 << LOG_M)
    gens = SparsePolyCommitmentGens.new(b"gens_sparse_poly", C, S,
                                        strategy.num_memories, LOG_M,
                                        device="cpu")
    tracing.reset_spans()
    dense = DensifiedRepresentation(gen_indices(S, 1 << LOG_M, C), LOG_M, C,
                                    device="cpu")
    comm = dense.commit(gens)
    proof = SparsePolynomialEvaluationProof.prove(
        dense, gen_random_point((S - 1).bit_length()), gens, strategy,
        ProofTranscript(b"tracing"), RandomTape(b"proof"))
    return (_digest(serialize_proof(proof)), _digest(serialize_commitment(comm)),
            tracing.span_tree())


def _walk(spans):
    for s in spans:
        yield s
        yield from _walk(s.children)


def _counts_tree(spans):
    return [(s.name, s.counts, _counts_tree(s.children)) for s in spans]


@pytest.mark.parametrize("mode", ["off", "env", "profiler"])
def test_prove_bytes_and_counts_under_tracing(mode, monkeypatch, capsys):
    monkeypatch.setenv("LASSO_TPU_DEVICE_TRANSCRIPT", "force")
    monkeypatch.delenv("LASSO_TPU_TRACE", raising=False)

    if mode == "off":
        synced, modes = [], []
        exit_ = tracing.Span.__exit__

        def checked_exit(self, *exc):
            modes.append(torch._C._len_torch_dispatch_stack())
            return exit_(self, *exc)

        # a card in use, as far as the spans can tell
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda device=None: synced.append(
                                tracing._STACK[-1].name))
        monkeypatch.setattr(tracing.Span, "__exit__", checked_exit)
        proof, comm, roots = _prove()
        monkeypatch.undo()
        assert set(synced) == SYNCED
        assert len(synced) == sum(s.name in SYNCED for s in _walk(roots))
        assert modes and not any(modes)
        assert all(s.counts == {} for s in _walk(roots))
    elif mode == "env":
        # the first prove of a process fills the generators' device caches,
        # so the counts compared are those of two proves after it
        assert _prove()[:2] == (PINNED["proof"], PINNED["commitment"])
        monkeypatch.setenv("LASSO_TPU_TRACE", "1")
        proof, comm, roots = _prove()
        again = _prove()
        assert again[:2] == (proof, comm)
        assert _counts_tree(again[2]) == _counts_tree(roots)
        assert "close SparsePoly.prove" in capsys.readouterr().err
        (prove,) = [s for s in roots if s.name == "SparsePoly.prove"]
        total = tracing.inclusive_counts(prove)
        assert total["ops"] > 0 and total["syncs"] > 0
        assert any("field.tfield" in s.counts.get("ops", {})
                   for s in _walk([prove]))
        # the chart: one line per name among siblings, with its counts
        tracing.print_span_tree()
        chart = capsys.readouterr().err.splitlines()
        layers = [ln for ln in chart if " GP.layer x" in ln]
        assert layers and all("ops=" in ln for ln in layers)
        assert sum(" Sumcheck.bind" in ln for ln in chart) <= len(layers)
        # one span of each phase a round of the primary sumcheck (log2 s
        # rounds), none of which waits for the device
        (sumcheck,) = [s for s in _walk([prove])
                       if s.name == "Sumcheck.prove"]
        for name in ARBITRARY:
            phases = [s for s in sumcheck.children if s.name == name]
            assert len(phases) == (S - 1).bit_length(), name
            assert all(tracing.inclusive_counts(s).get("syncs", 0) == 0
                       for s in phases), name
        # a card in use, as far as the spans can tell: each synchronizing
        # span counts its one sync, and no other span counts one
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
        synced = _prove()[2]
        assert {s.name for s in _walk(synced)} >= SYNCED
        assert all(s.counts.get("syncs", 0) == (s.name in SYNCED)
                   for s in _walk(synced))
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            proof, comm, roots = _prove()
        events = {e.name() for e in prof.profiler.kineto_results.events()}
        assert {s.name for s in _walk(roots)} <= events
        assert tracing.inclusive_counts(roots[-1])["ops"] > 0
    assert (proof, comm) == (PINNED["proof"], PINNED["commitment"])


def test_span_store_stays_bounded_without_reset():
    tracing.reset_spans()

    @tracing.instrument("Root")
    def root(i):
        with tracing.span(f"child {i}"):
            pass

    for i in range(3 * tracing.MAX_ROOTS + 5):
        root(i)
    roots = tracing.span_tree()
    assert len(roots) == tracing.MAX_ROOTS
    assert roots[-1].children[0].name == f"child {3 * tracing.MAX_ROOTS + 4}"
    assert roots[0].children[0].name == f"child {2 * tracing.MAX_ROOTS + 5}"
    assert all(s.end_ns >= s.start_ns for s in _walk(roots))
    tracing.reset_spans()
    assert tracing.span_tree() == []
