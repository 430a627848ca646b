"""Grand product circuits + batched argument (port of
subprotocols/grand_product.py; reference: src/subprotocols/grand_product.rs).

A batch of I same-sized product circuits is one tensor per layer
([I, len, W]), built bottom-up with one Montgomery product per layer; the
batched layer sumcheck runs through subprotocols/sumcheck.
prove_cubic_batched with all instances on the leading axis.

With the transcript on the device (sumcheck._device_sumcheck_supported),
every layer -- its RLC coefficients, the eq table, the cubic rounds, the
claim appends and the layer challenge -- runs in one loop on the device,
and the argument downloads once at its end.  The reference fuses only the
layers that fit its fixed XLA buffers (GP_FIX_CAP) and runs the rest
through prove_cubic_batched; the port runs every layer at its exact shape,
with the same transcript bytes.

ShardedBatchedGPCircuit is the circuit of one rank of a mesh; the same
argument proves it, its wide layers through the sharded sumcheck.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr, W
from lasso_tpu_torch.poly.dense import (eq_evals_device, eq_evaluate_host,
                                        eq_table)
from lasso_tpu_torch.subprotocols.sumcheck import (SumcheckInstanceProof,
                                                   _cubic_rounds_device,
                                                   _device_sumcheck_supported,
                                                   _round_polys,
                                                   prove_cubic_batched)
from lasso_tpu_torch.transcript.device_strobe import (DeviceTranscript,
                                                      _post_challenge_meta,
                                                      scalar_bytes)
from lasso_tpu_torch.utils.errors import LassoError
from lasso_tpu_torch.utils.tracing import instrument, span


def _layer_product(vals):
    """[I, n, W] -> [I, n/2, W]: pairwise left*right products."""
    half = vals.shape[1] // 2
    return TFr.mul(vals[:, :half], vals[:, half:])


# Product-tree layers above this many field elements are not kept resident:
# the layer loop recomputes them from the leaves on demand.
GP_STORE_ELEMS = 1 << 22


class _HalfView:
    """Lazy left/right halves of the per-layer product tensors."""

    def __init__(self, circuit: "BatchedGrandProductCircuit", side: int):
        self._circuit = circuit
        self._side = side

    def __len__(self) -> int:
        return self._circuit.num_layers

    def __getitem__(self, i: int) -> torch.Tensor:
        return self._circuit.layer_half(i, self._side)


class BatchedGrandProductCircuit:
    """I product-tree circuits over inputs [I, n, W] (n a power of two).

    Storage: the leaves plus every layer small enough for GP_STORE_ELEMS;
    wider layers are recomputed from the leaves on demand."""

    def __init__(self, inputs: torch.Tensor = None, leaves_fn=None,
                 shape: tuple = None):
        """Either hold `inputs` [I, n, W] as the leaves, or pass
        `leaves_fn(half)` + `shape=(I, n)` when the leaves are cheaply
        derivable: `leaves_fn(None)` returns the full leaves,
        `leaves_fn(0|1)` just the left/right half.  The leaves then never
        stay resident."""
        if leaves_fn is None:
            assert inputs.ndim == 3
            num_instances, n = inputs.shape[0], inputs.shape[1]
        else:
            num_instances, n = shape
        assert n & (n - 1) == 0 and n >= 2
        self.num_instances = num_instances
        self._num_layers = (n - 1).bit_length()
        self._leaves = inputs
        self._leaves_fn = leaves_fn
        self._stored: dict[int, torch.Tensor] = {}
        self._memo: tuple[int, torch.Tensor] | None = None
        cur = inputs if leaves_fn is None else leaves_fn(None)
        self.device = cur.device
        t = 0
        while cur.shape[1] > 2:
            cur = _layer_product(cur)
            t += 1
            if cur.numel() // W <= GP_STORE_ELEMS:
                self._stored[t] = cur
        self._top_t = t  # layer index of the width-2 top (0 when n == 2)
        if t and t not in self._stored:
            self._stored[t] = cur

    def layer(self, t: int) -> torch.Tensor:
        """Layer t values [I, n / 2^t, W] (recomputed if not resident)."""
        if t == 0:
            return (self._leaves if self._leaves_fn is None
                    else self._leaves_fn(None))
        got = self._stored.get(t)
        if got is not None:
            return got
        if self._memo is not None and self._memo[0] == t:
            return self._memo[1]
        cur = self.layer(0)
        for _ in range(t):
            cur = _layer_product(cur)
        # both halves of a layer are fetched back to back: keep the last
        # recompute
        self._memo = (t, cur)
        return cur

    def layer_half(self, t: int, side: int) -> torch.Tensor:
        """Left (side=0) / right (side=1) half of layer t."""
        if t == 0 and self._leaves_fn is not None:
            return self._leaves_fn(side)
        vals = self.layer(t)
        half = vals.shape[1] // 2
        return vals[:, :half] if side == 0 else vals[:, half:]

    def argument_layer(self, layer_id: int):
        """(left half, right half, mesh) of layer `layer_id` for the
        argument: whole on this device, so no mesh."""
        return self.left_layers[layer_id], self.right_layers[layer_id], None

    @property
    def left_layers(self) -> _HalfView:
        return _HalfView(self, 0)

    @property
    def right_layers(self) -> _HalfView:
        return _HalfView(self, 1)

    @property
    def num_layers(self) -> int:
        return self._num_layers

    def release(self) -> None:
        """Drop all layer tensors once the argument is done."""
        self._leaves = None
        self._leaves_fn = None
        self._stored = {}
        self._memo = None

    def evaluate_device(self) -> torch.Tensor:
        """Root products, one per instance ([I, W] Montgomery)."""
        top = self.layer(self._top_t)
        return TFr.mul(top[:, 0], top[:, 1])

    def evaluate(self) -> list[int]:
        """Root products, one per instance (host ints)."""
        return TFr.decode(self.evaluate_device())


class GrandProductCircuit:
    """Single product-tree circuit (reference: grand_product.rs:13-65): a
    one-instance BatchedGrandProductCircuit, whose halves it reads."""

    def __init__(self, poly):
        z = poly.z if hasattr(poly, "z") else poly
        self._batched = BatchedGrandProductCircuit(z[None])

    @property
    def num_layers(self) -> int:
        return self._batched.num_layers

    def left_vec(self, layer: int) -> torch.Tensor:
        return self._batched.left_layers[layer][0]

    def right_vec(self, layer: int) -> torch.Tensor:
        return self._batched.right_layers[layer][0]

    def evaluate(self) -> int:
        return self._batched.evaluate()[0]


class ShardedBatchedGPCircuit:
    """BatchedGrandProductCircuit over cyclic-sharded leaves [I, n/D, W]
    (one rank of a mesh, parallel/mesh.py): rank-local layers while a layer
    is wider than the mesh (the pair (k, k + n/2) lies on one rank), then a
    replicated top circuit over the gathered layer, at least two wide.
    Multiplication is associative: the roots are the same."""

    def __init__(self, mesh, leaves):
        d = mesh.size
        self.mesh = mesh
        self.device = leaves.device
        self.num_instances = leaves.shape[0]
        n = leaves.shape[1] * d
        self.num_layers = _log2(n)
        top_width = max(d, 2)
        self._sharded = []  # layers of global width n, n/2, ... > top_width
        cur = leaves
        while cur.shape[1] * d > top_width:
            self._sharded.append(cur)
            cur = _layer_product(cur)
        self.top = BatchedGrandProductCircuit(mesh.gather(cur, axis=1))

    def argument_layer(self, layer_id: int):
        """(left half, right half, mesh or None): a wide layer's halves are
        this rank's shards, the top circuit's are whole."""
        if layer_id >= len(self._sharded):
            return self.top.argument_layer(layer_id - len(self._sharded))
        vals = self._sharded[layer_id]
        half = vals.shape[1] // 2
        return vals[:, :half], vals[:, half:], self.mesh

    def evaluate(self) -> list[int]:
        return self.top.evaluate()

    def release(self) -> None:
        self._sharded = []
        self.top.release()


def _log2(n: int) -> int:
    return (n - 1).bit_length()


@dataclass
class LayerProofBatched:
    proof: SumcheckInstanceProof
    claims_prod_left: list[int]
    claims_prod_right: list[int]


@dataclass
class BatchedGrandProductArgument:
    proof: list[LayerProofBatched]

    @staticmethod
    @instrument("BatchedGrandProductArgument.prove", sync=True)
    def prove(circuits, transcript):
        """Returns (argument, rand).  `circuits` is a
        BatchedGrandProductCircuit or a ShardedBatchedGPCircuit; the
        argument is the same."""
        num_layers = circuits.num_layers
        device = circuits.device
        if isinstance(circuits, BatchedGrandProductCircuit) and \
                _device_sumcheck_supported(transcript, device):
            return BatchedGrandProductArgument._prove_device(circuits,
                                                             transcript)
        claims_to_verify = circuits.evaluate()
        proof_layers: list[LayerProofBatched] = []
        rand: list[int] = []

        for layer_id in range(num_layers - 1, -1, -1):
            num_rounds = num_layers - 1 - layer_id
            left, right, mesh = circuits.argument_layer(layer_id)
            eq_poly = eq_table(rand, device, mesh)
            assert eq_poly.shape[0] == left.shape[1]

            coeffs = transcript.challenge_vector(
                b"rand_coeffs_next_layer", len(claims_to_verify))
            claim = sum(c * v for c, v in zip(coeffs, claims_to_verify)) % Fr.p

            proof, rand_prod, (claims_left, claims_right, _claim_eq) = \
                prove_cubic_batched(claim, num_rounds, left, right, eq_poly,
                                    coeffs, transcript, mesh)

            for cl, cr in zip(claims_left, claims_right):
                transcript.append_scalar(b"claim_prod_left", cl)
                transcript.append_scalar(b"claim_prod_right", cr)

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [
                (cl + r_layer * (cr - cl)) % Fr.p
                for cl, cr in zip(claims_left, claims_right)
            ]
            rand = [r_layer] + rand_prod
            proof_layers.append(LayerProofBatched(proof, claims_left, claims_right))

        return BatchedGrandProductArgument(proof_layers), rand

    @staticmethod
    def _prove_device(circuits: BatchedGrandProductCircuit, transcript):
        """The argument with the transcript on the circuits' device: one
        upload of the strobe state, one download at the end."""
        num_layers = circuits.num_layers
        i_cnt = circuits.num_instances
        dt = DeviceTranscript.from_host(transcript, circuits.device)
        limbs = _prove_layers_device(circuits, dt)
        vals = TFr.decode(dt.finish(transcript, limbs))

        proof_layers: list[LayerProofBatched] = []
        off = 0
        for t in range(num_layers):  # layer t has t rounds
            polys, _ = _round_polys(vals[off:], t, 4)
            off += 5 * t
            cl, cr = vals[off: off + i_cnt], vals[off + i_cnt: off + 2 * i_cnt]
            off += 2 * i_cnt
            proof_layers.append(
                LayerProofBatched(SumcheckInstanceProof(polys), cl, cr))
        rand = vals[off:]
        assert len(rand) == num_layers
        return BatchedGrandProductArgument(proof_layers), rand

    def verify(self, claims_prod_vec: list[int], n: int, transcript):
        """Returns (claims_to_verify, rand). Host-side."""
        num_layers = (n - 1).bit_length()
        if len(self.proof) != num_layers:
            raise LassoError("grand product argument has wrong number of layers")
        rand: list[int] = []
        claims_to_verify = list(claims_prod_vec)

        for num_rounds, layer in enumerate(self.proof):
            coeffs = transcript.challenge_vector(
                b"rand_coeffs_next_layer", len(claims_to_verify))
            claim = sum(c * v for c, v in zip(coeffs, claims_to_verify)) % Fr.p

            claim_last, rand_prod = layer.proof.verify(claim, num_rounds, 3, transcript)

            claims_left = layer.claims_prod_left
            claims_right = layer.claims_prod_right
            if len(claims_left) != len(claims_prod_vec) or \
               len(claims_right) != len(claims_prod_vec):
                raise LassoError("claim count mismatch in grand product layer")

            for cl, cr in zip(claims_left, claims_right):
                transcript.append_scalar(b"claim_prod_left", cl)
                transcript.append_scalar(b"claim_prod_right", cr)

            if len(rand) != len(rand_prod):
                raise LassoError("rand length mismatch in grand product layer")
            eq_eval = eq_evaluate_host(rand, rand_prod)
            claim_expected = sum(
                c * (cl * cr % Fr.p * eq_eval) for c, cl, cr in
                zip(coeffs, claims_left, claims_right)) % Fr.p
            if claim_expected != claim_last:
                raise LassoError("grand product layer claim mismatch")

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [
                (cl + r_layer * (cr - cl)) % Fr.p
                for cl, cr in zip(claims_left, claims_right)
            ]
            rand = [r_layer] + rand_prod

        return claims_to_verify, rand


def _prove_layers_device(circuits: BatchedGrandProductCircuit, dt):
    """Every layer of the batched argument, from the root down, with the
    transcript `dt` on the device; no host sync.  Returns limbs [k, W]: per
    layer t its t rounds (4 coefficients and the challenge each), then the
    I left and the I right claims; last the final point rand [L, W]."""
    num_layers = circuits.num_layers
    i_cnt = circuits.num_instances
    device = circuits.device
    claims = circuits.evaluate_device()  # [I, W]
    rand: list[torch.Tensor] = []
    out = []
    for layer_id in range(num_layers - 1, -1, -1):
        with span("GP.layer"):
            coeffs = torch.stack([
                dt.challenge_scalar(b"rand_coeffs_next_layer")
                for _ in range(i_cnt)])  # [I, W]
            claim = TFr.finish_sum(TFr.sum_columns(TFr.mul(coeffs, claims)))
            with span("GP.eq_table"):
                eq_poly = eq_evals_device(rand, device)
            with span("GP.cubic_rounds"):
                a, b, _, rows, rs = _cubic_rounds_device(
                    dt, circuits.left_layers[layer_id],
                    circuits.right_layers[layer_id], eq_poly, claim, coeffs,
                    len(rand))
            with span("GP.claims_and_challenge"):
                left, right = a[:, 0], b[:, 0]  # [I, W]
                lb, rb = scalar_bytes(left), scalar_bytes(right)
                for i in range(i_cnt):
                    dt.append_message_dynamic(b"claim_prod_left", lb[i])
                    dt.append_message_dynamic(b"claim_prod_right", rb[i])
                r_layer = dt.challenge_scalar(b"challenge_r_layer")
                assert dt.meta() == _post_challenge_meta(), \
                    "strobe layer exit not canonical"
                claims = TFr.add(left, TFr.mul(r_layer, TFr.sub(right, left)))
        rand = [r_layer] + rs
        out += rows + [left, right]
    return torch.cat(out + [torch.stack(rand)])
