"""The port stands alone: lasso_tpu_torch (its multi-device prover and
entry points included) and chip_smoke.py import neither JAX nor the JAX
package, and the entry points -- the densifier and generators, the mesh,
its launcher and lasso_tpu_torch.entry -- run on the card unless the caller
asks for the CPU, with no silent fallback."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import pkgutil, sys
import lasso_tpu_torch
for mod in pkgutil.walk_packages(lasso_tpu_torch.__path__, "lasso_tpu_torch."):
    __import__(mod.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "lasso_tpu"
             or m.startswith("lasso_tpu."))
assert not bad, bad
for needed in ("lasso_tpu_torch.entry", "lasso_tpu_torch.parallel.mesh",
               "lasso_tpu_torch.parallel.launch",
               "lasso_tpu_torch.parallel.sharded",
               "lasso_tpu_torch.parallel.checks"):
    assert needed in sys.modules, needed
print("imported", len([m for m in sys.modules if m.startswith("lasso_tpu_torch")]))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert not any(n == "jax" or n.startswith("jax.") or n == "lasso_tpu"
                   or n.startswith("lasso_tpu.") for n in names), names


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
    from lasso_tpu_torch.lasso.surge import SparsePolyCommitmentGens

    with pytest.raises(RuntimeError):
        DensifiedRepresentation([[1]] * 4, 4, 1)
    with pytest.raises(RuntimeError):
        SparsePolyCommitmentGens.new(b"gens_sparse_poly", 1, 4, 1, 4)
    dense = DensifiedRepresentation([[1]] * 4, 4, 1, device="cpu")
    assert dense.combined_l_variate_polys.z.device.type == "cpu"

    # the dense polynomial's constructors: the card by default, too
    from lasso_tpu_torch.poly.dense import DensePolynomial

    for make in (DensePolynomial.from_ints, DensePolynomial.from_u64):
        with pytest.raises(RuntimeError):
            make([1, 2, 3, 4])
        assert make([1, 2, 3, 4], device="cpu").z.device.type == "cpu"

    # the multi-device entry points: no card, no CUDA mesh, no NCCL rank
    from lasso_tpu_torch import entry
    from lasso_tpu_torch.parallel.launch import spawn
    from lasso_tpu_torch.parallel.mesh import make_mesh

    never = "file:///nonexistent/rendezvous"  # raised before it is opened
    with pytest.raises(RuntimeError):
        make_mesh(0, 1, never, "gloo")
    with pytest.raises(ValueError):  # more NCCL ranks than cards
        make_mesh(0, 1, never, "nccl", device="cpu")
    with pytest.raises(RuntimeError):
        spawn(entry.prove_instances, 2, "gloo", "cuda", [])
    with pytest.raises(ValueError):
        spawn(entry.prove_instances, 2, "nccl", "cpu", [])
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError):
        entry.entry()
    step, (stack, r) = entry.entry("cpu")
    evals, bound = step(stack, r)
    assert evals.shape == (3, 16) and bound.shape == (5, 512, 16)
    assert bound.device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, str(tmp_path / "chip_smoke.py"))):
        if cwd == tmp_path:  # alone, without the rest of the repo
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
