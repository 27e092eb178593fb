"""Host layer of the PyTorch port against the JAX package.

The port copies the NumPy host layer (options, problem building,
preprocess, to_square_form, init_state) instead of importing it, because
importing ``proxsdp_tpu`` loads jax.  These tests hold the copies to the
originals exactly (``np.array_equal``), check that the port never imports
jax, and that options outside the port raise.  (The default hybrid
driver, the polar and subspace projections and f32 programs, which raised
here before they were ported, are solved against the JAX package in
tests/test_torch_hybrid.py.)"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.problem import preprocess as j_pre, to_square_form as j_sq
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.problem import preprocess as t_pre, to_square_form as t_sq

CASES = ["maxcut30", "maxcut50", "readme"]


def _dense(M):
    return M.toarray() if sp.issparse(M) else np.asarray(M)


def _assert_setup_equal(a, b):
    assert dataclasses.asdict(a.layout) == dataclasses.asdict(b.layout)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "layout":
            continue
        if sp.issparse(va) or sp.issparse(vb) or isinstance(va, np.ndarray):
            assert np.array_equal(_dense(va), _dense(vb)), f.name
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("name", CASES)
def test_problem_and_preprocess_equal(name):
    pj, pt = tp.build_problem(jx, name), tp.build_problem(tx, name)
    for attr in ("c", "b", "h"):
        assert np.array_equal(getattr(pj, attr), getattr(pt, attr)), attr
    assert np.array_equal(_dense(pj.A), _dense(pt.A))
    assert [list(v) for v in pj.sdp_vars] == [list(v) for v in pt.sdp_vars]
    sj, st = j_pre(pj), t_pre(pt)
    _assert_setup_equal(sj, st)
    _assert_setup_equal(j_sq(sj), t_sq(st))


@pytest.mark.parametrize("kw", [{}, {"dtype": "float32"}, {"subspace_rank": 8}],
                         ids=["f64", "f32", "subspace"])
@pytest.mark.parametrize("name", CASES)
def test_init_state_equal(name, kw):
    """f64 and f32 states, and the orthonormal (side, k) start basis of a
    subspace program (maxcut30, maxcut50; the README block is too small)."""
    sj = tp.jax_setup(name)
    st = t_sq(t_pre(tp.build_problem(tx, name)))
    want = tp.jax_state_numpy(
        jsolver.init_state(sj.layout, tp.jax_opts(**kw), sj))
    got = tsolver.init_state(st.layout, tp.torch_opts(**kw), st)
    assert set(got) == set(want) == set(jsolver.State._fields)
    for k in want:
        if k == "warm":
            assert all(np.array_equal(g, w) for g, w in zip(got[k], want[k]))
        else:
            g, w = np.asarray(got[k]), want[k]
            assert g.dtype == w.dtype and np.array_equal(g, w), k


def test_state_round_trip():
    sj = tp.jax_setup("maxcut30")
    host = tp.jax_state_numpy(jsolver.init_state(sj.layout, tp.jax_opts(), sj))
    back = tx.convert.state_to_numpy(tx.convert.state_from_numpy(host, "cpu"))
    tp.assert_states_close(back, host, rtol=0, atol=0)


def test_options_fields_and_defaults_equal():
    fj = [(f.name, f.default) for f in dataclasses.fields(jx.Options)]
    ft = [(f.name, f.default) for f in dataclasses.fields(tx.Options)]
    assert fj == ft
    with pytest.raises(ValueError):
        tx.make_options(no_such_option=1)


def test_import_leaves_jax_out():
    code = (
        "import sys, proxsdp_tpu_torch, proxsdp_tpu_torch.solver, "
        "proxsdp_tpu_torch.convert, proxsdp_tpu_torch.kernels, "
        "proxsdp_tpu_torch.kernels.build, proxsdp_tpu_torch.models, "
        "proxsdp_tpu_torch.ops.cones, proxsdp_tpu_torch.ops.linop, "
        "proxsdp_tpu_torch.ops.tri, proxsdp_tpu_torch.parallel.batch\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'proxsdp_tpu' or m.startswith('proxsdp_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _soc_problem():
    opt = tx.Optimizer()
    s = opt.add_soc_var(3)
    opt.add_eq_constraint({int(s[1]): 1.0}, 3.0)
    opt.add_eq_constraint({int(s[2]): 1.0}, 4.0)
    opt.set_objective({int(s[0]): 1.0})
    return opt.build_problem()


def _two_block_problem():
    opt = tx.Optimizer()
    for _ in range(2):
        X = opt.add_psd_var(3)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
    opt.set_objective({0: 1.0})
    return opt.build_problem()


@pytest.mark.parametrize(
    "problem, options",
    [
        ("readme", tx.Options(subspace_sign=True)),
        ("readme", tx.Options(subspace_accept_always=True)),
        ("readme", tp.torch_opts(square_form=False)),
        ("readme", tp.torch_opts(block_equilibration=True)),
        ("readme", tp.torch_opts(equilibration=True)),
        ("readme", tp.torch_opts(linop="coo")),
        ("readme", tp.torch_opts(checkpoint_path="ck.npz")),
        ("readme", tp.torch_opts(tp_shards=2)),
        ("soc", tp.torch_opts()),
        ("two_blocks", tp.torch_opts()),
    ],
    ids=["subspace_sign", "accept_always", "tri_layout", "beq",
         "equilibration", "coo", "checkpoint", "tp_shards", "soc",
         "two_blocks"],
)
def test_unsupported_raises(problem, options):
    prob = {"readme": lambda: tp.build_problem(tx, "readme"),
            "soc": _soc_problem, "two_blocks": _two_block_problem}[problem]()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tx.solve(prob, options, device="cpu")


def test_solve_requires_device(monkeypatch):
    """solve() runs on the card by default; where there is none it raises
    and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.solve(tp.build_problem(tx, "readme"))
