"""Host layer of the PyTorch port against the JAX package.

The port copies the NumPy host layer (options, problem building,
preprocess, to_square_form, init_state) instead of importing it, because
importing ``proxsdp_tpu`` loads jax.  These tests hold the copies to the
originals exactly (``np.array_equal``), check that the port never imports
jax, that options outside the port raise, and that the ones ported since
they raised here solve as the JAX package does.  (The default hybrid
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
        "proxsdp_tpu_torch.equilibration, proxsdp_tpu_torch.models.randsdp, "
        "proxsdp_tpu_torch.ops.cones, proxsdp_tpu_torch.ops.linop, "
        "proxsdp_tpu_torch.ops.tri, proxsdp_tpu_torch.parallel.batch, "
        "proxsdp_tpu_torch.parallel.sharded, proxsdp_tpu_torch.parallel.dist, "
        "proxsdp_tpu_torch.utils.checkpoint\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'proxsdp_tpu' or m.startswith('proxsdp_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _soc_problem(pkg):
    opt = pkg.Optimizer()
    s = opt.add_soc_var(3)
    opt.add_eq_constraint({int(s[1]): 1.0}, 3.0)
    opt.add_eq_constraint({int(s[2]): 1.0}, 4.0)
    opt.set_objective({int(s[0]): 1.0})
    return opt.build_problem()


def _two_block_problem(pkg):
    opt = pkg.Optimizer()
    for _ in range(2):
        X = opt.add_psd_var(3)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
    opt.set_objective({0: 1.0})
    return opt.build_problem()


def _problem(pkg, name):
    if name == "readme":
        return tp.build_problem(pkg, "readme")
    return {"soc": _soc_problem, "two_blocks": _two_block_problem}[name](pkg)


@pytest.mark.parametrize(
    "problem, options",
    [
        ("readme", tp.torch_opts(tp_shards=2)),
    ],
    ids=["tp_shards"],
)
def test_unsupported_raises(problem, options):
    """``tp_shards``, which raised until tensor parallelism was ported
    (ROADMAP A12), is a plain solve with no active mesh, as in the JAX
    package (the sharded solve: tests/test_torch_sharded.py)."""
    got = tx.solve(_problem(tx, problem), options, device="cpu")
    want = tx.solve(_problem(tx, problem), options.replace(tp_shards=0),
                    device="cpu")
    assert (got.status, got.iter, got.objval) == (want.status, want.iter,
                                                  want.objval)
    np.testing.assert_array_equal(got.primal, want.primal)


@pytest.mark.parametrize(
    "problem, kw",
    [
        ("readme", dict(block_equilibration=True)),
        ("readme", dict(equilibration=True, equilibration_force=True)),
        ("soc", {}),
        ("two_blocks", {}),
        ("readme", dict(linop="coo")),
    ],
    ids=["beq", "equilibration", "soc", "two_blocks", "coo"],
)
def test_formerly_unsupported_solves_match_jax(problem, kw):
    """Block and Ruiz equilibration, an SOC block, two PSD blocks and the
    COO operator, which raised before they were ported: the f64 program's
    status, iterations and objective against the JAX package's."""
    rj = jx.solve(_problem(jx, problem), tp.jax_opts(**kw))
    rt = tx.solve(_problem(tx, problem), tp.torch_opts(**kw), device="cpu")
    assert rt.status == rj.status == 1
    assert rt.iter == rj.iter
    assert abs(rt.objval - rj.objval) <= 1e-9 * (1 + abs(rj.objval))


def test_solve_requires_device(monkeypatch):
    """solve() runs on the card by default; where there is none it raises
    and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.solve(tp.build_problem(tx, "readme"))


# ---- the host copies of the API slice: models, the SDPA reader, ingest


def _problem_arrays(problem) -> dict:
    return {"c": problem.c, "A": _dense(problem.A), "b": problem.b,
            "G": _dense(problem.G), "h": problem.h,
            "sdp_vars": [np.asarray(v) for v in problem.sdp_vars],
            "soc_vars": [np.asarray(v) for v in problem.soc_vars]}


def _assert_problems_equal(pj, pt):
    aj, at = _problem_arrays(pj), _problem_arrays(pt)
    for key in aj:
        if isinstance(aj[key], list):
            assert len(aj[key]) == len(at[key]) and all(
                np.array_equal(x, y) for x, y in zip(aj[key], at[key])), key
        else:
            assert np.array_equal(aj[key], at[key]), key
    assert (pj.objective_sense, pj.objective_constant) == (
        pt.objective_sense, pt.objective_constant)


def test_mimo_copy_equal():
    """models/mimo.py: the data (s, H, y, L) and the problem, index matrix
    and signal of MIMO n = 5."""
    from proxsdp_tpu.models import mimo as jm
    from proxsdp_tpu_torch.models import mimo as tm

    for dj, dt in zip(jm.mimo_data(3, 50, 5), tm.mimo_data(3, 50, 5)):
        assert np.array_equal(dj, dt)
    pj, Xj, sj = jm.mimo_problem(0, 5)
    pt, Xt, st = tm.mimo_problem(0, 5)
    _assert_problems_equal(pj, pt)
    assert np.array_equal(Xj, Xt) and np.array_equal(sj, st)
    X = np.eye(6)
    for a, b in zip(jm.mimo_eval(sj, X), tm.mimo_eval(st, X)):
        assert np.array_equal(a, b)


def test_sensorloc_copy_equal():
    """models/sensorloc.py: the data and the problem of n = 10 (the 10 %
    sensor-pair sampling included)."""
    from proxsdp_tpu.models import sensorloc as js
    from proxsdp_tpu_torch.models import sensorloc as ts

    dj, dt = js.sensorloc_data(1, 10), ts.sensorloc_data(1, 10)
    assert dj[0] == dt[0] and np.array_equal(dj[1], dt[1])
    for a, b in zip(dj[2:], dt[2:]):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    pj, Xj, xj = js.sensorloc_problem(0, 10)
    pt, Xt, xt = ts.sensorloc_problem(0, 10)
    _assert_problems_equal(pj, pt)
    assert np.array_equal(Xj, Xt) and np.array_equal(xj, xt)


def test_sdplib_copy_equal(tmp_path, monkeypatch):
    """models/sdplib.py on a written .dat-s file: sdplib_data through the
    port's native parser and through its Python one equal the JAX
    package's Python parser (the JAX package's native build is left alone:
    it writes into that package, non-atomically), and the problems of both
    embeddings are equal."""
    from proxsdp_tpu.models import sdplib as jsd
    from proxsdp_tpu_torch.models import sdplib as tsd

    monkeypatch.setattr(jsd, "_try_native", lambda path: None)
    path = tp.write_sdpa(tmp_path)
    want = jsd.sdplib_data(path)
    for got in (tsd.sdplib_data(path), tsd._parse_python(path),
                tsd._try_native(path)):
        assert got is not None and len(got) == len(want) == 4
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert jsd.sdplib_blocks(path) == tsd.sdplib_blocks(path) == [2, -2]
    for split in (True, False):
        (pj, Xj), (pt, Xt) = (jsd.sdplib_problem(path, split_blocks=split),
                              tsd.sdplib_problem(path, split_blocks=split))
        _assert_problems_equal(pj, pt)
        assert np.array_equal(Xj, Xt)


def test_sdpa_parser_builds_atomically(tmp_path, monkeypatch):
    """utils/native.py builds its library into the checkout's build/
    directory (here a temporary one), under a temporary name in that
    directory moved into place by os.replace, and never into the package
    (the JAX package's copy writes _native.so in place, non-atomically)."""
    import os

    from proxsdp_tpu_torch.utils import native

    assert native.BUILD_DIR.parts[-2:] == ("build", "proxsdp_tpu_torch")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    moves = []
    real_replace = os.replace

    def replace(src, dst):
        moves.append((str(src), str(dst)))
        assert os.path.getsize(src) > 0  # written in full before the move
        real_replace(src, dst)

    monkeypatch.setattr(native.os, "replace", replace)
    path = native.library_path()
    assert path.parent == tmp_path / "build" and not path.exists()
    n, m, entries, c = native.parse_sdpa(tp.write_sdpa(tmp_path))
    assert (n, m, entries.shape) == (4, 2, (10, 4))
    assert path.exists() and len(moves) == 1
    src, dst = moves[0]
    assert dst == str(path) and os.path.dirname(src) == str(path.parent)
    assert sorted(os.listdir(path.parent)) == [path.name]  # no temporary left
    package = native.SOURCE.parent
    assert not any(f.endswith(".so") for f in os.listdir(package))


@pytest.mark.parametrize("dims", [dict(z=1, l=2), dict(z=1, l=1, q=(2,), s=(2,)),
                                  dict(q=(3,), s=(3,))],
                         ids=["lp", "all_cones", "soc_psd"])
def test_cone_program_to_conic_equal(dims):
    """ingest.cone_program_to_conic: the lowered problem's A, b, c, G, h and
    cone layout, and the recovered (x, y, s) of one Result, equal the JAX
    package's."""
    from proxsdp_tpu.ingest import ConeDims as JD, cone_program_to_conic as jc
    from proxsdp_tpu_torch.ingest import (ConeDims as TD,
                                          cone_program_to_conic as tc)

    rows = JD(**dims).total_rows
    assert rows == TD(**dims).total_rows
    rng = np.random.default_rng(0)
    n = 3
    c, A, b = rng.standard_normal(n), rng.standard_normal((rows, n)), \
        rng.standard_normal(rows)
    (pj, rec_j), (pt, rec_t) = jc(c, A, b, JD(**dims)), tc(c, A, b, TD(**dims))
    _assert_problems_equal(pj, pt)
    assert dataclasses.asdict(j_pre(pj).layout) == dataclasses.asdict(
        t_pre(pt).layout)
    res = tx.Result(primal=rng.standard_normal(len(pt.c)),
                    dual_eq=rng.standard_normal(len(pt.b)),
                    dual_in=rng.standard_normal(len(pt.h)))
    for a, w in zip(rec_t(res), rec_j(res)):
        assert np.array_equal(a, w)
