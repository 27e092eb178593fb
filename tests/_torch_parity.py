"""Shared set-up of the port's parity tests (not a test module).

Builds one problem through both packages -- the JAX package
(``proxsdp_tpu``, run on the CPU as the test suite runs it) and its
PyTorch port (``proxsdp_tpu_torch``, ``device="cpu"``, where every kernel
wrapper takes its plain PyTorch version) -- and hands data between them
as NumPy arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.models import maxcut as jmaxcut
from proxsdp_tpu.ops import linop as jlinop
from proxsdp_tpu_torch import convert
from proxsdp_tpu_torch.models import maxcut as tmaxcut

# full-precision products everywhere (no TF32 on a card)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
# the parity problems are tiny: PyTorch's intra-op thread pool only
# contends with XLA's in the same process (measured: a side-50 solve took
# 13 s with 8 threads against 1.4 s with one)
torch.set_num_threads(1)

DEV = "cpu"

# README max-cut example (reference README.md:62-86)
README_W = np.array([[18.0, -5.0, -7.0, -6.0],
                     [-5.0, 6.0, 0.0, -1.0],
                     [-7.0, 0.0, 8.0, -1.0],
                     [-6.0, -1.0, -1.0, 8.0]])


def build_problem(pkg, name: str):
    """("maxcut", side) or "readme" through package ``pkg`` (jx or tx)."""
    if name == "readme":
        opt = pkg.Optimizer(tol_gap=1e-4, tol_feasibility=1e-4)
        X = opt.add_psd_var(4)
        for i in range(4):
            opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
        opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * README_W),
                          sense="max")
        return opt.build_problem()
    side = int(name.removeprefix("maxcut"))
    mod = jmaxcut if pkg is jx else tmaxcut
    return mod.maxcut_problem(mod.random_graph_weights(0, side))[0]


def jax_opts(**kw):
    return jx.Options(hybrid_precision=False, **kw)


def torch_opts(**kw):
    return tx.Options(hybrid_precision=False, **kw)


@functools.lru_cache(maxsize=16)
def jax_setup(name: str):
    from proxsdp_tpu.problem import preprocess, to_square_form

    return to_square_form(preprocess(build_problem(jx, name)))


def jax_operands(setup, dtype=jnp.float64):
    M = jlinop.build_linop(setup.A, setup.G, dtype)
    return jsolver.Operands(
        M=M,
        b=jnp.asarray(setup.b, dtype),
        h=jnp.asarray(setup.h, dtype),
        c=jnp.asarray(setup.c, dtype),
        norm_b=jnp.asarray(setup.norm_b, dtype),
        norm_h=jnp.asarray(setup.norm_h, dtype),
        norm_c=jnp.asarray(setup.norm_c, dtype),
        chunk_end=jnp.asarray(0, jnp.int32),
        obj_scale=jnp.asarray(setup.obj_scale * setup.rhs_scale, dtype),
    )


def torch_operands_from_jax(o_jax, setup, dtype=torch.float64):
    """The port's Operands from the JAX operands' arrays (via convert)."""
    M = o_jax.M
    if isinstance(M, jlinop.EllOp):
        tM = convert.linop_from_tables(
            row_cols=np.asarray(M.row_cols), row_vals=np.asarray(M.row_vals),
            col_rows=np.asarray(M.col_rows), col_vals=np.asarray(M.col_vals),
            device=DEV, dtype=dtype)
    else:
        tM = convert.linop_from_tables(mat=np.asarray(M.mat), device=DEV,
                                       dtype=dtype)
    return convert.operands_from_numpy(
        M=tM, b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
        norm_h=setup.norm_h, norm_c=setup.norm_c,
        obj_scale=setup.obj_scale * setup.rhs_scale, device=DEV, dtype=dtype)


def jax_state_numpy(s) -> dict:
    d = {k: np.asarray(v) for k, v in s._asdict().items() if k != "warm"}
    d["warm"] = tuple(np.asarray(w) for w in s.warm)
    return d


@functools.lru_cache(maxsize=16)
def jax_iteration(layout, opts):
    return jax.jit(jsolver.make_chunk_runner(layout, opts)[1])


def assert_states_close(got: dict, want: dict, rtol=1e-9, atol=1e-11):
    """Every State field: floats to rtol/atol, integers exactly.  The warm
    vector is the top eigenvector of the projected matrix: it is compared
    up to sign, and only where that eigenvalue is simple (at iteration 1
    the matrix is 0 and each LAPACK build returns its own basis)."""
    assert set(got) == set(want)
    for name in want:
        if name == "warm":
            for g, w in zip(got[name], want[name]):
                g, w = np.asarray(g), np.asarray(w)
                np.testing.assert_allclose(np.linalg.norm(g), np.linalg.norm(w),
                                           rtol=1e-12)
                side = g.shape[0]
                ev = np.linalg.eigvalsh(
                    np.asarray(want["x"][: side * side]).reshape(side, side))
                if side > 1 and ev[-1] - ev[-2] > 1e-6 * max(abs(ev[-1]), 1.0):
                    flip = -1.0 if np.dot(g, w) < 0 else 1.0
                    np.testing.assert_allclose(flip * g, w, rtol=1e-7,
                                               atol=1e-9, err_msg=name)
            continue
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
