"""Checkpoint and resume (``Options(checkpoint_path=..., checkpoint_freq=...)``,
``solve(..., resume_from=path)``) in the port against the JAX package.

* ``proxsdp_tpu_torch.utils.checkpoint`` writes and reads the JAX module's
  format: the same arrays under the same names (``np.array_equal``), the
  same ``ValueError`` on a layout mismatch;
* a checkpoint written by the JAX package's solve resumes in the port and
  one written by the port's resumes in the JAX package: from the loaded
  state the next 100 iterations of the f64 program agree in every field
  to rtol 1e-9, atol 1e-11 (``test_torch_iteration.py``'s bound), and the
  resumed solves end alike;
* ``test_solver.py::TestCheckpoint``'s stop-and-resume through the port;
* a checkpoint taken in the f32 race's subspace phase resumes into it;
* the certificate search writes none; ``solve_batch`` accepts
  ``checkpoint_path`` and hands it to its re-entry into ``solve``.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.utils import checkpoint as jckpt
from proxsdp_tpu_torch import convert
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.parallel import batch as tbatch
from proxsdp_tpu_torch.utils import checkpoint as tckpt

ITERS = 100


def _jax_state(host: dict):
    return jsolver.State(**{
        k: (tuple(jnp.asarray(w) for w in v) if k == "warm" else jnp.asarray(v))
        for k, v in host.items()})


def _host_state(name="maxcut30", square_form=True):
    setup = tp.jax_setup(name, square_form=square_form)
    opts = tp.jax_opts(square_form=square_form)
    return tp.jax_state_numpy(jsolver.init_state(setup.layout, opts, setup))


@pytest.mark.parametrize("square_form", [True, False, None])
def test_checkpoint_files_match_jax(tmp_path, square_form):
    """The port's save and load against the JAX module's: the same array
    names and values in the file, each package reading the other's."""
    host = _host_state()
    host["warm"] = (host["warm"][0], np.ones((5, 3)))
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tckpt.save_checkpoint(pt, convert.state_from_numpy(host, tp.DEV), True,
                          square_form=square_form)
    jckpt.save_checkpoint(pj, _jax_state(host), True, square_form=square_form)
    with np.load(pt) as zt, np.load(pj) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for name in zj.files:
            assert zt[name].dtype == zj[name].dtype, name
            assert np.array_equal(zt[name], zj[name]), name
    for path in (pt, pj):
        got, ph_t = tckpt.load_checkpoint_numpy(path)
        want, ph_j = jckpt.load_checkpoint(path)
        assert ph_t is ph_j is True
        want = tp.jax_state_numpy(want)
        assert set(got) == set(want)
        for name in want:
            if name == "warm":
                assert len(got[name]) == len(want[name]) == 2
                for g, w in zip(got[name], want[name]):
                    assert np.array_equal(g, w)
            else:
                assert np.array_equal(got[name], want[name]), name
        state, _ = tckpt.load_checkpoint(path, device=tp.DEV)
        assert np.array_equal(state.x.numpy(), host["x"])


def test_checkpoint_layout_mismatch_raises_jax_error(tmp_path):
    """A checkpoint of the square layout resumed in the packed one (and
    back) raises the JAX module's ValueError, word for word."""
    path = str(tmp_path / "s.npz")
    tckpt.save_checkpoint(path, convert.state_from_numpy(_host_state(), tp.DEV),
                          False, square_form=True)
    with pytest.raises(ValueError) as got:
        tckpt.load_checkpoint(path, expect_square_form=False, device=tp.DEV)
    with pytest.raises(ValueError) as want:
        jckpt.load_checkpoint(path, expect_square_form=False)
    assert str(got.value) == str(want.value)
    assert "square_form=True" in str(got.value)
    # through solve: the packed solve refuses the square checkpoint
    with pytest.raises(ValueError, match="re-solve with Options"):
        tx.solve(tp.build_problem(tx, "maxcut30"),
                 tp.torch_opts(square_form=False), resume_from=path,
                 device="cpu")


def _write(pkg, path, square_form, max_iter=60):
    """A checkpoint of the f64 program (maxcut30) at a chunk end."""
    opts = (tp.jax_opts if pkg is jx else tp.torch_opts)(
        checkpoint_path=path, checkpoint_freq=max_iter, max_iter=max_iter,
        chunk_iters=max_iter // 2, square_form=square_form)
    kw = {} if pkg is jx else {"device": "cpu"}
    res = pkg.solve(tp.build_problem(pkg, "maxcut30"), opts, **kw)
    assert res.status == 3 and os.path.exists(path)
    return res


@pytest.mark.parametrize("square_form", [True, False],
                         ids=["square", "packed"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_resume(tmp_path, writer, square_form):
    """A checkpoint written by one package resumes in the other: from the
    loaded state, ITERS iterations of the f64 program in each agree to
    rtol 1e-9; the resumed solves reach the same status, iterations and
    objective (1e-9)."""
    path = str(tmp_path / "c.npz")
    _write(jx if writer == "jax" else tx, path, square_form)
    setup = tp.jax_setup("maxcut30", square_form=square_form)
    layout = setup.layout
    jopts = tp.jax_opts(square_form=square_form)
    topts = tp.torch_opts(square_form=square_form)
    s_t, ph_t = tckpt.load_checkpoint(path, expect_square_form=square_form,
                                      device=tp.DEV)
    s_j, ph_j = jckpt.load_checkpoint(path, expect_square_form=square_form)
    assert ph_t is ph_j is False
    assert int(s_t.iter) == 60
    s_j = jax.tree_util.tree_map(jnp.asarray, s_j)
    o_j = tp.jax_operands(setup)
    o_t = tp.torch_operands_from_jax(o_j, setup)
    it_j = tp.jax_iteration(layout, jopts)
    it_t = tsolver.make_chunk_runner(layout, topts, device=tp.DEV)[1]
    for _ in range(ITERS):
        s_j, s_t = it_j(s_j, o_j), it_t(s_t, o_t)
    tp.assert_states_close(convert.state_to_numpy(s_t), tp.jax_state_numpy(s_j),
                           offsets=layout.sdp_offsets, square_form=square_form)
    rt = tx.solve(tp.build_problem(tx, "maxcut30"), topts, resume_from=path,
                  device="cpu")
    rj = jx.solve(tp.build_problem(jx, "maxcut30"), jopts, resume_from=path)
    assert rt.status == rj.status == 1
    assert rt.iter == rj.iter > 60
    assert abs(rt.objval - rj.objval) <= 1e-9 * (1 + abs(rj.objval))


def _readme_opt(pkg, **kw):
    """test_solver.py's build_maxcut_opt: the README max-cut."""
    opt = pkg.Optimizer(**kw)
    X = opt.add_psd_var(4)
    for i in range(4):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * tp.README_W),
                      sense="max")
    return opt


def test_checkpoint_and_resume(tmp_path):
    """test_solver.py::TestCheckpoint::test_checkpoint_and_resume through
    the port (the default hybrid driver): stop at an iteration limit with
    a checkpoint on disk, resume and converge."""
    ckpt = str(tmp_path / "state.npz")
    prob = _readme_opt(tx).build_problem()
    r1 = tx.solve(prob, tx.Options(checkpoint_path=ckpt, checkpoint_freq=10,
                                   max_iter=60, chunk_iters=20, min_iter=0),
                  device="cpu")
    assert r1.status == 3
    assert os.path.exists(ckpt)
    r2 = tx.solve(prob, tx.Options(min_iter=0), resume_from=ckpt, device="cpu")
    assert r2.status == 1
    assert abs(r2.objval - 18.0) < 5e-2
    assert r2.iter > 20
    # the JAX package resumes the port's checkpoint alike
    rj = jx.solve(_readme_opt(jx).build_problem(), jx.Options(min_iter=0),
                  resume_from=ckpt)
    assert rj.status == 1 and abs(rj.iter - r2.iter) <= 2


def _race_log(pkg, problem, opts, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = pkg.solve(problem, opts, **kw)
    return res, buf.getvalue()


def test_checkpoint_in_the_subspace_race_resumes_into_it(tmp_path):
    """A checkpoint taken in the default driver's f32 race after its
    subspace entry (side 50: the race enters at iteration 64 with rank
    16) holds the f32 state and the (50, 16) basis; resumed, the port
    continues in the f32 subspace race (no second entry, a hand-over
    later) as the JAX package does from the same file."""
    path = str(tmp_path / "race.npz")
    kw = dict(chunk_iters=32, race_subspace_warmup=64, log_verbose=True,
              log_freq=10 ** 9)
    _, log = _race_log(tx, tp.build_problem(tx, "maxcut50"), tx.Options(
        checkpoint_path=path, checkpoint_freq=96, max_iter=96, **kw),
        device="cpu")
    assert "f32 race: subspace rank 16" in log
    fields, phase32 = tckpt.load_checkpoint_numpy(path)
    assert phase32 and fields["x"].dtype == np.float32
    assert fields["warm"][0].shape == (50, 16) and int(fields["iter"]) == 96
    rt, log_t = _race_log(tx, tp.build_problem(tx, "maxcut50"),
                          tx.Options(**kw), resume_from=path, device="cpu")
    rj, log_j = _race_log(jx, tp.build_problem(jx, "maxcut50"),
                          jx.Options(**kw), resume_from=path)
    for log_ in (log_t, log_j):
        assert "f32 race: subspace rank" not in log_
        assert "f32 -> f64 at iter" in log_
    assert rt.status == rj.status == 1
    assert abs(rt.objval - rj.objval) <= 1e-4 * (1 + abs(rj.objval))
    assert rt.iter > 96


def test_certificate_search_writes_no_checkpoint(tmp_path, monkeypatch):
    """An infeasible program (X psd with X_00 = -1): checkpoints are
    written only outside the certificate search, none of them during it,
    and the search still finds its ray."""
    saved = []
    real = tsolver.save_checkpoint

    def spy(path, state, phase32, square_form=None):
        saved.append((int(state.iter), int(state.cert_kind)))
        real(path, state, phase32, square_form=square_form)

    monkeypatch.setattr(tsolver, "save_checkpoint", spy)
    opt = tx.Optimizer()
    X = opt.add_psd_var(2)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, -1.0)
    opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
    path = str(tmp_path / "cert.npz")
    res = tx.solve(opt.build_problem(), tp.torch_opts(
        checkpoint_path=path, checkpoint_freq=1, chunk_iters=64), device="cpu")
    assert res.status == 6 and res.certificate_found
    assert saved and all(kind == 0 for _, kind in saved)
    assert saved[-1][0] < res.iter  # the search ran past the last save


def test_solve_batch_hands_checkpoint_to_the_reentry(tmp_path, monkeypatch):
    """solve_batch accepts checkpoint_path (it writes none in the batch
    loop, as the JAX batch) and hands it to its re-entry into solve for a
    declared instance, whose driver writes it."""
    seen = []
    real = tbatch.solve

    def spy(problem, options, **kw):
        seen.append(options.checkpoint_path)
        return real(problem, options, **kw)

    monkeypatch.setattr(tbatch, "solve", spy)
    path = str(tmp_path / "batch.npz")

    def diag(rhs):
        opt = tx.Optimizer()
        X = opt.add_psd_var(2)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, rhs)
        opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
        return opt.build_problem()

    res = tx.solve_batch([diag(1.0), diag(-1.0)], tp.torch_opts(
        max_iter=20_000, chunk_iters=256, checkpoint_path=path,
        checkpoint_freq=256), device="cpu")
    assert [r.status for r in res] == [1, 6]
    assert seen == [path]
    assert os.path.exists(path)
