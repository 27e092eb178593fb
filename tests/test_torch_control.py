"""The iteration's control (K19), the restart-to-average (K20) and the
batch's masked freeze (K21) of the PyTorch port against the JAX package,
through their plain twins on the CPU.

* ``_residuals_and_gap`` (K3's plain version, then K19's formulas and ring
  writes) on seeded random states against the JAX function, single and
  batched (the JAX side through ``jax.vmap``), f64 and f32, on a layout
  with PSD and SOC blocks, equality and inequality rows;
* ``_control`` (K20a, K19's decisions, K20b) on the crafted states of
  ``kernels.control_cases`` -- one per branch -- against the JAX
  function, single and batched, f64 and f32;
* the crafted states together fire every branch: b1, b2 with and without
  its reset, fire3 and fire4 under both ``line_search_flag`` and both
  ``step_balance`` modes, statuses 1, 5, 6 and 7, a NaN dual objective,
  the certificate wait, a restart epoch with and without the jump;
* K21's twin and the batch driver's ``_where_rows`` against the
  ``torch.where`` per field they replace, bit for bit, on a state whose
  ``x_old`` is its ``x``;
* a call off the CPU never takes the plain twin.

Integer fields and statuses must be equal; floats within rtol 1e-12 /
atol 1e-14 in f64 (tests/test_torch_iteration.py's adoption bound) and
1e-6 in f32 (the two packages' f32 dots sum in other orders).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.problem import preprocess as j_pre, to_square_form as j_sq
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.kernels import control_cases
from proxsdp_tpu_torch.parallel import batch as tbatch

DTYPES = {"f64": (jnp.float64, torch.float64, np.float64),
          "f32": (jnp.float32, torch.float32, np.float32)}
TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=1e-6, atol=1e-6)}


def _program(pkg):
    """A PSD block of side 4, an SOC block of length 3, five equality and
    two inequality rows."""
    o = pkg.Optimizer()
    X = o.add_psd_var(4)
    s = o.add_soc_var(3)
    for i in range(4):
        o.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    o.add_eq_constraint({int(s[0]): 1.0}, 2.0)
    o.add_ineq_constraint({int(X[0, 1]): 1.0}, 0.3)
    o.add_ineq_constraint({int(X[1, 2]): 1.0, int(s[1]): 1.0}, 0.2)
    W = np.arange(16.0).reshape(4, 4)
    obj = o.psd_inner_product_coeffs(X, (W + W.T) / 10.0)
    obj[int(s[2])] = 0.5
    o.set_objective(obj)
    return o.build_problem()


@functools.lru_cache(maxsize=None)
def _setup(square: bool):
    setup = j_pre(_program(jx))
    return j_sq(setup) if square else setup


def _operands(setup, dt: str, B: int | None = None):
    """(JAX operands, port operands) of ``setup`` in ``dt``; with ``B`` the
    batch's (every instance the same problem, the operator shared)."""
    jdt, tdt, _ = DTYPES[dt]
    o_j = tp.jax_operands(setup, jdt)
    o_t = tp.torch_operands_from_jax(o_j, setup, tdt)
    if B is None:
        return o_j, o_t

    def rows(v):
        return jnp.broadcast_to(v, (B,) + v.shape)

    o_j = o_j._replace(**{f: rows(getattr(o_j, f)) for f in (
        "b", "h", "c", "norm_b", "norm_h", "norm_c", "obj_scale")})
    o_t = dataclasses.replace(o_t, **{f: getattr(o_t, f).expand(
        (B,) + getattr(o_t, f).shape).contiguous() for f in (
        "b", "h", "c", "norm_b", "norm_h", "norm_c", "obj_scale")})
    return o_j, o_t


JAX_OP_AXES = jsolver.Operands(M=None, b=0, h=0, c=0, norm_b=0, norm_h=0,
                               norm_c=0, chunk_end=None, obj_scale=0,
                               row_unscale=None)


def _opts(dt: str, **kw):
    dtype = "float64" if dt == "f64" else "float32"
    return (jx.Options(hybrid_precision=False, dtype=dtype, **kw),
            tx.Options(hybrid_precision=False, dtype=dtype, **kw))


def _host(setup, opts_j, dt: str) -> dict:
    host = tp.jax_state_numpy(jsolver.init_state(setup.layout, opts_j, setup))
    np_dt = DTYPES[dt][2]
    return {k: (tuple(np.asarray(w, np_dt) for w in v) if k == "warm" else
                np.asarray(v, np_dt) if np.issubdtype(np.asarray(v).dtype,
                                                       np.floating)
                else np.asarray(v))
            for k, v in host.items()}


def _jax_state(host: dict):
    return jsolver.State(**{
        k: (tuple(jnp.asarray(w) for w in v) if k == "warm" else jnp.asarray(v))
        for k, v in host.items()})


def _assert_close(got: dict, want: dict, dt: str, label=""):
    for name, w in want.items():
        if name == "warm":
            continue
        g, w = np.asarray(got[name]), np.asarray(w)
        assert g.shape == w.shape, (label, name, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")
        else:
            assert g.dtype == w.dtype, (label, name)
            np.testing.assert_allclose(g, w, err_msg=f"{label} {name}",
                                       **TOL[dt])


def _random_state(host: dict, seed: int) -> dict:
    """``host`` with seeded random iterates, steps, rings and counters."""
    rng = np.random.default_rng(seed)
    h = {k: v for k, v in host.items()}
    L = h["buf_gap"].shape[-1]
    for name in ("x", "x_old", "Mty", "Mty_old", "y", "y_old", "Mx", "Mx_old",
                 *control_cases.RINGS):
        h[name] = rng.standard_normal(h[name].shape).astype(h[name].dtype)
    for name in ("primal_step", "dual_step", "equa_feas", "ineq_feas"):
        h[name] = np.asarray(0.1 + rng.random(), h[name].dtype)
    h["iter"] = np.int32(rng.integers(0, 3 * L))
    return h


# ------------------------------------------------ residual formulas (K19)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_residuals_and_gap_matches_jax(dt, batched, seed):
    setup = _setup(square=not batched)  # the batch runs the packed layout
    opts_j, opts_t = _opts(dt)
    host = _host(setup, opts_j, dt)
    layout = setup.layout
    if not batched:
        h = _random_state(host, seed)
        o_j, o_t = _operands(setup, dt)
        want = tp.jax_state_numpy(jsolver._residuals_and_gap(
            _jax_state(h), o_j, layout, opts_j))
        got = convert.state_to_numpy(tsolver._residuals_and_gap(
            convert.state_from_numpy(h, tp.DEV), o_t, layout, opts_t))
    else:
        hs = [_random_state(host, seed * 10 + i) for i in range(5)]
        h = convert.stack_states(hs)
        o_j, o_t = _operands(setup, dt, B=len(hs))
        fn = jax.vmap(lambda s, o: jsolver._residuals_and_gap(
            s, o, layout, opts_j), in_axes=(0, JAX_OP_AXES))
        want = tp.jax_state_numpy(fn(_jax_state(h), o_j))
        got = convert.state_to_numpy(tsolver._residuals_and_gap(
            convert.state_from_numpy(h, tp.DEV), o_t, layout, opts_t))
    _assert_close(got, want, dt)
    assert all(v == 0 for v in kernels.launch_counts.values())


# ------------------------------------------ the crafted branch states


@functools.lru_cache(maxsize=None)
def _cases(dt: str):
    setup = _setup(square=True)
    opts_j, opts_t = _opts(dt)
    return control_cases.branch_cases(_host(setup, opts_j, dt), opts_t,
                                      setup.c, setup.b, setup.h)


def _jax_opts(opts_t):
    """The JAX Options of the port's ``opts_t`` (same field values)."""
    return jx.Options(**{f.name: getattr(opts_t, f.name)
                         for f in dataclasses.fields(jx.Options)})


def _sides(layout):
    return torch.tensor(layout.sdp_sides or (1,), dtype=torch.int32)


CASE_NAMES = [c.name for c in _cases("f64")]


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_control_matches_jax(name, dt):
    setup = _setup(square=True)
    case = next(c for c in _cases(dt) if c.name == name)
    o_j, o_t = _operands(setup, dt)
    want = tp.jax_state_numpy(jsolver._control(
        _jax_state(case.state), o_j, setup.layout, _jax_opts(case.opts)))
    got = convert.state_to_numpy(tsolver._control(
        convert.state_from_numpy(case.state, tp.DEV), o_t, setup.layout,
        case.opts, _sides(setup.layout)))
    _assert_close(got, want, dt, name)
    assert case.fired(case.state, got), name


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_batched_control_matches_jax(dt):
    """Every crafted case under the default options as one batch (the
    packed layout the batch driver runs)."""
    setup = _setup(square=False)
    opts_j, opts_t = _opts(dt)
    cases = control_cases.branch_cases(_host(setup, opts_j, dt), opts_t,
                                       setup.c, setup.b, setup.h)
    cases = [c for c in cases if c.opts == opts_t]
    assert len(cases) >= 15
    h = convert.stack_states([c.state for c in cases])
    o_j, o_t = _operands(setup, dt, B=len(cases))
    fn = jax.vmap(lambda s, o: jsolver._control(s, o, setup.layout, opts_j),
                  in_axes=(0, JAX_OP_AXES))
    want = tp.jax_state_numpy(fn(_jax_state(h), o_j))
    got = convert.state_to_numpy(tsolver._control(
        convert.state_from_numpy(h, tp.DEV), o_t, setup.layout, opts_t,
        _sides(setup.layout)))
    _assert_close(got, want, dt)
    for i, c in enumerate(cases):
        assert c.fired(c.state, convert.index_state(got, i)), c.name


BRANCHES = (
    "status 1", "opt_block_until", "b1 (bump, reset)", "b2 with reset",
    "b2 without reset",
    *(f"{fire} line_search_flag={ls} step_balance={bal}"
      for ls in (True, False) for bal in ("ratio", "reference")
      for fire in ("fire3", "fire4")),
    "status 6 (dual objective > max_obj)", "status 6 (NaN dual objective)",
    "status 5 (primal objective < -max_obj)",
    "status 6 (stalled feasibility)", "infeas_block_until",
    "status 6 (stalled gap, |dual| > |prim|)",
    "status 5 (stalled gap, |prim| > |dual|)", "status 7 (primal ray)",
    "certificate wait", "restart epoch, stalled",
    "restart epoch, not stalled",
)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_crafted_states_fire_every_branch(dt):
    setup = _setup(square=True)
    _, o_t = _operands(setup, dt)
    cases = _cases(dt)
    assert sorted(c.name for c in cases) == sorted(BRANCHES)
    fired = []
    for c in cases:
        out = convert.state_to_numpy(tsolver._control(
            convert.state_from_numpy(c.state, tp.DEV), o_t, setup.layout,
            c.opts, _sides(setup.layout)))
        if c.fired(c.state, out):
            fired.append(c.name)
    assert sorted(fired) == sorted(BRANCHES)


def test_restart_none_skips_the_restart():
    """restart="none": no sums (0-length), no jump, the iterate kept."""
    setup = _setup(square=True)
    opts_j, opts_t = _opts("f64", restart="none")
    case = control_cases.branch_cases(_host(setup, opts_j, "f64"), opts_t,
                                      setup.c, setup.b, setup.h)[0]
    o_j, o_t = _operands(setup, "f64")
    want = tp.jax_state_numpy(jsolver._control(
        _jax_state(case.state), o_j, setup.layout, opts_j))
    got = convert.state_to_numpy(tsolver._control(
        convert.state_from_numpy(case.state, tp.DEV), o_t, setup.layout,
        opts_t, _sides(setup.layout)))
    _assert_close(got, want, "f64")
    assert got["avg_x"].size == 0
    np.testing.assert_array_equal(got["x"], case.state["x"])


# ------------------------------------------------------- the freeze (K21)


def _old_where_rows(mask, new, old):
    """parallel/batch.py's _where_rows before K21: torch.where per field."""
    def pick(n, o):
        return torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)

    kw = {}
    for name in tsolver.STATE_FIELDS:
        n, o = getattr(new, name), getattr(old, name)
        kw[name] = (tuple(pick(a, b) for a, b in zip(n, o)) if name == "warm"
                    else pick(n, o))
    return tsolver.State(**kw)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_freeze_matches_where_rows(dt):
    setup = _setup(square=False)
    opts_j, _ = _opts(dt)
    host = _host(setup, opts_j, dt)
    old = convert.state_from_numpy(
        convert.stack_states([_random_state(host, i) for i in range(6)]), tp.DEV)
    new = convert.state_from_numpy(
        convert.stack_states([_random_state(host, 100 + i) for i in range(6)]), tp.DEV)
    # after _residuals_and_gap the old iterates are the new ones
    new = new.replace(x_old=new.x, y_old=new.y, Mx_old=new.Mx,
                      Mty_old=new.Mty, status=old.status)
    new.x[2, 0] = float("nan")
    mask = torch.tensor([True, False, True, True, False, False])
    want = convert.state_to_numpy(_old_where_rows(mask, new, old))
    got_state = tbatch._where_rows(mask, new, old)
    got = convert.state_to_numpy(got_state)
    for name in want:
        if name == "warm":
            for g, w in zip(got[name], want[name]):
                np.testing.assert_array_equal(g, w)
            continue
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # fresh outputs where new and old differ; the aliased pair stays two
    assert got_state.x is not got_state.x_old
    assert got_state.status is new.status  # one tensor in both: kept
    fields = [getattr(new, f) for f in ("x", "y", "beta")]
    olds = [getattr(old, f) for f in ("x", "y", "beta")]
    for g, w in zip(kernels.freeze_rows_plain(mask, fields, olds),
                    kernels.freeze_rows(mask, fields, olds)):
        assert torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0))


# ---------------------------------------------------------- no fallback


def test_off_cpu_never_takes_the_plain_twin():
    """A tensor off the CPU takes the kernel path: here (no card) every
    wrapper raises, and a solve on the default device raises."""
    setup = _setup(square=True)
    opts_j, opts_t = _opts("f64")
    case = _cases("f64")[0]
    s = convert.state_from_numpy(case.state, "meta")
    _, o_t = _operands(setup, "f64")
    o_m = dataclasses.replace(o_t, **{f: getattr(o_t, f).to("meta") for f in (
        "b", "h", "c", "norm_b", "norm_h", "norm_c", "obj_scale")})
    cfg = kernels.control_config(setup.layout, opts_t)
    sides = _sides(setup.layout).to("meta")
    with pytest.raises(ValueError, match="not supported"):
        kernels.control(s, o_m, cfg, sides, red=torch.zeros(5, device="meta",
                                                            dtype=torch.float64))
    with pytest.raises(ValueError, match="not supported"):
        kernels.restart_average(s.x, s.y, s.Mx, s.Mty, s.avg_x, s.avg_y,
                                s.avg_Mx, s.avg_Mty, s.avg_w, s.primal_step,
                                o_m.c, o_m.b, o_m.h, setup.layout.p,
                                setup.layout.m)
    with pytest.raises(ValueError, match="not supported"):
        kernels.restart_adopt(s.x, s.y, s.Mx, s.Mty, s.avg_x, s.avg_y,
                              s.avg_Mx, s.avg_Mty,
                              torch.zeros((), dtype=torch.bool, device="meta"),
                              s.avg_w)
    with pytest.raises(ValueError, match="not supported"):
        kernels.freeze_rows(torch.ones(2, dtype=torch.bool, device="meta"),
                            [torch.zeros(2, 3, device="meta")],
                            [torch.zeros(2, 3, device="meta")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tx.solve(_program(tx), tx.Options(hybrid_precision=False))
