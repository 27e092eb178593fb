"""The port's tensor-parallel solve (``proxsdp_tpu_torch.parallel.sharded``)
against the JAX package's ``solve_sharded`` on the conftest's virtual CPU
devices, and K18's plain twin (``kernels.psd_reconstruct``).

The port's ranks are CPU processes of one gloo group
(``parallel.dist.spawn``, one torch thread each), 2 and 4 of them, as the
JAX cases use 2 and 4 devices (tests/test_parallel.py::TestShardedTP).
Each group runs its jobs once (a module fixture); every test reads them.
"""

import inspect
import queue

import numpy as np
import pytest
import torch

import _torch_dist_workers as w
import _torch_parity as tp
import jax
import proxsdp_tpu as jx
from jax.sharding import Mesh
from proxsdp_tpu.parallel.sharded import solve_sharded as jsolve_sharded
import proxsdp_tpu_torch as tx
from proxsdp_tpu_torch import kernels
from proxsdp_tpu_torch.ops import cones
from proxsdp_tpu_torch.parallel import dist
from proxsdp_tpu_torch.parallel.dist import spawn, split

F64_300 = dict(max_iter=300, hybrid_precision=False, certificate_search=False)
DENSE = dict(linop="dense", hybrid_precision=False)
# (seed, side, options) as test_parallel.py's TestShardedTP cases
CASE12 = (1, 12, {})
CASE96 = (3, 96, F64_300)
CASE64 = (5, 64, DENSE)

JOBS2 = [("tp_solve", CASE12),
         ("tp_divergent", (1, 12, dict(hybrid_precision=False,
                                       max_iter=200)))]
JOBS4 = [("tp_solve", CASE96),
         ("tp_iterate", (3, 96, 300, dict(hybrid_precision=False))),
         ("tp_solve", CASE64)]


@pytest.fixture(scope="module")
def ranks2():
    return spawn(w.run_jobs, 2, JOBS2, device_type="cpu")


@pytest.fixture(scope="module")
def ranks4():
    return spawn(w.run_jobs, 4, JOBS4, device_type="cpu")


def _jax(case, ndev):
    seed, side, kw = case
    W = tp.jmaxcut.random_graph_weights(seed, side)
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("tp",))
    return jsolve_sharded(tp.jmaxcut.maxcut_problem(W)[0], mesh,
                          jx.Options(**kw))


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


@pytest.mark.parametrize("group, job", [(2, 0), (4, 0), (4, 1), (4, 2)],
                         ids=["side12", "side96", "side96-iterate",
                              "side64-dense"])
def test_ranks_agree(ranks2, ranks4, group, job):
    """Every rank returns the same answer (the solves passed their own
    end-of-solve checksum test too)."""
    outs = ranks2 if group == 2 else ranks4
    assert w.all_equal(w.one_rank_results(outs, job))


def test_default_options_side12(ranks2):
    """The default Options() (hybrid race and polish) over 2 ranks: status
    1, the objective within 1e-4 (1 + |obj|) of JAX's solve_sharded."""
    got = ranks2[0][0]
    want = _jax(CASE12, 2)
    assert got["status"] == want.status == 1
    assert _rel(got["objval"], want.objval) <= 1e-4
    # the sharded products, projections and decisions ran collectives
    assert got["collectives"] > got["iter"]


def test_f64_side96_iterates_bit_for_bit(ranks4):
    """300 iterations of the f64 program over 4 ranks with the ELL
    operator: x, y and the fetched scalars equal the unsharded port's bit
    for bit (K1 on row slices, K18's rows, replicated eigh)."""
    want = w.program_iterate(w.maxcut(3, 96), tx.Options(hybrid_precision=False),
                             300)
    for out in ranks4:
        got = out[1]
        for name in ("x", "y", "fetch"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_f64_side96_objective(ranks4):
    """The same program through solve_sharded (max_iter 300): the objective
    within JAX's 1e-3 (1 + |obj|) of its solve_sharded."""
    got = ranks4[0][0]
    want = _jax(CASE96, 4)
    assert got["iter"] == want.iter
    assert _rel(got["objval"], want.objval) <= 1e-3


def test_dense_operator_side64(ranks4):
    """A column-sharded dense operator over 4 ranks (M x summed by an
    all_reduce): status 1, within 1e-4 (1 + |obj|) of JAX's."""
    got = ranks4[0][2]
    want = _jax(CASE64, 4)
    assert got["status"] == want.status == 1
    assert _rel(got["objval"], want.objval) <= 1e-4


def test_divergent_rank_raises(ranks2):
    """A rank whose problem differs: every rank takes rank 0's decisions,
    then each raises RankDivergence naming the first iteration whose
    checksums differ."""
    msgs = w.one_rank_results(ranks2, 1)
    assert all(m is not None and "diverged" in m for m in msgs), msgs
    assert len(set(msgs)) == 1


@pytest.mark.parametrize("entry", ["solve", "solve_batch"])
def test_tp_shards_without_mesh_is_plain(entry):
    """tp_shards > 0 with no active mesh is the plain solve, as in JAX."""
    probs = [w.maxcut(s, 10) for s in range(2)]
    o = tx.Options(hybrid_precision=False)
    if entry == "solve":
        got = [tx.solve(probs[0], o.replace(tp_shards=4), device="cpu")]
        want = [tx.solve(probs[0], o, device="cpu")]
    else:
        got = tx.solve_batch(probs, o.replace(tp_shards=4), device="cpu")
        want = tx.solve_batch(probs, o, device="cpu")
    for g, r in zip(got, want):
        assert (g.status, g.iter, g.objval) == (r.status, r.iter, r.objval)
        np.testing.assert_array_equal(g.primal, r.primal)


def test_spawn_defaults_to_the_card(monkeypatch):
    """``spawn``'s ranks compute on the card unless the caller asks for
    the CPU: its mesh is "cuda" by default, and a rank that finds no card
    raises before it joins the group."""
    assert inspect.signature(spawn).parameters["device_type"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = queue.Queue()
    dist._rank_main(0, 1, dist.free_port(), "gloo", "cuda", "tp", 0, print,
                    (), out)
    rank, ok, msg = out.get_nowait()
    assert (rank, ok) == (0, False) and "no CUDA card" in msg


@pytest.mark.parametrize("n, parts", [(10, 3), (12, 4), (5, 8), (250, 2)])
def test_split_covers_rows(n, parts):
    spans = split(n, parts)
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(hi - lo <= -(-n // parts) for lo, hi in spans)


def _eig(side, dtype, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((side, side))
    X = torch.tensor(A + A.T, dtype=dtype)
    return torch.linalg.eigh(X)


@pytest.mark.parametrize("side", [1, 5, 16, 33, 100])
@pytest.mark.parametrize("pair", ["f64", "f32", "f64_f32"])
def test_psd_reconstruct_slabs_equal_rows(side, pair):
    """K18's twin: the slabs of 1, 2, 3 and 4 ranks are the rows of the
    full product bit for bit, in V's type then cast (the mixed pair)."""
    dt = torch.float32 if pair == "f32" else torch.float64
    out = torch.float64 if pair == "f64" else torch.float32
    wv, V = _eig(side, dt)
    full = kernels.psd_reconstruct(V, wv, 0, side, out)
    want = (torch.matmul(V * torch.clamp_min(wv, 0.0)[None, :], V.T)
            .to(out))
    assert full.dtype == out and full.shape == (side, side)
    assert torch.equal(full, want)
    for parts in (2, 3, 4):
        slabs = [kernels.psd_reconstruct(V, wv, lo, hi, out)
                 for lo, hi in split(side, parts)]
        assert torch.equal(torch.cat(slabs), full)


def test_psd_reconstruct_keeps_nan():
    """A failed eigh's NaN eigenvalues stay NaN (clamp_min, as jnp.maximum)."""
    wv, V = _eig(6, torch.float64)
    wv[2] = float("nan")
    assert torch.isnan(kernels.psd_reconstruct(V, wv, 0, 6)).all()


@pytest.mark.parametrize("dtype, mixed", [(torch.float64, False),
                                          (torch.float32, False),
                                          (torch.float32, True)])
def test_dense_eigh_unchanged(dtype, mixed):
    """``_dense_eigh`` with K18 gives the former eigh + matmul
    reconstruction bit for bit (the mixed projection's f64 eigenpairs
    reconstructed in f64, then cast)."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((40, 40))
    X = torch.tensor(A + A.T, dtype=dtype)
    opts = tx.Options(mixed_projection=mixed)
    Xp, rank, V = cones._dense_eigh(X, opts)
    wv, V0 = cones._eigh(X.to(torch.float64 if mixed else dtype))
    want = torch.matmul(V0 * torch.clamp_min(wv, 0.0)[None, :], V0.T).to(dtype)
    assert Xp.dtype == dtype and torch.equal(Xp, want)
    assert int(rank) == int(torch.sum(wv > opts.tol_psd))


def test_psd_reconstruct_checks_arguments():
    wv, V = _eig(4, torch.float64)
    with pytest.raises(ValueError):
        kernels.psd_reconstruct(V, wv, 3, 2)
    with pytest.raises(ValueError):
        kernels.psd_reconstruct(V[:3], wv, 0, 3)
