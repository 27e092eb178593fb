"""``solve_batch(mesh=...)`` of the port (instances over the ranks of a
mesh axis) against its unsharded batch and the JAX package's
``solve_batch(mesh=...)`` on the conftest's virtual CPU devices.

The fixture of tests/test_parallel.py (8 max-cut instances of side 10)
in the f64 program over 2 and 4 CPU ranks of one gloo group
(``parallel.dist.spawn``, one torch thread each); one hybrid sweep and
one subspace-mode sweep over 2 ranks; the ray search of a declared
instance with and without a checkpoint path; the refusals.  Each group runs its
jobs once (a module fixture).
"""

import os

import numpy as np
import pytest

import _torch_dist_workers as w
import _torch_parity as tp
import jax
import proxsdp_tpu as jx
from jax.sharding import Mesh
from proxsdp_tpu.parallel.batch import solve_batch as jsolve_batch
import proxsdp_tpu_torch as tx
from proxsdp_tpu_torch.parallel.batch import BatchStats
from proxsdp_tpu_torch.parallel.dist import spawn

B, SIDE = 8, 10
F64 = dict(hybrid_precision=False)
SUB = (8, 40, dict(hybrid_precision=False), "subspace")

JOBS2 = [("batch", (B, SIDE, F64)),
         ("batch", (B, SIDE, {})),
         ("batch", SUB),
         ("batch_refused", (B, SIDE, "dp")),
         ("batch_refused", (3, SIDE, "batch"))]
JOBS4 = [("batch", (B, SIDE, F64))]


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_checkpoint") / "batch.npz")


@pytest.fixture(scope="module")
def ranks2(ckpt_path):
    jobs = JOBS2 + [("batch_declared", (ckpt_path,)),
                    ("batch_declared", ("",))]
    return spawn(w.run_jobs, 2, jobs, device_type="cpu", axis="batch")


@pytest.fixture(scope="module")
def ranks4():
    return spawn(w.run_jobs, 4, JOBS4, device_type="cpu", axis="batch")


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded batch of each job, as run_jobs' batch reports it."""
    def run(n, side, opts, projection="auto"):
        stats = BatchStats()
        res = tx.solve_batch([w.maxcut(s, side) for s in range(n)],
                             tx.Options(**opts), projection=projection,
                             device="cpu", stats=stats)
        return {"results": [(r.status, r.objval, r.iter) for r in res],
                "race_iters": stats.race_iters, "programs": stats.programs}

    return {"f64": run(B, SIDE, F64), "hybrid": run(B, SIDE, {}),
            "sub": run(*SUB)}


def _jax_mesh_batch(ndev):
    problems = [tp.jmaxcut.maxcut_problem(tp.jmaxcut.random_graph_weights(s, SIDE))[0]
                for s in range(B)]
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("batch",))
    return jsolve_batch(problems, jx.Options(**F64), mesh=mesh)


@pytest.mark.parametrize("ranks", [2, 4])
def test_f64_batch_over_ranks(ranks2, ranks4, unsharded, ranks):
    """Every rank returns all 8 Results: statuses equal and objectives
    within 1e-9 of the unsharded port batch and of JAX's mesh batch over
    as many devices; the ranks' answers are one answer."""
    outs = ranks2 if ranks == 2 else ranks4
    per_rank = w.one_rank_results(outs, 0)
    assert w.all_equal(per_rank)
    got = per_rank[0]["results"]
    want = unsharded["f64"]["results"]
    jres = _jax_mesh_batch(ranks)
    assert len(got) == B
    for (st, obj, it), (st_u, obj_u, it_u), r in zip(got, want, jres):
        assert st == st_u == r.status == 1
        assert abs(obj - obj_u) <= 1e-9 and abs(obj - r.objval) <= 1e-9
        assert it == it_u


@pytest.mark.parametrize("job, key", [(1, "hybrid"), (2, "sub")],
                         ids=["hybrid", "subspace"])
def test_sweep_over_ranks(ranks2, unsharded, job, key):
    """The hybrid sweep hands over at one iteration on every rank, and
    the subspace mode switches programs at the same points; both as the
    unsharded port batch does, with its answers."""
    per_rank = w.one_rank_results(ranks2, job)
    assert w.all_equal(per_rank)
    got, want = per_rank[0], unsharded[key]
    assert got["race_iters"] == want["race_iters"]
    assert got["programs"] == want["programs"]
    for (st, obj, it), (st_u, obj_u, it_u) in zip(got["results"],
                                                  want["results"]):
        assert st == st_u == 1 and it == it_u
        assert abs(obj - obj_u) <= 1e-9 * (1 + abs(obj_u))


@pytest.mark.parametrize("job, text", [(3, "no axis 'dp'"),
                                       (4, "does not divide")],
                         ids=["missing-axis", "uneven"])
def test_refused(ranks2, job, text):
    """A mesh without the batch axis, and a batch its size does not
    divide, raise ValueError on every rank (as the JAX driver's
    device_put does)."""
    msgs = w.one_rank_results(ranks2, job)
    assert all(m is not None and text in m for m in msgs), msgs


@pytest.mark.parametrize("job, writes", [(5, True), (6, False)],
                         ids=["checkpoint", "no-checkpoint"])
def test_declared_instance_over_ranks(ranks2, ckpt_path, job, writes):
    """The ray search of the declared instance, which rank 1 owns: with a
    checkpoint_path rank 0 runs it and alone writes the file, as the
    unsharded batch's re-entry does (tests/test_torch_checkpoint.py);
    without one its owner runs it.  Every rank returns both Results."""
    outs = w.one_rank_results(ranks2, job)
    assert [o["results"] for o in outs] == [[(1, False), (6, True)]] * 2
    seen = [o["seen"] for o in outs]
    assert seen == ([[ckpt_path], []] if writes else [[], [""]])
    if writes:
        assert os.path.exists(ckpt_path)
