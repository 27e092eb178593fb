"""Solver-state checkpoint/resume: the format of ``proxsdp_tpu/utils/
checkpoint.py``, so one file moves between the two packages.

A checkpoint is one ``np.savez`` of every ``State`` field (``warm`` as
``__warm_len__`` and ``__warm_{i}__``), the hybrid-phase flag
``__phase32__``, ``__version__`` and ``__square_form__``.  The write is
atomic (a temporary file, then ``os.replace``): a pre-emption during a
save never corrupts the previous checkpoint.

Version history (the JAX package's):
  1 -- original format (packed-triangle ``state.x`` layout implied)
  2 -- adds ``__square_form__`` (the device-coordinate convention of
       ``state.x``); a resume checks it against the rebuilt layout, so a
       layout mismatch fails with a clear message instead of a shape error.
"""

from __future__ import annotations

import os

import numpy as np

CKPT_VERSION = 2


def save_checkpoint(path: str, state, phase32: bool,
                    square_form: bool | None = None) -> None:
    """Serialize the port's solver ``State`` (+ the hybrid-phase flag) to
    ``path``."""
    from .. import convert

    arrs = {}
    for name, v in convert.state_to_numpy(state).items():
        if name == "warm":
            arrs["__warm_len__"] = np.asarray(len(v))
            for i, w in enumerate(v):
                arrs[f"__warm_{i}__"] = np.asarray(w)
        else:
            arrs[name] = np.asarray(v)
    arrs["__phase32__"] = np.asarray(bool(phase32))
    arrs["__version__"] = np.asarray(CKPT_VERSION)
    if square_form is not None:
        arrs["__square_form__"] = np.asarray(bool(square_form))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def load_checkpoint_numpy(path: str, expect_square_form: bool | None = None):
    """``(fields, phase32)`` saved by :func:`save_checkpoint` (or by the JAX
    package's), ``fields`` a dict of host arrays keyed by the ``State``
    fields.

    ``expect_square_form``: the coordinate convention of the layout the
    caller rebuilt (Options.square_form); a checkpoint of the other one
    raises a ValueError naming the fix instead of failing later with a
    shape error.
    """
    from ..solver import STATE_FIELDS

    with np.load(path) as z:
        version = int(z["__version__"])
        if version not in (1, 2):
            raise ValueError(
                f"checkpoint version {version} > supported {CKPT_VERSION}"
            )
        if expect_square_form is not None:
            if "__square_form__" in z:
                saved_sq = bool(z["__square_form__"])
            else:
                # v1 checkpoints predate the square-form device layout
                saved_sq = False
            if saved_sq != bool(expect_square_form):
                raise ValueError(
                    f"checkpoint {path!r} was written with "
                    f"square_form={saved_sq} but this solve uses "
                    f"square_form={bool(expect_square_form)}; re-solve "
                    "with Options(square_form="
                    f"{saved_sq}) to resume it, or discard the checkpoint"
                )
        fields = {name: z[name] for name in STATE_FIELDS if name != "warm"}
        fields["warm"] = tuple(
            z[f"__warm_{i}__"] for i in range(int(z["__warm_len__"]))
        )
        phase32 = bool(z["__phase32__"])
    return fields, phase32


def load_checkpoint(path: str, expect_square_form: bool | None = None,
                    device="cuda"):
    """``(state, phase32)``: the port's ``State`` on ``device``
    (``convert.state_from_numpy``) and the hybrid-phase flag."""
    from .. import convert

    fields, phase32 = load_checkpoint_numpy(path, expect_square_form)
    return convert.state_from_numpy(fields, device), phase32
