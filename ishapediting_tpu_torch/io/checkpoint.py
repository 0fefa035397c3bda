"""Train-state checkpoints: the counterpart of the JAX package's
``io/checkpoint.py`` (orbax) for a torch ``TrainState``.

A checkpoint is a directory (``step_<N>`` under a run's checkpoint
directory) holding one ``torch.save`` file with the step, the parameters,
their EMA and the optimizer's state (Adam moments and step counts). A save
is written into a sibling temporary directory and renamed into place, so a
run cut off mid-save leaves no partial ``step_<N>`` behind.

A checkpoint holds whole tensors, as JAX's orbax saves global arrays: a
model cut over the model axis (``parallel/tensor.py``) gathers its slices,
their EMA and their Adam moments before the save, the mesh's first rank
writes, and every rank waits for it; a load keeps this rank's slices. So
one rank resumes a cut run's checkpoint and a cut run resumes one rank's.

``load_train_state`` also resumes the JAX package's train state
(``step_<N>`` written by its ``train/loop.py``: ``TrainState(step, params,
ema_params, opt_state)`` with optax's ``chain(clip_by_global_norm,
adamw)``) through the orbax reader (``io/orbax.py``).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import torch

from ishapediting_tpu_torch.parallel.mesh import DataMesh
from ishapediting_tpu_torch.parallel.tensor import gather_named, is_cut, slice_named

STATE_FILE = "train_state.pt"
MOMENTS = ("exp_avg", "exp_avg_sq")


def _opt_names(state) -> list:
    """The parameter name of each optimizer index (``state_dict``'s keys)."""
    names = {id(p): k for k, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


def _map_moments(opt_sd: dict, names: list, model, op) -> dict:
    """``opt_sd`` with each parameter's Adam moments through ``op``
    (``gather_named`` or ``slice_named``), under the parameter's name."""
    state = {}
    for i, s in opt_sd["state"].items():
        name = names[int(i)]
        state[i] = {m: op(model, {name: v})[name] if m in MOMENTS else v for m, v in s.items()}
    return dict(opt_sd, state=state)


def whole_state(state) -> Dict:
    """The checkpoint's content: the step, the parameters, their EMA and the
    optimizer's state, each tensor whole (a cut model's gathered over the
    model axis; every rank of it calls this)."""
    model = state.model
    opt_sd = state.optimizer.state_dict()
    if is_cut(model):
        names = _opt_names(state)
        params = gather_named(model, dict(model.named_parameters()))
        params = {k: v.detach() for k, v in params.items()}
        ema = gather_named(model, state.ema_params)
        opt_sd = _map_moments(opt_sd, names, model, gather_named)
    else:
        params, ema = model.state_dict(), state.ema_params
    return {"step": int(state.step), "params": params, "ema_params": ema, "optimizer": opt_sd}


def save_train_state(path: str, state, mesh: Optional[DataMesh] = None) -> int:
    """Write ``state`` (a ``train.trainer.TrainState``) into the directory
    ``path``, replacing one that is there. Over a ``mesh`` of several ranks
    every rank calls it: a cut model's tensors are gathered, the mesh's
    first rank writes and the others wait for it. Returns the bytes
    written."""
    blob = whole_state(state)
    path = os.path.abspath(path)
    if mesh is None or mesh.rank == 0:
        tmp = path + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(blob, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    if mesh is not None and mesh.n_ranks > 1:
        torch.distributed.barrier(group=mesh.mesh_group)
    return os.path.getsize(os.path.join(path, STATE_FILE))


def load_train_state(path: str, state):
    """Load the checkpoint directory ``path`` (the port's, or the JAX
    package's orbax train state) into ``state`` in place, a cut model
    keeping its slices (every tensor keeps its device; the optimizer
    places its state as it does when it creates it, Adam's step counts on
    the host); returns ``state``."""
    if os.path.exists(os.path.join(path, STATE_FILE)):
        blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    else:
        from ishapediting_tpu_torch.io.orbax import jax_train_state

        blob = jax_train_state(path, state)
    model = state.model
    if blob["ema_params"].keys() != state.ema_params.keys():
        raise ValueError(f"{path}: EMA parameters do not match the model's")
    params, ema, opt_sd = blob["params"], blob["ema_params"], blob["optimizer"]
    if is_cut(model):
        params, ema = slice_named(model, params), slice_named(model, ema)
        opt_sd = _map_moments(opt_sd, _opt_names(state), model, slice_named)
    model.load_state_dict(params)
    with torch.no_grad():
        for k, v in state.ema_params.items():
            v.copy_(ema[k])
    state.optimizer.load_state_dict(opt_sd)
    state.step = int(blob["step"])
    return state
