"""Checkpoints in the JAX package's format: the counterpart of its
``io/checkpoint.py`` (``save_params``, ``load_params``,
``convert_model_dir``), and train states as its ``train/loop.py`` saves
them.

A train state is a directory (``step_<N>`` under a run's checkpoint
directory) holding the orbax checkpoint of JAX's ``TrainState(step, params,
ema_params, opt_state)`` with optax's ``chain(clip_by_global_norm, adamw)``
state (``io/orbax.py`` writes and reads it). So the JAX package resumes the
port's checkpoints and the port resumes JAX's. The port's state maps onto
that tree:

- the step and optax's Adam ``count``: int32 scalars; ``count`` is every
  parameter's Adam ``step`` (a save refuses counts that differ);
- the parameters, their EMA, ``mu`` (``exp_avg``) and ``nu``
  (``exp_avg_sq``): JAX's UNet layout (``io/convert.py``), fp32;
- optax's ``EmptyState``s (the clip, the weight decay, the learning rate):
  ``None``; without clipping the chain holds adamw alone.

A checkpoint holds whole tensors, as JAX's orbax saves global arrays: a
model cut over the model axis (``parallel/tensor.py``) gathers its slices,
their EMA and their Adam moments before the save, the mesh's first rank
writes, and every rank waits for it; a load keeps this rank's slices. So
one rank resumes a cut run's checkpoint and a cut run resumes one rank's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ishapediting_tpu_torch.io.convert import (
    jax_decoder_from_state_dict,
    jax_params_from_unet_state_dict,
    read_pt_state_dict,
    unet_state_dict_from_jax,
)
from ishapediting_tpu_torch.io.orbax import OrbaxFormatError, dir_bytes, load_params, save_params
from ishapediting_tpu_torch.parallel.mesh import DataMesh
from ishapediting_tpu_torch.parallel.tensor import gather_named, is_cut, slice_named

MOMENTS = ("exp_avg", "exp_avg_sq")
TRAIN_STATE_KEYS = ("step", "params", "ema_params", "opt_state")


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
    """The checkpoint's content in the port's layout: the step, the
    parameters, their EMA and the optimizer's state, each tensor whole (a
    cut model's gathered over the model axis; every rank of it calls
    this)."""
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


def jax_train_tree(blob: Dict, state) -> Dict:
    """``whole_state``'s content as the JAX package's ``TrainState`` tree
    (views of its tensors in JAX's layout)."""
    names = _opt_names(state)
    opt = {names[int(i)]: s for i, s in blob["optimizer"]["state"].items()}
    counts = sorted({int(s["step"]) for s in opt.values()})
    if len(counts) > 1:
        raise ValueError(f"Adam step counts {counts} differ between parameters: optax keeps one count")
    params = blob["params"]
    moments = [{n: opt[n][m] if n in opt else torch.zeros_like(params[n]) for n in names} for m in MOMENTS]
    adam = {"count": torch.tensor(counts[0] if counts else 0, dtype=torch.int32),
            "mu": jax_params_from_unet_state_dict(moments[0]), "nu": jax_params_from_unet_state_dict(moments[1])}
    adamw = [adam, None, None]  # scale_by_adam, add_decayed_weights, scale_by_learning_rate
    return {"step": torch.tensor(blob["step"], dtype=torch.int32),
            "params": jax_params_from_unet_state_dict(params),
            "ema_params": jax_params_from_unet_state_dict(blob["ema_params"]),
            "opt_state": [None, adamw] if getattr(state.optimizer, "grad_clip", 0) > 0 else [adamw]}


def save_train_state(path: str, state, mesh: Optional[DataMesh] = None) -> int:
    """Write ``state`` (a ``train.trainer.TrainState``) into the directory
    ``path`` as the JAX package's orbax train state, replacing one that is
    there. Over a ``mesh`` of several ranks every rank calls it: a cut
    model's tensors are gathered, the mesh's first rank writes and the
    others wait for it. Returns the bytes written."""
    blob = whole_state(state)
    if mesh is None or mesh.rank == 0:
        save_params(path, jax_train_tree(blob, state))
    if mesh is not None and mesh.n_ranks > 1:
        torch.distributed.barrier(group=mesh.mesh_group)
    return dir_bytes(path)


def _adam_states(tree, where: str, found: list) -> None:
    """Collect optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) in an
    opt_state tree; any other leaf has no counterpart here."""
    if tree is None:
        return
    if isinstance(tree, dict) and set(tree) == {"count", "mu", "nu"}:
        found.append((where, tree))
    elif isinstance(tree, (list, dict)):
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        for k, v in items:
            _adam_states(v, f"{where}/{k}", found)
    else:
        raise OrbaxFormatError(f"{where}: an optimizer leaf with no counterpart in ClippedAdamW "
                               "(this reader maps optax's clip_by_global_norm + adamw)")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def read_train_state(path: str, state) -> dict:
    """The orbax train state ``path`` as ``whole_state``'s content for
    ``state``'s model and optimizer: whole tensors in the port's layout
    (moved to the model's device first, where the layout maps run, unless
    the model is cut: its rank slices them on the host); ``count`` -> each
    parameter's ``step``, ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``."""
    model = state.model
    device = torch.device("cpu") if is_cut(model) else next(model.parameters()).device
    tree = _to(load_params(path), device)
    if not isinstance(tree, dict) or set(tree) != set(TRAIN_STATE_KEYS):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise OrbaxFormatError(f"{path}: a train state holds step, params, ema_params and opt_state, not {got}")
    found: list = []
    _adam_states(tree["opt_state"], "opt_state", found)
    if len(found) != 1:
        raise OrbaxFormatError(f"{path}: {len(found)} Adam states in opt_state (this reader maps one)")
    where, adam = found[0]
    params = unet_state_dict_from_jax(tree["params"])
    mu, nu = unet_state_dict_from_jax(adam["mu"]), unet_state_dict_from_jax(adam["nu"])
    if mu.keys() != params.keys() or nu.keys() != params.keys():
        raise OrbaxFormatError(f"{path}: {where} moments do not match the parameters")
    count = float(adam["count"])
    opt = state.optimizer.state_dict()
    opt["state"] = {i: {"step": torch.tensor(count, dtype=torch.float32), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]} for i, name in enumerate(_opt_names(state))}
    return {"step": int(tree["step"]), "params": params, "ema_params": unet_state_dict_from_jax(tree["ema_params"]),
            "optimizer": opt}


def load_train_state(path: str, state):
    """Load the orbax train state ``path`` (the port's or the JAX
    package's) into ``state`` in place, a cut model keeping its slices
    (every tensor keeps its device; the optimizer places its state as it
    does when it creates it, Adam's step counts on the host); returns
    ``state``."""
    blob = read_train_state(path, state)
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


def convert_model_dir(main_path: str, out_path: Optional[str] = None) -> str:
    """One shot: the reference's ``.pt`` category dir -> ``unet.orbax`` and
    ``decoder.orbax`` in JAX's layout, written into ``out_path`` (the dir
    itself by default), as the JAX package's ``convert_model_dir`` does."""
    from ishapediting_tpu_torch.io.model_dir import discover_model_dir

    info = discover_model_dir(main_path)
    if info.unet_ckpt is None or info.decoder_ckpt is None:
        raise FileNotFoundError(f"{main_path}: needs a ddpm*/ema* UNet .pt and a decoder .pt")
    out_path = out_path or main_path
    save_params(os.path.join(out_path, "unet.orbax"),
                jax_params_from_unet_state_dict(read_pt_state_dict(info.unet_ckpt)))
    save_params(os.path.join(out_path, "decoder.orbax"),
                jax_decoder_from_state_dict(read_pt_state_dict(info.decoder_ckpt)))
    return out_path
