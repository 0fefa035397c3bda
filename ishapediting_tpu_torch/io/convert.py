"""Weights between the port and the JAX parameter tree, and from the
reference's ``.pt`` files.

The JAX tree (NumPy arrays, or the tensors ``io/orbax.py::load_params``
reads) is ``{prefix: {"w"|"b"|"scale"|"bias": array}}``
with torch's dotted module names, so the conversion is the per-tensor
inverse of the JAX package's torch -> JAX converter:

- conv ``w`` HWIO (kh, kw, I, O)          -> Conv2d ``weight`` (O, I, kh, kw)
- dense ``w`` (I, O) of ``qkv``/``proj_out`` -> Conv1d ``weight`` (O, I, 1)
- other dense ``w`` (I, O)                -> Linear ``weight`` (O, I)
- ``label_emb`` ``w`` (N, D)               -> Embedding ``weight`` as is
- GroupNorm ``scale``/``bias``            -> ``weight``/``bias``

and ``jax_params_from_unet_state_dict`` / ``jax_decoder_from_state_dict``
are the inverses (the JAX package's ``io/torch_convert.py``), which the
orbax writer uses to save in JAX's layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder


def _t(a) -> torch.Tensor:
    """An fp32 CPU tensor of a NumPy array or a tensor (bf16 included); an
    fp32 tensor is not copied."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def unet_state_dict_from_jax(params: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """The port's UNet state_dict from a JAX UNet parameter tree."""
    sd: Dict[str, torch.Tensor] = {}
    for prefix, leaves in params.items():
        if "scale" in leaves:  # GroupNorm affine
            sd[f"{prefix}.weight"] = _t(leaves["scale"])
            sd[f"{prefix}.bias"] = _t(leaves["bias"])
            continue
        w = _t(leaves["w"])
        if prefix == "label_emb":
            sd[f"{prefix}.weight"] = w
            continue
        if w.ndim == 4:
            weight = w.permute(3, 2, 0, 1)
        elif prefix.endswith((".qkv", ".proj_out")):
            weight = w.T[:, :, None]
        else:
            weight = w.T
        sd[f"{prefix}.weight"] = weight.contiguous()
        if "b" in leaves:
            sd[f"{prefix}.bias"] = _t(leaves["b"])
    return sd


def decoder_state_dict_from_jax(dec: Mapping) -> Dict[str, torch.Tensor]:
    """The decoder state_dict (reference MultiTriplane.net keys ``0._B``,
    ``1/3/5.weight|bias``) from the JAX decoder tree."""
    sd = {"0._B": _t(dec["fourier_B"])}
    for idx, name in ((1, "dense1"), (3, "dense2"), (5, "dense3")):
        sd[f"{idx}.weight"] = _t(dec[name]["w"]).T.contiguous()
        sd[f"{idx}.bias"] = _t(dec[name]["b"])
    return sd


def jax_params_from_unet_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX UNet parameter tree of a port UNet state_dict, the inverse of
    ``unet_state_dict_from_jax`` (views of the tensors, dtypes and devices
    kept)."""
    raw: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        raw.setdefault(prefix, {})[leaf] = value.detach()
    params = {}
    for prefix, leaves in raw.items():
        w = leaves["weight"]
        if w.ndim == 1:  # GroupNorm affine
            params[prefix] = {"scale": w, "bias": leaves["bias"]}
            continue
        if w.ndim == 4:
            w = w.permute(2, 3, 1, 0)
        elif w.ndim == 3:
            w = w[:, :, 0].T
        elif prefix != "label_emb":
            w = w.T
        params[prefix] = {"w": w, **({"b": leaves["bias"]} if "bias" in leaves else {})}
    return params


def jax_decoder_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX decoder tree of a decoder state_dict, the inverse of
    ``decoder_state_dict_from_jax``."""
    dec = {"fourier_B": sd["0._B"].detach()}
    for idx, name in ((1, "dense1"), (3, "dense2"), (5, "dense3")):
        dec[name] = {"w": sd[f"{idx}.weight"].detach().T, "b": sd[f"{idx}.bias"].detach()}
    return dec


def read_pt_state_dict(path: str) -> Dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v.float() for k, v in state.items()}


def load_torch_checkpoint(path: str, model: UNetModel) -> UNetModel:
    """Read a reference EMA UNet ``.pt`` state_dict straight into ``model``."""
    model.load_state_dict(read_pt_state_dict(path))
    return model


def load_torch_decoder(path: str, decoder: TriplaneDecoder) -> TriplaneDecoder:
    """Read a reference decoder ``.pt`` (MultiTriplane.net) into ``decoder``."""
    decoder.load_state_dict(read_pt_state_dict(path))
    return decoder
