"""Weights into the port: from the JAX parameter tree, and from the
reference's ``.pt`` files.

The JAX tree (as NumPy arrays) is ``{prefix: {"w"|"b"|"scale"|"bias": ndarray}}``
with torch's dotted module names, so the conversion is the per-tensor
inverse of the JAX package's torch -> JAX converter:

- conv ``w`` HWIO (kh, kw, I, O)          -> Conv2d ``weight`` (O, I, kh, kw)
- dense ``w`` (I, O) of ``qkv``/``proj_out`` -> Conv1d ``weight`` (O, I, 1)
- other dense ``w`` (I, O)                -> Linear ``weight`` (O, I)
- ``label_emb`` ``w`` (N, D)               -> Embedding ``weight`` as is
- GroupNorm ``scale``/``bias``            -> ``weight``/``bias``
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def unet_state_dict_from_jax(params: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """The port's UNet state_dict from a JAX UNet parameter tree."""
    sd: Dict[str, torch.Tensor] = {}
    for prefix, leaves in params.items():
        if "scale" in leaves:  # GroupNorm affine
            sd[f"{prefix}.weight"] = _t(leaves["scale"])
            sd[f"{prefix}.bias"] = _t(leaves["bias"])
            continue
        w = np.asarray(leaves["w"], np.float32)
        if prefix == "label_emb":
            sd[f"{prefix}.weight"] = _t(w)
            continue
        if w.ndim == 4:
            weight = w.transpose(3, 2, 0, 1)
        elif prefix.endswith((".qkv", ".proj_out")):
            weight = w.T[:, :, None]
        else:
            weight = w.T
        sd[f"{prefix}.weight"] = _t(weight)
        if "b" in leaves:
            sd[f"{prefix}.bias"] = _t(leaves["b"])
    return sd


def decoder_state_dict_from_jax(dec: Mapping) -> Dict[str, torch.Tensor]:
    """The decoder state_dict (reference MultiTriplane.net keys ``0._B``,
    ``1/3/5.weight|bias``) from the JAX decoder tree."""
    sd = {"0._B": _t(dec["fourier_B"])}
    for idx, name in ((1, "dense1"), (3, "dense2"), (5, "dense3")):
        sd[f"{idx}.weight"] = _t(np.asarray(dec[name]["w"]).T)
        sd[f"{idx}.bias"] = _t(dec[name]["b"])
    return sd


def _read_pt(path: str) -> Dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v.float() for k, v in state.items()}


def load_torch_checkpoint(path: str, model: UNetModel) -> UNetModel:
    """Read a reference EMA UNet ``.pt`` state_dict straight into ``model``."""
    model.load_state_dict(_read_pt(path))
    return model


def load_torch_decoder(path: str, decoder: TriplaneDecoder) -> TriplaneDecoder:
    """Read a reference decoder ``.pt`` (MultiTriplane.net) into ``decoder``."""
    decoder.load_state_dict(_read_pt(path))
    return decoder
