"""Shared set-up of the port's parity tests: one set of random weights, made
with numpy, loaded into both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ishapediting_tpu.config import UNetConfig as JUNetConfig
from ishapediting_tpu.models import unet as junet
from ishapediting_tpu.ops.triplane import init_decoder_params
from ishapediting_tpu_torch.config import UNetConfig
from ishapediting_tpu_torch.io.convert import decoder_state_dict_from_jax, unet_state_dict_from_jax
from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder


def random_jax_params(jcfg, seed):
    """The JAX tree's structure with every leaf random (zero modules too, so
    every path carries signal), from numpy."""
    rng = np.random.default_rng(seed)
    params = junet.init_unet_params(jax.random.PRNGKey(0), jcfg)
    out = {}
    for prefix, leaves in params.items():
        entry = {}
        for leaf, arr in leaves.items():
            if leaf == "w":
                v = rng.normal(size=arr.shape) / np.sqrt(int(np.prod(arr.shape[:-1])))
            elif leaf == "scale":
                v = 1.0 + 0.1 * rng.normal(size=arr.shape)
            else:
                v = 0.1 * rng.normal(size=arr.shape)
            entry[leaf] = v.astype(np.float32)
        out[prefix] = entry
    return out


def unet_pair(cfg_kwargs, seed=0):
    """(JAX config, JAX params, port UNetModel) with the same weights."""
    jcfg = JUNetConfig(**cfg_kwargs)
    np_params = random_jax_params(jcfg, seed)
    model = UNetModel(UNetConfig(**cfg_kwargs))
    model.load_state_dict(unet_state_dict_from_jax(np_params), strict=True)
    return jcfg, jax.tree.map(jnp.asarray, np_params), model.eval().requires_grad_(False)


def decoder_pair(in_channels, seed=0):
    """(JAX decoder tree, port TriplaneDecoder) with the same weights."""
    dec = init_decoder_params(jax.random.PRNGKey(seed), in_channels=in_channels)
    model = TriplaneDecoder(in_channels)
    model.load_state_dict(decoder_state_dict_from_jax(jax.tree.map(np.asarray, dec)))
    return dec, model.eval().requires_grad_(False)


def jax_step_noises(rng, shape, steps):
    """The per-step normals a JAX sampling scan draws from ``rng``
    (``key, sub = split(key)``; ``normal(sub)``), as numpy arrays."""
    key, noises = rng, []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return noises


def to_torch(a):
    return torch.from_numpy(np.asarray(a, np.float32))
