"""Port parity, UNet: the JAX parameter tree goes through
``unet_state_dict_from_jax`` into the port's ``UNetModel`` (strict load), and
both forwards (output and feature tap) agree in fp32 on the CPU. Layout
helpers are checked on the published config without running it, and the
``.pt`` loaders on state_dicts the test saves itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.models import unet as junet
from ishapediting_tpu.ops.triplane import init_decoder_params
from ishapediting_tpu_torch.config import UNetConfig, preset
from ishapediting_tpu_torch.io.convert import (
    decoder_state_dict_from_jax,
    load_torch_checkpoint,
    load_torch_decoder,
)
from ishapediting_tpu_torch.models import unet as tunet
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder
from torch_parity_helpers import unet_pair

torch.set_num_threads(2)

# the miniature config of tests/test_pallas_kernels.py
MINI = dict(
    image_size=8, in_channels=6, model_channels=16, out_channels=12, num_res_blocks=1,
    attention_ds=(2,), channel_mult=(1, 2), num_head_channels=8, dropout=0.0,
    compute_dtype="float32",
)


# A miniature of the heads-by-count UNet (num_head_channels -1: ADM's
# num_heads split, UNetConfig.from_reference_args(num_head_channels=-1) at
# chairs width): one head per attention block, so head dims 128 (ds 2) and
# 192 (ds 4 and the middle block), past the 128 the port's kernels once
# stopped at.
HEADS_BY_COUNT = dict(
    image_size=16, in_channels=6, model_channels=64, out_channels=12, num_res_blocks=1,
    attention_ds=(2, 4), channel_mult=(1, 2, 3), num_heads=1, num_head_channels=-1,
    dropout=0.0, compute_dtype="float32",
)


@pytest.mark.parametrize(
    "cfg_kwargs,feat_layer",
    [(MINI, 1), (dict(vars(preset("tiny").unet)), 1), (dict(vars(preset("tiny").unet)), 2),
     (HEADS_BY_COUNT, 2)],
    ids=["mini", "tiny-feat1", "tiny-feat2", "heads-by-count"],
)
def test_unet_forward_matches_jax(cfg_kwargs, feat_layer):
    jcfg, jparams, model = unet_pair(cfg_kwargs)
    rng = np.random.default_rng(1)
    s = cfg_kwargs["image_size"]
    x = rng.normal(size=(2, s, s, cfg_kwargs["in_channels"])).astype(np.float32)
    t = np.array([3, 71], np.int32)
    want, feat_want = junet.unet_apply(jcfg, jparams, jnp.asarray(x), jnp.asarray(t), feat_layer=feat_layer)
    with torch.no_grad():
        got, feat_got = model(torch.from_numpy(x), torch.from_numpy(t).long(), feat_layer=feat_layer)
    assert got.shape == want.shape and feat_got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(feat_got.numpy(), np.asarray(feat_want), atol=1e-4)


def test_unet_state_dict_keys_and_shapes_match_jax_tree():
    jcfg, jparams, model = unet_pair(MINI)
    sd = model.state_dict()
    n_jax = sum(int(np.prod(a.shape)) for d in jparams.values() for a in d.values())
    assert tunet.param_count(model) == n_jax
    assert sd["input_blocks.1.0.in_layers.2.weight"].ndim == 4  # OIHW
    qkv = [k for k in sd if k.endswith(".qkv.weight")]
    assert qkv and all(sd[k].ndim == 3 and sd[k].shape[-1] == 1 for k in qkv)


def test_published_layout_without_running():
    """build_layout / feat_layer_shape / parameter count on the published
    chairs config, built on the meta device (no memory, no compute)."""
    tcfg, jcfg = preset("chairs").unet, jpreset("chairs").unet
    assert tunet.build_layout(tcfg).__repr__() == junet.build_layout(jcfg).__repr__()
    for fl in range(len(junet.build_layout(jcfg).output_blocks)):
        assert tunet.feat_layer_shape(tcfg, fl) == junet.feat_layer_shape(jcfg, fl)
    assert tunet.kernel_calls_per_forward(tcfg) == (71, 16)
    with torch.device("meta"):
        model = tunet.UNetModel(tcfg)
    assert tunet.param_count(model) == 421_148_608


def test_init_unet_zero_modules_and_bounds():
    model = tunet.UNetModel(UNetConfig(**MINI))
    tunet.init_unet_(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert not sd["out.2.weight"].any() and not sd["input_blocks.1.0.out_layers.3.weight"].any()
    assert not sd["middle_block.1.proj_out.weight"].any()
    w = sd["input_blocks.1.0.in_layers.2.weight"]
    bound = np.sqrt(3.0 / w[0].numel())
    assert 0 < w.abs().max() <= bound and (sd["input_blocks.1.0.in_layers.0.weight"] == 1).all()


def test_pt_loaders_roundtrip(tmp_path):
    _, _, model = unet_pair(MINI, seed=3)
    path = tmp_path / "ema_0.999.pt"
    torch.save({k: v.half() for k, v in model.state_dict().items()}, path)
    loaded = load_torch_checkpoint(str(path), tunet.UNetModel(UNetConfig(**MINI)))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v.half().float())

    dec = jax.tree.map(np.asarray, init_decoder_params(jax.random.PRNGKey(1), in_channels=4))
    sd = decoder_state_dict_from_jax(dec)
    torch.save(sd, tmp_path / "decoder.pt")
    d = load_torch_decoder(str(tmp_path / "decoder.pt"), TriplaneDecoder(4))
    np.testing.assert_array_equal(d.fourier_B.numpy(), dec["fourier_B"])
    np.testing.assert_array_equal(d[3].weight.detach().numpy(), dec["dense2"]["w"].T)
