"""The bias epilogue of the UNet's products (``hk.bias_epilogue``,
``csrc/bias_epilogue.cu``): the plain form ``y + b`` and the fused form
``res + (y + b)`` (``res + res_bias`` first where the residual is a 1x1
skip convolution's raw product), the biases fp32 as the layer stores them,
bit-equal to eager PyTorch's cast and adds.

This file imports neither JAX nor the JAX package. The kernel checks need a
CUDA card (a CUDA kernel has no CPU mode) and skip without one; on the card
run them with

    python -m pytest tests/test_torch_bias_epilogue.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from ishapediting_tpu_torch.ops import hopper_kernels as hk
from ishapediting_tpu_torch.tools import bias_epilogue_bench as beb

torch.set_num_threads(2)

BF16, FP32 = torch.bfloat16, torch.float32
FORMS = ("plain", "fused", "fused_skip")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bias epilogue kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, form, device="cpu", seed=0):
    """(y, b, res, res_bias) of ``form``, drawn on ``device``, the biases
    fp32: values of a few units, so that the bf16 adds round."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]

    def draw(s, scale, dt=dtype):
        return (torch.randn(s, generator=gen, device=device) * scale).to(dt)

    y, b = draw(shape, 3.0), draw((c,), 1.0, FP32)
    res = draw(shape, 2.0) if form != "plain" else None
    rb = draw((c,), 1.0, FP32) if form == "fused_skip" else None
    return y, b, res, rb


def _eager(y, b, res, rb):
    """The composition the UNet ran before the epilogue: each bias cast to
    y's dtype, then each ``+`` alone."""
    hh = y + b.to(y.dtype)
    if res is None:
        return hh
    x = res if rb is None else res + rb.to(y.dtype)
    return x + hh


def _model(y, b, res, rb):
    """The kernel's arithmetic: each bias rounded to y's dtype, every add one
    fp32 add rounded to the dtype."""
    def add(p, q):
        return (p.float() + q.to(y.dtype).float()).to(y.dtype)

    hh = add(y, b)
    if res is None:
        return hh
    return add(res if rb is None else add(res, rb), hh)


# ---------------------------------------------------------------------------
# CPU: the plain composition and the Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_plain_composition_is_the_eager_adds(dtype, form):
    """On the CPU with no gradient: bit-equal to ``out + b`` then ``x + hh``
    (the bias cast to y's dtype first), and to one fp32 add rounded to the
    dtype per ``+`` (what the kernel computes)."""
    y, b, res, rb = _inputs((2, 5, 7, 24), dtype, form, seed=1)
    got = hk.bias_epilogue(y, b, res, rb)
    assert got.dtype == dtype and got.shape == y.shape
    assert torch.equal(got, _eager(y, b, res, rb))
    assert torch.equal(got, _model(y, b, res, rb))
    assert torch.equal(hk.bias_epilogue_plain(y, b, res, rb), got)


def test_cut_layer_keeps_the_composition():
    """``b`` None (a cut layer's gathered output, its bias added before the
    gather): ``res + y``, with ``res + res_bias`` first."""
    y, _, res, rb = _inputs((2, 4, 4, 16), BF16, "fused_skip", seed=2)
    assert torch.equal(hk.bias_epilogue(y, None, res), res + y)
    assert torch.equal(hk.bias_epilogue(y, None, res, rb), (res + rb.to(BF16)) + y)
    assert torch.equal(hk.bias_epilogue(y, None), y)


def _grads(fn, y, b, res, rb, dout, need):
    leaves = [None if t is None else t.clone().requires_grad_(n) for t, n in zip((y, b, res, rb), need)]
    out = fn(*leaves)
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    return out, torch.autograd.grad(out, wanted, dout)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_gradients_under_autograd_are_the_compositions(dtype, form):
    """Under autograd the epilogue is the eager composition (an fp32 bias's
    gradient through its cast): output and every gradient bit for bit."""
    y, b, res, rb = _inputs((2, 6, 6, 40), dtype, form, seed=3)
    dout = _inputs((2, 6, 6, 40), dtype, "plain", seed=4)[0]
    need = [True, True, res is not None, rb is not None]
    out, got = _grads(hk.bias_epilogue, y, b, res, rb, dout, need)
    ref_out, want = _grads(_eager, y, b, res, rb, dout, need)
    assert torch.equal(out, ref_out)
    assert len(got) == len(want) == sum(need)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("grad_mode", [True, False])
@pytest.mark.parametrize("wants", ["none", "y", "b", "res", "res_bias"])
def test_a_gradient_is_wanted_where_autograd_records(grad_mode, wants):
    """``needs_grad`` (the dispatch's test: a CUDA call takes the kernel
    only where it is false) is true where grad mode is on and any operand
    requires a gradient: the drag step's latent, a train step's weights."""
    y, b, res, rb = _inputs((1, 3, 3, 8), FP32, "fused_skip", seed=5)
    if wants != "none":
        dict(y=y, b=b, res=res, res_bias=rb)[wants].requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        assert hk.needs_grad(y, b, res, rb) == (grad_mode and wants != "none")
        assert hk.needs_grad(y, None) == (grad_mode and wants == "y")


# ---------------------------------------------------------------------------
# Where the UNet calls it (meta-device forwards, kernels replaced by recorders)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["nfd_chairs", "adm_imagenet128"])
def test_each_configuration_runs_90_plain_and_51_fused(name):
    """A forward of either benchmark configuration: 90 plain epilogues and
    51 fused ones (35 ResBlocks, 18 of them with a skip conv, and 16
    attention blocks), against 159 bias adds and 51 residual adds before."""
    from ishapediting_tpu_torch.models.unet import epilogue_calls_per_forward

    cfg = beb.cell_configs()[name]
    calls = beb.forward_epilogues(cfg, 2)
    forms = [f for _, _, f in calls]
    assert (forms.count("plain"), forms.count("fused") + forms.count("fused_skip")) == (90, 51)
    assert forms.count("fused_skip") == 18
    assert epilogue_calls_per_forward(cfg) == (90, 51)
    heads = [(s, d) for s, d, _ in calls if d == FP32 and s[0] == 2 * 128 * 128]
    assert heads == [((2 * 128 * 128, cfg.out_channels), FP32)]  # the fp32 output head


@pytest.mark.parametrize("variant", [{}, {"resblock_updown": False},
                                     {"resblock_updown": False, "conv_resample": False}])
def test_tiny_preset_counts_match_the_layout(variant):
    """Resamples as ResBlocks, as convolutions, or as plain pools and
    repeats (no epilogue): ``epilogue_calls_per_forward`` counts each."""
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import epilogue_calls_per_forward

    cfg = dataclasses.replace(preset("tiny").unet, **variant)
    forms = [f for _, _, f in beb.forward_epilogues(cfg, 1)]
    plain = forms.count("plain")
    assert (plain, len(forms) - plain) == epilogue_calls_per_forward(cfg)


@pytest.mark.parametrize("step", ["drag", "train"])
@pytest.mark.parametrize("variant", [{}, {"resblock_updown": False},
                                     {"resblock_updown": False, "conv_resample": False}])
def test_under_autograd_only_the_time_embedding_path_would_launch(monkeypatch, variant, step):
    """The epilogues that a CUDA forward would still hand the kernel under
    autograd (those where ``needs_grad`` is false): in a drag step (frozen
    weights, the latent wants the gradient) the time MLP's two dense layers
    and each ResBlock's FiLM projection, which do not depend on the latent;
    in a train step (the weights want it) none."""
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_

    cfg = dataclasses.replace(preset("tiny").unet, **variant)
    kernel = []
    real = hk.bias_epilogue

    def rec(y, b, res=None, res_bias=None):
        if b is not None and not hk.needs_grad(y, b, res, res_bias):
            kernel.append(y.shape[-1])
        return real(y, b, res, res_bias)

    monkeypatch.setattr(hk, "bias_epilogue", rec)
    unet = init_unet_(UNetModel(cfg), torch.Generator().manual_seed(0)).requires_grad_(step == "train")
    x = torch.randn((1, cfg.image_size, cfg.image_size, cfg.in_channels), requires_grad=step == "drag")
    out, feat = unet(x, torch.tensor([5]), feat_layer=1)
    (feat.sum() if step == "drag" else out.sum()).backward()
    film = [m.emb_layers[1].out_features for m in unet.modules() if hasattr(m, "emb_layers")]
    time_mlp = [unet.time_embed[0].out_features, unet.time_embed[2].out_features]
    assert kernel == ([] if step == "train" else time_mlp + film)


# ---------------------------------------------------------------------------
# Launch geometry and vector width (pure Python)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,c,vec", [(32 * 128 * 128, 256, 8), (32 * 32 * 32, 1536, 8), (32, 2048, 4),
                                        (32 * 128 * 128, 6, 2), (32 * 128 * 128, 192, 4), (7, 3, 1),
                                        (1000, 5000, 8), (2 * 8 * 8, 1024, 8)])
def test_geometry_visits_each_vector_once(rows, c, vec):
    geo = hk.bias_epilogue_geometry(rows, c, vec)
    bdx, bdy = geo["block"]
    grid_x, grid_c = geo["grid"]
    assert bdx * bdy <= 512 and grid_c * bdx * vec >= c and grid_c * bdx * vec - c < bdx * vec
    assert grid_x * grid_c <= 2 * hk.NUM_SMS + grid_c and geo["row_step"] == grid_x * bdy
    starts = np.arange(grid_x)[:, None] * bdy + np.arange(bdy)[None, :]
    hits = np.zeros(rows, dtype=np.int64)
    for s in starts.ravel():
        hits[s::geo["row_step"]] += 1
    assert (hits == 1).all()


def test_vector_width_follows_c_and_alignment():
    base = 1 << 20  # a 16-byte aligned address; 0 stands for an absent tensor
    assert hk.bias_vec(256, 2, (base,)) == 8
    assert hk.bias_vec(12, 2, (base,)) == 4 and hk.bias_vec(6, 2, (base,)) == 2 and hk.bias_vec(3, 2, (base,)) == 1
    assert [hk.bias_vec(256, 2, (base, base + k)) for k in (2, 4, 8, 16)] == [1, 2, 4, 8]
    assert hk.bias_vec(192, 4, (base,)) == 4 and hk.bias_vec(6, 4, (base,)) == 2 and hk.bias_vec(7, 4, (base,)) == 1
    assert hk.bias_vec(192, 4, (base, base + 8)) == 2 and hk.bias_vec(192, 4, (base, 0)) == 4


def test_cuda_wrapper_refuses_cpu_tensors():
    y, b, _, _ = _inputs((2, 4, 4, 8), FP32, "plain")
    with pytest.raises(ValueError, match="CUDA"):
        hk.bias_epilogue_cuda(y, b)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cell_shapes(batches=(1, 32)):
    """Every ([rows, C], dtype, form) that a forward of either benchmark
    configuration gives its epilogues, at each batch."""
    return sorted({s for cfg in beb.cell_configs().values() for batch in batches for s in beb.forward_epilogues(cfg, batch)},
                  key=str)


@pytest.mark.cuda
def test_kernel_bit_equal_at_every_cell_shape(cuda_device):
    """At every [rows, C] of both configurations at batch 32 and 1 (C = 6
    and 192 fp32 heads included): the kernel, into a new tensor and into
    y's own buffer, is ``torch.equal`` to the eager composition."""
    shapes = _cell_shapes()
    assert any(s[1] == 6 and d == FP32 for s, d, _ in shapes) and any(s[1] == 192 and d == FP32 for s, d, _ in shapes)
    for i, (shape, dtype, form) in enumerate(shapes):
        y, b, res, rb = _inputs(shape, dtype, form, cuda_device, seed=i)
        want = _eager(y, b, res, rb)
        new = hk.bias_epilogue_cuda(y, b, res, rb)
        assert torch.equal(new, want), (shape, dtype, form)
        ptr = y.data_ptr()
        with torch.no_grad():
            inplace = hk.bias_epilogue(y, b, res, rb)
        assert inplace.data_ptr() == ptr and torch.equal(inplace, want), (shape, dtype, form)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype,c,offset", [(BF16, 256, 1), (BF16, 256, 2), (BF16, 6, 0), (BF16, 3, 0),
                                            (FP32, 6, 0), (FP32, 192, 1), (FP32, 7, 0), (BF16, 1536, 4)])
def test_narrow_vectors_and_misaligned_bases(cuda_device, dtype, c, offset, form):
    """C that 16-byte vectors do not divide and bases off 16 bytes take
    narrower vectors, with the same bits; the biases (off 16 bytes too) are
    read one by one."""
    rows = 333
    y, _, res, _ = _inputs((rows * c + offset,), dtype, form, cuda_device, seed=c + offset)
    y = y[offset:].view(rows, c)
    res = None if res is None else res[offset:].view(rows, c)
    ptrs = [0 if t is None else t.data_ptr() for t in (y, res)]
    assert offset == 0 or hk.bias_vec(c, y.element_size(), ptrs) < 16 // y.element_size()
    b = _inputs((c + 1,), FP32, "plain", cuda_device, seed=7)[0][1:]
    rb = _inputs((c + 1,), FP32, "plain", cuda_device, seed=8)[0][1:] if form == "fused_skip" else None
    assert torch.equal(hk.bias_epilogue_cuda(y, b, res, rb), _eager(y, b, res, rb))


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_routes_and_gradients_on_card(cuda_device, form):
    """No gradient wanted: one launch, the result in y's own buffer. Under
    autograd: no launch, a new tensor (y untouched), and the gradients of
    the eager composition, bit for bit."""
    y, b, res, rb = _inputs((2, 16, 16, 256), BF16, form, cuda_device, seed=9)
    y0 = y.clone()
    dout = _inputs((2, 16, 16, 256), BF16, "plain", cuda_device, seed=10)[0]
    need = [True, True, res is not None, rb is not None]
    before = dict(hk.LAUNCHES)
    out, got = _grads(hk.bias_epilogue, y, b, res, rb, dout, need)
    assert dict(hk.LAUNCHES) == before
    ref_out, want = _grads(_eager, y, b, res, rb, dout, need)
    assert torch.equal(y, y0) and torch.equal(out, ref_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    kernel = "bias_add" if form == "plain" else "bias_residual"
    with torch.no_grad():
        assert hk.bias_epilogue(y, b, res, rb).data_ptr() == y.data_ptr()
    assert hk.LAUNCHES[kernel] == before[kernel] + 1


@pytest.mark.cuda
def test_kernel_refuses_a_bias_that_is_not_fp32(cuda_device):
    """Every layer stores its bias in fp32, and the kernel reads it so."""
    y, b, res, rb = _inputs((4, 8, 16), BF16, "fused_skip", cuda_device, seed=11)
    with pytest.raises(ValueError, match="fp32"):
        hk.bias_epilogue_cuda(y, b.to(BF16))
    with pytest.raises(ValueError, match="fp32"):
        hk.bias_epilogue_cuda(y, b, res, rb.to(BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nfd_chairs", "adm_imagenet128"])
def test_launches_per_forward_on_card(cuda_device, name):
    """One batch-1 forward of each configuration on the card: 90
    ``bias_add`` and 51 ``bias_residual`` launches."""
    from ishapediting_tpu_torch.models.unet import UNetModel

    cfg = beb.cell_configs()[name]
    with torch.device(cuda_device):
        unet = UNetModel(cfg).eval()
    x = torch.randn((1, cfg.image_size, cfg.image_size, cfg.in_channels), device=cuda_device)
    with torch.no_grad():
        hk.reset_launch_counts()
        unet(x, torch.tensor([500], device=cuda_device))
    torch.cuda.synchronize()
    assert (hk.LAUNCHES["bias_add"], hk.LAUNCHES["bias_residual"]) == (90, 51)


@pytest.mark.cuda
def test_unet_forward_bit_equal_to_the_composition(cuda_device, monkeypatch):
    """A miniature bf16 UNet on the card, every epilogue on the kernel,
    against the same forward with the eager composition in its place:
    output and feature tap equal bit for bit."""
    from ishapediting_tpu_torch.config import UNetConfig
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_

    cfg = UNetConfig(image_size=16, in_channels=6, model_channels=64, out_channels=12, num_res_blocks=1,
                     attention_ds=(2,), channel_mult=(1, 2), num_head_channels=64, dropout=0.0)
    gen = torch.Generator().manual_seed(5)
    unet = init_unet_(UNetModel(cfg), gen).eval()
    with torch.no_grad():
        for p in unet.parameters():  # signal in the ADM init's zeroed layers too
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    unet.to(cuda_device)
    x = torch.randn((2, 16, 16, 6), generator=gen).to(cuda_device)
    t = torch.tensor([3, 700], device=cuda_device)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    with torch.no_grad():
        got = unet(x, t, feat_layer=1)
        monkeypatch.setattr(hk, "bias_epilogue", hk.bias_epilogue_plain)
        want = unet(x, t, feat_layer=1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
