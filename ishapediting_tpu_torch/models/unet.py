"""ADM UNet as an ``nn.Module`` over NHWC activations, bf16 torso.

Architecture semantics match the reference UNetModel (reference:
unet.py:396-671, factory script_util.py:132-187), and module and parameter
names follow its state_dict keys ("input_blocks.3.0.in_layers.2.weight", ...):
convolutions are OIHW, ``qkv``/``proj_out`` Conv1d-shaped (O, I, 1). A
released ``.pt`` therefore loads with ``load_state_dict`` as it is.

Precision mirrors the JAX package by explicit casts (no autocast): the torso
runs in ``compute_dtype`` with weights cast per op; GroupNorm statistics, the
time embedding and the output head stay fp32; the tapped feature
(``feat_layer``) is returned in fp32. Activations are NHWC tensors, i.e. the
channels_last memory of the NCHW tensors cuDNN convolves, which the Hopper
kernels read with no copy. Parameters are held in fp32.

``train=True`` applies the config's dropout after the second
GroupNorm-SiLU of each ResBlock, ``where(keep, hh / (1 - p), 0)`` in the
activation dtype as the JAX package computes it. The caller passes the keep
masks of the whole forward, one per dropout site in the JAX package's
``drop_rngs[site]`` order (``dropout_sites``): drawn from an explicit
``torch.Generator`` (``draw_dropout_masks``) or injected. They exist before
any block runs, so a block recomputed under ``remat`` applies the same
ones (``torch.utils.checkpoint`` would not replay an explicit generator's
draws). The inference forward (``train=False``: the samplers, drag and
fit) has no dropout.

``remat=True`` recomputes each input, middle and output block in the
backward pass (``torch.utils.checkpoint``, non-reentrant), as the JAX
package's ``jax.checkpoint`` does: the forward keeps only the blocks'
inputs, and the backward runs each block it reaches a second time, Hopper
kernels included.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ishapediting_tpu_torch.config import UNetConfig
from ishapediting_tpu_torch.ops.attention import qkv_attention
from ishapediting_tpu_torch.ops.nn import (
    add_bias,
    add_bias_residual,
    avg_pool_2x,
    conv2d,
    conv2d_product,
    group_norm,
    group_norm_silu,
    linear,
    linear_product,
    nearest_upsample_2x,
    silu,
    timestep_embedding,
)
from ishapediting_tpu_torch.utils.trace import first_call, span


# ---------------------------------------------------------------------------
# Static layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layer:
    """One sublayer inside a block (reference TimestepEmbedSequential)."""

    kind: str  # 'conv' | 'res' | 'attn' | 'downsample' | 'upsample'
    in_ch: int
    out_ch: int
    updown: str = "none"  # for 'res': 'none' | 'up' | 'down'
    heads: int = 0  # for 'attn'
    scale_shift: bool = True  # for 'res': FiLM vs additive time embedding
    use_conv: bool = True  # for 'downsample'/'upsample'


@dataclasses.dataclass(frozen=True)
class Layout:
    input_blocks: Tuple[Tuple[Layer, ...], ...]
    middle_block: Tuple[Layer, ...]
    output_blocks: Tuple[Tuple[Layer, ...], ...]
    out_ch_final: int  # channels entering the output head


def _num_heads(cfg: UNetConfig, ch: int, upsample: bool) -> int:
    if cfg.num_head_channels == -1:
        if upsample and cfg.num_heads_upsample != -1:
            return cfg.num_heads_upsample
        return cfg.num_heads
    assert ch % cfg.num_head_channels == 0, (ch, cfg.num_head_channels)
    return ch // cfg.num_head_channels


def build_layout(cfg: UNetConfig) -> Layout:
    """The constructor wiring of the reference UNet (unet.py:480-616) as a
    static description."""
    mc = cfg.model_channels
    ssn = cfg.use_scale_shift_norm
    ch = int(cfg.channel_mult[0] * mc)
    input_blocks: List[Tuple[Layer, ...]] = [(Layer("conv", cfg.in_channels, ch),)]
    input_block_chans = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [Layer("res", ch, int(mult * mc), scale_shift=ssn)]
            ch = int(mult * mc)
            if ds in cfg.attention_ds:
                layers.append(Layer("attn", ch, ch, heads=_num_heads(cfg, ch, False)))
            input_blocks.append(tuple(layers))
            input_block_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                input_blocks.append((Layer("res", ch, ch, updown="down", scale_shift=ssn),))
            else:
                input_blocks.append(
                    (Layer("downsample", ch, ch, use_conv=cfg.conv_resample),)
                )
            input_block_chans.append(ch)
            ds *= 2

    middle = (
        Layer("res", ch, ch, scale_shift=ssn),
        Layer("attn", ch, ch, heads=_num_heads(cfg, ch, False)),
        Layer("res", ch, ch, scale_shift=ssn),
    )

    output_blocks: List[Tuple[Layer, ...]] = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_block_chans.pop()
            layers = [Layer("res", ch + ich, int(mc * mult), scale_shift=ssn)]
            ch = int(mc * mult)
            if ds in cfg.attention_ds:
                layers.append(Layer("attn", ch, ch, heads=_num_heads(cfg, ch, True)))
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    layers.append(Layer("res", ch, ch, updown="up", scale_shift=ssn))
                else:
                    layers.append(Layer("upsample", ch, ch, use_conv=cfg.conv_resample))
                ds //= 2
            output_blocks.append(tuple(layers))

    return Layout(
        input_blocks=tuple(input_blocks),
        middle_block=middle,
        output_blocks=tuple(output_blocks),
        out_ch_final=ch,
    )


def feat_layer_shape(cfg: UNetConfig, feat_layer: int) -> Tuple[int, int]:
    """(channels, spatial) of the activation after output_blocks[feat_layer]."""
    layout = build_layout(cfg)
    size = cfg.image_size // 2 ** (len(cfg.channel_mult) - 1)
    for i, block in enumerate(layout.output_blocks):
        ch = block[0].out_ch
        if any(l.kind == "res" and l.updown == "up" or l.kind == "upsample" for l in block):
            size *= 2
        if i == feat_layer:
            return ch, size
    raise ValueError(f"feat_layer {feat_layer} out of range")


def kernel_calls_recomputed(cfg: UNetConfig, feat_layer: int, head: bool = False) -> Tuple[int, int]:
    """(GroupNorm-SiLU calls, attention calls) that a ``remat`` backward
    recomputes when the loss reaches the output only through the feature tap
    at ``feat_layer`` (a drag step): every input and middle block and output
    blocks 0..feat_layer run again. ``head=True``: the loss reaches the
    output (a fit step), so every block runs again (the output head is not
    checkpointed). Two calls per ResBlock, one per attention block."""
    layout = build_layout(cfg)
    layers = _layers(layout, len(layout.output_blocks) if head else feat_layer + 1)
    return 2 * sum(l.kind == "res" for l in layers), sum(l.kind == "attn" for l in layers)


def _layers(layout: Layout, output_blocks: Optional[int] = None) -> List[Layer]:
    """The layers of the input blocks, the middle block and the first
    ``output_blocks`` output blocks (all by default), in forward order."""
    layers = [l for b in layout.input_blocks for l in b] + list(layout.middle_block)
    return layers + [l for b in layout.output_blocks[:output_blocks] for l in b]


def attention_head_dims(cfg: UNetConfig) -> List[int]:
    """Head dim of each attention call of one forward, in block order
    (input, middle, output): a block's channels over its heads, which for
    ``num_head_channels == -1`` (heads by count) grow with the level."""
    return [l.in_ch // l.heads for l in _layers(build_layout(cfg)) if l.kind == "attn"]


def kernel_calls_per_forward(cfg: UNetConfig) -> Tuple[int, int]:
    """(GroupNorm-SiLU calls, attention calls) of one forward: those of
    every block, and the output head's GroupNorm-SiLU."""
    gn, attn = kernel_calls_recomputed(cfg, -1, head=True)
    return gn + 1, attn


def _epilogues(layer: Layer) -> Tuple[int, int]:
    """(plain, fused) bias epilogues of one layer's forward. Fused: a
    ResBlock's last conv (with the skip conv's bias where there is one) and
    an attention block's projection, each with the residual add. Plain:
    every other convolution and dense layer, i.e. a ResBlock's first conv
    and FiLM projection, an attention block's qkv, the input conv and each
    resample conv."""
    if layer.kind == "res":
        return 2, 1
    if layer.kind == "attn":
        return 1, 1
    return int(layer.use_conv), 0  # conv, downsample, upsample


def epilogue_calls_per_forward(cfg: UNetConfig) -> Tuple[int, int]:
    """(plain, fused) bias epilogues of one forward of an uncut UNet: those
    of every layer (``_epilogues``), and three plain ones outside the
    blocks (the time MLP's two dense layers and the output conv)."""
    counts = [_epilogues(l) for l in _layers(build_layout(cfg))]
    return 3 + sum(c[0] for c in counts), sum(c[1] for c in counts)


def dropout_sites(cfg: UNetConfig, batch: int) -> List[Optional[Tuple[int, int, int, int]]]:
    """The keep mask's shape at each dropout site of a batch-``batch``
    forward, in the JAX package's ``drop_rngs[site]`` order: every layer of
    the input, middle and output blocks is a site; a ResBlock's mask has the
    shape of its output [N, H, W, out_ch], every other site's is None."""
    size, shapes = cfg.image_size, []
    for l in _layers(build_layout(cfg)):
        if l.kind == "downsample" or l.updown == "down":
            size //= 2
        elif l.kind == "upsample" or l.updown == "up":
            size *= 2
        shapes.append((batch, size, size, l.out_ch) if l.kind == "res" else None)
    return shapes


def draw_dropout_masks(cfg: UNetConfig, batch: int, generator: torch.Generator) -> List[Optional[torch.Tensor]]:
    """Keep masks for every dropout site of one train forward, drawn on the
    generator's device: ``uniform < 1 - dropout``, as ``jax.random.bernoulli``."""
    keep = 1.0 - cfg.dropout
    return [
        None if s is None else torch.rand(s, generator=generator, device=generator.device) < keep
        for s in dropout_sites(cfg, batch)
    ]


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class GroupNorm32(nn.Module):
    """GroupNorm parameters (``weight``/``bias``, reference GroupNorm32);
    its forward is the plain fp32-statistics ``group_norm`` over NHWC."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias)


def dense(mod: nn.Module, x: torch.Tensor, **conv_kw) -> torch.Tensor:
    """``mod``'s output on ``x``, its bias added: ``conv2d`` (NHWC) for an
    ``nn.Conv2d``, ``linear`` for an ``nn.Linear`` or an attention block's
    1x1 ``nn.Conv1d`` (see ``dense_product``)."""
    return add_bias(*dense_product(mod, x, **conv_kw))


def dense_product(mod: nn.Module, x: torch.Tensor, **conv_kw):
    """(``mod``'s raw product on ``x``, its bias as stored), for a caller
    that adds the bias in a fused epilogue (``add_bias_residual``). A layer
    that ``parallel/tensor.py::shard_params_tp`` cut computes this rank's
    slice of the output features, its bias added, and gathers the slices
    over the model axis: it returns the whole output and None."""
    w, conv = mod.weight, isinstance(mod, nn.Conv2d)
    if not conv and w.dim() == 3:
        w = w[:, :, 0]
    axis = getattr(mod, "model_axis", None)
    if axis is None:
        return (conv2d_product(x, w, **conv_kw) if conv else linear_product(x, w)), mod.bias
    from ishapediting_tpu_torch.parallel.tensor import copy_to_model, gather_from_model

    x = copy_to_model(x, axis)
    return gather_from_model(conv2d(x, w, mod.bias, **conv_kw) if conv else linear(x, w, mod.bias), axis), None


def embed(mod: nn.Embedding, y: torch.Tensor) -> torch.Tensor:
    """The rows ``y`` of ``mod``'s table; a table that ``shard_params_tp``
    cut looks up this rank's columns and gathers them over the model axis."""
    axis = getattr(mod, "model_axis", None)
    if axis is None:
        return mod.weight[y]
    from ishapediting_tpu_torch.parallel.tensor import gather_from_model

    return gather_from_model(mod.weight[y], axis)


def _gn_silu(norm: GroupNorm32, h: torch.Tensor, film=None) -> torch.Tensor:
    return group_norm_silu(h.contiguous(), norm.weight, norm.bias, film=film)


class ResBlock(nn.Module):
    """ResBlock with scale-shift GroupNorm FiLM and in-block up/down resample
    (reference: unet.py:188-256)."""

    def __init__(self, layer: Layer, emb_ch: int):
        super().__init__()
        self.layer = layer
        i, o = layer.in_ch, layer.out_ch
        self.in_layers = nn.Sequential(GroupNorm32(i), nn.SiLU(), nn.Conv2d(i, o, 3, padding=1))
        emb_out = 2 * o if layer.scale_shift else o
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, emb_out))
        self.out_layers = nn.Sequential(
            GroupNorm32(o), nn.SiLU(), nn.Identity(), nn.Conv2d(o, o, 3, padding=1)  # [2]: dropout
        )
        if i != o:
            self.skip_connection = nn.Conv2d(i, o, 1)

    def forward(self, h: torch.Tensor, emb: torch.Tensor, keep: Optional[torch.Tensor] = None,
                p: float = 0.0) -> torch.Tensor:
        """``keep``: the dropout site's keep mask (train mode), ``p`` the rate."""
        x = h
        hh = _gn_silu(self.in_layers[0], h)
        if self.layer.updown != "none":
            with span("resample"):
                if self.layer.updown == "up":
                    hh, x = nearest_upsample_2x(hh), nearest_upsample_2x(x)
                else:
                    hh, x = avg_pool_2x(hh), avg_pool_2x(x)
        hh = dense(self.in_layers[2], hh, padding=1)
        emb_out = dense(self.emb_layers[1], silu(emb)).to(hh.dtype)
        if self.layer.scale_shift:
            scale, shift = emb_out.chunk(2, dim=-1)
            hh = _gn_silu(self.out_layers[0], hh, film=(scale, shift))
        else:  # additive time embedding (reference: unet.py:253-255)
            hh = _gn_silu(self.out_layers[0], hh + emb_out[:, None, None, :])
        if keep is not None:  # the reference's nn.Dropout at out_layers[2]
            hh = torch.where(keep, hh / torch.tensor(1.0 - p, dtype=hh.dtype), 0.0)
        hh, b = dense_product(self.out_layers[3], hh, padding=1)
        xb = None
        if self.layer.in_ch != self.layer.out_ch:
            x, xb = dense_product(self.skip_connection, x)
        return add_bias_residual(hh, b, x, xb)  # x [+ skip bias] + (hh + b), one epilogue


class AttentionBlock(nn.Module):
    """Self-attention block with residual (reference: unet.py:259-305).
    Its GroupNorm is the plain one, not fused, as in the JAX package."""

    def __init__(self, layer: Layer):
        super().__init__()
        self.heads = layer.heads
        ch = layer.in_ch
        self.norm = GroupNorm32(ch)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, h: torch.Tensor, emb: torch.Tensor = None) -> torch.Tensor:
        n, hh, ww, c = h.shape
        with span("group_norm"):
            normed = self.norm(h).reshape(n, hh * ww, c)
        att = qkv_attention(dense(self.qkv, normed), self.heads)
        out, b = dense_product(self.proj_out, att)
        return add_bias_residual(out.reshape(n, hh, ww, c), b, h)  # h + (out + b), one epilogue


class Downsample(nn.Module):
    def __init__(self, layer: Layer):
        super().__init__()
        if layer.use_conv:
            self.op = nn.Conv2d(layer.in_ch, layer.out_ch, 3, stride=2, padding=1)

    def forward(self, h, emb=None):
        if not hasattr(self, "op"):
            with span("resample"):
                return avg_pool_2x(h)
        return dense(self.op, h, stride=2, padding=1)


class Upsample(nn.Module):
    def __init__(self, layer: Layer):
        super().__init__()
        if layer.use_conv:
            self.conv = nn.Conv2d(layer.in_ch, layer.out_ch, 3, padding=1)

    def forward(self, h, emb=None):
        with span("resample"):
            h = nearest_upsample_2x(h)
        if not hasattr(self, "conv"):
            return h
        return dense(self.conv, h, padding=1)


class InputConv(nn.Conv2d):
    def forward(self, h, emb=None):
        return dense(self, h, padding=1)


def _make_layer(layer: Layer, emb_ch: int) -> nn.Module:
    if layer.kind == "conv":
        return InputConv(layer.in_ch, layer.out_ch, 3, padding=1)
    if layer.kind == "res":
        return ResBlock(layer, emb_ch)
    if layer.kind == "attn":
        return AttentionBlock(layer)
    if layer.kind == "downsample":
        return Downsample(layer)
    if layer.kind == "upsample":
        return Upsample(layer)
    raise ValueError(layer.kind)


class UNetModel(nn.Module):
    """The ADM UNet. ``forward(x [N,H,W,C_in], timesteps [N], feat_layer)``
    returns ``(out [N,H,W,C_out] in x.dtype, feat or None)``; ``timesteps``
    are *original-chain* steps (reference: respace.py:122-127)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        self.layout = build_layout(cfg)
        mc = cfg.model_channels
        emb_ch = 4 * mc
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(), nn.Linear(emb_ch, emb_ch))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, emb_ch)

        def blocks(layout_blocks):
            return nn.ModuleList(
                nn.ModuleList(_make_layer(l, emb_ch) for l in block) for block in layout_blocks
            )

        self.input_blocks = blocks(self.layout.input_blocks)
        self.middle_block = nn.ModuleList(_make_layer(l, emb_ch) for l in self.layout.middle_block)
        self.output_blocks = blocks(self.layout.output_blocks)
        ch = self.layout.out_ch_final
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), nn.Conv2d(ch, cfg.out_channels, 3, padding=1))
        self._signatures = set()  # of the forwards called so far (first_call)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        feat_layer: int = -1,
        y: Optional[torch.Tensor] = None,
        remat: bool = False,
        train: bool = False,
        dropout_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``train``: apply the config's dropout with ``dropout_masks``, one
        per site in ``dropout_sites`` order (``draw_dropout_masks``).

        The call is the ``unet`` span. The first call of each signature
        (input shape, dtype and device, ``feat_layer``, ``remat``, grad
        mode) also runs inside a ``first_call`` span, which waits for the
        device at its end: cuDNN searches its algorithms there."""
        key = (tuple(x.shape), x.dtype, x.device, feat_layer, remat, torch.is_grad_enabled())
        first = key not in self._signatures
        if first:
            self._signatures.add(key)
        with span("unet"), (first_call(x.device) if first else contextlib.nullcontext()):
            return self._forward(x, timesteps, feat_layer, y, remat, train, dropout_masks)

    def _forward(self, x, timesteps, feat_layer, y, remat, train, dropout_masks):
        cfg = self.config
        if feat_layer >= len(self.output_blocks):
            raise ValueError(
                f"feat_layer {feat_layer} out of range "
                f"(model has {len(self.output_blocks)} output blocks)"
            )
        with span("embed"):
            emb = timestep_embedding(timesteps, cfg.model_channels)
            emb = dense(self.time_embed[2], silu(dense(self.time_embed[0], emb)))
            if cfg.num_classes is not None:
                assert y is not None, "class-conditional model requires y"
                emb = emb + embed(self.label_emb, y)

        p = cfg.dropout if train else 0.0
        if p > 0.0 and dropout_masks is None:
            raise ValueError("train=True with dropout needs dropout_masks (draw_dropout_masks)")
        n_sites = sum(len(b) for b in self.input_blocks) + len(self.middle_block)
        n_sites += sum(len(b) for b in self.output_blocks)
        if p > 0.0 and len(dropout_masks) != n_sites:
            raise ValueError(f"{len(dropout_masks)} dropout masks for {n_sites} sites")
        sites = iter(dropout_masks if p > 0.0 else [None] * n_sites)

        def run(block, h, emb, skip, keeps):
            if skip is not None:
                with span("concat"):
                    h = torch.cat([h, skip], dim=-1)
            for mod, keep in zip(block, keeps):
                h = mod(h, emb) if keep is None else mod(h, emb, keep, p)
            return h

        def run_block(block, h, skip=None):
            # the masks are inputs of the checkpointed block, so that a
            # recompute under remat applies the same ones
            keeps = [next(sites) for _ in block]
            if remat and torch.is_grad_enabled():
                return checkpoint(run, block, h, emb, skip, keeps, use_reentrant=False)
            return run(block, h, emb, skip, keeps)

        with span("act_cast"):
            h = x.to(cfg.torch_compute_dtype)
        hs = []
        for block in self.input_blocks:
            h = run_block(block, h)
            hs.append(h)
        h = run_block(self.middle_block, h)
        feat = None
        for i, block in enumerate(self.output_blocks):
            h = run_block(block, h, hs.pop())
            if i == feat_layer:
                with span("act_cast"):
                    feat = h.float()

        with span("act_cast"):
            h = h.to(x.dtype)
        h = _gn_silu(self.out[0], h)
        out = dense(self.out[2], h, padding=1)
        return out.to(x.dtype), feat


# ---------------------------------------------------------------------------
# Initialization (fan-in uniform as the JAX package; zero modules zeroed)
# ---------------------------------------------------------------------------

_ZERO_SUFFIXES = (".out_layers.3", ".proj_out")


@torch.no_grad()
def init_unet_(model: UNetModel, generator: torch.Generator) -> UNetModel:
    """Re-initialize every parameter in place from ``generator``, drawn on
    the generator's device and copied in (a model on the CPU takes a CUDA
    generator's weights), with the JAX package's distributions:
    weights U(+-sqrt(3/fan_in)), biases U(+-1/sqrt(fan_in)), GroupNorm ones
    and zeros, and the ADM zero modules (each ResBlock's last conv, each
    attention projection, the output conv) zeroed."""

    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator, device=generator.device) * 2 - 1) * bound)

    for name, mod in model.named_modules():
        if isinstance(mod, GroupNorm32):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Conv1d, nn.Linear)):
            if name.endswith(_ZERO_SUFFIXES) or name == "out.2":
                mod.weight.zero_()
                mod.bias.zero_()
                continue
            fan_in = mod.weight[0].numel()
            uniform_(mod.weight, math.sqrt(3.0 / fan_in))
            uniform_(mod.bias, 1.0 / math.sqrt(fan_in))
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator, device=generator.device))
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
