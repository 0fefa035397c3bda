"""The plain ADM UNet (openai/guided-diffusion ``unet.py``, as NFD and
iShapEditing use it), in fp32 PyTorch over NCHW tensors, with the feature
tap after one output block.

Written from the published description and kept independent of the code it
judges: it imports nothing of the program. Weights are a state dict under
the reference's own names ("input_blocks.3.0.in_layers.2.weight", ...).

``quant`` (the control): a function applied to both operands of every
convolution, dense layer and attention product, to compute them in a lower
precision than fp32 (``fp8_quant``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Arch:
    """The architecture keys of a configuration file."""

    image_size: int
    in_channels: int
    model_channels: int
    out_channels: int
    num_res_blocks: int
    attention_resolutions: Tuple[int, ...]
    channel_mult: Tuple[float, ...]
    num_heads: int
    num_head_channels: int
    num_heads_upsample: int
    use_scale_shift_norm: bool
    resblock_updown: bool

    @staticmethod
    def from_config(cfg: dict) -> "Arch":
        return Arch(
            image_size=int(cfg["image_size"]),
            in_channels=int(cfg["in_channels"]),
            model_channels=int(cfg["num_channels"]),
            out_channels=int(cfg["in_channels"]) * (2 if cfg["learn_sigma"] else 1),
            num_res_blocks=int(cfg["num_res_blocks"]),
            attention_resolutions=tuple(int(r) for r in str(cfg["attention_resolutions"]).split(",")),
            channel_mult=tuple(cfg["channel_mult"]),
            num_heads=int(cfg["num_heads"]),
            num_head_channels=int(cfg["num_head_channels"]),
            num_heads_upsample=int(cfg["num_heads_upsample"]),
            use_scale_shift_norm=bool(cfg["use_scale_shift_norm"]),
            resblock_updown=bool(cfg["resblock_updown"]),
        )


@dataclasses.dataclass(frozen=True)
class Layer:
    """One module of a block: 'conv' (the input conv), 'res', 'attn'."""

    kind: str
    name: str  # state-dict prefix, e.g. "input_blocks.4.1"
    cin: int
    cout: int
    size: int  # spatial size of the layer's input
    updown: str = "none"  # 'res': 'none' | 'up' | 'down'
    heads: int = 0


@dataclasses.dataclass(frozen=True)
class Layout:
    input_blocks: Tuple[Tuple[Layer, ...], ...]
    middle: Tuple[Layer, ...]
    output_blocks: Tuple[Tuple[Layer, ...], ...]
    out_ch: int
    emb_ch: int


def _heads(a: Arch, ch: int, up: bool) -> int:
    if a.num_head_channels == -1:
        return a.num_heads_upsample if up and a.num_heads_upsample != -1 else a.num_heads
    return ch // a.num_head_channels


def layout(a: Arch) -> Layout:
    """The constructor of guided-diffusion's UNetModel, with resblock_updown
    (up and down inside ResBlocks) as NFD configures it."""
    if not a.resblock_updown:
        raise ValueError("the reference covers resblock_updown=True (NFD's setting)")
    mc, size = a.model_channels, a.image_size
    attn_ds = {a.image_size // r for r in a.attention_resolutions}
    ch = int(a.channel_mult[0] * mc)
    inp: List[Tuple[Layer, ...]] = [(Layer("conv", "input_blocks.0.0", a.in_channels, ch, size),)]
    chans, ds = [ch], 1
    for level, mult in enumerate(a.channel_mult):
        for _ in range(a.num_res_blocks):
            i = len(inp)
            block = [Layer("res", f"input_blocks.{i}.0", ch, int(mult * mc), size)]
            ch = int(mult * mc)
            if ds in attn_ds:
                block.append(Layer("attn", f"input_blocks.{i}.1", ch, ch, size, heads=_heads(a, ch, False)))
            inp.append(tuple(block))
            chans.append(ch)
        if level != len(a.channel_mult) - 1:
            inp.append((Layer("res", f"input_blocks.{len(inp)}.0", ch, ch, size, updown="down"),))
            chans.append(ch)
            ds, size = ds * 2, size // 2
    mid = (Layer("res", "middle_block.0", ch, ch, size),
           Layer("attn", "middle_block.1", ch, ch, size, heads=_heads(a, ch, False)),
           Layer("res", "middle_block.2", ch, ch, size))
    out: List[Tuple[Layer, ...]] = []
    for level, mult in list(enumerate(a.channel_mult))[::-1]:
        for i in range(a.num_res_blocks + 1):
            b = len(out)
            ich = chans.pop()
            block = [Layer("res", f"output_blocks.{b}.0", ch + ich, int(mc * mult), size)]
            ch = int(mc * mult)
            if ds in attn_ds:
                block.append(Layer("attn", f"output_blocks.{b}.1", ch, ch, size, heads=_heads(a, ch, True)))
            if level and i == a.num_res_blocks:
                block.append(Layer("res", f"output_blocks.{b}.{len(block)}", ch, ch, size, updown="up"))
                ds, size = ds // 2, size * 2
            out.append(tuple(block))
    return Layout(tuple(inp), mid, tuple(out), ch, 4 * mc)


def param_shapes(a: Arch) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the reference's state-dict
    layout (convs OIHW, the attention's 1x1 convs (O, I, 1))."""
    lay = layout(a)
    mc, emb = a.model_channels, lay.emb_ch
    shapes: Dict[str, Tuple[int, ...]] = {
        "time_embed.0.weight": (emb, mc), "time_embed.0.bias": (emb,),
        "time_embed.2.weight": (emb, emb), "time_embed.2.bias": (emb,),
    }

    def conv(name, cin, cout, k):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)

    def norm(name, c):
        shapes[f"{name}.weight"] = (c,)
        shapes[f"{name}.bias"] = (c,)

    for l in _all_layers(lay):
        if l.kind == "conv":
            conv(l.name, l.cin, l.cout, 3)
        elif l.kind == "res":
            norm(f"{l.name}.in_layers.0", l.cin)
            conv(f"{l.name}.in_layers.2", l.cin, l.cout, 3)
            e = 2 * l.cout if a.use_scale_shift_norm else l.cout
            shapes[f"{l.name}.emb_layers.1.weight"] = (e, emb)
            shapes[f"{l.name}.emb_layers.1.bias"] = (e,)
            norm(f"{l.name}.out_layers.0", l.cout)
            conv(f"{l.name}.out_layers.3", l.cout, l.cout, 3)
            if l.cin != l.cout:
                conv(f"{l.name}.skip_connection", l.cin, l.cout, 1)
        else:
            norm(f"{l.name}.norm", l.cin)
            shapes[f"{l.name}.qkv.weight"] = (3 * l.cin, l.cin, 1)
            shapes[f"{l.name}.qkv.bias"] = (3 * l.cin,)
            shapes[f"{l.name}.proj_out.weight"] = (l.cin, l.cin, 1)
            shapes[f"{l.name}.proj_out.bias"] = (l.cin,)
    norm("out.0", lay.out_ch)
    conv("out.2", lay.out_ch, a.out_channels, 3)
    return shapes


def _all_layers(lay: Layout) -> List[Layer]:
    return ([l for b in lay.input_blocks for l in b] + list(lay.middle)
            + [l for b in lay.output_blocks for l in b])


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (amax to 448,
    as fp8 inference scales it), returned in fp32."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = 448.0 / amax
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class UNet:
    """``UNet(arch, params, quant)(x [N,C,H,W], t [N], feat_layer)`` ->
    (out [N,C_out,H,W], the activation after ``output_blocks[feat_layer]``
    [N,C,h,w] or None). fp32 throughout (TF32 must be off: ``fp32_strict``)."""

    def __init__(self, arch: Arch, params: Params, quant: Quant = None):
        self.a, self.p, self.lay = arch, params, layout(arch)
        self.q = quant or (lambda t: t)

    def _w(self, name: str) -> torch.Tensor:
        return self.p[name].float()

    def conv(self, name, x, stride=1, padding=1):
        return F.conv2d(self.q(x), self.q(self._w(f"{name}.weight")), self._w(f"{name}.bias"),
                        stride=stride, padding=padding)

    def linear(self, name, x):
        return F.linear(self.q(x), self.q(self._w(f"{name}.weight")), self._w(f"{name}.bias"))

    def norm(self, name, x):
        return F.group_norm(x.float(), 32, self._w(f"{name}.weight"), self._w(f"{name}.bias"), 1e-5)

    def res(self, l: Layer, x, emb):
        h = F.silu(self.norm(f"{l.name}.in_layers.0", x))
        if l.updown == "up":
            h, x = F.interpolate(h, scale_factor=2, mode="nearest"), F.interpolate(x, scale_factor=2, mode="nearest")
        elif l.updown == "down":
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.conv(f"{l.name}.in_layers.2", h)
        e = self.linear(f"{l.name}.emb_layers.1", F.silu(emb))[:, :, None, None]
        if self.a.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = self.norm(f"{l.name}.out_layers.0", h) * (1 + scale) + shift
        else:
            h = self.norm(f"{l.name}.out_layers.0", h + e)
        h = self.conv(f"{l.name}.out_layers.3", F.silu(h))
        if l.cin != l.cout:
            x = self.conv(f"{l.name}.skip_connection", x, padding=0)
        return x + h

    def attn(self, l: Layer, x):
        n, c, hh, ww = x.shape
        t = hh * ww
        qkv = F.conv1d(self.q(self.norm(f"{l.name}.norm", x).reshape(n, c, t)),
                       self.q(self._w(f"{l.name}.qkv.weight")), self._w(f"{l.name}.qkv.bias"))
        ch = c // l.heads
        q, k, v = qkv.reshape(n * l.heads, 3 * ch, t).split(ch, dim=1)
        s = 1.0 / math.sqrt(math.sqrt(ch))
        w = torch.einsum("bct,bcs->bts", self.q(q * s), self.q(k * s)).softmax(dim=-1)
        a = torch.einsum("bts,bcs->bct", self.q(w), self.q(v)).reshape(n, c, t)
        h = F.conv1d(self.q(a), self.q(self._w(f"{l.name}.proj_out.weight")), self._w(f"{l.name}.proj_out.bias"))
        return x + h.reshape(n, c, hh, ww)

    def layer(self, l: Layer, x, emb):
        if l.kind == "conv":
            return self.conv(l.name, x)
        return self.res(l, x, emb) if l.kind == "res" else self.attn(l, x)

    def __call__(self, x: torch.Tensor, t: torch.Tensor, feat_layer: int = -1):
        emb = timestep_embedding(t, self.a.model_channels)
        emb = self.linear("time_embed.2", F.silu(self.linear("time_embed.0", emb)))
        h, hs, feat = x.float(), [], None
        for block in self.lay.input_blocks:
            for l in block:
                h = self.layer(l, h, emb)
            hs.append(h)
        for l in self.lay.middle:
            h = self.layer(l, h, emb)
        for i, block in enumerate(self.lay.output_blocks):
            h = torch.cat([h, hs.pop()], dim=1)
            for l in block:
                h = self.layer(l, h, emb)
            if i == feat_layer:
                feat = h
        out = self.conv("out.2", F.silu(self.norm("out.0", h)))
        return out, feat


def fp32_strict() -> None:
    """Full fp32 products on the card (no TF32), as the reference needs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
