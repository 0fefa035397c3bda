"""What every cell shares. A cell's kind (its traffic mix's ``kind``) is a
module ``kinds/<kind>.py`` found by name, whose ``Cell`` subclasses
``Cell`` here and gives:

- ``setup()``: weights, the program, the cell's records, a warm-up of every
  shape the window uses;
- ``request(i)``: one timed request, its answers kept in ``outputs[i]``;
- ``end_to_end(n, window_s)`` and ``per_layer_context(trace)``;
- ``reference(chosen, quant)``: the plain reference's answers of the picked
  (request, row)s, worked out again from the seed (``check.py``);
- ``free()``: drop the program's state before the check.

A kind module may also give ``FAULTS``: name -> ``plant(monkeypatch)``,
the faults of its timed path that the check has to catch
(``tests/test_port_bench_faults.py``, ``calibrate.py --fault``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from port_bench.reference.unet import Arch, UNet
from port_bench.trace import Capture, span
from port_bench.traffic import Traffic, sub_seed
from port_bench.weights import make_weights


class _HostEvent:
    """A stand-in for a CUDA event on the CPU (tests only)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, later) -> float:
        return (later.t - self.t) * 1e3


def event(device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def x_T(seed: int, shape, device) -> torch.Tensor:
    """x_T of a batch sampled by the port's ``sample_batches(seed=seed)``:
    one draw of the whole batch from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


class Cell:
    outer_span = "request"  # the span that holds a traced request
    rows_per_request = 1  # answers a request returns

    def __init__(self, config: dict, traffic: dict, seed: int, device, capture: Optional[Capture]):
        self.cfg, self.p, self.seed, self.device = config, traffic, seed, torch.device(device)
        self.arch = Arch.from_config(config)
        self.latent_shape = (config["image_size"], config["image_size"], config["in_channels"])
        self.traffic = Traffic(traffic, seed)
        self.capture = capture
        self.outputs: Dict[int, np.ndarray] = {}
        self.calls = 0  # UNet calls so far
        self.window_calls: Optional[int] = None  # self.calls when the window opened
        self.weights = None
        self.phases: Dict[str, float] = {}  # set-up seconds by phase
        self._t = time.perf_counter()

    def phase(self, name: str) -> None:
        """Close the set-up phase ``name`` (its device work included)."""
        sync(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now

    def weights_from_seed(self):
        return make_weights(self.arch, sub_seed(self.seed, "weights"), self.device)

    def make_weights(self):
        self.weights = self.weights_from_seed()
        self.phase("weights")

    def _traced(self, inner, first: int, count: int, on_call=None):
        """The model function the program gets: ``inner`` inside a
        ``bench:unet`` span, counting calls; a capture, if any, runs from
        the start of call ``first`` to the start of call ``first + count``
        of the window."""

        def fn(x, t):
            if self.capture is not None and self.window_calls is not None:
                k = self.calls - self.window_calls
                if k == first:
                    self.capture.start()
                elif k == first + count:
                    self.capture.stop()
            if on_call is not None:
                on_call()
            self.calls += 1
            with span("unet"):
                return inner(x, t)

        return fn

    def open_window(self):
        self.window_calls = self.calls

    def window(self, seconds: float, after=None) -> Tuple[int, float, List[float]]:
        """One closed-loop client: requests back to back until one ends
        ``seconds`` or more after the window opened, ``after()`` called
        after each; (requests, the window's length, each request's end)."""
        if self.p["loop"] != "closed" or self.p["clients"] != 1:
            raise ValueError(f"kind {self.p['kind']!r} drives one closed-loop client")
        self.open_window()
        start, n, marks = time.perf_counter(), 0, []
        while True:
            self.request(n)
            n += 1
            marks.append(time.perf_counter())
            if after is not None:
                after()
            if marks[-1] - start >= seconds:
                return n, marks[-1] - start, [m - start for m in marks]

    def free(self):
        self.weights = None

    # the check (check.py)

    def picks(self) -> List[Tuple[int, int]]:
        """(request, row) pairs to compare, drawn from the seed, spread
        over the rows of a request."""
        return self.traffic.check_picks(len(self.outputs), self.rows_per_request, self.p["check"]["rows"])

    def answers(self, chosen) -> List[torch.Tensor]:
        """The program's answers of the picks, [C, H, W] each."""
        shape = (1,) + self.latent_shape
        return [nchw(torch.as_tensor(self.outputs[r][row], device=self.device).reshape(shape))[0]
                for r, row in chosen]

    def reference_net(self, quant=None) -> UNet:
        """The plain UNet over weights made again from the seed (never the
        tensors the program was handed)."""
        return UNet(self.arch, self.weights_from_seed(), quant)

    def reference(self, chosen, quant=None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def numbers(self, got, ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """``rel_err``: the largest ||program - reference|| / ||reference||."""
        return {"rel_err": max(float((a - b).norm() / b.norm()) for a, b in zip(got, ref["edited"]))}
