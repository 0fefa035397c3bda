"""``generate``: one client sends batches of ``batch`` latents, each from
its own x_T, through ``parallel/sampling.py::sample_batches`` on
``DragEngine.model_fn()`` (the path of ``cli.generate``); a batch ends when
its latents are on the host.

The check: each picked sample's DDIM trajectory from its x_T, by the plain
reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from port_bench import cells, faults, flops
from port_bench.reference import diffusion as D
from port_bench.trace import span
from port_bench.traffic import sub_seed


class Cell(cells.Cell):
    outer_span = "sample_batches"

    @property
    def rows_per_request(self) -> int:
        return self.p["batch"]

    def _respacing(self, steps: int) -> str:
        return f"{self.p['sampler']}{steps}" if self.p["sampler"] == "ddim" else str(steps)

    def setup(self):
        from port_bench import system

        self.make_weights()
        self.config = system.pipeline_config(self.cfg, self._respacing(self.p["steps"]))
        self.engine = system.engine(self.config, self.weights, self.device)
        self.phase("engine")
        tr = self.p["trace"]
        self.mf = self._traced(self.engine.model_fn(feat=False), tr["skip_calls"], tr["calls"])
        # warm-up: every shape of a request (the batch's x_T, two UNet calls
        # and DDIM updates, the copy to the host) on a two-step chain
        self._sample(system.schedule(self.config, self._respacing(2), self.device), sub_seed(self.seed, "warm-up"))
        self.phase("warm-up")

    def _sample(self, sched, seed: int) -> np.ndarray:
        from port_bench import system

        with span("sample_batches"):
            return system.sample_batches(
                sched, self.mf, num_samples=self.p["batch"], batch_size=self.p["batch"],
                latent_shape=self.config.latent_shape, device=self.device, seed=seed,
                sampler=self.p["sampler"], clip_denoised=self.config.diffusion.clip_denoised)

    def request(self, i: int):
        req = self.traffic.request(i)
        self.outputs[i] = self._sample(self.engine.sched, req.seed)
        if self.capture is not None and self.capture.state == "on" and i == 0:
            self.capture.stop()  # a stretch longer than the request ends with it

    def end_to_end(self, n: int, window_s: float) -> Dict[str, float]:
        return {"gen_samples_per_s": n * self.p["batch"] / window_s}

    def per_layer_context(self, trace) -> dict:
        trace.calls = trace.steps = self.p["trace"]["calls"]
        return {"kind": "generate", "flops_per_call": flops.forward_flops(self.arch, self.p["batch"]),
                "unit_calls": flops.forward_calls(self.arch, self.p["batch"])}

    def free(self):
        super().free()
        self.engine = self.mf = None

    def reference(self, chosen, quant=None) -> Dict[str, torch.Tensor]:
        """{"edited": [K, C, H, W]}: the picked samples by DDIM from their x_T."""
        if self.p["sampler"] != "ddim":
            raise ValueError("the reference covers the DDIM sampler")
        dev, shape = self.device, (self.p["batch"],) + self.latent_shape
        xs = torch.stack([cells.x_T(self.traffic.request(r).seed, shape, dev)[row] for r, row in chosen])
        sched = D.respaced(self.cfg["diffusion_steps"], self._respacing(self.p["steps"]), dev)
        net = self.reference_net(quant)
        with torch.no_grad():
            return {"edited": D.ddim_sample(sched, lambda x, t: net(x, t), cells.nchw(xs))}


def _unchanged_step(mp):
    """Each DDIM step returns its input."""
    import ishapediting_tpu_torch.core.diffusion as d

    real = d.ddim_sample

    def stuck(sched, model_fn, x, t, *a, **k):
        return dict(real(sched, model_fn, x, t, *a, **k), sample=x.float())

    mp.setattr(d, "ddim_sample", stuck)


def _altered_answer(mp):
    """One channel of every sample zeroed where the entry returns it."""
    from port_bench import system

    real = system.sample_batches

    def altered(*a, **k):
        out = real(*a, **k).copy()
        out[..., 0] = 0.0
        return out

    mp.setattr(system, "sample_batches", altered)


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": faults.half_batch,
          "altered_answer": _altered_answer}
