"""``edit``: set-up samples ``shapes`` latents, inverts them with
``edit/batch.py::invert_batched`` and keeps their records; one client then
sends edit requests, each one ``drag_edit_batched`` of every shape with its
own handles, as ``cli.batch_edit --edit_steps`` runs it; a request ends when
the edited latents are on the host.

The check: each picked shape's latent by DDIM from its x_T, the inversion's
forward chain with the program's noise draws, the feature cache at the fast
window's positions, then the guided drag steps with the request's handles
and step noise, by the plain reference. ``rel_err`` as for every kind, and
``guide_err`` = the largest ||program - reference|| / ||reference -
unguided||, where ``unguided`` is the same walk without the guidance term,
so a drag whose gradient is lost reads about 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from port_bench import cells, faults, flops
from port_bench.reference import diffusion as D
from port_bench.reference import drag as R
from port_bench.trace import quantile, span
from port_bench.traffic import sub_seed


class Cell(cells.Cell):
    outer_span = "drag_edit_batched"

    @property
    def rows_per_request(self) -> int:
        return self.p["shapes"]

    def setup(self):
        from ishapediting_tpu_torch.config import EditConfig

        from port_bench import system

        p = self.p
        self.make_weights()
        self.config = dataclasses.replace(
            system.pipeline_config(self.cfg, str(p["chain_steps"])),
            edit=EditConfig(w_time=p["w_time"], feat_layer=p["feat_layer"], grad_scale=p["grad_scale"],
                            mask_weight=p["mask_weight"], r1=p["r1"], shape_resolution=p["shape_resolution"],
                            feat_store_dtype=self.cfg["feat_store_dtype"], edit_steps=p["edit_steps"]))
        self.engine = e = system.engine(self.config, self.weights, self.device)
        self.phase("engine")
        n = p["shapes"]
        # cli.batch_edit's choice: remat when more than 8 shapes share a device
        self.remat = n > 8 if p["remat"] == "auto" else p["remat"] == "on"
        mf_plain = e.model_fn(feat=False, remat=self.remat)
        latent_sched = system.schedule(self.config, f"{p['latent_sampler']}{p['latent_steps']}", self.device)
        with span("setup_latents"):
            lat = system.sample_batches(
                latent_sched, mf_plain, num_samples=n, batch_size=n,
                latent_shape=self.config.latent_shape, device=self.device,
                seed=sub_seed(self.seed, "latents"), sampler=p["latent_sampler"],
                clip_denoised=self.config.diffusion.clip_denoised)
        latents = torch.as_tensor(lat, device=self.device)
        self.phase("latents")
        feat_dtype = getattr(torch, self.cfg["feat_store_dtype"])
        mf_feat = e.model_fn(feat=True, remat=self.remat)
        g = p["inversion_group"]
        ws, feats = [], []
        with span("setup_inversion"):
            for k in range(0, n, g):
                gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "inversion", k // g))
                rec = system.invert_batched(
                    e.sched, mf_feat, latents[k:k + g], gen, w_time=p["w_time"],
                    clip_denoised=self.config.diffusion.clip_denoised, chunk=p["inversion_chunk"],
                    feat_dtype=feat_dtype)
                ws.append(rec["w"])
                feats.append(rec["features"])
                del rec
        self.w = torch.cat(ws)
        self.features = torch.cat(feats)
        del ws, feats, latents
        self.phase("inversion")
        self.fast_sched, self.positions = e._fast_edit_schedule(p["edit_steps"])
        self.step_events: List = []  # an event at the start of each step
        self.requests_events: List = []  # per request: (start, its step events, end)
        tr = p["trace"]
        self.mf = self._traced(mf_feat, tr["skip_steps"], tr["steps"], on_call=self._step_event)
        # warm-up: a drag request on a two-step window (every shape of a
        # step: the forward with its tap, the losses, the backward under
        # remat, the update), then the copy to the host
        warm_sched, warm_pos = e._fast_edit_schedule(2)
        self._drag(self.traffic.request(-1), warm_sched, warm_pos)
        self.phase("warm-up")
        self.step_events = []

    def _step_event(self):
        ev = cells.event(self.device)
        ev.record()
        self.step_events.append(ev)

    def generators(self, req) -> List[torch.Generator]:
        return [torch.Generator(device=self.device).manual_seed(sub_seed(req.seed, "shape", s))
                for s in range(self.p["shapes"])]

    def _drag(self, req, sched, positions):
        """One drag request; (edited latents on the host, an event recorded
        after its last step)."""
        from port_bench import system

        p = self.p
        with span("host_setup"):
            problems = system.build_batched_problems(
                list(req.sources), list(req.targets), r1=p["r1"], voxel_size=self.config.edit.voxel_size,
                feat_width=self.features.shape[-2], device=self.device)
            gens = self.generators(req)
        with span("drag_edit_batched"):
            out = system.drag_edit_batched(
                sched, self.mf, self.w, self.features, problems, gens, w_time=p["w_time"],
                scale=p["grad_scale"], cof=p["mask_weight"],
                clip_denoised=self.config.diffusion.clip_denoised, noise_mode=p["noise_mode"],
                edit_positions=positions)
        end = cells.event(self.device)
        end.record()
        with span("to_host"):
            host = out.cpu().numpy()
        return host, end

    def request(self, i: int):
        start = cells.event(self.device)
        start.record()
        first = len(self.step_events)
        self.outputs[i], end = self._drag(self.traffic.request(i), self.fast_sched, self.positions)
        self.requests_events.append((start, self.step_events[first:], end))
        if self.capture is not None and self.capture.state == "on" and i == 0:
            self.capture.stop()

    def step_intervals_ms(self) -> List[float]:
        """Each guided step's interval on the device timeline: from its
        start to the next step's; the first step of a request from the
        request's start (its host set-up included), the last to the
        request's end."""
        out = []
        for start, steps, end in self.requests_events:
            marks = [start] + steps[1:] + [end]
            out += [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return out

    def end_to_end(self, n: int, window_s: float) -> Dict[str, float]:
        steps = n * self.p["edit_steps"]
        return {"edit_step_ms": window_s * 1e3 / steps,
                "edit_step_p95_ms": quantile(self.step_intervals_ms(), 0.95)}

    def per_layer_context(self, trace) -> dict:
        trace.calls = trace.steps = self.p["trace"]["steps"]
        n, fl = self.p["shapes"], self.p["feat_layer"]
        return {"kind": "edit", "flops_per_call": flops.edit_step_flops(self.arch, n, fl),
                "unit_calls": flops.edit_step_calls(self.arch, n, fl)}

    def free(self):
        super().free()
        self.engine = self.mf = self.w = self.features = None

    def reference(self, chosen, quant=None) -> Dict[str, torch.Tensor]:
        """{"edited", "unguided"}: [K, C, H, W] for the picked (request, shape)s."""
        p, dev, cfg = self.p, self.device, self.cfg
        n, g, w_time = p["shapes"], p["inversion_group"], p["w_time"]
        lat_shape = self.latent_shape
        net = self.reference_net(quant)
        shapes = [s for _, s in chosen]
        # the latents: set-up's DDIM batch of all shapes, from one x_T draw
        xT = cells.x_T(sub_seed(self.seed, "latents"), (n,) + lat_shape, dev)[shapes]
        lsched = D.respaced(cfg["diffusion_steps"], f"ddim{p['latent_steps']}", dev)
        with torch.no_grad():
            x0 = D.ddim_sample(lsched, lambda x, t: net(x, t), cells.nchw(xT))
        # the inversion's noise: each group's generator, one [g, ...] draw per step
        chain = D.respaced(cfg["diffusion_steps"], str(p["chain_steps"]), dev)
        draws = {}
        for k in sorted({s // g for s in shapes}):
            gen = torch.Generator(device=dev).manual_seed(sub_seed(self.seed, "inversion", k))
            draws[k] = [torch.randn((g,) + lat_shape, generator=gen, device=dev) for _ in range(w_time)]

        def noise(t):
            return torch.stack([cells.nchw(draws[s // g][t][s % g: s % g + 1])[0] for s in shapes])

        xs = D.inversion_chain(chain, x0, noise, w_time)
        fast, positions = D.fast_edit(chain, cfg["diffusion_steps"], w_time, p["edit_steps"], dev)
        order = positions[::-1]  # chain position of drag step j
        tap = p["feat_layer"]
        with torch.no_grad():
            origin = []
            for t in order:
                _, feat = net(xs[int(t) + 1], chain.tmap[int(t)].expand(len(shapes)), tap)
                origin.append(R.plane_features(feat))
        handles, gens = [], []
        for r, s in chosen:
            req = self.traffic.request(r)
            handles.append(R.Handles(req.sources[s], req.targets[s], p["r1"], 2.0 / p["shape_resolution"],
                                     origin[0].shape[-1], dev))
            gens.append(torch.Generator(device=dev).manual_seed(sub_seed(req.seed, "shape", s)))
        model = lambda x, t: net(x, t, tap)  # noqa: E731
        x = u = xs[w_time]
        for j in range(len(order)):
            t = len(order) - 1 - j
            z = torch.cat([cells.nchw(torch.randn((1,) + lat_shape, generator=gg, device=dev)) for gg in gens])

            def loss_fn(feat, j=j):
                planes = R.plane_features(feat)
                total = 0.0
                for i, h in enumerate(handles):
                    motion, mask = R.losses(planes[i], origin[j][i], h)
                    total = total - motion - p["mask_weight"] * mask
                return total

            x = D.guided_step(fast, model, x, t, z, loss_fn, p["grad_scale"])["next"]
            with torch.no_grad():
                mean, var, _, _ = D.p_mean_variance(fast, model, u, t)
                u = mean + (1.0 if t != 0 else 0.0) * torch.sqrt(var) * z
        return {"edited": x.detach(), "unguided": u}

    def numbers(self, got, ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
        out = super().numbers(got, ref)
        out["guide_err"] = max(float((a - b).norm() / (b - c).norm())
                               for a, b, c in zip(got, ref["edited"], ref["unguided"]))
        return out


def _unchanged_step(mp):
    """Each guided step returns its input."""
    import ishapediting_tpu_torch.edit.batch as b

    real = b.p_sample_guidance

    def stuck(sched, model_fn, x, t, *a, **k):
        out = real(sched, model_fn, x, t, *a, **k)
        return dict(out, sample=x.detach(), variance=torch.zeros_like(out["variance"]))

    mp.setattr(b, "p_sample_guidance", stuck)


def _altered_answer(mp):
    """One channel of every edited latent zeroed where the entry returns it."""
    from port_bench import system

    real = system.drag_edit_batched

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[..., 0] = 0.0
        return out

    mp.setattr(system, "drag_edit_batched", altered)


def _lost_gradient(mp):
    """The drag's gradient never reaches the update (guidance scale 0)."""
    from port_bench import system

    real = system.drag_edit_batched
    mp.setattr(system, "drag_edit_batched", lambda *a, **k: real(*a, **dict(k, scale=0.0)))


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": faults.half_batch,
          "altered_answer": _altered_answer, "lost_gradient": _lost_gradient}
