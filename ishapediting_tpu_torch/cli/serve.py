"""JSON-lines edit server: the editing engine as a long-lived service that
keeps the weights on the card and cuDNN's timed algorithms warm across
requests.

    request:  one JSON object per line on stdin
    response: one JSON object per line on stdout, ``{"ok": true/false, ...}``
    events:   long commands stream ``{"event": ...}`` lines before their
              response

Commands (``EditServer.handle``): ping, init_random, load_model, status,
quit, sample, fit, morph, generate, drag, stop, reset, clear, save_mesh,
render, edit_log, metrics. A ``{"cmd": "stop"}`` line sent while a drag runs
is read between progress events (the engine's cooperative ``train_flag``,
as the reference GUI's Stop button, main.py:483-486): the remaining steps
run unguided. ``init_random`` and ``load_model`` build the engine on the
server's device (``--device``, CUDA by default); ``init_random`` also takes
``w_time``, ``feat_layer`` and ``shape_resolution`` to cut a preset.

Usage::

    python -m ishapediting_tpu_torch.cli.serve [--device cpu]
    echo '{"cmd": "ping"}' | python -m ishapediting_tpu_torch.cli.serve
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import select
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np


class EditServer:
    """Protocol handler; dict -> dict, so it is testable without IO. Every
    exception becomes an ``{"ok": false}`` response: a bad request must not
    end the server."""

    def __init__(self, device: Optional[str] = None):
        self.device = device
        self.engine = None
        self.last_drag: Optional[Dict] = None
        self.edit_count = 0

    def handle(self, req: Dict, emit: Optional[Callable[[Dict], None]] = None) -> Dict:
        """Run one request and return its response; ``emit`` receives the
        intermediate events (progress) of streaming transports."""
        cmd = req.get("cmd")
        try:
            fn = getattr(self, f"_cmd_{cmd}", None)
            if cmd is None or cmd.startswith("_") or fn is None:
                return {"ok": False, "cmd": cmd, "error": f"unknown cmd: {cmd!r}"}
            out = fn(req, emit or (lambda e: None))
            out.setdefault("ok", True)
            out.setdefault("cmd", cmd)
            return out
        except Exception as e:  # noqa: BLE001 - protocol errors must not kill the server
            return {"ok": False, "cmd": cmd, "error": f"{type(e).__name__}: {e}"}

    def _require_engine(self):
        if self.engine is None:
            raise RuntimeError("no engine: send init_random or load_model first")
        return self.engine

    def _require_mesh(self):
        eng = self._require_engine()
        if eng.mesh is None:
            raise RuntimeError("no mesh: send sample or fit first")
        return eng

    @staticmethod
    def _preset(req):
        from ishapediting_tpu_torch.config import preset

        return preset(req.get("preset", "tiny"), num_steps=int(req.get("num_steps", 200)),
                      use_ddim=bool(req.get("use_ddim", False)))

    # -- lifecycle ------------------------------------------------------

    def _cmd_ping(self, req, emit):
        return {"pong": True}

    def _cmd_init_random(self, req, emit):
        """Random-weight engine (serving without checkpoints)."""
        from ishapediting_tpu_torch.edit.engine import DragEngine

        cfg = self._preset(req)
        cut = {k: int(req[k]) for k in ("w_time", "feat_layer", "shape_resolution") if k in req}
        if cut:
            cfg = dataclasses.replace(cfg, edit=dataclasses.replace(cfg.edit, **cut))
        self.engine = DragEngine(cfg, seed=int(req.get("seed", 0)), device=self.device)
        return {"preset": req.get("preset", "tiny")}

    def _cmd_load_model(self, req, emit):
        from ishapediting_tpu_torch.edit.engine import DragEngine

        cfg = self._preset(req) if "preset" in req else None
        self.engine = DragEngine.from_model_dir(req["model_dir"], config=cfg, device=self.device)
        return {"model_dir": req["model_dir"]}

    def _cmd_status(self, req, emit):
        eng = self.engine
        if eng is None:
            return {"engine": None}
        return {
            "engine": {
                "has_latent": eng.w is not None,
                "has_mesh": eng.mesh is not None,
                "has_inversion": eng.variance_noise is not None,
                "respacing": eng.config.diffusion.timestep_respacing,
                "w_time": eng.config.edit.w_time,
                "image_size": eng.config.unet.image_size,
            }
        }

    def _cmd_quit(self, req, emit):
        return {"bye": True, "_quit": True}

    # -- shape creation ---------------------------------------------------

    def _cmd_sample(self, req, emit):
        eng = self._require_engine()
        eng.update_latent_params(seed=int(req.get("seed", 0)))
        return {"vertices": int(len(eng.mesh.vertices)), "triangles": int(len(eng.mesh.triangles))}

    def _cmd_fit(self, req, emit):
        eng = self._require_engine()
        fit_steps = req.get("fit_steps")
        eng.fit_real_shape(
            mesh_path=req.get("mesh_path"), tri_feat_path=req.get("tri_feat_path"),
            path=req.get("workdir", "."), seed=int(req.get("seed", 0)),
            fit_steps=None if fit_steps is None else int(fit_steps),
        )
        return {"vertices": int(len(eng.mesh.vertices)), "triangles": int(len(eng.mesh.triangles))}

    def _cmd_morph(self, req, emit):
        """{"cmd": "morph", "seed_a": 1, "seed_b": 2, "frames": 5,
        "out_dir": "morphs/"}: endpoints from seeds or normalized-latent
        ``.npy`` paths ("latent_a"/"latent_b"). With ``out_dir``, writes
        frame_kk.obj and latents.npy and streams a morph_frame event per
        frame."""
        eng = self._require_engine()

        def endpoint(which):
            path = req.get(f"latent_{which}")
            if path is not None:
                return np.load(path)
            return eng.sample_latent(seed=int(req.get(f"seed_{which}", 0)))

        frames = eng.morph(endpoint("a"), endpoint("b"), n=int(req.get("frames", 5)))
        out = {"frames": int(frames.shape[0])}
        out_dir = req.get("out_dir")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, "latents.npy"), frames)
            for k in range(frames.shape[0]):
                mesh = eng.get_mesh(frames[k][None], smooth=int(req.get("smooth", 10)))
                mesh.write(os.path.join(out_dir, f"frame_{k:02d}.obj"))
                emit({"event": "morph_frame", "frame": k, "vertices": int(len(mesh.vertices))})
            out["out_dir"] = out_dir
        return out

    def _cmd_generate(self, req, emit):
        """{"cmd": "generate", "num_samples": 4, "batch_size": 4, "sampler":
        "dpm", "num_steps": 16, "seed": 0, "out_dir": "gen/", "decode": true,
        "shape_resolution": 64, "smooth": 0}: batch generation
        (``cli.generate`` over the protocol). ``sampler`` is ddpm|ddim|dpm,
        ``num_steps`` respaces the base chain per request (dpm on the
        log-SNR grid). Streams a gen_batch event per batch and a gen_mesh
        event per mesh; ``out_dir`` gets triplanes/{i}.npy (NCHW, physical
        scale) and objects/{i}.obj."""
        from ishapediting_tpu_torch.core.schedule import make_schedule
        from ishapediting_tpu_torch.parallel.sampling import sample_batches

        eng = self._require_engine()
        sampler = req.get("sampler", "ddim")
        if sampler not in ("ddpm", "ddim", "dpm"):
            raise ValueError(f"unknown sampler {sampler!r}")
        n_total = int(req.get("num_samples", 4))
        if n_total < 1:
            raise ValueError("num_samples must be >= 1")
        bs = max(1, int(req.get("batch_size", min(4, n_total))))
        dcfg = eng.config.diffusion
        steps = req.get("num_steps")
        if steps is None and sampler == "dpm":
            steps = eng.sched.num_timesteps  # the engine's step count, on the dpm grid
        if steps is None:
            sched = eng.sched
        else:
            n = min(int(steps), dcfg.base_steps)
            resp = {"ddpm": str(n), "ddim": f"ddim{n}", "dpm": f"dpm{n}"}[sampler]
            sched = make_schedule(dcfg.base_steps, dcfg.noise_schedule, resp,
                                  rescale_timesteps=dcfg.rescale_timesteps).to(eng.device)

        t0 = time.perf_counter()
        samples = sample_batches(
            sched, eng.model_fn(feat=False), num_samples=n_total, batch_size=bs,
            latent_shape=eng.config.latent_shape, device=eng.device, seed=int(req.get("seed", 0)),
            sampler=sampler, clip_denoised=dcfg.clip_denoised,
            on_batch=lambda batch_idx, done: emit(
                {"event": "gen_batch", "batch": batch_idx, "done": done, "total": n_total}),
        )
        resp_out = {
            "num_samples": int(samples.shape[0]),
            "sampler": sampler,
            "realized_steps": int(sched.num_timesteps),
            "sample_s": round(time.perf_counter() - t0, 3),
        }
        out_dir = req.get("out_dir")
        if out_dir:
            phys = samples * np.asarray(eng.stats.half_range) + np.asarray(eng.stats.middle)
            os.makedirs(os.path.join(out_dir, "triplanes"), exist_ok=True)
            for i in range(phys.shape[0]):
                np.save(os.path.join(out_dir, "triplanes", f"{i}.npy"),
                        phys[i].transpose(2, 0, 1).astype(np.float32))
            resp_out["out_dir"] = out_dir
        if bool(req.get("decode", False)):
            t0 = time.perf_counter()
            res = req.get("shape_resolution")
            verts = []
            for i in range(samples.shape[0]):
                mesh = eng.get_mesh(samples[i][None], smooth=int(req.get("smooth", 0)),
                                    res=None if res is None else int(res))
                if out_dir:
                    os.makedirs(os.path.join(out_dir, "objects"), exist_ok=True)
                    mesh.write(os.path.join(out_dir, "objects", f"{i}.obj"))
                verts.append(int(len(mesh.vertices)))
                emit({"event": "gen_mesh", "index": i, "vertices": verts[-1]})
            resp_out["decode_s"] = round(time.perf_counter() - t0, 3)
            resp_out["vertices"] = verts
        return resp_out

    # -- editing -----------------------------------------------------------

    def _cmd_drag(self, req, emit):
        eng = self._require_mesh()
        sources = np.asarray(req["sources"], np.float64).reshape(-1, 3)
        targets = np.asarray(req["targets"], np.float64).reshape(-1, 3)
        if len(sources) != len(targets) or len(sources) == 0:
            raise ValueError("sources/targets must be equal-length, non-empty")
        scale = float(req.get("scale", eng.config.edit.grad_scale))
        cof = float(req.get("cof", eng.config.edit.mask_weight))
        edit_steps = req.get("edit_steps")  # fast editing (resample only)
        eng.train_flag = True
        mesh = eng.drag_edit(
            sources, targets, scale=scale, cof=cof, seed=int(req.get("seed", 0)),
            chunk=int(req.get("chunk", 10)), noise_mode=req.get("noise_mode", "resample"),
            edit_steps=None if edit_steps is None else int(edit_steps),
            progress_callback=lambda v: emit({"event": "progress", "value": float(v)}),
        )
        self.last_drag = {"sources": sources.tolist(), "targets": targets.tolist(),
                          "scale": scale, "cof": cof}
        resp = {
            "vertices": int(len(mesh.vertices)),
            "triangles": int(len(mesh.triangles)),
            "stopped_early": not eng.train_flag,
        }
        summary = eng.drag_loss_summary()
        if summary is not None:
            resp["motion_loss_first"] = summary["motion_first"]
            resp["motion_loss_last"] = summary["motion_last"]
        return resp

    def _cmd_stop(self, req, emit):
        self._require_engine().train_flag = False
        return {}

    def _cmd_reset(self, req, emit):
        self._require_engine().reset_params()
        return {}

    def _cmd_clear(self, req, emit):
        self._require_engine().clear_params()
        return {}

    # -- capture ------------------------------------------------------------

    def _which_mesh(self, req):
        eng = self._require_mesh()
        return eng.mesh0 if req.get("which") == "original" else eng.mesh

    @staticmethod
    def _parent(path):
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)

    def _cmd_save_mesh(self, req, emit):
        mesh = self._which_mesh(req)
        self._parent(req["path"])
        mesh.write(req["path"])
        return {"path": req["path"]}

    def _cmd_render(self, req, emit):
        from ishapediting_tpu_torch.geometry.render import render_mesh

        mesh = self._which_mesh(req)
        self._parent(req["path"])
        render_mesh(mesh, size=int(req.get("size", 512)), save_path=req["path"])
        return {"path": req["path"]}

    def _cmd_edit_log(self, req, emit):
        """EditLog provenance of the last drag (reference format,
        main.py:400-404)."""
        from ishapediting_tpu_torch.cli.edit import write_edit_log

        if self.last_drag is None:
            raise RuntimeError("no drag recorded yet")
        self.edit_count += 1
        edit_id = req.get("edit_id", f"{self.edit_count:02d}")
        d = self.last_drag
        write_edit_log(req["path"], edit_id, np.asarray(d["sources"]), np.asarray(d["targets"]),
                       d["scale"], d["cof"])
        return {"path": req["path"], "edit_id": edit_id}

    def _cmd_metrics(self, req, emit):
        """Chamfer and Hausdorff distances between the current mesh and the
        original (or ``other_mesh_path``): the reference's offline metrics
        (meshProcess.py:18-105), served online."""
        from ishapediting_tpu_torch.geometry.mesh import TriMesh
        from ishapediting_tpu_torch.geometry.metrics import chamfer_distance, hausdorff_distance

        eng = self._require_mesh()
        other = TriMesh.read(req["other_mesh_path"]) if "other_mesh_path" in req else eng.mesh0
        if other is None:
            raise RuntimeError("no original mesh to compare against")
        n = int(req.get("points", 20000))
        return {
            "chamfer": float(chamfer_distance(eng.mesh, other, point_num=n)),
            "hausdorff": float(hausdorff_distance(eng.mesh, other, point_num=n)),
        }


def serve_loop(instream, outstream, server: Optional[EditServer] = None) -> None:
    """Blocking request loop. Streams events; a ``stop`` line sent during a
    drag is read between progress events through ``select`` on
    ``instream``; any other line read then waits its turn."""
    server = server or EditServer()
    pending = []

    def write(obj):
        outstream.write(json.dumps(obj) + "\n")
        outstream.flush()

    def emit(obj):
        write(obj)
        if obj.get("event") == "progress" and _readable(instream):
            line = instream.readline()
            if line:
                try:
                    nxt = json.loads(line)
                except json.JSONDecodeError:
                    return
                if nxt.get("cmd") == "stop" and server.engine is not None:
                    server.engine.train_flag = False
                    write({"ok": True, "cmd": "stop"})
                else:
                    pending.append(nxt)

    while True:
        if pending:
            req = pending.pop(0)
        else:
            line = instream.readline()
            if not line:
                return
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                write({"ok": False, "error": f"bad json: {e}"})
                continue
        resp = server.handle(req, emit=emit)
        quit_now = resp.pop("_quit", False)
        write(resp)
        if quit_now:
            return


def _readable(stream) -> bool:
    """Whether a line is waiting: ``select`` on a pipe or a terminal; an
    in-memory stream (``io.StringIO``) is readable while it holds unread
    text."""
    if isinstance(stream, io.StringIO):
        return stream.tell() < len(stream.getvalue())
    try:
        return bool(select.select([stream], [], [], 0)[0])
    except (ValueError, OSError, io.UnsupportedOperation, TypeError):
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(description="JSON-lines edit server")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true",
                    help="the JAX package's flag: the same as --device cpu")
    args = ap.parse_args(argv)
    serve_loop(sys.stdin, sys.stdout, EditServer(device="cpu" if args.cpu else args.device))


if __name__ == "__main__":
    main()
