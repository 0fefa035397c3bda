"""Rank functions of ``tests/test_torch_tensor_parallel.py``: the model axis
(``make_mesh(model_parallel=2)``, ``shard_params_tp``, the cut UNet's
forward and guidance gradient, the drag, DDIM and the decode over a 2-D
mesh, the cut train step with its checkpoints, loop and export) and
``cli.serve`` over ranks. Ranks are started by
``torch_parallel_workers.run_rank`` with ``TASKS`` of this module; like it,
this module imports torch and the port only, never JAX."""

import dataclasses
import io
import json
import os

import numpy as np
import torch

from ishapediting_tpu_torch.config import UNetConfig, preset
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.parallel import mesh as pmesh
from ishapediting_tpu_torch.parallel import tensor as ptensor
from torch_parallel_workers import _unet, per_sample

FEAT_LAYER = 1


def cut_unet(inputs, mesh):
    """The miniature UNet of ``inputs`` built on the CPU and cut over the
    mesh's model axis."""
    return ptensor.shard_params_tp(_unet(inputs["mini"], inputs["unet"]), mesh)


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def mesh_layout(rank, inputs, out_dir):
    """The 2-D mesh's shape and this rank's indices and rows; a second mesh
    over the same ranks reuses the groups; ``plan_data_mesh`` twice makes one
    group; a model axis that does not divide the ranks is refused."""
    from ishapediting_tpu_torch.parallel.sampling import plan_data_mesh

    mesh = pmesh.make_mesh(model_parallel=2, device="cpu")
    again = pmesh.make_mesh(model_parallel=2, device="cpu")
    plans = [plan_data_mesh(2, device="cpu")[0] for _ in range(2)]
    try:
        pmesh.make_mesh(model_parallel=3, device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(shape=mesh.shape, data_index=mesh.data_index, model_index=mesh.model_index,
                rows=(mesh.rows(4).start, mesh.rows(4).stop), mesh_rows=(mesh.mesh_rows(8).start, mesh.mesh_rows(8).stop),
                reused=again.group is mesh.group and again.model_group is mesh.model_group
                and again.mesh_group is mesh.mesh_group,
                plan_reused=plans[0].group is plans[1].group, plan_size=plans[0].size, refused=refused)


def forward(rank, inputs, out_dir):
    """One forward of the cut UNet with the feature tap, each data index on
    its rows of the batch, gathered; the cut layers, the bytes this rank
    holds and the gathers the forward made; then the class-conditional
    miniature's cut forward and cut layers."""
    mesh = pmesh.make_mesh(model_parallel=2, device="cpu")
    whole = param_bytes(_unet(inputs["mini"], inputs["unet"]))
    model = cut_unet(inputs, mesh)
    x = pmesh.shard_batch(torch.from_numpy(inputs["x"]), mesh)
    t = pmesh.shard_batch(torch.from_numpy(inputs["t"]).long(), mesh)
    ptensor.reset_gather_counts()
    with torch.no_grad():
        out, feat = model(x, t, feat_layer=FEAT_LAYER)
    gathers = ptensor.GATHERS["calls"]
    cond = ptensor.shard_params_tp(_unet(inputs["mini_cond"], inputs["unet_cond"]), mesh)
    with torch.no_grad():
        cond_out, _ = cond(x, t, y=pmesh.shard_batch(torch.from_numpy(inputs["y"]).long(), mesh))
    return dict(shape=mesh.shape, out=pmesh.gather(out, mesh).numpy(), feat=pmesh.gather(feat, mesh).numpy(),
                cut=cut_names(model), bytes=param_bytes(model), whole_bytes=whole, gathers=gathers,
                cond_out=pmesh.gather(cond_out, mesh).numpy(), cond_cut=cut_names(cond),
                cond_label_shape=list(cond.label_emb.weight.shape))


def cut_names(model):
    return sorted(n for n, m in model.named_modules() if getattr(m, "model_axis", None) is not None)


def guidance_grad(model, inputs, remat):
    """d/dx of a fixed weighting of the output and the tapped feature."""
    x = torch.from_numpy(inputs["x"][:2]).requires_grad_(True)
    out, feat = model(x, torch.from_numpy(inputs["t"][:2]).long(), feat_layer=FEAT_LAYER, remat=remat)
    loss = (out * torch.from_numpy(inputs["w_out"])).sum() + (feat * torch.from_numpy(inputs["w_feat"])).sum()
    return torch.autograd.grad(loss, x)[0].numpy()


def drag_config(inputs):
    """The tiny pipeline with the miniature UNet and a 2-step drag window."""
    cfg = preset("tiny")
    return dataclasses.replace(cfg, unet=UNetConfig(**inputs["mini"]),
                               edit=dataclasses.replace(cfg.edit, w_time=2, feat_layer=FEAT_LAYER))


def tiny_engine(model, inputs, remat=False):
    """A ``DragEngine`` of ``drag_config`` over ``model``."""
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder

    cfg = drag_config(inputs)
    dec = TriplaneDecoder(cfg.plane_channels)
    dec.load_state_dict(inputs["decoder"])
    return DragEngine(cfg, unet=model, decoder=dec, device="cpu", remat=remat)


def drag_runs(model, inputs, remat):
    """``update_latent_params`` from the given x_T and step noises, a 2-step
    ``drag_edit`` with recorded noises, then ``latent_inversion`` of the
    edited latent, on an engine over ``model``: the edited latent, the
    guidance losses per step and the inverted latent."""
    eng = tiny_engine(model, inputs, remat)
    eng.update_latent_params(latent=inputs["x_T"], noises=inputs["gen_noises"])
    eng.drag_edit(inputs["src"], inputs["tgt"], scale=inputs["scale"], cof=0.2, noises=inputs["drag_noises"])
    edited = np.asarray(eng.edited_latent)
    eng.latent_inversion(edited, noises=inputs["drag_noises"])
    return dict(edited=edited, motion=np.asarray(eng.last_drag_losses["motion"]), inverted=eng.w.numpy())


def batched_edit_runs(model, inputs, mesh=None):
    """``invert_batched`` of 2 latents and ``drag_edit_batched`` on its
    records with recorded noises, one trajectory per forward, on an engine
    over ``model`` (over ``mesh``'s data axis, or one rank)."""
    from ishapediting_tpu_torch.edit import batch as tbatch

    eng = tiny_engine(model, inputs)
    cfg, sched, fn = eng.config, eng.sched, per_sample(eng.model_fn(feat=True))
    lat = torch.from_numpy(inputs["x_T2"]).clamp(-1, 1)
    inv = tbatch.invert_batched(sched, fn, lat, w_time=2, noises=inputs["batch_noises"], mesh=mesh)
    problems = tbatch.build_batched_problems([inputs["src"], -inputs["src"]], [inputs["tgt"], -inputs["tgt"]],
                                             r1=cfg.edit.r1, voxel_size=cfg.edit.voxel_size,
                                             feat_width=inv["features"].shape[-2])
    edited = tbatch.drag_edit_batched(sched, fn, inv["w"], inv["features"], problems, w_time=2,
                                      scale=[inputs["scale"]] * 2, cof=[0.2, 0.2], noises=inputs["batch_noises"],
                                      mesh=mesh)
    return dict(w=inv["w"].numpy(), edited=edited.numpy())


def drag(rank, inputs, out_dir):
    """The guidance gradient and the 2-step drag through the cut UNet,
    without and with remat."""
    mesh = pmesh.make_mesh(model_parallel=2, device="cpu")
    model = cut_unet(inputs, mesh)
    out = {}
    for remat in (False, True):
        out[f"grad_remat{int(remat)}"] = guidance_grad(model, inputs, remat)
        out[f"drag_remat{int(remat)}"] = drag_runs(model, inputs, remat)
    return out


def sample_edit_2d(rank, inputs, out_dir):
    """Over data 2 x model 2 (one trajectory or shape per data index):
    DDIM-10 of 2 trajectories from the given x_T, ``sample_batches`` of 3
    samples in batches of 2 (the last batch on the ranks of data index 0),
    and the batched inversion and drag."""
    from ishapediting_tpu_torch.parallel.sampling import sample_batches, sample_sharded

    mesh = pmesh.make_mesh(model_parallel=2, device="cpu")
    model = cut_unet(inputs, mesh)
    fn = per_sample(model)
    shape = preset("tiny").latent_shape
    ddim = sample_sharded(make_schedule(100, "linear", "ddim10"), fn, mesh, batch_size=2, latent_shape=shape,
                          sampler="ddim", x_T=torch.from_numpy(inputs["x_T2"])).numpy()
    batches = sample_batches(make_schedule(100, "linear", "5"), fn, num_samples=3, batch_size=2,
                             latent_shape=shape, device="cpu", seed=5, sampler="ddpm", mesh=mesh)
    return dict(ddim=ddim, batches=batches, edit=batched_edit_runs(model, inputs, mesh))


def decode_2d(rank, inputs, out_dir):
    """``decode_grid_sharded`` and ``decode_grids_batched`` over data 2 x
    model 2: this rank's slab and the gathered grids."""
    from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder
    from ishapediting_tpu_torch.parallel.decode import decode_grid_sharded, decode_grids_batched

    mesh = pmesh.make_mesh(model_parallel=2, device="cpu")
    planes = torch.from_numpy(inputs["planes"])
    dec = TriplaneDecoder(planes.shape[-1])
    dec.load_state_dict(inputs["grid_decoder"])
    kw = dict(res=inputs["res"], compute_dtype=torch.float32)
    slab = decode_grid_sharded(dec, planes[0], mesh, **kw)
    return dict(slab=slab.numpy(), grid=pmesh.gather_mesh(slab, mesh).numpy(),
                grids=pmesh.gather_mesh(decode_grids_batched(dec, planes, mesh, **kw), mesh).numpy())


def serve(rank, inputs, out_dir):
    """``serve_loop`` over the ranks on the session's requests; what this
    rank wrote to its output stream."""
    from ishapediting_tpu_torch.cli.serve import EditServer, serve_loop

    out = io.StringIO()
    reqs = [json.dumps(r).replace("{out}", os.path.join(out_dir, "served")) for r in inputs["serve"]]
    serve_loop(io.StringIO("\n".join(reqs) + "\n"), out, EditServer(device="cpu"))
    return out.getvalue()


def train_tensors(state, gather):
    """The parameters, EMA and Adam moments of a train state by name
    (``p.``, ``ema.``, ``exp_avg.``, ``exp_avg_sq.``): gathered whole, or
    this rank's slices."""
    from ishapediting_tpu_torch.io.checkpoint import MOMENTS, _opt_names, whole_state

    if gather:
        blob = whole_state(state)
        params, ema, opt = blob["params"], blob["ema_params"], blob["optimizer"]["state"]
    else:
        params = {k: p.detach() for k, p in state.model.named_parameters()}
        ema, opt = state.ema_params, state.optimizer.state_dict()["state"]
    out = {f"p.{k}": v for k, v in params.items()}
    out.update({f"ema.{k}": v for k, v in ema.items()})
    for i, name in enumerate(_opt_names(state)):
        out.update({f"{m}.{name}": opt[i][m] for m in MOMENTS})
    return {k: v.detach().clone().numpy() for k, v in out.items()}


def _cut_state(cfg, state, mesh, grad_clip):
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer

    model = ptensor.shard_params_tp(_unet(cfg, state), mesh)
    return init_train_state(model, make_optimizer(model.parameters(), 1e-4, grad_clip=grad_clip))


def _train_batches(shape, seed, skip=0):
    """The loop's global batches, the first ``skip`` left out (a resumed
    run's iterator starts where the interrupted one stopped)."""
    rng = np.random.default_rng(seed)
    for i in range(10**6):
        batch = np.clip(rng.standard_normal(shape), -1, 1).astype(np.float32)
        if i >= skip:
            yield batch


def train_tp(rank, inputs, out_dir):
    """The train step cut over model 2 (with 4 ranks on data 2 x model 2),
    global batch 4. On the JAX comparison's UNet: (jax) one step with the
    injected draws and JAX's optimizer (grad_clip 1.0), its metrics and
    state gathered; (clip) one step with the clip at half the one-rank
    norm, its clipped gradients gathered, then a second step from a
    generator and this rank's slices. On the small UNet: (loop)
    ``train(mesh=)`` for 2 steps, and for 1 step resumed to 2 from its cut
    checkpoint; (nan) a step whose loss is NaN on the last rank alone;
    (load) a one-rank checkpoint loaded cut; (export) the EMA exported as a
    model dir."""
    from ishapediting_tpu_torch.cli.train import export_model_dir
    from ishapediting_tpu_torch.io.checkpoint import load_train_state
    from ishapediting_tpu_torch.train.loop import train
    from ishapediting_tpu_torch.train.trainer import make_train_step

    tr = inputs["train"]
    mesh = pmesh.make_mesh(model_parallel=2, device="cpu")
    cfg, sched = UNetConfig(**tr["cfg"]), make_schedule(*tr["sched"])
    step = make_train_step(cfg, sched, mesh=mesh)
    draws = dict(t=torch.from_numpy(tr["t"]).long(), noise=torch.from_numpy(tr["noise"]), dropout_masks=tr["masks"])
    out = dict(shape=mesh.shape, data_index=mesh.data_index, model_index=mesh.model_index)

    state = _cut_state(tr["cfg"], tr["state"], mesh, 1.0)
    out["jax_metrics"] = step(state, tr["batch"], **draws)
    out["jax_state"] = train_tensors(state, gather=True)  # gathered tensors are the same on every rank

    state = _cut_state(tr["cfg"], tr["state"], mesh, tr["clip"])
    out["clip_metrics"] = step(state, tr["batch"], **draws)
    grads = ptensor.gather_named(state.model, {k: p.grad for k, p in state.model.named_parameters()})
    out["clip_grads"] = {k: v.numpy().copy() for k, v in grads.items()}
    out["step2_metrics"] = step(state, tr["batch"], torch.Generator().manual_seed(tr["seed"]))
    out["slices"] = train_tensors(state, gather=False)
    out["cut_dims"] = ptensor.cut_dims(state.model)

    small = UNetConfig(**tr["small_cfg"])
    shape = (4, small.image_size, small.image_size, small.in_channels)
    kw = dict(log_every=100, grad_clip=1.0, seed=tr["seed"], mesh=mesh)
    runs = {}
    for name, legs in (("straight", (2,)), ("resumed", (1, 2))):
        ckpt = os.path.join(out_dir, f"loop_{name}") if name == "resumed" else None
        for done, total in zip((0,) + legs, legs):
            model = ptensor.shard_params_tp(_unet(tr["small_cfg"], tr["small_state"]), mesh)
            state = train(small, sched, model, _train_batches(shape, tr["seed"], skip=done), total_steps=total,
                          ckpt_dir=ckpt, ckpt_every=1, **kw)
        runs[name], runs[f"{name}_step"] = train_tensors(state, gather=True), state.step
    out["loop"], out["small_cut_dims"] = runs, ptensor.cut_dims(state.model)

    last = mesh.n_ranks - 1  # its output, so its loss alone, made NaN
    hook = state.model.register_forward_hook(
        lambda mod, args, y: (y[0] * float("nan"), y[1]) if mesh.rank == last else y)
    before, step_before = train_tensors(state, gather=False), state.step
    out["nan_metrics"] = make_train_step(small, sched, mesh=mesh)(state, next(_train_batches(shape, 0)),
                                                                   torch.Generator().manual_seed(0))
    hook.remove()
    after = train_tensors(state, gather=False)
    out["nan_unchanged"] = state.step == step_before and all(np.array_equal(before[k], after[k]) for k in before)

    export = os.path.join(out_dir, "export")
    dec = os.path.join(out_dir, "dec.pt")
    if rank == 0:
        torch.save(tr["decoder"], dec)
    pmesh.barrier()
    export_model_dir(export, state.ema_params, decoder_from=dec, channels=6, model=state.model, mesh=mesh)
    out["export_dir"] = export
    out["ema_whole"] = {k: v.numpy().copy() for k, v in ptensor.gather_named(state.model, state.ema_params).items()}

    loaded = _cut_state(tr["small_cfg"], tr["small_state"], mesh, 1.0)
    load_train_state(tr["whole_ckpt"], loaded)
    out["loaded_slices"], out["loaded_step"] = train_tensors(loaded, gather=False), loaded.step
    if rank:  # the whole tensors are rank 0's to report
        for k in ("jax_state", "clip_grads", "loop", "ema_whole"):
            out[k] = None
    return out


TASKS = dict(mesh_layout=mesh_layout, forward=forward, drag=drag, sample_edit_2d=sample_edit_2d, decode_2d=decode_2d,
             serve=serve, train_tp=train_tp)
