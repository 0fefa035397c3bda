"""Rank functions of ``tests/test_torch_parallel.py``. Each rank is a spawned
process that joins a gloo process group through a file in the test's
temporary directory, runs its tasks on the inputs the test saved
(torch.save), and saves what each got as ``<task>_rank<r>.pt``. This module imports torch and
the port only, never JAX, so that a spawned rank stays light."""

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ishapediting_tpu_torch.config import UNetConfig, preset
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.parallel import mesh as pmesh

TIMEOUT_S = 120  # a rank left waiting in a collective raises after this long


def run_rank(rank, world_size, init_file, tasks, inputs_path, out_dir, table=None):
    """Join the group, run each task of ``table`` (default ``TASKS``) in
    order and save its result."""
    torch.set_num_threads(2)
    pmesh.initialize_distributed("gloo", device="cpu", init_method=f"file://{init_file}", rank=rank,
                                 world_size=world_size, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        for task in tasks:
            result = (TASKS if table is None else table)[task](rank, inputs, out_dir)
            torch.save(result, os.path.join(out_dir, f"{task}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def per_sample(fn):
    """``fn`` one trajectory per forward: the CPU convolutions' reduction
    order depends on the batch size (about 1e-5 after a 10-step walk), so
    with a batched forward the runs on several ranks would differ from the
    one-rank run whatever their draws. One sample per forward leaves only
    the draws and the data layout to tell the runs apart."""

    def run(x, t):
        outs = [fn(x[i : i + 1], t[i : i + 1]) for i in range(x.shape[0])]
        return tuple(None if part[0] is None else torch.cat(part) for part in zip(*outs))

    return run


def _unet(cfg_kwargs, state):
    model = UNetModel(UNetConfig(**cfg_kwargs))
    model.load_state_dict(state)
    return model.eval().requires_grad_(False)


def _flat(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


def _tiny_engine(inputs):
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder

    cfg = preset("tiny")
    dec = TriplaneDecoder(cfg.plane_channels)
    dec.load_state_dict(inputs["decoder"])
    return DragEngine(cfg, unet=_unet(dict(vars(cfg.unet)), inputs["unet"]), decoder=dec, device="cpu")


def sampling(rank, inputs, out_dir):
    """DDIM and DPM from the given x_T, DDPM from a generator, the
    data-axis batches of ``sample_batches`` (with and without ``usable``);
    then the sharded decodes and ``distributed_mean_kvs``."""
    from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder
    from ishapediting_tpu_torch.parallel.decode import decode_grid_sharded, decode_grids_batched
    from ishapediting_tpu_torch.parallel.sampling import sample_batches, sample_sharded
    from ishapediting_tpu_torch.utils.logger import distributed_mean_kvs

    cfg = preset("tiny")
    fn = per_sample(_unet(dict(vars(cfg.unet)), inputs["unet"]))
    mesh = pmesh.make_mesh(device="cpu")
    out = {"size": mesh.size}
    for sampler, respacing in (("ddim", "ddim10"), ("dpm", "dpm8")):
        out[sampler] = sample_sharded(make_schedule(100, "linear", respacing), fn, mesh,
                                      batch_size=2, latent_shape=cfg.latent_shape, sampler=sampler,
                                      x_T=torch.from_numpy(inputs["x_T"])).numpy()
    ddpm = inputs["ddpm"]
    out["ddpm"] = sample_sharded(make_schedule(100, "linear", "10"), fn, mesh, batch_size=ddpm["batch"],
                                 latent_shape=cfg.latent_shape, sampler="ddpm",
                                 generator=torch.Generator().manual_seed(ddpm["seed"])).numpy()
    for key, usable in (("batches", mesh.size), ("batches_no_usable", None)):
        out[key] = sample_batches(make_schedule(100, "linear", "10"), fn, num_samples=ddpm["samples"],
                                  batch_size=ddpm["batch_size"], latent_shape=cfg.latent_shape,
                                  device="cpu", seed=ddpm["seed"], sampler="ddpm", mesh=mesh,
                                  usable=usable)

    dec = TriplaneDecoder(inputs["planes"].shape[-1])
    dec.load_state_dict(inputs["grid_decoder"])
    planes = torch.from_numpy(inputs["planes"])
    kw = dict(res=inputs["res"], compute_dtype=torch.float32)
    out["grid_slab"] = decode_grid_sharded(dec, planes[0], mesh, **kw).numpy()
    out["grid_sharded"] = pmesh.gather(decode_grid_sharded(dec, planes[0], mesh, **kw), mesh).numpy()
    out["grids_batched"] = pmesh.gather(decode_grids_batched(dec, planes, mesh, **kw), mesh).numpy()

    out["kvs"] = distributed_mean_kvs({"a": rank + 1.0, "b": 10.0 * (rank + 1)}, counts={"a": rank + 1.0})
    t0 = time.perf_counter()
    try:
        distributed_mean_kvs({"a": 1.0} if rank == 0 else {"b": 1.0})
    except ValueError as e:
        out["kvs_mismatch"] = str(e)
    out["kvs_mismatch_s"] = time.perf_counter() - t0
    out["kvs_after"] = distributed_mean_kvs({"a": float(rank)})  # the group still works
    return out


def ddpm_idle(rank, inputs, out_dir):
    """DDPM over every rank of the world, and ``sample_batches`` on the plan
    of ``plan_data_mesh`` (ranks past the usable count sit idle)."""
    from ishapediting_tpu_torch.parallel.sampling import plan_data_mesh, sample_batches, sample_sharded

    cfg = preset("tiny")
    fn = per_sample(_unet(dict(vars(cfg.unet)), inputs["unet"]))
    ddpm = inputs["ddpm"]
    mesh = pmesh.make_mesh(device="cpu")
    out = {"ddpm": sample_sharded(make_schedule(100, "linear", "10"), fn, mesh, batch_size=ddpm["batch"],
                                  latent_shape=cfg.latent_shape, sampler="ddpm",
                                  generator=torch.Generator().manual_seed(ddpm["seed"])).numpy()}
    plan_mesh, usable = plan_data_mesh(ddpm["batch_size"], device="cpu")
    out["usable"], out["active"] = usable, plan_mesh.active
    out["batches"] = sample_batches(make_schedule(100, "linear", "10"), fn, num_samples=ddpm["samples"],
                                    batch_size=ddpm["batch_size"], latent_shape=cfg.latent_shape,
                                    device="cpu", seed=ddpm["seed"], sampler="ddpm", mesh=plan_mesh,
                                    usable=usable)
    return out


def train(rank, inputs, out_dir):
    """The data-parallel train step: once with the global batch's injected
    draws (grads and metrics kept), twice from a generator, then once with
    rank 1's rows of the batch made NaN."""
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step
    from ishapediting_tpu_torch.utils.logger import distributed_mean_kvs

    tr = inputs["train"]
    cfg = UNetConfig(**tr["cfg"])
    mesh = pmesh.make_mesh(device="cpu")
    sched = make_schedule(100, "linear", "")
    out = {}

    model = UNetModel(cfg)
    model.load_state_dict(tr["state"])
    state = init_train_state(model, make_optimizer(model.parameters(), grad_clip=0.0))
    step = make_train_step(cfg, sched, mesh=mesh)
    out["metrics"] = step(state, tr["batch"], t=torch.from_numpy(tr["t"]).long(),
                          noise=torch.from_numpy(tr["noise"]), dropout_masks=tr["masks"])
    out["mean_kvs"] = distributed_mean_kvs(out["metrics"])
    out["grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    out["params_injected"] = _flat(model)

    torch.manual_seed(1000 + rank)  # the ranks' global streams differ; the step must not use them
    model = UNetModel(cfg)
    model.load_state_dict(tr["state"])
    pmesh.replicate(model, mesh)
    state = init_train_state(model, make_optimizer(model.parameters(), grad_clip=1.0))
    step = make_train_step(cfg, sched, mesh=mesh)
    gen = torch.Generator().manual_seed(tr["seed"])
    out["gen_metrics"] = [step(state, tr["batch"], gen)]
    out["gen_grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    out["params_gen1"] = _flat(model)
    out["gen_metrics"].append(step(state, tr["batch"], gen))
    out["params_gen"] = _flat(model)
    out["ema_gen"] = torch.cat([v.reshape(-1) for v in state.ema_params.values()]).numpy()

    bad = tr["batch"].copy()
    bad[(mesh.size - 1) * (bad.shape[0] // mesh.size):] = np.nan  # the last rank's rows
    before = _flat(model)
    nan_metrics = step(state, bad, gen)
    out["nan"] = dict(loss=nan_metrics["loss"], unchanged=bool(np.array_equal(before, _flat(model))),
                      step=state.step)
    return out


def editing(rank, inputs, out_dir):
    """``invert_batched``, ``drag_edit_batched`` (recorded and generator
    noise), ``morph_latents`` and ``fit_real_shapes_batched`` (injected and
    generator draws) over the data axis on the tiny engine."""
    from ishapediting_tpu_torch.config import FitConfig
    from ishapediting_tpu_torch.edit import batch as tbatch
    from ishapediting_tpu_torch.edit.morph import morph_latents
    from ishapediting_tpu_torch.geometry.mesh import TriMesh

    ed = inputs["edit"]
    engine = _tiny_engine(inputs)
    mesh = pmesh.make_mesh(device="cpu")
    mf = per_sample(engine.model_fn(feat=True))
    w_time = engine.config.edit.w_time
    lat = torch.from_numpy(ed["latents"])
    out = {}
    inv = tbatch.invert_batched(engine.sched, mf, lat, w_time=w_time, noises=ed["inv_noises"], mesh=mesh)
    out["inv"] = {k: v.numpy() for k, v in inv.items()}
    inv_gen = tbatch.invert_batched(engine.sched, mf, lat, torch.Generator().manual_seed(ed["seed"]),
                                    w_time=w_time, mesh=mesh)
    out["inv_gen"] = {k: v.numpy() for k, v in inv_gen.items()}
    problems = tbatch.build_batched_problems(ed["src"], ed["tgt"], r1=engine.config.edit.r1,
                                             voxel_size=engine.config.edit.voxel_size, feat_width=16)
    kw = dict(w_time=w_time, scale=ed["scale"], cof=ed["cof"], mesh=mesh)
    out["drag"] = tbatch.drag_edit_batched(engine.sched, mf, inv["w"], inv["features"], problems,
                                           noises=ed["drag_noises"], **kw).numpy()
    gens = [torch.Generator().manual_seed(ed["seed"] + i) for i in range(len(ed["src"]))]
    out["drag_gen"] = tbatch.drag_edit_batched(
        engine.sched, mf, inv_gen["w"], inv_gen["features"], problems, gens, **kw).numpy()
    with torch.no_grad():
        out["morph"] = morph_latents(engine.sched, per_sample(engine.model_fn()), lat[0], lat[1], ed["alphas"],
                                     mesh=mesh).numpy()
    fit = inputs["fit"]
    meshes = [TriMesh(v, f) for v, f in fit["meshes"]]

    def fit_run(**draws):
        return tbatch.fit_real_shapes_batched(
            engine._fit_schedule(fit["steps"]), per_sample(engine.model_fn()), engine.decoder, meshes,
            engine.half_range, engine.middle, latent_shape=engine.config.latent_shape,
            fit_cfg=FitConfig(**fit["cfg"]), seed=fit["seed"], mesh=mesh, **draws).numpy()

    out["fit"] = fit_run(x_T=torch.from_numpy(fit["x_T"]), noises=fit["noises"],
                         batch_indices=fit["batches"])
    out["fit_gen"] = fit_run(generator=torch.Generator().manual_seed(fit["seed"]))
    return out


def cli_generate(rank, inputs, out_dir):
    """``cli.generate --sharded_decode`` in the rank's process group."""
    from ishapediting_tpu_torch.cli import generate as tgen

    return tgen.main(inputs["argv"] + ["--save_dir", os.path.join(out_dir, "gen")])


def cli_batch_edit(rank, inputs, out_dir):
    """``cli.batch_edit`` on two seeds, one shape per rank."""
    from ishapediting_tpu_torch.cli import batch_edit

    res = batch_edit.main(inputs["batch_argv"] + ["--out", os.path.join(out_dir, "batch")])
    return {k: res[k].numpy() for k in ("latents", "edited")}


def cli_morph(rank, inputs, out_dir):
    """``cli.morph`` at two frames, one per rank; then at three, which the
    ranks do not divide (rank 0 alone)."""
    from ishapediting_tpu_torch.cli import morph

    two = morph.main(inputs["morph_argv"] + ["--out", os.path.join(out_dir, "morph")])[1]
    three = morph.main(inputs["morph_argv"] + ["--frames", "3", "--skip_decode",
                                               "--out", os.path.join(out_dir, "morph3")])[1]
    return dict(two=two, three=three)


TASKS = dict(sampling=sampling, ddpm_idle=ddpm_idle, train=train, editing=editing, cli_generate=cli_generate,
             cli_batch_edit=cli_batch_edit, cli_morph=cli_morph)
