"""Port parity, data parallelism over ranks: ``parallel/mesh.py``,
``parallel/sampling.py``, ``parallel/decode.py``,
``utils/logger.py::distributed_mean_kvs``, the data-parallel train step, the
batched edit, fit and morph over ranks, and ``cli.generate --sharded_decode``
under 2 ranks. Ranks are spawned processes on the CPU over gloo
(``tests/torch_parallel_workers.py``, which imports no JAX), 2 of them, and
3 where a rank must sit idle; they rendezvous through a file in a temporary
directory. Each rank's result is held to the one-rank run of the port in
this process and to the JAX package's ``mesh`` path on ``make_mesh(2)`` of
the virtual CPU devices, on the same numpy-made weights and inputs.

Ranks against one rank: the UNet runs one trajectory per forward on both
sides (``torch_parallel_workers.per_sample``): the CPU convolutions' reduction
order depends on the batch size, which alone moves a 10-step walk by about
1e-5 and a 3-step guided fit by 2e-3 (measured), so a batched forward would
hide what the ranks must get right, their draws and rows. With it the
samples, inversion records, drags, fits and morph frames are held to 1e-6.
Against the JAX package (batched): samplers atol 1e-4
(``test_torch_sampling.py``), inversion 1e-4, drags and fits 1e-3
(``test_torch_batch.py``), morph frames 1e-3 (``test_torch_morph.py``),
decodes 1e-4 (``test_torch_decode_mesh.py``; against ``decode_grid``, bit
for bit); the train step's loss terms and gradients 1e-4 relative, as
``test_torch_train.py`` holds the one-device step. The train step's own
forward is batched: parameters and EMA bit-equal across ranks, gradients
1e-5 relative and loss terms 1e-5 from the one-rank step.
"""

import logging
import multiprocessing as mp
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_workers as workers
from ishapediting_tpu.config import FitConfig as JFitConfig
from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.core.losses import training_losses as j_training_losses
from ishapediting_tpu.core.schedule import make_schedule as j_make_schedule
from ishapediting_tpu.edit import batch as jbatch
from ishapediting_tpu.edit import morph as jmorph
from ishapediting_tpu.edit.engine import DragEngine as JDragEngine
from ishapediting_tpu.geometry.mesh import TriMesh as JTriMesh
from ishapediting_tpu.models.unet import unet_apply
from ishapediting_tpu.parallel import decode as jdecode
from ishapediting_tpu.parallel import sampling as jsampling
from ishapediting_tpu.parallel.mesh import make_mesh as jmake_mesh
from ishapediting_tpu.parallel.mesh import replicate as jreplicate
from ishapediting_tpu.parallel.mesh import shard_batch as jshard_batch
from ishapediting_tpu_torch.cli import generate as tgen
from ishapediting_tpu_torch.config import FitConfig, UNetConfig, preset
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.edit import batch as tbatch
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.edit.morph import morph_latents
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from ishapediting_tpu_torch.io.convert import unet_state_dict_from_jax
from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.ops import triplane as ttri
from ishapediting_tpu_torch.parallel import mesh as pmesh
from ishapediting_tpu_torch.parallel.sampling import batch_plan, sample_batches, sample_sharded
from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step
from ishapediting_tpu_torch.utils.logger import distributed_mean_kvs
from tests.test_torch_batch import COF, SCALE, SRC, TGT, shape_noises
from tests.test_torch_train import TINY, jax_masks
from torch_parity_helpers import decoder_pair, to_torch, unet_pair

torch.set_num_threads(2)

CFG = preset("tiny")
W_TIME = CFG.edit.w_time
ATOL = 1e-4
RANKS_TOL = 1e-6
DDPM = dict(seed=5, batch=6, samples=5, batch_size=2)  # batch 6 splits over 2 and over 3 ranks
RES = 32
ALPHAS = [0.0, 0.4, 0.7, 1.0]  # two frames per rank
FIT = dict(steps=3, seed=2, cfg=dict(points_size=2000, batch_points=400, grad_scale=1.0))
GEN_ARGV = ["--random_init", "--preset", "tiny", "--use_ddim", "--num_steps", "3", "--num_samples", "3",
            "--batch_size", "2", "--shape_resolution", "16", "--seed", "4", "--device", "cpu",
            "--sharded_decode"]
BATCH_ARGV = ["--random_init", "--preset", "tiny", "--latent_seed", "1", "--latent_seed", "2", "--source", "0.2",
              "0", "0", "--target", "0.4", "0", "0", "--scale", "30", "--noise_mode", "replay", "--device", "cpu"]
MORPH_ARGV = ["--random_init", "--preset", "tiny", "--seed_a", "1", "--seed_b", "2", "--frames", "2",
              "--shape_resolution", "16", "--smooth", "2", "--device", "cpu"]
SPAWN_TIMEOUT_S = 300


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def sphere(r, c=(0.0, 0.0, 0.0), res=24):
    x = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return grid_to_mesh((r - np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)).astype(np.float32))


class Spawn:
    """``world_size`` ranks running ``tasks`` of ``table`` (default
    ``torch_parallel_workers.TASKS``); ``results(task)`` waits for them and
    returns each rank's result."""

    def __init__(self, world_size, tasks, inputs_path, out_dir, table=None):
        self.world_size, self.out_dir = world_size, str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        ctx = mp.get_context("spawn")
        init = os.path.join(self.out_dir, f"init_{world_size}")
        self.procs = [ctx.Process(target=workers.run_rank,
                                  args=(r, world_size, init, tasks, str(inputs_path), self.out_dir, table))
                      for r in range(world_size)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + SPAWN_TIMEOUT_S
        self.codes = None

    def wait(self):
        if self.codes is None:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            self.codes = [p.exitcode for p in self.procs]
        assert self.codes == [0] * self.world_size, f"rank exit codes {self.codes}"

    def results(self, task):
        self.wait()
        return [torch.load(os.path.join(self.out_dir, f"{task}_rank{r}.pt"), weights_only=False)
                for r in range(self.world_size)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs both packages take, the ranks started on them (2, and 3
    with one idle), and the JAX package's mesh paths."""
    d = tmp_path_factory.mktemp("ranks")
    jcfg, jparams, unet = unet_pair(dict(vars(CFG.unet)), seed=71)
    jdec, tdec = decoder_pair(CFG.plane_channels, seed=72)
    jeng = JDragEngine(jpreset("tiny"), unet_params=jparams, decoder_params=jdec)
    teng = DragEngine(CFG, unet=unet, decoder=tdec, device="cpu")
    gdec_j, gdec_t = decoder_pair(in_channels=8, seed=3)

    # the data-parallel train step: JAX's draws of one step on the global batch
    tcfg_j, tparams_j, _ = unet_pair(TINY, seed=3)
    batch = np.clip(np.random.default_rng(2).normal(size=(4, 8, 8, 6)), -1, 1).astype(np.float32)
    rng = jax.random.PRNGKey(8)
    r_t, r_loss, r_drop = jax.random.split(rng, 3)
    t = np.asarray(jax.random.randint(r_t, (4,), 0, 100, jnp.int32))
    assert t.min() > 0  # t = 0's decoder NLL differs in the last ulp of tanh (test_torch_losses.py)
    train = dict(cfg=TINY, state=unet_state_dict_from_jax(jax.tree.map(np.asarray, tparams_j)),
                 batch=batch, t=t, noise=np.asarray(jax.random.normal(r_loss, batch.shape, jnp.float32)),
                 masks=jax_masks(r_drop, 4), seed=9)

    lat = np.random.default_rng(3).uniform(-0.8, 0.8, (2,) + CFG.latent_shape).astype(np.float32)
    inv_rng = jax.random.PRNGKey(7)
    edit = dict(latents=lat, seed=13, src=SRC, tgt=TGT, scale=SCALE, cof=COF, alphas=ALPHAS,
                inv_noises=[np.asarray(jax.random.normal(jax.random.fold_in(inv_rng, t_), lat.shape))
                            for t_ in range(W_TIME)],
                drag_noises=shape_noises(jax.random.PRNGKey(11), W_TIME, range(W_TIME - 1, -1, -1)))
    meshes = [sphere(0.5), sphere(0.4, (0.1, -0.1, 0.0))]
    fit_rng = jax.random.PRNGKey(13)
    loop_rng, init_rng = jax.random.split(fit_rng)
    noises, batches = [], []
    for t_ in range(FIT["steps"] - 1, -1, -1):
        r_noise, r_batch = jax.random.split(jax.random.fold_in(loop_rng, t_))
        batches.append(np.asarray(jax.random.randint(r_batch, (2, 400), 0, 2000)))
        noises.append(np.asarray(jax.random.normal(r_noise, (2,) + CFG.latent_shape)))
    fit = dict(FIT, meshes=[(m.vertices, m.triangles) for m in meshes], noises=noises, batches=batches,
               x_T=np.asarray(jax.random.normal(init_rng, (2,) + CFG.latent_shape)))

    inputs = dict(unet=unet.state_dict(), decoder=tdec.state_dict(), grid_decoder=gdec_t.state_dict(),
                  x_T=np.random.default_rng(12).normal(size=(2,) + CFG.latent_shape).astype(np.float32),
                  ddpm=DDPM, planes=np.random.default_rng(4).normal(size=(2, 3, 16, 16, 8)).astype(np.float32),
                  res=RES, train=train, edit=edit, fit=fit, argv=GEN_ARGV, batch_argv=BATCH_ARGV,
                  morph_argv=MORPH_ARGV)
    inputs_path = d / "inputs.pt"
    torch.save(inputs, inputs_path)
    two = Spawn(2, ["sampling", "train", "editing", "cli_generate", "cli_batch_edit", "cli_morph"], inputs_path,
                d / "two")
    three = Spawn(3, ["ddpm_idle"], inputs_path, d / "three")
    return dict(dir=d, inputs=inputs, two=two, three=three, jeng=jeng, teng=teng, gdec_j=gdec_j,
                gdec_t=gdec_t, jcfg=jcfg, jparams=jparams, tcfg_j=tcfg_j, tparams_j=tparams_j,
                train_rng=rng, inv_rng=inv_rng, fit_rng=fit_rng, meshes=meshes)


def jmodel(setup):
    jcfg, jparams = setup["jcfg"], setup["jparams"]
    return lambda x, t: unet_apply(jcfg, jparams, x, t)


def tmodel(setup):
    return workers.per_sample(setup["teng"].model_fn())


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def test_initialize_distributed_without_environment(caplog, monkeypatch):
    """No launcher environment and no arguments: a logged warning, one
    process, no group; ``make_mesh()`` is one rank and every helper the
    identity."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with caplog.at_level(logging.WARNING, logger="ishapediting_tpu_torch.parallel.mesh"):
        assert pmesh.initialize_distributed() is False
    assert "continuing as one process" in caplog.text
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device, mesh.group, mesh.active) == (0, 1, torch.device("cpu"), None, True)
    x = torch.arange(6.0).reshape(3, 2)
    assert pmesh.shard_batch(x, mesh) is not None and torch.equal(pmesh.shard_batch(x, mesh), x)
    assert pmesh.gather(x, mesh) is x
    model = torch.nn.Linear(2, 2)
    before = model.weight.clone()
    assert pmesh.replicate(model, mesh) is model and torch.equal(model.weight, before)
    assert distributed_mean_kvs({"a": 2.0}) == {"a": 2.0}
    pmesh.barrier()


def test_make_mesh_refuses_model_parallel_and_other_sizes():
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        pmesh.make_mesh(model_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="world of 1"):
        pmesh.make_mesh(2, device="cpu")
    mesh = pmesh.DataMesh(rank=1, size=2, device=torch.device("cpu"))
    assert mesh.rows(6) == slice(3, 6)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.rows(5)
    with pytest.raises(ValueError, match="not on the data axis"):
        pmesh.DataMesh(rank=2, size=2, device=torch.device("cpu")).rows(4)


def test_parallel_import_loads_no_jax():
    code = ("import sys, ishapediting_tpu_torch.parallel, ishapediting_tpu_torch.parallel.decode; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ishapediting_tpu.'))]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler,respacing", [("ddim", "ddim10"), ("dpm", "dpm8")])
def test_sample_sharded_matches_jax(setup, sampler, respacing):
    """Two ranks from the same x_T against JAX's ``sample_sharded`` on
    ``make_mesh(2)`` (atol 1e-4) and the one-rank port (1e-6)."""
    got = setup["two"].results("sampling")
    x_T = setup["inputs"]["x_T"]
    want = jsampling.sample_sharded(j_make_schedule(100, "linear", respacing), jmodel(setup), jmake_mesh(2),
                                    batch_size=2, latent_shape=CFG.latent_shape, rng=jax.random.PRNGKey(0),
                                    sampler=sampler, x_T=jnp.asarray(x_T))
    one = sample_sharded(make_schedule(100, "linear", respacing), tmodel(setup), pmesh.make_mesh(device="cpu"),
                         batch_size=2, latent_shape=CFG.latent_shape, sampler=sampler, x_T=to_torch(x_T))
    for r in (0, 1):
        assert got[r]["size"] == 2
        np.testing.assert_allclose(got[r][sampler], np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(got[r][sampler], one.numpy(), atol=RANKS_TOL)


@pytest.mark.parametrize("ranks", [2, 3])
def test_ddpm_over_ranks_matches_one_rank(setup, ranks):
    """Ancestral sampling of 6 trajectories from one generator: each rank
    draws x_T and every step's noise for the whole batch and keeps its
    rows, so 2 and 3 ranks give the one-rank samples (1e-6)."""
    task = "sampling" if ranks == 2 else "ddpm_idle"
    got = setup["two" if ranks == 2 else "three"].results(task)
    want = sample_sharded(make_schedule(100, "linear", "10"), tmodel(setup), pmesh.make_mesh(device="cpu"),
                          batch_size=DDPM["batch"], latent_shape=CFG.latent_shape, sampler="ddpm",
                          generator=torch.Generator().manual_seed(DDPM["seed"])).numpy()
    for r in range(ranks):
        assert got[r]["ddpm"].shape == (DDPM["batch"],) + CFG.latent_shape
        np.testing.assert_allclose(got[r]["ddpm"], want, atol=RANKS_TOL)


def test_sample_batches_over_ranks(setup):
    """``sample_batches`` (5 samples in batches of 2) over a data axis of 2
    ranks, and over the plan of 3 ranks (2 usable, rank 2 idle; the last
    sample on rank 0 alone): every rank gets the one-rank samples (1e-6).
    Without ``usable`` the 2-rank run takes it from the mesh (the JAX
    package raises TypeError there) and gives the same samples."""
    want = sample_batches(make_schedule(100, "linear", "10"), tmodel(setup), num_samples=DDPM["samples"],
                          batch_size=DDPM["batch_size"], latent_shape=CFG.latent_shape, device="cpu",
                          seed=DDPM["seed"], sampler="ddpm")
    two = setup["two"].results("sampling")
    three = setup["three"].results("ddpm_idle")
    assert [r["usable"] for r in three] == [2, 2, 2] and [r["active"] for r in three] == [True, True, False]
    for got in [r["batches"] for r in two + three] + [r["batches_no_usable"] for r in two]:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=RANKS_TOL)


def _jax_plan(num_samples, batch_size, data, monkeypatch, **usable):
    """JAX's ``sample_batches`` batches: each batch's size read off the
    ``x.shape`` its model function sees, and the data axis it ran on. Its
    ``sample_sharded`` is replaced by one call of the model function (the
    plan is ``sample_batches``' own)."""
    seen = []

    def model_fn_p(params, x, t):
        seen.append([x.shape[0]])
        return x

    def one_call(sched, model_fn, mesh, *, batch_size, latent_shape, model_fn_p, params, **kw):
        x = jnp.zeros((batch_size,) + tuple(latent_shape))
        model_fn_p(params, x, jnp.zeros((batch_size,), jnp.int32))
        seen[-1].append(mesh.shape["data"])
        return x

    monkeypatch.setattr(jsampling, "sample_sharded", one_call)
    jsampling.sample_batches(None, None, model_fn_p, num_samples=num_samples, batch_size=batch_size,
                             latent_shape=(1, 1, 1), mesh=jmake_mesh(data), **usable)
    return seen


@pytest.mark.parametrize("usable", [1, 2, 3])
def test_batch_plan_matches_jax(usable, monkeypatch):
    """The port's batches (sizes, and whether the data axis takes them) are
    JAX's for 1-9 samples in batches of 1-4."""
    for num_samples in range(1, 10):
        for batch_size in range(1, 5):
            want = [(n, data == usable) for n, data in
                    _jax_plan(num_samples, batch_size, usable, monkeypatch, usable=usable)]
            assert batch_plan(num_samples, batch_size, usable, usable) == want, (num_samples, batch_size)


def test_sample_batches_mesh_without_usable(setup, monkeypatch):
    """The reference fault, repaired: JAX's ``sample_batches`` with a mesh
    and no ``usable`` raises TypeError; the port takes ``usable`` from the
    mesh (its 2-rank run above equals the one with ``usable=2``)."""
    with pytest.raises(TypeError):
        _jax_plan(4, 2, 2, monkeypatch)
    for r in setup["two"].results("sampling"):
        np.testing.assert_array_equal(r["batches_no_usable"], r["batches"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def test_sharded_decodes_equal_decode_grid(setup):
    """Each rank's slab is its half of the x-rows; the gathered slabs and
    the gathered per-rank grids equal ``decode_grid`` bit for bit, and JAX's
    ``decode_grid_sharded`` on ``make_mesh(2)`` to 1e-4."""
    planes = setup["inputs"]["planes"]
    kw = dict(res=RES, compute_dtype=torch.float32)
    want = [ttri.decode_grid(setup["gdec_t"], torch.from_numpy(p), **kw).numpy() for p in planes]
    jwant = jdecode.decode_grid_sharded(setup["gdec_j"], jnp.asarray(planes[0]), jmake_mesh(2), res=RES,
                                        compute_dtype=jnp.float32)
    for r, got in enumerate(setup["two"].results("sampling")):
        np.testing.assert_array_equal(got["grid_slab"], want[0][r * RES // 2 : (r + 1) * RES // 2])
        np.testing.assert_array_equal(got["grid_sharded"], want[0])
        np.testing.assert_array_equal(got["grids_batched"], np.stack(want))
        np.testing.assert_allclose(got["grid_sharded"], np.asarray(jwant), atol=1e-4)


def test_sharded_decode_refuses_indivisible():
    mesh = pmesh.DataMesh(rank=0, size=3, device=torch.device("cpu"))
    _, dec = decoder_pair(in_channels=8, seed=3)
    from ishapediting_tpu_torch.parallel.decode import decode_grid_sharded, decode_grids_batched

    with pytest.raises(ValueError, match="res=16 must divide"):
        decode_grid_sharded(dec, torch.zeros(3, 4, 4, 8), mesh, res=16)
    with pytest.raises(ValueError, match="batch 2 must divide"):
        decode_grids_batched(dec, torch.zeros(2, 3, 4, 4, 8), mesh, res=6)


# ---------------------------------------------------------------------------
# distributed_mean_kvs
# ---------------------------------------------------------------------------


def test_distributed_mean_kvs(setup):
    """The weighted mean over ranks; mismatched key sets raise ValueError on
    both ranks at once (no rank waits for the timeout), and the group still
    works afterwards."""
    got = setup["two"].results("sampling")
    for r in got:
        assert r["kvs"] == pytest.approx({"a": (1 * 1 + 2 * 2) / 3, "b": 15.0}, rel=1e-12)
        assert "identical kv keys" in r["kvs_mismatch"]
        assert r["kvs_mismatch_s"] < workers.TIMEOUT_S / 4
        assert r["kvs_after"] == {"a": 0.5}


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------


def test_dp_train_step_matches_jax(setup):
    """The step over 2 ranks at global batch 4 with JAX's draws injected,
    against the JAX trainer's ``loss_fn`` (``make_train_step``'s, under
    remat) on a ``shard_batch``ed batch with ``replicate``d parameters on
    ``make_mesh(2)``, held as ``test_torch_train.py`` holds the one-device
    step: loss, mse, vb and the gradient's global norm at 1e-4 relative,
    each parameter's gradient at 1e-4 relative L2 against the larger of its
    norm and 1e-4 of the global norm; ``distributed_mean_kvs`` of the
    metrics is the metrics."""
    tr = setup["inputs"]["train"]
    jcfg = setup["tcfg_j"]
    jsched = j_make_schedule(100, "linear", "")
    mesh = jmake_mesh(2)
    _, r_loss, r_drop = jax.random.split(setup["train_rng"], 3)

    def loss_fn(params, batch):
        def model_fn(x, t_orig):
            return unet_apply(jcfg, params, x, t_orig, train=True, dropout_rng=r_drop, remat=True)

        terms = j_training_losses(jsched, model_fn, batch, jnp.asarray(tr["t"]), r_loss)
        return jnp.mean(terms["loss"]), terms

    with mesh:
        (loss, terms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jreplicate(setup["tparams_j"], mesh), jshard_batch(jnp.asarray(tr["batch"]), mesh))
    metrics = {"loss": loss, "mse": jnp.mean(terms["mse"]), "vb": jnp.mean(terms["vb"]),
               "grad_norm": optax.global_norm(grads)}
    want_grads = unet_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    floor = 1e-4 * np.sqrt(sum(float(np.square(v.numpy()).sum()) for v in want_grads.values()))
    for r in setup["two"].results("train"):
        for k, want in metrics.items():
            assert abs(r["metrics"][k] - float(want)) <= 1e-4 * abs(float(want)), k
        assert r["mean_kvs"] == pytest.approx(r["metrics"], rel=1e-12)
        assert r["grads"].keys() == want_grads.keys()
        worst = max(float(np.linalg.norm(r["grads"][k] - want_grads[k].numpy()))
                    / max(float(want_grads[k].norm()), floor) for k in want_grads)
        assert worst <= 1e-4, worst


def test_dp_train_step_ranks_agree_with_one_rank(setup):
    """Parameters and EMA bit-equal on both ranks after each step (the
    ranks' global RNG streams differ; the step draws from its generator
    only). Against the one-rank step at batch 4 from the same generator
    (whose t, noise and masks are the global batch's): the first step's
    gradients at 1e-5 relative L2 per parameter (floor as above), both
    steps' metrics at 1e-5 relative. Parameters are not compared across
    the two: Adam turns a last-bit difference of a gradient near 0 into
    an update difference of up to the learning rate."""
    tr = setup["inputs"]["train"]
    r0, r1 = setup["two"].results("train")
    for k in ("params_injected", "params_gen1", "params_gen", "ema_gen"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert r0["gen_metrics"] == r1["gen_metrics"]

    cfg = UNetConfig(**tr["cfg"])
    model = UNetModel(cfg)
    model.load_state_dict(tr["state"])
    state = init_train_state(model, make_optimizer(model.parameters(), grad_clip=1.0))
    step = make_train_step(cfg, make_schedule(100, "linear", ""))
    gen = torch.Generator().manual_seed(tr["seed"])
    metrics = [step(state, tr["batch"], gen)]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    metrics.append(step(state, tr["batch"], gen))
    floor = 1e-4 * float(torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in grads.values()])))
    worst = max(float(np.linalg.norm(r0["gen_grads"][k] - g.numpy())) / max(float(g.norm()), floor)
                for k, g in grads.items())
    assert worst <= 1e-5, worst
    for got, m in zip(r0["gen_metrics"], metrics):
        assert got == pytest.approx(m, rel=1e-5)


def test_dp_train_step_nan_guard_is_collective(setup):
    """Rank 1's rows made NaN: the reduced loss is NaN on both ranks, and no
    rank steps (parameters unchanged, step count 2)."""
    for r in setup["two"].results("train"):
        assert np.isnan(r["nan"]["loss"])
        assert r["nan"]["unchanged"] and r["nan"]["step"] == 2


# ---------------------------------------------------------------------------
# batched editing, fitting and morphing over ranks
# ---------------------------------------------------------------------------


def _one_rank_inversion(setup, generator=None, noises=None):
    teng = setup["teng"]
    return tbatch.invert_batched(teng.sched, workers.per_sample(teng.model_fn(feat=True)),
                                 to_torch(setup["inputs"]["edit"]["latents"]), generator, w_time=W_TIME,
                                 noises=noises)


def test_invert_batched_over_ranks(setup):
    """Each rank inverts its shape with its rows of each whole-batch draw
    (injected, or from one generator): the gathered records equal the
    one-rank inversion's (1e-6); the replay identity holds exactly."""
    ed = setup["inputs"]["edit"]
    want = _one_rank_inversion(setup, noises=ed["inv_noises"])
    want_gen = _one_rank_inversion(setup, generator=torch.Generator().manual_seed(ed["seed"]))
    for r in setup["two"].results("editing"):
        for got, ref in ((r["inv"], want), (r["inv_gen"], want_gen)):
            for k, v in ref.items():
                assert got[k].shape == tuple(v.shape), k
                np.testing.assert_allclose(got[k], v.numpy(), atol=RANKS_TOL, err_msg=k)
            np.testing.assert_array_equal(got["sample"], ed["latents"])


def _problems():
    return tbatch.build_batched_problems(SRC, TGT, r1=CFG.edit.r1, voxel_size=CFG.edit.voxel_size, feat_width=16)


def test_drag_edit_batched_over_ranks(setup):
    """One shape per rank with JAX's recorded per-shape noises: against the
    one-rank batched drag (1e-6) and against JAX's
    ``drag_edit_batched(mesh=make_mesh(2))`` on its own inversion (1e-3)."""
    ed = setup["inputs"]["edit"]
    jeng, teng = setup["jeng"], setup["teng"]
    inv = _one_rank_inversion(setup, noises=ed["inv_noises"])
    want = tbatch.drag_edit_batched(teng.sched, workers.per_sample(teng.model_fn(feat=True)), inv["w"],
                                    inv["features"], _problems(), w_time=W_TIME, scale=SCALE, cof=COF,
                                    noises=ed["drag_noises"]).numpy()
    jinv = jbatch.invert_batched(jeng.sched, jeng.model_fn_p(feat=True), jeng.unet_params,
                                 jnp.asarray(ed["latents"]), setup["inv_rng"], w_time=W_TIME)
    jwant = jbatch.drag_edit_batched(
        jeng.sched, jeng.model_fn_p(feat=True), jeng.unet_params, jinv["w"], jinv["features"],
        jbatch.build_batched_problems(SRC, TGT, r1=CFG.edit.r1, voxel_size=CFG.edit.voxel_size, feat_width=16),
        jax.random.PRNGKey(11), w_time=W_TIME, scale=np.asarray(SCALE), cof=np.asarray(COF),
        mesh=jmake_mesh(2))
    for r in setup["two"].results("editing"):
        assert r["drag"].shape == (2, 1) + CFG.latent_shape
        np.testing.assert_allclose(r["drag"], want, atol=RANKS_TOL)
        np.testing.assert_allclose(r["drag"], np.asarray(jwant), atol=1e-3)


def test_drag_edit_batched_generators_over_ranks(setup):
    """Per-shape generators keep their global index: the 2-rank drag from
    ``generators[i]`` equals the one-rank drag (1e-6) and differs from a
    run with the generators swapped."""
    ed = setup["inputs"]["edit"]
    teng = setup["teng"]
    inv = _one_rank_inversion(setup, generator=torch.Generator().manual_seed(ed["seed"]))

    def drag(order):
        gens = [torch.Generator().manual_seed(ed["seed"] + i) for i in order]
        return tbatch.drag_edit_batched(teng.sched, workers.per_sample(teng.model_fn(feat=True)), inv["w"],
                                        inv["features"], _problems(), gens, w_time=W_TIME, scale=SCALE,
                                        cof=COF).numpy()

    want = drag([0, 1])
    for r in setup["two"].results("editing"):
        np.testing.assert_allclose(r["drag_gen"], want, atol=RANKS_TOL)
        assert np.abs(r["drag_gen"] - drag([1, 0])).max() > 1e-2


def test_morph_latents_over_ranks(setup):
    """Four frames, two per rank, each rank encoding the pair itself:
    against one rank (1e-6) and JAX's ``morph_latents(mesh=make_mesh(2))``
    (1e-3)."""
    ed = setup["inputs"]["edit"]
    jeng, teng = setup["jeng"], setup["teng"]
    lat = ed["latents"]
    with torch.no_grad():
        want = morph_latents(teng.sched, workers.per_sample(teng.model_fn()), to_torch(lat[0]),
                             to_torch(lat[1]), ALPHAS).numpy()
    jwant = jmorph.morph_latents(jeng.sched, jeng._model_fn(feat=False), jnp.asarray(lat[0]),
                                 jnp.asarray(lat[1]), ALPHAS, mesh=jmake_mesh(2))
    for r in setup["two"].results("editing"):
        assert r["morph"].shape == (4,) + CFG.latent_shape
        np.testing.assert_allclose(r["morph"], want, atol=RANKS_TOL)
        np.testing.assert_allclose(r["morph"], np.asarray(jwant), atol=1e-3)


def test_fit_real_shapes_batched_over_ranks(setup):
    """One mesh per rank, three guided steps: with JAX's x_T, step noises
    and point batches injected, against JAX's ``fit_real_shapes_batched
    (mesh=make_mesh(2))`` (1e-3, as ``test_torch_batch.py``) and the
    one-rank port (1e-6); from one generator, each rank's rows of the
    whole batch's draws give the one-rank fit (1e-6)."""
    jeng, teng = setup["jeng"], setup["teng"]
    fit = setup["inputs"]["fit"]
    ts = teng._fit_schedule(FIT["steps"])

    def one(**draws):
        return tbatch.fit_real_shapes_batched(
            ts, workers.per_sample(teng.model_fn()), teng.decoder, setup["meshes"], teng.half_range, teng.middle,
            latent_shape=CFG.latent_shape, fit_cfg=FitConfig(**FIT["cfg"]), seed=FIT["seed"], **draws).numpy()

    want = one(x_T=to_torch(fit["x_T"]), noises=fit["noises"], batch_indices=fit["batches"])
    want_gen = one(generator=torch.Generator().manual_seed(FIT["seed"]))
    jmeshes = [JTriMesh(m.vertices.copy(), m.triangles.copy()) for m in setup["meshes"]]
    jwant = jbatch.fit_real_shapes_batched(
        jeng._fit_schedule(FIT["steps"]), jeng.model_fn_p(feat=False), jeng.unet_params, jeng.decoder_params,
        jmeshes, jeng.half_range, jeng.middle, setup["fit_rng"], latent_shape=CFG.latent_shape,
        fit_cfg=JFitConfig(**FIT["cfg"]), seed=FIT["seed"], mesh=jmake_mesh(2))
    for r in setup["two"].results("editing"):
        np.testing.assert_allclose(r["fit"], np.asarray(jwant), atol=1e-3)
        np.testing.assert_allclose(r["fit"], want, atol=RANKS_TOL)
        np.testing.assert_allclose(r["fit_gen"], want_gen, atol=RANKS_TOL)
        assert np.abs(r["fit_gen"] - want).max() > 1e-2  # the generator's draws, not the injected ones


# ---------------------------------------------------------------------------
# cli.generate
# ---------------------------------------------------------------------------


def test_cli_generate_sharded_decode_over_ranks(setup, tmp_path):
    """``cli.generate --sharded_decode`` under 2 ranks (3 samples in batches
    of 2: the first batch split over the ranks, the last sample on rank 0;
    samples 0 and 1 decoded and written by ranks 0 and 1, sample 2 by rank
    0) writes the triplanes and meshes one rank writes, byte for byte, and
    returns its samples on both ranks."""
    want = tgen.main(GEN_ARGV + ["--save_dir", str(tmp_path)])
    got = setup["two"].results("cli_generate")
    out = os.path.join(setup["two"].out_dir, "gen")
    for r in got:
        np.testing.assert_array_equal(r, want)
    for i in range(3):
        for f in (f"triplanes/{i}.npy", f"objects/{i}.obj"):
            with open(os.path.join(out, f), "rb") as a, open(tmp_path / f, "rb") as b:
                assert a.read() == b.read(), f


def test_cli_batch_edit_and_morph_over_ranks(setup, tmp_path):
    """``cli.batch_edit`` on two seeds under 2 ranks (one shape each: rank r
    writes shape r's meshes, rank 0 the EditLog) and ``cli.morph`` at two
    frames (one each; rank 0 writes latents.npy): the files a one-rank run
    writes, the EditLog byte for byte, and its latents (the CLI's batched
    model: batch 1 against 2 moves them by under 1e-4 here). At three
    frames ``cli.morph`` runs on rank 0 alone."""
    from ishapediting_tpu_torch.cli import batch_edit as tcli_batch
    from ishapediting_tpu_torch.cli import morph as tcli_morph

    want = tcli_batch.main(BATCH_ARGV + ["--out", str(tmp_path / "batch")])
    _, want_frames = tcli_morph.main(MORPH_ARGV + ["--out", str(tmp_path / "morph")])
    out = setup["two"].out_dir
    for sub in ("batch", "morph"):
        assert sorted(os.listdir(os.path.join(out, sub))) == sorted(os.listdir(tmp_path / sub))
    for name in sorted(os.listdir(tmp_path / "batch")) + [f"frame_{k:02d}.obj" for k in range(2)]:
        sub = "morph" if name.startswith("frame") else "batch"
        assert os.path.getsize(os.path.join(out, sub, name)) > 0, name
    with open(os.path.join(out, "batch", "EditLog"), "rb") as f:
        assert f.read() == (tmp_path / "batch" / "EditLog").read_bytes()
    for r in setup["two"].results("cli_batch_edit"):
        np.testing.assert_allclose(r["latents"], want["latents"].numpy(), atol=1e-4)
        np.testing.assert_allclose(r["edited"], want["edited"].numpy(), atol=1e-4)
    np.testing.assert_allclose(np.load(os.path.join(out, "morph", "latents.npy")), want_frames, atol=1e-4)
    for frames in setup["two"].results("cli_morph"):
        np.testing.assert_allclose(frames["two"], want_frames, atol=1e-4)
    # three frames over two ranks: rank 0 morphs alone (the JAX CLI's fallback
    # to one device), rank 1 returns nothing; the one-rank frames exactly
    _, want3 = tcli_morph.main(MORPH_ARGV + ["--frames", "3", "--skip_decode", "--out", str(tmp_path / "m3")])
    r0, r1 = setup["two"].results("cli_morph")
    np.testing.assert_array_equal(r0["three"], want3)
    assert r1["three"] is None
