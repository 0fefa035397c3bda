"""Port parity, the model axis and serving over ranks:
``parallel/mesh.py::make_mesh(model_parallel=)``,
``parallel/tensor.py::shard_params_tp``, the cut UNet's forward
(``models/unet.py::dense``) and guidance gradient, the drag, DDIM and the
occupancy decode over a ``data`` x ``model`` mesh, the train step of a cut
model with its checkpoints, loop and export, and ``cli.serve`` over
ranks. Ranks are spawned processes on the CPU over gloo
(``tests/torch_tp_workers.py``, which imports no JAX): 2 ranks (model 2)
and 4 (data 2 x model 2). Each is held to the one-rank port in this
process and, for the cut set and the forward, to the JAX package's
``shard_params_tp`` on ``make_mesh(8, model_parallel=2)`` of the virtual
CPU devices, on the same numpy-made weights.

The miniature (``MINI``) is the one whose widths reach the policy's 256
output features: 33 of its 200 JAX leaves are cut. Tolerances: forward 1e-5
relative to one rank (a cut layer computes half the output features, which
may change the CPU convolution's blocking) and atol 1e-4 to JAX; guidance
gradient and drag 1e-5 relative; DDIM per sample 1e-6 (one trajectory per
forward, ``torch_parallel_workers.per_sample``); decodes bit-equal.

The cut train step runs ``__graft_entry__.py::dryrun_multichip``'s UNet
(image 32, widths 64-256, dropout 0.1, remat) in fp32 (``TP_TRAIN``), at
global batch 4, against JAX's ``make_train_step`` on its
``shard_params_tp``-cut parameters (1e-4 relative, as
``test_torch_train.py`` holds the one-device step) and against the
one-rank port step (1e-5); checkpoints, the resumed loop and the export
bit for bit.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_tp_workers as tp
from ishapediting_tpu.config import UNetConfig as JUNetConfig
from ishapediting_tpu.core.schedule import make_schedule as j_make_schedule
from ishapediting_tpu.models.unet import unet_apply
from ishapediting_tpu.parallel.mesh import make_mesh as jmake_mesh
from ishapediting_tpu.parallel.mesh import shard_batch as jshard_batch
from ishapediting_tpu.parallel.mesh import shard_params_tp as jshard_params_tp
from ishapediting_tpu.train import trainer as jtrainer
from ishapediting_tpu_torch.cli.serve import EditServer, serve_loop
from ishapediting_tpu_torch.config import UNetConfig, preset
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.io.checkpoint import load_params, load_train_state, save_train_state
from ishapediting_tpu_torch.io.convert import unet_state_dict_from_jax
from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.ops import triplane as ttri
from ishapediting_tpu_torch.parallel import mesh as pmesh
from ishapediting_tpu_torch.parallel import tensor as ptensor
from ishapediting_tpu_torch.parallel.sampling import sample_batches, sample_sharded
from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step
from tests.test_torch_parallel import Spawn, rel_l2
from tests.test_torch_train import jax_masks
from torch_parallel_workers import per_sample
from torch_parity_helpers import decoder_pair, unet_pair

torch.set_num_threads(2)

MINI = dict(image_size=16, in_channels=6, model_channels=64, out_channels=12, num_res_blocks=1,
            attention_ds=(2,), channel_mult=(1, 2, 4), num_head_channels=32, dropout=0.0,
            compute_dtype="float32")
CUT_LEAVES = 33  # of MINI's 200 JAX leaves (every other leaf replicated)
MINI_COND = dict(MINI, num_classes=4)  # adds label_emb (4, 256), cut along its 256 columns
FWD_TOL = 1e-5
JAX_ATOL = 1e-4
GRAD_TOL = 1e-5
DDIM_TOL = 1e-6
RES = 16
TIMING = ("sample_s", "decode_s")
TP_TRAIN = dict(image_size=32, in_channels=6, out_channels=12, model_channels=64, num_res_blocks=1,
                attention_ds=(2, 4), channel_mult=(1, 2, 4), num_head_channels=32, dropout=0.1,
                compute_dtype="float32")  # dryrun_multichip's UNet, fp32
TP_SCHED = (1000, "linear", "20")  # dryrun_multichip's schedule
# the loop, checkpoint and export tests' UNet: 12 of its layers cut (the
# time embedding, emb_layers of 256 outputs, qkv), 3.3M parameters
TP_SMALL = dict(TP_TRAIN, image_size=8, channel_mult=(1, 2), attention_ds=(2,))
TP_BATCH = 4
TRAIN_JAX_TOL = 1e-4
TRAIN_RANKS_TOL = 1e-5
FAMILIES = ("p", "ema", "exp_avg", "exp_avg_sq")
SERVE = [
    {"cmd": "ping"},
    {"cmd": "init_random", "preset": "tiny", "seed": 3},
    {"cmd": "generate", "num_samples": 2, "batch_size": 2, "sampler": "ddim", "num_steps": 3, "seed": 1,
     "out_dir": "{out}", "decode": True, "shape_resolution": 16, "smooth": 0},
    {"cmd": "generate", "num_samples": 0},
    {"cmd": "generate", "num_samples": 2, "batch_size": 2, "sampler": "ddim", "num_steps": 2,
     "out_dir": "{out}/triplanes/0.npy"},
    {"cmd": "sample", "seed": 2},
    {"cmd": "drag", "sources": [[0.2, 0.0, 0.0]], "targets": [[0.4, 0.0, 0.0]], "edit_steps": 2},
    {"cmd": "status"},
    {"cmd": "quit"},
]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs of both packages, the ranks started on them (2, and 4 as
    data 2 x model 2) and the JAX package's cut parameters; the ranks'
    checkpoints are removed at the end."""
    d = tmp_path_factory.mktemp("tp")
    train = train_inputs(d)
    jcfg, jparams, unet = unet_pair(MINI, seed=81)
    jcfg_cond, jparams_cond, unet_cond = unet_pair(MINI_COND, seed=85)
    _, tdec = decoder_pair(preset("tiny").plane_channels, seed=82)
    _, gdec = decoder_pair(in_channels=8, seed=83)
    rng = np.random.default_rng(84)
    shape = (1,) + preset("tiny").latent_shape
    inputs = dict(
        mini=MINI, unet=unet.state_dict(), mini_cond=MINI_COND, unet_cond=unet_cond.state_dict(),
        y=np.array([3, 0, 2, 1]), decoder=tdec.state_dict(), grid_decoder=gdec.state_dict(),
        x=rng.normal(size=(4, 16, 16, 6)).astype(np.float32), t=np.array([5, 40, 77, 99]),
        w_out=rng.normal(size=(2, 16, 16, 12)).astype(np.float32),
        w_feat=rng.normal(size=(2, 8, 8, 256)).astype(np.float32),
        x_T=rng.normal(size=shape).astype(np.float32), x_T2=rng.normal(size=(2,) + shape[1:]).astype(np.float32),
        gen_noises=[rng.normal(size=shape).astype(np.float32) for _ in range(10)],
        drag_noises=[rng.normal(size=shape).astype(np.float32) for _ in range(2)],
        batch_noises=[rng.normal(size=(2,) + shape[1:]).astype(np.float32) for _ in range(2)],
        src=np.array([[0.2, 0.1, 0.0]]), tgt=np.array([[0.4, 0.1, 0.0]]), scale=30.0,
        planes=rng.normal(size=(4, 3, 8, 8, 8)).astype(np.float32), res=RES, serve=SERVE,
        train={k: v for k, v in train.items() if not k.startswith("_")})
    path = d / "inputs.pt"
    torch.save(inputs, path)
    two = Spawn(2, ["forward", "drag", "serve", "train_tp"], path, d / "two", table=tp.TASKS)
    four = Spawn(4, ["mesh_layout", "forward", "sample_edit_2d", "decode_2d", "train_tp"], path, d / "four",
                 table=tp.TASKS)
    for ranks in (2, 4):  # while the ranks run
        jax_cut_step(train, ranks)
    jmesh = jmake_mesh(8, model_parallel=2)
    jcut = jshard_params_tp(jparams, jmesh)
    jcut_cond = jshard_params_tp(jparams_cond, jmesh)
    yield dict(dir=d, inputs=inputs, two=two, four=four, jcfg=jcfg, jcut=jcut, unet=unet, gdec=gdec,
               jcfg_cond=jcfg_cond, jcut_cond=jcut_cond, unet_cond=unet_cond, train=train)
    for spawn in (two, four):
        with contextlib.suppress(AssertionError):  # a rank that failed fails the tests that read it
            spawn.wait()
    shutil.rmtree(d, ignore_errors=True)


def one_rank_train_state(train, grad_clip, small=False):
    """``TP_TRAIN``'s (or ``TP_SMALL``'s) weights on one rank, in a fresh
    train state."""
    model = UNetModel(UNetConfig(**(TP_SMALL if small else TP_TRAIN)))
    model.load_state_dict(train["small_state" if small else "state"])
    return init_train_state(model, make_optimizer(model.parameters(), 1e-4, grad_clip=grad_clip))


def one_rank_step(train, state):
    """One port step of ``state`` on one rank with the injected draws."""
    step = make_train_step(UNetConfig(**TP_TRAIN), make_schedule(*TP_SCHED))
    return step(state, train["batch"], t=torch.from_numpy(train["t"]).long(), noise=torch.from_numpy(train["noise"]),
                dropout_masks=train["masks"])


def train_inputs(d):
    """The cut train step's inputs: ``TP_TRAIN``'s weights from numpy (both
    packages), a global batch with JAX's draws of ``make_train_step``'s rng
    (``split(rng, 3)``: t, noise, dropout), the clip at half the one-rank
    step's norm, and a one-rank checkpoint after one step (JAX's clip)."""
    jcfg, jparams, unet = unet_pair(TP_TRAIN, seed=86)
    rng = jax.random.PRNGKey(17)
    r_t, r_loss, r_drop = jax.random.split(rng, 3)
    batch = np.clip(np.random.default_rng(87).normal(size=(TP_BATCH, 32, 32, 6)), -1, 1).astype(np.float32)
    t = np.asarray(jax.random.randint(r_t, (TP_BATCH,), 0, int(TP_SCHED[2]), jnp.int32))
    assert t.min() > 0  # t = 0's decoder NLL differs in the last ulp of tanh (test_torch_losses.py)
    train = dict(cfg=TP_TRAIN, sched=TP_SCHED, state=unet.state_dict(), batch=batch, t=t,
                 noise=np.asarray(jax.random.normal(r_loss, batch.shape, jnp.float32)),
                 masks=jax_masks(r_drop, TP_BATCH, TP_TRAIN), seed=19, _rng=rng, _jparams=jparams,
                 decoder=decoder_pair(preset("tiny").plane_channels, seed=88)[1].state_dict())
    train["clip"] = one_rank_step(train, one_rank_train_state(train, 0.0))["grad_norm"] / 2
    train.update(small_cfg=TP_SMALL, small_state=unet_pair(TP_SMALL, seed=89)[2].state_dict())
    state = one_rank_train_state(train, 1.0, small=True)
    make_train_step(UNetConfig(**TP_SMALL), make_schedule(*TP_SCHED))(state, np.zeros((4, 8, 8, 6), np.float32),
                                                                    torch.Generator().manual_seed(1))
    train["whole_ckpt"] = str(d / "whole_ckpt")
    save_train_state(train["whole_ckpt"], state)
    train["_whole"] = tp.train_tensors(state, gather=False)
    return train


JAX_STEPS = {}


def jax_cut_step(train, ranks):
    """JAX's ``make_train_step`` (remat, ``make_optimizer(1e-4,
    grad_clip=1.0)``) under ``jax.jit`` on ``shard_params_tp``-cut
    parameters over ``make_mesh(ranks, model_parallel=2)``, the batch
    ``shard_batch``ed: its metrics, and its parameters, EMA and Adam
    moments after the step in the port's layout, keyed as
    ``train_tensors``."""
    if ranks not in JAX_STEPS:
        opt = jtrainer.make_optimizer(1e-4, grad_clip=1.0)
        step = jtrainer.make_train_step(JUNetConfig(**TP_TRAIN), j_make_schedule(*TP_SCHED), opt, remat=True)
        mesh = jmake_mesh(ranks, model_parallel=2)
        with mesh:
            state = jtrainer.init_train_state(jshard_params_tp(train["_jparams"], mesh), opt)
            new, metrics = jax.jit(step)(state, jshard_batch(jnp.asarray(train["batch"]), mesh), train["_rng"])
        adam = next(s for s in jax.tree_util.tree_leaves(new.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                    if hasattr(s, "mu"))
        out = {}
        for fam, tree in (("p", new.params), ("ema", new.ema_params), ("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            sd = unet_state_dict_from_jax(jax.tree.map(np.asarray, tree))
            out.update({f"{fam}.{k}": v.numpy() for k, v in sd.items()})
        JAX_STEPS[ranks] = ({k: float(v) for k, v in metrics.items()}, out)
    return JAX_STEPS[ranks]


def worst_rel(got, want, fam):
    """The largest relative L2 error over the tensors of family ``fam``,
    each relative to the larger of its norm and 1e-4 of the family's norm
    (``test_torch_train.py``'s floor)."""
    keys = [k for k in want if k.startswith(fam + ".")]
    floor = 1e-4 * np.sqrt(sum(float(np.square(want[k].astype(np.float64)).sum()) for k in keys))
    return max(float(np.linalg.norm((got[k] - want[k]).astype(np.float64)))
               / max(float(np.linalg.norm(want[k].astype(np.float64))), floor) for k in keys)


def one_rank_forward(setup):
    x, t = torch.from_numpy(setup["inputs"]["x"]), torch.from_numpy(setup["inputs"]["t"]).long()
    with torch.no_grad():
        return setup["unet"](x, t, feat_layer=tp.FEAT_LAYER)


# ---------------------------------------------------------------------------
# the mesh and the cut
# ---------------------------------------------------------------------------


def test_mesh_shapes_and_row_major_indices(setup):
    """Data 2 x model 2 over 4 ranks: rank r at data r // 2, model r % 2
    (JAX ``test_mesh_shapes``: ``np.asarray(devices).reshape``); rows by the
    data index, mesh rows by the rank; groups made once and reused; a model
    axis of 3 refused with JAX's message."""
    got = setup["four"].results("mesh_layout")
    assert jmake_mesh(8, model_parallel=2).shape == {"data": 4, "model": 2}
    for r, g in enumerate(got):
        assert g["shape"] == {"data": 2, "model": 2}
        assert (g["data_index"], g["model_index"]) == (r // 2, r % 2)
        assert g["rows"] == (2 * (r // 2), 2 * (r // 2) + 2)
        assert g["mesh_rows"] == (2 * r, 2 * r + 2)
        assert g["reused"] and g["plan_reused"] and g["plan_size"] == 2
        assert g["refused"] == "4 devices not divisible by model_parallel=3"


def jax_cut_set(jcut):
    """The prefixes of the JAX leaves whose ``sharding.spec`` is not ``P()``."""
    return sorted(prefix for prefix, entry in jcut.items() for leaf, arr in entry.items()
                  if arr.sharding.spec != P())


def test_cut_set_matches_jax(setup):
    """The layers ``shard_params_tp`` cuts are the JAX leaves whose
    ``sharding.spec`` is not ``P()`` (all of them weights)."""
    want = jax_cut_set(setup["jcut"])
    assert len(want) == CUT_LEAVES
    assert sum(len(e) for e in setup["jcut"].values()) == 200
    assert sorted(n for n, _ in ptensor.cut_layers(setup["unet"])) == want
    for got in setup["two"].results("forward") + setup["four"].results("forward"):
        assert got["cut"] == want
        assert got["gathers"] == CUT_LEAVES  # one gather per cut layer per forward


def test_cut_set_matches_jax_class_conditional(setup):
    """With classes, JAX also cuts the label table ``(4, 256)`` along its
    columns; so does ``shard_params_tp`` (``label_emb``, dim 1), on every
    rank, and each rank keeps a (4, 128) slice."""
    want = jax_cut_set(setup["jcut_cond"])
    assert want == sorted(jax_cut_set(setup["jcut"]) + ["label_emb"])
    assert sorted(n for n, _ in ptensor.cut_layers(setup["unet_cond"])) == want
    for got in setup["two"].results("forward") + setup["four"].results("forward"):
        assert got["cond_cut"] == want
        assert got["cond_label_shape"] == [4, 128]


def test_rank_holds_its_slices(setup):
    """Each rank of model 2 holds every uncut parameter and half of each cut
    one (0.60 of the miniature's bytes; 0.5007 of the chairs UNet's, where
    158 of 159 weighted layers are cut)."""
    cut = sum(p.numel() for _, m in ptensor.cut_layers(setup["unet"]) for p in m.parameters())
    whole = sum(p.numel() for p in setup["unet"].parameters())
    for got in setup["two"].results("forward"):
        assert got["whole_bytes"] == 4 * whole
        assert got["bytes"] == 4 * (whole - cut // 2)


def test_shard_params_tp_one_rank_and_refusals():
    """A model axis of one rank is ``replicate`` (the module on the mesh's
    device, unchanged, uncut); a layer whose outputs the axis does not divide
    is named in the refusal, and nothing is cut then."""
    model = UNetModel(UNetConfig(**MINI))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mesh = pmesh.make_mesh(device="cpu")
    assert ptensor.shard_params_tp(model, mesh) is model and not ptensor.is_cut(model)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    odd = pmesh.DataMesh(rank=0, size=1, device=torch.device("cpu"), model=3)
    with pytest.raises(ValueError, match=r"time_embed\.0: 256 output features not divisible"):
        ptensor.shard_params_tp(model, odd)
    assert not ptensor.is_cut(model)


# ---------------------------------------------------------------------------
# forward, gradient, drag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks", [2, 4])
def test_cut_forward_matches_one_rank_and_jax(setup, ranks):
    """The cut forward (model 2; with 4 ranks each data index on two rows)
    against the one-rank forward (1e-5 relative) and JAX ``unet_apply`` on
    its ``shard_params_tp``-cut parameters (atol 1e-4), output and tap."""
    got = setup["two" if ranks == 2 else "four"].results("forward")
    want, feat = one_rank_forward(setup)
    x, t = jnp.asarray(setup["inputs"]["x"]), jnp.asarray(setup["inputs"]["t"])
    jout, jfeat = jax.jit(lambda p: unet_apply(setup["jcfg"], p, x, t, feat_layer=tp.FEAT_LAYER))(setup["jcut"])
    for g in got:
        assert g["shape"] == {"data": ranks // 2, "model": 2}
        assert rel_l2(g["out"], want.numpy()) <= FWD_TOL
        assert rel_l2(g["feat"], feat.numpy()) <= FWD_TOL
        np.testing.assert_allclose(g["out"], np.asarray(jout), atol=JAX_ATOL)
        np.testing.assert_allclose(g["feat"], np.asarray(jfeat), atol=JAX_ATOL)


@pytest.mark.parametrize("ranks", [2, 4])
def test_class_conditional_cut_forward_matches_one_rank_and_jax(setup, ranks):
    """The class-conditional miniature cut over model 2, its label rows
    gathered over the model axis, against the one-rank forward (1e-5
    relative) and JAX ``unet_apply`` on its cut parameters (atol 1e-4)."""
    got = setup["two" if ranks == 2 else "four"].results("forward")
    x, t, y = (setup["inputs"][k] for k in ("x", "t", "y"))
    with torch.no_grad():
        want, _ = setup["unet_cond"](torch.from_numpy(x), torch.from_numpy(t).long(), y=torch.from_numpy(y).long())
    jout, _ = jax.jit(lambda p: unet_apply(setup["jcfg_cond"], p, jnp.asarray(x), jnp.asarray(t),
                                           y=jnp.asarray(y)))(setup["jcut_cond"])
    for g in got:
        assert rel_l2(g["cond_out"], want.numpy()) <= FWD_TOL
        np.testing.assert_allclose(g["cond_out"], np.asarray(jout), atol=JAX_ATOL)


@pytest.mark.parametrize("remat", [False, True])
def test_guidance_gradient_matches_one_rank(setup, remat):
    """d/dx through the cut UNet, each rank's copy summed over the model
    axis (without that sum each rank holds a partial gradient); under remat
    the recompute re-issues the gathers in the same order on every rank."""
    got = setup["two"].results("drag")
    want = tp.guidance_grad(setup["unet"], setup["inputs"], remat)
    for g in got:
        assert rel_l2(g[f"grad_remat{int(remat)}"], want) <= GRAD_TOL


@pytest.mark.parametrize("remat", [False, True])
def test_drag_edit_matches_one_rank(setup, remat):
    """``update_latent_params``, a 2-step ``drag_edit`` with recorded
    noises and ``latent_inversion`` of its result on a ``DragEngine`` over
    the cut UNet: the edited latent, the per-step motion losses and the
    inverted latent against one rank's engine."""
    got = setup["two"].results("drag")
    want = tp.drag_runs(setup["unet"], setup["inputs"], remat)
    for g in got:
        run = g[f"drag_remat{int(remat)}"]
        for k in ("edited", "motion", "inverted"):
            assert rel_l2(run[k], want[k]) <= GRAD_TOL, k


# ---------------------------------------------------------------------------
# DDIM and the decode over data 2 x model 2
# ---------------------------------------------------------------------------


def test_ddim_and_batches_on_2d_mesh(setup):
    """DDIM-10, one trajectory per data index, and ``sample_batches`` (the
    odd batch on data index 0's ranks, then broadcast) against one rank,
    1e-6 per sample, on every rank."""
    got = setup["four"].results("sample_edit_2d")
    fn = per_sample(setup["unet"])
    shape = preset("tiny").latent_shape
    ddim = sample_sharded(make_schedule(100, "linear", "ddim10"), fn, pmesh.make_mesh(device="cpu"),
                          batch_size=2, latent_shape=shape, sampler="ddim",
                          x_T=torch.from_numpy(setup["inputs"]["x_T2"])).numpy()
    batches = sample_batches(make_schedule(100, "linear", "5"), fn, num_samples=3, batch_size=2,
                             latent_shape=shape, device="cpu", seed=5, sampler="ddpm")
    for g in got:
        for i in range(2):
            np.testing.assert_allclose(g["ddim"][i], ddim[i], atol=DDIM_TOL)
        assert g["batches"].shape == batches.shape
        np.testing.assert_allclose(g["batches"], batches, atol=DDIM_TOL)


def test_batched_inversion_and_drag_on_2d_mesh(setup):
    """``invert_batched`` and ``drag_edit_batched`` of 2 shapes over data 2
    x model 2 (one shape per data index, the cut UNet's gradient summed over
    each model axis) against one rank, 1e-5 relative, on every rank."""
    got = setup["four"].results("sample_edit_2d")
    want = tp.batched_edit_runs(setup["unet"], setup["inputs"])
    for g in got:
        for k in ("w", "edited"):
            assert rel_l2(g["edit"][k], want[k]) <= GRAD_TOL, k


def test_decode_on_2d_mesh_bit_equal(setup):
    """Each of 4 ranks decodes its [res/4, res, res] x-slab in row-major
    rank order; gathered, it equals ``decode_grid`` bit for bit, as do the
    whole grids of ``decode_grids_batched`` (one per rank)."""
    got = setup["four"].results("decode_2d")
    planes = torch.from_numpy(setup["inputs"]["planes"])
    kw = dict(res=RES, compute_dtype=torch.float32)
    grid = ttri.decode_grid(setup["gdec"], planes[0], **kw).numpy()
    grids = np.stack([ttri.decode_grid(setup["gdec"], p, **kw).numpy() for p in planes])
    for r, g in enumerate(got):
        assert g["slab"].shape == (RES // 4, RES, RES)
        np.testing.assert_array_equal(g["slab"], grid[r * RES // 4 : (r + 1) * RES // 4])
        np.testing.assert_array_equal(g["grid"], grid)
        np.testing.assert_array_equal(g["grids"], grids)


# ---------------------------------------------------------------------------
# the train step of a cut model
# ---------------------------------------------------------------------------


TRAIN_RESULTS = {}


def train_results(setup, ranks):
    """Each rank's ``train_tp`` result (rank 0's alone holds the gathered
    tensors), read once."""
    if ranks not in TRAIN_RESULTS:
        TRAIN_RESULTS[ranks] = setup["two" if ranks == 2 else "four"].results("train_tp")
    return TRAIN_RESULTS[ranks]


@pytest.mark.parametrize("ranks", [2, 4])
def test_cut_train_step_matches_jax(setup, ranks):
    """One step of the miniature cut over model 2 (4 ranks: data 2 x model
    2) with JAX's draws injected, against JAX's ``make_train_step`` on its
    cut parameters over ``make_mesh(ranks, model_parallel=2)``: loss, mse,
    vb and the one global norm at 1e-4 relative; the parameters, EMA and
    Adam moments after the step, gathered whole, at 1e-4 relative L2 per
    tensor against the larger of its norm and 1e-4 of its family's."""
    metrics, want = jax_cut_step(setup["train"], ranks)
    assert metrics["grad_norm"] > 1.0  # JAX's clip at 1.0 is engaged
    got = train_results(setup, ranks)
    for r in got:
        assert r["shape"] == {"data": ranks // 2, "model": 2}
        for k in ("loss", "mse", "vb", "grad_norm"):
            assert abs(r["jax_metrics"][k] - metrics[k]) <= TRAIN_JAX_TOL * abs(metrics[k]), k
    assert got[0]["jax_state"].keys() == want.keys()
    for fam in FAMILIES:
        assert worst_rel(got[0]["jax_state"], want, fam) <= TRAIN_JAX_TOL, fam


@pytest.mark.parametrize("ranks", [2, 4])
def test_cut_train_step_matches_one_rank_with_clip(setup, ranks):
    """With the clip at half the one-rank norm, so that a norm counted on
    this rank's slices alone would clip differently: the gathered clipped
    gradients at 1e-5 relative L2 per parameter (floor as above) and the
    metrics at 1e-5 relative, against the one-rank port step on the same
    weights and draws."""
    train = setup["train"]
    state = one_rank_train_state(train, train["clip"])
    metrics = one_rank_step(train, state)
    want = {f"g.{k}": p.grad.numpy() for k, p in state.model.named_parameters()}
    assert metrics["grad_norm"] == pytest.approx(2 * train["clip"], rel=1e-6)
    results = train_results(setup, ranks)
    got = {f"g.{k}": v for k, v in results[0]["clip_grads"].items()}
    assert got.keys() == want.keys()
    assert worst_rel(got, want, "g") <= TRAIN_RANKS_TOL
    for r in results:
        assert r["clip_metrics"] == pytest.approx(metrics, rel=TRAIN_RANKS_TOL)


@pytest.mark.parametrize("ranks", [2, 4])
def test_cut_train_ranks_stay_in_step(setup, ranks):
    """After two steps each whole parameter, its EMA and its moments are
    bit-equal across each model group, and every tensor (slice or whole)
    bit-equal across each data group."""
    got = train_results(setup, ranks)
    dims = got[0]["cut_dims"]
    whole = [k for k in got[0]["slices"] if dims[k.split(".", 1)[1]] is None]
    assert 0 < len(whole) < len(got[0]["slices"])
    for a in got:
        for b in got:
            if a["data_index"] == b["data_index"]:
                for k in whole:
                    np.testing.assert_array_equal(a["slices"][k], b["slices"][k], err_msg=k)
            if a["model_index"] == b["model_index"]:
                for k in a["slices"]:
                    np.testing.assert_array_equal(a["slices"][k], b["slices"][k], err_msg=k)
        assert a["step2_metrics"] == got[0]["step2_metrics"]


@pytest.mark.parametrize("ranks", [2, 4])
def test_cut_train_nan_guard_stops_every_rank(setup, ranks):
    """The last rank's output made NaN (its loss alone non-finite): no rank
    steps; every rank's parameters, EMA, moments and step are unchanged."""
    got = train_results(setup, ranks)
    assert np.isnan(got[-1]["nan_metrics"]["loss"])
    for r in got:
        assert r["nan_unchanged"]


def whole_blob(path):
    return load_params(str(path))


def blob_layout(tree, where=""):
    """Key paths, dtypes and shapes of an orbax checkpoint's leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in blob_layout(tree[k], f"{where}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in blob_layout(v, f"{where}/{i}")]
    return [(where, None if tree is None else (tree.dtype, tuple(tree.shape)))]


@pytest.mark.parametrize("ranks", [2, 4])
def test_cut_checkpoint_is_whole_and_resumes_on_one_rank(setup, ranks):
    """The cut loop's last checkpoint has the keys and shapes of a one-rank
    save; one rank loads it to the cut run's gathered state, bit for bit."""
    got = train_results(setup, ranks)[0]["loop"]["resumed"]
    path = setup["dir"] / ("two" if ranks == 2 else "four") / "loop_resumed" / "step_2"
    assert blob_layout(whole_blob(path)) == blob_layout(whole_blob(setup["train"]["whole_ckpt"]))
    state = load_train_state(str(path), one_rank_train_state(setup["train"], 1.0, small=True))
    assert state.step == 2
    mine = tp.train_tensors(state, gather=False)
    assert mine.keys() == got.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


@pytest.mark.parametrize("ranks", [2, 4])
def test_one_rank_checkpoint_resumes_cut(setup, ranks):
    """A one-rank checkpoint loaded into a cut state: each rank holds its
    slice of every cut tensor and every whole one, bit for bit."""
    whole = setup["train"]["_whole"]
    for r in train_results(setup, ranks):
        assert r["loaded_step"] == 1
        for k, v in r["loaded_slices"].items():
            dim = r["small_cut_dims"][k.split(".", 1)[1]]
            if dim is None:
                want = whole[k]
            else:
                per = whole[k].shape[dim] // 2
                want = np.take(whole[k], range(r["model_index"] * per, (r["model_index"] + 1) * per), axis=dim)
            np.testing.assert_array_equal(v, want, err_msg=k)


@pytest.mark.parametrize("ranks", [2, 4])
def test_cut_train_loop_resumes_exactly(setup, ranks):
    """``train(mesh=)`` on the cut model: 1 step, then a resume from its
    cut checkpoint to step 2, equals 2 uninterrupted steps bit for bit."""
    loop = train_results(setup, ranks)[0]["loop"]
    assert loop["straight_step"] == loop["resumed_step"] == 2
    for k, v in loop["straight"].items():
        np.testing.assert_array_equal(loop["resumed"][k], v, err_msg=k)


@pytest.mark.parametrize("ranks", [2, 4])
def test_cut_export_serves_the_gathered_ema(setup, ranks):
    """``export_model_dir`` of a cut state writes the whole EMA once;
    ``DragEngine.from_model_dir`` loads exactly it."""
    r = train_results(setup, ranks)[0]
    cfg = dataclasses.replace(preset("tiny"), unet=UNetConfig(**TP_SMALL))
    engine = DragEngine.from_model_dir(r["export_dir"], config=cfg, device="cpu")
    sd = engine.unet.state_dict()
    assert sd.keys() == r["ema_whole"].keys()
    for k, v in r["ema_whole"].items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


# ---------------------------------------------------------------------------
# cli.serve over ranks
# ---------------------------------------------------------------------------


def session_lines(text, out_dir):
    """The session's JSON lines without their timings, ``out_dir`` written
    as it was requested."""
    text = text.replace(str(out_dir), "{out}")
    return [{k: v for k, v in json.loads(line).items() if k not in TIMING} for line in text.splitlines()]


def test_serve_loop_over_ranks_matches_one_rank(setup, tmp_path):
    """Rank 0's session over 2 ranks equals the one-rank session apart from
    timings: the generate sampled over the data axis, written and decoded
    on rank 0 (the triplanes equal to 1e-6), a generate refused on every
    rank and one failing on rank 0 alone after the sampling (both ``ok``
    false, and no rank left waiting), then commands on rank 0 alone. The
    other rank prints nothing."""
    got = setup["two"].results("serve")
    out = io.StringIO()
    reqs = [json.dumps(r).replace("{out}", str(tmp_path / "served")) for r in SERVE]
    serve_loop(io.StringIO("\n".join(reqs) + "\n"), out, EditServer(device="cpu"))
    want = session_lines(out.getvalue(), tmp_path / "served")
    assert got[1] == ""
    lines = session_lines(got[0], setup["dir"] / "two" / "served")
    assert [line.get("cmd", line.get("event")) for line in lines] == [w.get("cmd", w.get("event")) for w in want]
    responses = [line for line in lines if "cmd" in line]
    assert [r["ok"] for r in responses] == [True, True, True, False, False, True, True, True, True]
    assert "num_samples must be >= 1" in responses[3]["error"]
    assert lines == want
    for i in range(2):
        name = os.path.join("served", "triplanes", f"{i}.npy")
        np.testing.assert_allclose(np.load(setup["dir"] / "two" / name), np.load(tmp_path / name), atol=DDIM_TOL)


def test_cli_serve_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    ishapediting_tpu_torch.cli.serve`` with the requests piped to the
    launcher's stdin: one answer per request, all ok, from rank 0 alone."""
    reqs = [{"cmd": "init_random", "preset": "tiny", "seed": 1},
            {"cmd": "generate", "num_samples": 2, "batch_size": 2, "sampler": "ddim", "num_steps": 2,
             "out_dir": str(tmp_path / "g")},
            {"cmd": "status"}, {"cmd": "quit"}]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "ishapediting_tpu_torch.cli.serve", "--device", "cpu", "--dist_backend", "gloo"],
        input="".join(json.dumps(r) + "\n" for r in reqs), capture_output=True, text=True, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    responses = [line for line in lines if "cmd" in line]
    assert [r["cmd"] for r in responses] == [r["cmd"] for r in reqs]
    assert all(r["ok"] for r in responses), responses
    assert len(lines) == len(responses) + 1  # the one gen_batch event
    assert sorted(os.listdir(tmp_path / "g" / "triplanes")) == ["0.npy", "1.npy"]
