"""Port parity, the model axis and serving over ranks:
``parallel/mesh.py::make_mesh(model_parallel=)``,
``parallel/tensor.py::shard_params_tp``, the cut UNet's forward
(``models/unet.py::dense``) and guidance gradient, the drag, DDIM and the
occupancy decode over a ``data`` x ``model`` mesh, and ``cli.serve`` over
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
"""

import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_tp_workers as tp
from ishapediting_tpu.models.unet import unet_apply
from ishapediting_tpu.parallel.mesh import make_mesh as jmake_mesh
from ishapediting_tpu.parallel.mesh import shard_params_tp as jshard_params_tp
from ishapediting_tpu_torch.cli.serve import EditServer, serve_loop
from ishapediting_tpu_torch.config import UNetConfig, preset
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.ops import triplane as ttri
from ishapediting_tpu_torch.parallel import mesh as pmesh
from ishapediting_tpu_torch.parallel import tensor as ptensor
from ishapediting_tpu_torch.parallel.sampling import sample_batches, sample_sharded
from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step
from tests.test_torch_parallel import Spawn, rel_l2
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
    data 2 x model 2) and the JAX package's cut parameters."""
    d = tmp_path_factory.mktemp("tp")
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
        planes=rng.normal(size=(4, 3, 8, 8, 8)).astype(np.float32), res=RES, serve=SERVE)
    path = d / "inputs.pt"
    torch.save(inputs, path)
    two = Spawn(2, ["forward", "drag", "serve"], path, d / "two", table=tp.TASKS)
    four = Spawn(4, ["mesh_layout", "forward", "sample_edit_2d", "decode_2d"], path, d / "four", table=tp.TASKS)
    jmesh = jmake_mesh(8, model_parallel=2)
    jcut = jshard_params_tp(jparams, jmesh)
    jcut_cond = jshard_params_tp(jparams_cond, jmesh)
    return dict(dir=d, inputs=inputs, two=two, four=four, jcfg=jcfg, jcut=jcut, unet=unet, gdec=gdec,
                jcfg_cond=jcfg_cond, jcut_cond=jcut_cond, unet_cond=unet_cond)


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


def test_train_step_refuses_a_cut_model():
    """The train step under the model axis is not ported: a cut model and a
    mesh with a model axis are refused."""
    model = UNetModel(UNetConfig(**MINI))
    layer = dict(ptensor.cut_layers(model))["input_blocks.4.0.emb_layers.1"]
    layer.model_axis = ptensor.ModelAxis(group=None, size=2, index=0)
    with pytest.raises(NotImplementedError, match="model axis"):
        init_train_state(model, make_optimizer(model.parameters()))
    mesh = pmesh.DataMesh(rank=0, size=1, device=torch.device("cpu"), model=2)
    with pytest.raises(NotImplementedError, match="model axis"):
        make_train_step(UNetConfig(**MINI), make_schedule(100, "linear", ""), mesh=mesh)


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
