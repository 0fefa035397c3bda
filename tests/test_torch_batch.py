"""Port parity, batched editing and activation recomputation on
``preset("tiny")``: ``invert_batched`` and ``drag_edit_batched`` (all three
noise modes, fast ``edit_positions``, per-shape scale and cof) against the
JAX package's vmapped programs with JAX's draws injected; a batch of N equal
to N single-shape ``make_drag_step`` walks; ``fit_real_shapes_batched``;
the argument checks of ``edit/batch.py``; ``remat`` (outputs, gradients and
the recomputed kernel calls) against the plain forward; and
``cli.batch_edit``.

Tolerances: inversion records atol 1e-4; batched drags against JAX atol
1e-3 (six guided steps after an inversion, as the single-shape engine's
test); a batch of N against N single walks atol 3e-4 and relative L2 5e-5
(the CPU convolutions' reduction order depends on the batch size: 7e-6
unguided, and the guidance gradient jumps where an element of pred_x0 sits
on the clip at +-1); the batched fit atol 1e-3 (three guided steps from
pred_x0 clipped the same way, with the guidance itself moving the latents
by over 1e-2); remat against plain: outputs equal, gradients within 1e-6 of
their largest magnitude (the backward sums a reused tensor's gradients in
another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu.cli import edit as jcli_edit
from ishapediting_tpu.config import FitConfig as JFitConfig
from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.core.schedule import fast_edit_schedule as j_fast_edit_schedule
from ishapediting_tpu.core.schedule import named_beta_schedule as j_named_betas
from ishapediting_tpu.edit import batch as jbatch
from ishapediting_tpu.edit.engine import DragEngine as JDragEngine
from ishapediting_tpu.geometry.mesh import TriMesh as JTriMesh
from ishapediting_tpu_torch.cli import batch_edit as tcli_batch
from ishapediting_tpu_torch.cli.edit import parse_edit_log, write_edit_log
from ishapediting_tpu_torch.config import FitConfig, preset
from ishapediting_tpu_torch.edit import batch as tbatch
from ishapediting_tpu_torch.edit import drag as tdrag
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from ishapediting_tpu_torch.models import unet as tunet
from torch_parity_helpers import decoder_pair, to_torch, unet_pair

torch.set_num_threads(2)

CFG = preset("tiny")
W_TIME = CFG.edit.w_time
N = 2
SRC = [np.array([[0.3, 0.1, -0.2]], np.float32), np.array([[-0.2, 0.3, 0.1], [0.1, -0.3, 0.2]], np.float32)]
TGT = [s + np.array([0.2, 0.0, 0.05], np.float32) for s in SRC]
SCALE, COF = [40.0, 60.0], [0.3, 0.1]


@pytest.fixture(scope="module")
def pair():
    jcfg, jparams, unet = unet_pair(dict(vars(CFG.unet)), seed=61)
    jdec, tdec = decoder_pair(CFG.plane_channels, seed=62)
    jeng = JDragEngine(jpreset("tiny"), unet_params=jparams, decoder_params=jdec)
    teng = DragEngine(CFG, unet=unet, decoder=tdec, device="cpu")
    return jeng, teng


def shape_noises(rng, n_steps, ts):
    """JAX's per-shape draws of a batched drag: shape i at step t takes
    ``normal(fold_in(split(rng, n)[i], t), [1, H, W, C])``; as [steps, N,
    H, W, C] in loop order."""
    keys = jax.random.split(rng, N)
    return np.stack([
        np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(k, int(t)), (1,) + CFG.latent_shape))
                        for k in keys])
        for t in ts
    ])


@pytest.fixture(scope="module")
def inverted(pair):
    """Both packages' batched inversions of the same two latents (JAX's
    forward noises injected), held to each other."""
    jeng, teng = pair
    lat = np.random.default_rng(3).uniform(-0.8, 0.8, (N,) + CFG.latent_shape).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    want = jbatch.invert_batched(jeng.sched, jeng.model_fn_p(feat=True), jeng.unet_params,
                                 jnp.asarray(lat), rng, w_time=W_TIME)
    noises = [np.asarray(jax.random.normal(jax.random.fold_in(rng, t), lat.shape)) for t in range(W_TIME)]
    got = tbatch.invert_batched(teng.sched, teng.model_fn(feat=True), to_torch(lat), w_time=W_TIME,
                                noises=noises)
    for k in ("w", "features", "variances", "variance_noise", "sample"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["sample"].numpy(), lat)
    return want, got


def problems(pkg):
    kw = dict(r1=CFG.edit.r1, voxel_size=CFG.edit.voxel_size, feat_width=16)
    return (jbatch if pkg == "jax" else tbatch).build_batched_problems(SRC, TGT, **kw)


@pytest.mark.parametrize("mode", ["resample", "fixed_variance", "replay", "fast"])
def test_drag_edit_batched_matches_jax(pair, inverted, mode):
    jeng, teng = pair
    jinv, tinv = inverted
    rng = jax.random.PRNGKey(11)
    sched_j, sched_t, positions, noise_mode = jeng.sched, teng.sched, None, mode
    n_steps = W_TIME
    if mode == "fast":
        n_steps, noise_mode = 3, "resample"
        sched_j, positions = j_fast_edit_schedule(jeng.sched, j_named_betas("linear", 100), W_TIME, n_steps)
        sched_t, tpos = teng._fast_edit_schedule(n_steps)
        np.testing.assert_array_equal(tpos, positions)
    rec = noise_mode != "resample"
    want = jbatch.drag_edit_batched(
        sched_j, jeng.model_fn_p(feat=True), jeng.unet_params, jinv["w"], jinv["features"],
        problems("jax"), rng, w_time=W_TIME, scale=np.asarray(SCALE), cof=np.asarray(COF),
        noise_mode=noise_mode, variances_batch=jinv["variances"] if rec else None,
        variance_noise_batch=jinv["variance_noise"] if rec else None, edit_positions=positions)
    got = tbatch.drag_edit_batched(
        sched_t, teng.model_fn(feat=True), tinv["w"], tinv["features"], problems("torch"),
        w_time=W_TIME, scale=SCALE, cof=COF, noise_mode=noise_mode,
        variances_batch=tinv["variances"] if rec else None,
        variance_noise_batch=tinv["variance_noise"] if rec else None, edit_positions=positions,
        noises=None if mode == "replay" else shape_noises(rng, n_steps, range(n_steps - 1, -1, -1)))
    assert got.shape == (N, 1) + CFG.latent_shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    # the guidance moved both shapes
    base = tbatch.drag_edit_batched(
        sched_t, teng.model_fn(feat=True), tinv["w"], tinv["features"], problems("torch"),
        w_time=W_TIME, scale=0.0, cof=COF, noise_mode=noise_mode,
        variances_batch=tinv["variances"] if rec else None,
        variance_noise_batch=tinv["variance_noise"] if rec else None, edit_positions=positions,
        noises=None if mode == "replay" else shape_noises(rng, n_steps, range(n_steps - 1, -1, -1)))
    assert float((got - base).abs().amax(dim=(1, 2, 3, 4)).min()) > 1e-2


@pytest.mark.parametrize("remat", [False, True])
def test_batch_equals_single_shape_walks(pair, inverted, remat):
    """A batch-2 drag (one batch-2 forward per step, the losses summed)
    equals two single-shape ``make_drag_step`` walks, each at its own scale,
    cof and handles, with the same noises; with and without remat."""
    _, teng = pair
    _, tinv = inverted
    noises = np.random.default_rng(5).normal(size=(W_TIME, N) + CFG.latent_shape).astype(np.float32)
    got = tbatch.drag_edit_batched(
        teng.sched, teng.model_fn(feat=True, remat=remat), tinv["w"], tinv["features"], problems("torch"),
        w_time=W_TIME, scale=SCALE, cof=COF, noise_mode="fixed_variance", variances_batch=tinv["variances"],
        variance_noise_batch=tinv["variance_noise"], noises=noises)
    for i in range(N):
        prob = tdrag.build_drag_problem(SRC[i], TGT[i], r1=CFG.edit.r1, voxel_size=CFG.edit.voxel_size,
                                        feat_width=16)
        step = tdrag.make_drag_step(teng.sched, teng.model_fn(feat=True), prob, scale=SCALE[i], cof=COF[i])
        img = tinv["w"][i]
        for j, t in enumerate(range(W_TIME - 1, -1, -1)):
            img, _ = step(img, t, tinv["features"][i, j], noise=to_torch(noises[j, i][None]),
                          variance_override=tinv["variances"][i, j])
        np.testing.assert_allclose(got[i].numpy(), img.numpy(), atol=3e-4)
        assert float((got[i] - img).norm() / img.norm()) < 5e-5


def test_drag_edit_batched_generators(pair, inverted):
    """One generator per shape: shape i's draws are those of its own
    generator, whatever the other shapes do."""
    _, teng = pair
    _, tinv = inverted
    kw = dict(w_time=W_TIME, scale=SCALE, cof=COF)
    gens = lambda: [torch.Generator().manual_seed(s) for s in (4, 9)]  # noqa: E731
    got = tbatch.drag_edit_batched(teng.sched, teng.model_fn(feat=True), tinv["w"], tinv["features"],
                                   problems("torch"), gens(), **kw)
    g = gens()
    noises = np.stack([np.concatenate([torch.randn((1,) + CFG.latent_shape, generator=gi).numpy() for gi in g])
                       for _ in range(W_TIME)])
    want = tbatch.drag_edit_batched(teng.sched, teng.model_fn(feat=True), tinv["w"], tinv["features"],
                                    problems("torch"), noises=noises, **kw)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_drag_edit_batched_refusals(pair, inverted):
    """The argument checks of the JAX package's ``drag_edit_batched``."""
    _, teng = pair
    _, tinv = inverted
    mf, p = teng.model_fn(feat=True), problems("torch")
    kw = dict(w_time=W_TIME, scale=1.0, cof=0.2)
    recs = dict(variances_batch=tinv["variances"], variance_noise_batch=tinv["variance_noise"])
    gens = [torch.Generator() for _ in range(N)]
    with pytest.raises(ValueError, match="unknown noise_mode"):
        tbatch.drag_edit_batched(teng.sched, mf, tinv["w"], tinv["features"], p, gens, noise_mode="x", **kw)
    with pytest.raises(ValueError, match="rows but w_time"):
        tbatch.drag_edit_batched(teng.sched, mf, tinv["w"], tinv["features"][:, :4], p, gens, **kw)
    with pytest.raises(ValueError, match="w_time=11"):
        tbatch.drag_edit_batched(teng.sched, mf, tinv["w"], tinv["features"].repeat(1, 2, 1, 1, 1, 1)[:, :11],
                                 p, gens, **{**kw, "w_time": 11})
    with pytest.raises(ValueError, match="edit_positions must lie"):
        tbatch.drag_edit_batched(teng.sched, mf, tinv["w"], tinv["features"], p, gens,
                                 edit_positions=np.array([0, 6]), **kw)
    with pytest.raises(ValueError, match="resample' only"):
        tbatch.drag_edit_batched(teng.sched, mf, tinv["w"], tinv["features"], p, gens, noise_mode="replay",
                                 edit_positions=np.array([0, 3]), **recs, **kw)
    with pytest.raises(ValueError, match="needs variances_batch"):
        tbatch.drag_edit_batched(teng.sched, mf, tinv["w"], tinv["features"], p, gens, noise_mode="replay",
                                 **kw)
    with pytest.raises(ValueError, match="generators"):
        tbatch.drag_edit_batched(teng.sched, mf, tinv["w"], tinv["features"], p, gens[:1], **kw)
    one = tdrag.build_drag_problem(SRC[0], TGT[0], r1=2, voxel_size=0.1, feat_width=16)
    two = tdrag.build_drag_problem(SRC[1], TGT[1], r1=2, voxel_size=0.1, feat_width=16)
    with pytest.raises(ValueError, match="one handle count"):
        tbatch.stack_problems([one, two])


def test_build_batched_problems_matches_jax():
    j, t = problems("jax"), problems("torch")
    assert t.patch_grid.shape[:3] == (N, 3, 2)  # padded to two handles
    for a, b in zip(t, j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def sphere(r, c=(0.0, 0.0, 0.0), res=24):
    x = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return grid_to_mesh((r - np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)).astype(np.float32))


def test_fit_real_shapes_batched_matches_jax(pair):
    """Two meshes, three guided steps at scale 1 (see test_torch_fit for
    why not the product's 600), JAX's x_T, step noises and point batches
    injected: latents atol 1e-3, the guidance moves them by over 1e-2, and
    the shapes fit apart."""
    jeng, teng = pair
    js, ts = jeng._fit_schedule(3), teng._fit_schedule(3)
    fkw = dict(points_size=2000, batch_points=400, grad_scale=1.0)
    meshes = [sphere(0.5), sphere(0.4, (0.1, -0.1, 0.0))]
    jmeshes = [JTriMesh(m.vertices.copy(), m.triangles.copy()) for m in meshes]
    rng = jax.random.PRNGKey(13)
    want = jbatch.fit_real_shapes_batched(
        js, jeng.model_fn_p(feat=False), jeng.unet_params, jeng.decoder_params, jmeshes, jeng.half_range,
        jeng.middle, rng, latent_shape=CFG.latent_shape, fit_cfg=JFitConfig(**fkw), seed=2)
    loop_rng, init_rng = jax.random.split(rng)
    x_T = np.asarray(jax.random.normal(init_rng, (N,) + CFG.latent_shape))
    noises, batches = [], []
    for t in range(2, -1, -1):
        r_noise, r_batch = jax.random.split(jax.random.fold_in(loop_rng, t))
        batches.append(np.asarray(jax.random.randint(r_batch, (N, 400), 0, 2000)))
        noises.append(np.asarray(jax.random.normal(r_noise, (N,) + CFG.latent_shape)))
    def fit(scale):
        return tbatch.fit_real_shapes_batched(
            ts, teng.model_fn(), teng.decoder, meshes, teng.half_range, teng.middle,
            latent_shape=CFG.latent_shape, fit_cfg=FitConfig(**{**fkw, "grad_scale": scale}), seed=2,
            x_T=to_torch(x_T), noises=noises, batch_indices=batches)

    got = fit(1.0)
    assert got.shape == (N,) + CFG.latent_shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert float((got - fit(0.0)).abs().max()) > 1e-2
    assert float((got[0] - got[1]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def counting(monkeypatch):
    calls = {"gn": 0, "attn": 0}
    gn, attn = tunet.group_norm_silu, tunet.qkv_attention

    def gn_count(*a, **k):
        calls["gn"] += 1
        return gn(*a, **k)

    def attn_count(*a, **k):
        calls["attn"] += 1
        return attn(*a, **k)

    monkeypatch.setattr(tunet, "group_norm_silu", gn_count)
    monkeypatch.setattr(tunet, "qkv_attention", attn_count)
    return calls


@pytest.mark.parametrize("through", ["feature", "output"])
def test_remat_matches_plain_and_recomputes_the_reached_blocks(pair, monkeypatch, through):
    """The UNet with ``remat`` gives the plain forward's output and feature
    and ``autograd.grad``; its backward runs the kernel calls of the blocks
    the loss reaches a second time: through the feature tap (a drag step)
    every input and middle block and output blocks 0..feat_layer, through
    the output (a fit step) every block."""
    _, teng = pair
    unet = teng.unet
    rng = np.random.default_rng(8)
    x = to_torch(rng.normal(size=(2,) + CFG.latent_shape))
    t = torch.tensor([3, 70])
    feat_layer = CFG.edit.feat_layer
    calls = counting(monkeypatch)
    per_fwd = tunet.kernel_calls_per_forward(CFG.unet)
    r = None
    results = {}
    for remat in (False, True):
        xx = x.clone().requires_grad_(True)
        calls.update(gn=0, attn=0)
        with torch.enable_grad():
            out, feat = unet(xx, t, feat_layer=feat_layer, remat=remat)
            assert (calls["gn"], calls["attn"]) == per_fwd
            reached = feat if through == "feature" else out
            if r is None:
                r = to_torch(rng.normal(size=reached.shape))
            (g,) = torch.autograd.grad((reached * r).sum(), xx)
        results[remat] = (out.detach(), feat.detach(), g, (calls["gn"], calls["attn"]))
    plain, rem = results[False], results[True]
    torch.testing.assert_close(rem[0], plain[0], atol=0, rtol=0)
    torch.testing.assert_close(rem[1], plain[1], atol=0, rtol=0)
    torch.testing.assert_close(rem[2], plain[2], atol=1e-6 * float(plain[2].abs().max()), rtol=0)
    assert plain[3] == per_fwd  # the plain backward calls nothing
    again = tunet.kernel_calls_recomputed(CFG.unet, feat_layer, head=through == "output")
    assert rem[3] == (per_fwd[0] + again[0], per_fwd[1] + again[1])
    assert 0 < again[0] < per_fwd[0] if through == "feature" else again[0] == per_fwd[0] - 1


def test_engine_remat_drag_equals_plain(pair):
    """The engine's drag with ``remat=True`` equals the one without, the
    same weights, state and noises."""
    _, teng = pair
    rem = DragEngine(CFG, unet=teng.unet, decoder=teng.decoder, device="cpu", remat=True)
    x_T = np.random.default_rng(9).normal(size=(1,) + CFG.latent_shape).astype(np.float32)
    noises = [np.random.default_rng(10 + i).normal(size=(1,) + CFG.latent_shape).astype(np.float32)
              for i in range(10)]
    out = []
    for eng in (teng, rem):
        eng.update_latent_params(latent=x_T, noises=noises)
        eng.drag_edit(SRC[0], TGT[0], scale=40.0, cof=0.3, noises=noises[:W_TIME])
        out.append(eng.edited_latent)
    np.testing.assert_allclose(out[1], out[0], atol=1e-6)


# ---------------------------------------------------------------------------
# cli.batch_edit
# ---------------------------------------------------------------------------


def test_cli_batch_edit_generated_writes_what_jax_writes(tmp_path):
    """The files of the JAX package's CLI (its tests/test_batch_cli.py), the
    EditLog byte-equal to what its ``write_edit_log`` writes for the same
    edits."""
    argv = ["--random_init", "--preset", "tiny", "--latent_seed", "1", "--latent_seed", "2",
            "--source", "0.2", "0", "0", "--target", "0.4", "0", "0", "--scale", "30",
            "--noise_mode", "replay"]
    res = tcli_batch.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "t")) == ["EditLog", "edit01.obj", "edit02.obj", "original01.obj",
                                                  "original02.obj"]
    for name in ("original01.obj", "original02.obj", "edit01.obj", "edit02.obj"):
        assert os.path.getsize(tmp_path / "t" / name) > 0, name
    for i in ("01", "02"):
        jcli_edit.write_edit_log(str(tmp_path / "j"), i, np.array([[0.2, 0.0, 0.0]], np.float32),
                                 np.array([[0.4, 0.0, 0.0]], np.float32), 30.0, 0.2)
    assert (tmp_path / "t" / "EditLog").read_bytes() == (tmp_path / "j").read_bytes()
    assert res["edited"].shape == (2, 1) + CFG.latent_shape and res["noise_mode"] == "replay"
    assert not res["remat"] and res["inversion"]["features"].shape[:2] == (2, W_TIME)


def test_cli_batch_edit_fast_edit_and_remat(tmp_path, capsys):
    res = tcli_batch.main(["--random_init", "--preset", "tiny", "--latent_seed", "1", "--source", "0.2", "0",
                           "0", "--target", "0.4", "0", "0", "--edit_steps", "3", "--remat", "on",
                           "--feat_dtype", "bfloat16", "--out", str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "fast editing: 3 of" in text and "resample" in text and "remat=on" in text
    assert res["remat"] and res["inversion"]["features"].dtype == torch.bfloat16
    assert os.path.getsize(tmp_path / "edit01.obj") > 0


def test_cli_batch_edit_meshes_and_edit_log(tmp_path, capsys):
    """Real meshes with a fast fit and per-shape edits from an EditLog."""
    paths = []
    for i, m in enumerate([sphere(0.5), sphere(0.45, (0.1, 0.0, 0.0))]):
        paths.append(str(tmp_path / f"m{i}.obj"))
        m.write(paths[-1])
    log = str(tmp_path / "EditLog")
    write_edit_log(log, "01", SRC[0], TGT[0], 30.0, 0.2)
    write_edit_log(log, "02", SRC[1], TGT[1], 50.0, 0.4)
    out = tmp_path / "out"
    res = tcli_batch.main(["--random_init", "--preset", "tiny", "--mesh", paths[0], "--mesh", paths[1],
                           "--edit_log", log, "--fit_steps", "3", "--out", str(out), "--device", "cpu"])
    assert "fast fitting: 3 of" in capsys.readouterr().out
    got = parse_edit_log(str(out / "EditLog"))
    assert [got[k]["scale"] for k in ("01", "02")] == [30.0, 50.0]
    np.testing.assert_allclose(got["02"]["targets"], TGT[1])
    assert res["latents"].shape == (2,) + CFG.latent_shape and os.path.getsize(out / "edit02.obj") > 0


def test_cli_batch_edit_refusals(tmp_path):
    base = ["--random_init", "--preset", "tiny", "--out", str(tmp_path), "--device", "cpu"]
    for bad in ([], ["--latent_seed", "1"], ["--latent_seed", "1", "--mesh", "x.obj", "--source", "0", "0",
                                                "0", "--target", "0", "0", "0"]):
        with pytest.raises(SystemExit):
            tcli_batch.main(base + bad)
    log = str(tmp_path / "EditLog")
    write_edit_log(log, "01", SRC[0], TGT[0], 30.0, 0.2)
    with pytest.raises(SystemExit, match="1 edits for 2 shapes"):
        tcli_batch.main(base + ["--latent_seed", "1", "--latent_seed", "2", "--edit_log", log])
