"""Port parity, the editing path on ``preset("tiny")``: the drag geometry
(bit-equal), ``drag_losses``, one ``make_drag_step`` (sample and gradient),
``fast_edit_schedule`` (bit-equal), ``ddpm_inversion`` (and its independence
of ``inversion_chunk``), ``DragEngine.drag_edit`` in every noise mode, fast
and stopped, against the JAX engine from the same x_T, weights and noises,
and the edit gate (``tests/assets/edit_gate.npz``) on the CPU.

Every stochastic step of the port takes JAX's own draw, injected. Tolerances:
latents, features and variances atol 1e-4 (fp32, 2 threads); per-step
losses rtol 1e-4; gradients 1e-4 of their largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.core import diffusion as jdiff
from ishapediting_tpu.core.schedule import fast_edit_schedule as j_fast_edit_schedule
from ishapediting_tpu.core.schedule import make_schedule as j_make_schedule
from ishapediting_tpu.core.schedule import named_beta_schedule as j_named_betas
from ishapediting_tpu.edit import drag as jdrag
from ishapediting_tpu.edit import features as jfeat
from ishapediting_tpu.edit.engine import DragEngine as JDragEngine
from ishapediting_tpu_torch.config import preset, with_feat_store_dtype
from ishapediting_tpu_torch.core import diffusion as tdiff
from ishapediting_tpu_torch.core.schedule import fast_edit_schedule, make_schedule, named_beta_schedule
from ishapediting_tpu_torch.edit import drag as tdrag
from ishapediting_tpu_torch.edit import features as tfeat
from ishapediting_tpu_torch.edit.engine import DragEngine
from torch_parity_helpers import decoder_pair, jax_step_noises, to_torch, unet_pair

torch.set_num_threads(2)

CFG = preset("tiny")
SHAPE = (1,) + CFG.latent_shape
ATOL = 1e-4


def chamfer(a, b):
    return cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean()


def fold_noises(seed, ts, shape=SHAPE):
    """JAX's draws ``normal(fold_in(PRNGKey(seed), t))`` for each t."""
    key = jax.random.PRNGKey(seed)
    return [np.array(jax.random.normal(jax.random.fold_in(key, int(t)), shape, jnp.float32)) for t in ts]


# ---------------------------------------------------------------------------
# geometry, losses, one step
# ---------------------------------------------------------------------------


def handles():
    rng = np.random.default_rng(3)
    src = rng.uniform(-0.6, 0.6, (2, 3)).astype(np.float32)
    return src, src + np.array([0.2, -0.1, 0.05], np.float32)


def test_feature_helpers_bit_equal():
    src, tgt = handles()
    np.testing.assert_array_equal(tfeat.make_offsets(3), jfeat.make_offsets(3))
    p_t = tfeat.neighborhood_points(src, 2, 2.0 / 32)
    p_j = jfeat.neighborhood_points(src, 2, 2.0 / 32)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(tfeat.plane_grids(p_t), jfeat.plane_grids(p_j))
    s_t = tfeat.neighborhood_points(tgt, 2, 2.0 / 32)
    m_t, c_t = tfeat.complement_masks(p_t, s_t, 16)
    m_j, c_j = jfeat.complement_masks(p_j, jfeat.neighborhood_points(tgt, 2, 2.0 / 32), 16)
    np.testing.assert_array_equal(m_t, m_j)
    assert c_t == c_j and 0 < c_t < 3 * 16 * 16
    tp = tdrag.build_drag_problem(src, tgt, r1=2, voxel_size=2.0 / 32, feat_width=16)
    jp = jdrag.build_drag_problem(src, tgt, r1=2, voxel_size=2.0 / 32, feat_width=16)
    for a, b in zip(tp[:3], jp[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tp.mask_count == float(jp.mask_count)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_drag_losses_match_jax(loss_type):
    src, tgt = handles()
    rng = np.random.default_rng(4)
    edit = rng.normal(size=(3, 16, 16, 10)).astype(np.float32)
    origin = rng.normal(size=(3, 16, 16, 10)).astype(np.float32)
    tp = tdrag.build_drag_problem(src, tgt, r1=2, voxel_size=2.0 / 32, feat_width=16)
    jp = jdrag.build_drag_problem(src, tgt, r1=2, voxel_size=2.0 / 32, feat_width=16)
    got = tdrag.drag_losses(to_torch(edit), to_torch(origin), tp, loss_type)
    want = jdrag.drag_losses(jnp.asarray(edit), jnp.asarray(origin), jp, loss_type)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-6)


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port engine on the tiny preset with the same weights."""
    jcfg, jparams, unet = unet_pair(dict(vars(CFG.unet)), seed=31)
    jdec, tdec = decoder_pair(CFG.plane_channels, seed=32)
    jeng = JDragEngine(jpreset("tiny"), unet_params=jparams, decoder_params=jdec)
    teng = DragEngine(CFG, unet=unet, decoder=tdec, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("mode", ["resample", "fixed_variance", "replay"])
def test_make_drag_step_matches_jax(pair, mode):
    """One guided step at scale 0 (the sample) and scale 300 (sample +
    variance * scale * grad), and the gradient itself against
    ``jax.value_and_grad`` of the same loss, with the same noise."""
    jeng, teng = pair
    rng = np.random.default_rng(5)
    img = rng.normal(size=SHAPE).astype(np.float32)
    origin = rng.normal(size=(3, 16, 16, 10)).astype(np.float32)
    var = np.abs(rng.normal(size=SHAPE)).astype(np.float32) * 0.01
    vn = rng.normal(size=SHAPE).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    src, tgt = handles()
    tp = tdrag.build_drag_problem(src, tgt, r1=2, voxel_size=2.0 / 32, feat_width=16)
    jp = jdrag.build_drag_problem(src, tgt, r1=2, voxel_size=2.0 / 32, feat_width=16)
    jkw = {"variance_override": jnp.asarray(var)} if mode == "fixed_variance" else (
        {"variance_noise": jnp.asarray(vn)} if mode == "replay" else {})
    tkw = {"variance_override": to_torch(var)} if mode == "fixed_variance" else (
        {"variance_noise": to_torch(vn)} if mode == "replay" else {})
    t = 4
    for scale in (0.0, 300.0):
        jstep = jdrag.make_drag_step(jeng.sched, jeng._model_fn(feat=True), jp, scale=scale, cof=0.3)
        tstep = tdrag.make_drag_step(teng.sched, teng.model_fn(feat=True), tp, scale=scale, cof=0.3)
        want, (jm, jk) = jstep(jnp.asarray(img), t, jnp.asarray(origin), key, **jkw)
        got, (tm, tk) = tstep(to_torch(img), t, to_torch(origin), noise=to_torch(noise), **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert float(tm) == pytest.approx(float(jm), rel=1e-4)
        assert float(tk) == pytest.approx(float(jk), rel=1e-4)

    def jloss(im):
        tb = jnp.full((1,), t, jnp.int32)
        out = jdiff.p_sample_guidance(jeng.sched, jeng._model_fn(feat=True), im, tb, key, **{
            k.replace("variance_override", "variance"): v for k, v in jkw.items()})
        motion, mask = jdrag.drag_losses(jfeat.regroup_features(out["inter_feat"])[0],
                                         jnp.asarray(origin), jp)
        return -motion - 0.3 * mask

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(img))
    im = to_torch(img).requires_grad_(True)
    out = tdiff.p_sample_guidance(teng.sched, teng.model_fn(feat=True), im, torch.full((1,), t),
                                  noise=to_torch(noise), **{
                                      k.replace("variance_override", "variance"): v
                                      for k, v in tkw.items()})
    motion, mask = tdrag.drag_losses(tfeat.regroup_features(out["inter_feat"])[0], to_torch(origin), tp)
    loss = -motion - 0.3 * mask
    (grad,) = torch.autograd.grad(loss, im)
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-4)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(grad.numpy(), jg, atol=1e-4 * np.abs(jg).max())


def test_drag_edit_scan_matches_jax(pair):
    """The whole guided loop as one call, three steps from a random latent
    with random cached features, JAX's per-step draws injected: the result
    to 1e-4."""
    jeng, teng = pair
    rng = np.random.default_rng(12)
    w = rng.normal(size=SHAPE).astype(np.float32)
    feats = rng.normal(size=(3, 3, 16, 16, 10)).astype(np.float32)
    src, tgt = handles()
    jp = jdrag.build_drag_problem(src, tgt, r1=2, voxel_size=2.0 / 32, feat_width=16)
    tp = tdrag.build_drag_problem(src, tgt, r1=2, voxel_size=2.0 / 32, feat_width=16)
    want = jdrag.drag_edit_scan(jeng.sched, jeng._model_fn(feat=True), jp, jnp.asarray(w),
                                jnp.asarray(feats), jax.random.PRNGKey(4), w_time=3, scale=40.0, cof=0.3)
    got = tdrag.drag_edit_scan(teng.sched, teng.model_fn(feat=True), tp, to_torch(w), to_torch(feats),
                               w_time=3, scale=40.0, cof=0.3, noises=fold_noises(4, [2, 1, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("w_time,count", [(6, 3), (6, 5), (170, 120), (170, 2)])
def test_fast_edit_schedule_bit_equal(w_time, count):
    respacing = "10" if w_time == 6 else "200"
    base = 100 if w_time == 6 else 1000
    j_sched, j_pos = j_fast_edit_schedule(
        j_make_schedule(base, "linear", respacing), j_named_betas("linear", base), w_time, count)
    t_sched, t_pos = fast_edit_schedule(
        make_schedule(base, "linear", respacing), named_beta_schedule("linear", base), w_time, count)
    np.testing.assert_array_equal(t_pos, j_pos)
    assert t_sched.num_timesteps == j_sched.num_timesteps
    np.testing.assert_array_equal(t_sched.timestep_map.numpy(), np.asarray(j_sched.timestep_map))
    for f in ("betas", "alphas_cumprod", "posterior_variance", "posterior_mean_coef1",
              "posterior_mean_coef2", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(t_sched, f).numpy(), np.asarray(getattr(j_sched, f)), f)
    with pytest.raises(ValueError, match="edit_steps"):
        fast_edit_schedule(make_schedule(base, "linear", respacing),
                           named_beta_schedule("linear", base), w_time, w_time)


# ---------------------------------------------------------------------------
# inversion
# ---------------------------------------------------------------------------


def _inversion(fn_pair, x0, chunk, steps=6):
    jeng, teng = fn_pair
    rng = jax.random.PRNGKey(7)
    want = jdiff.ddpm_inversion(jeng.sched, jeng._model_fn(feat=True), jnp.asarray(x0), rng,
                                steps=steps, feat_postprocess=jfeat.regroup_features, chunk=chunk)
    noises = [np.array(jax.random.normal(jax.random.fold_in(rng, t), x0.shape, jnp.float32))
              for t in range(steps)]
    with torch.no_grad():
        got = tdiff.ddpm_inversion(teng.sched, teng.model_fn(feat=True), to_torch(x0), steps=steps,
                                   feat_postprocess=tfeat.regroup_features, chunk=chunk,
                                   noises=noises)
    return got, want


def test_ddpm_inversion_matches_jax(pair):
    """JAX's forward noises injected: latent, features, variances and
    variance_noise to 1e-4. The recorded sample is x_0 exactly; replaying
    ``mean + variance_noise`` one step at a time reproduces it to 1e-5 (the
    means of batch-1 forwards differ in the last bits from those of the
    batched inversion: the CPU convolutions' reduction order depends on the
    batch size)."""
    x0 = np.random.default_rng(8).uniform(-1, 1, SHAPE).astype(np.float32)
    got, want = _inversion(pair, x0, chunk=4)
    for k in ("latent", "features", "variances", "variance_noise"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(got["sample"].numpy(), x0)
    # replaying mean + variance_noise reproduces every x_t (fp32 exact)
    _, teng = pair
    x = got["latent"]
    with torch.no_grad():
        for k, t in enumerate(range(5, -1, -1)):
            x = tdiff.p_sample_guidance(teng.sched, teng.model_fn(), x, torch.full((1,), t),
                                        variance_noise=got["variance_noise"][k])["sample"]
    np.testing.assert_allclose(x.numpy(), x0, atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_inversion_independent_of_chunk(pair, chunk):
    """Batching the backward evaluations ``chunk`` at a time (with padding)
    changes no result beyond 5e-5 on values of order 1 (the CPU
    convolutions' reduction order depends on the batch size)."""
    x0 = np.random.default_rng(9).uniform(-1, 1, (2,) + CFG.latent_shape).astype(np.float32)
    ref, _ = _inversion(pair, x0, chunk=6)
    got, want = _inversion(pair, x0, chunk=chunk)
    for k in ("latent", "features", "variances", "variance_noise"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=5e-5, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the engine's drag loop against the JAX engine
# ---------------------------------------------------------------------------

X_T = np.random.default_rng(33).normal(size=SHAPE).astype(np.float32)
SRC = np.array([[0.3, 0.1, -0.2]], np.float32)
TGT = np.array([[0.5, 0.1, -0.2]], np.float32)


@pytest.fixture(scope="module")
def generated(pair):
    """Both engines after generation from X_T (JAX's step noises injected),
    and the generated x0 (for inversion)."""
    jeng, teng = pair
    x0 = np.asarray(jeng.update_latent_params(latent=X_T, seed=0))
    noises = jax_step_noises(jax.random.PRNGKey(1), SHAPE, jeng.sched.num_timesteps)
    got = teng.update_latent_params(latent=X_T, seed=0, noises=noises)
    np.testing.assert_allclose(got, x0, atol=ATOL)
    assert teng.variances is None and teng.variance_noise is None
    return x0


def _invert_both(pair, x0, seed=2):
    jeng, teng = pair
    jeng.latent_inversion(jnp.asarray(x0), seed=seed)
    teng.latent_inversion(x0, noises=fold_noises(seed, range(CFG.edit.w_time)))
    np.testing.assert_allclose(teng.w.numpy(), np.asarray(jeng.w), atol=ATOL)
    np.testing.assert_allclose(teng.feature_guidance.numpy(), np.asarray(jeng.feature_guidance), atol=ATOL)
    np.testing.assert_allclose(teng.variance_noise.numpy(), np.asarray(jeng.variance_noise), atol=ATOL)
    assert teng.last_phase_walls["path"] == "inversion"


CASES = {
    # name: (noise_mode, edit_steps, chunk, stop after the first chunk)
    "resample": ("resample", None, 10, False),
    "fixed_variance": ("fixed_variance", None, 10, False),
    "replay": ("replay", None, 4, False),
    "fast": ("resample", 4, 10, False),
    "stop": ("resample", None, 2, True),
    "fast_stop": ("resample", 4, 2, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_drag_edit_matches_jax_engine(pair, generated, case):
    """The same drag on both engines: the edited latent to 1e-4 (1e-3 after
    an inversion), the per-step losses to rtol 1e-4; the meshes (random weights: a noisy 32^3 field,
    bf16 decoder MLP, fp16 grid, where 1e-4 on the latent moves a few grid
    points across the iso level) within 1% in vertex count and 5e-3 in
    symmetric Chamfer distance (a voxel is 0.0625). Guided steps take
    ``normal(fold_in(PRNGKey(seed), t))``; unguided finishing steps after a
    stop take JAX's split chain from ``fold_in(rng, n_steps)`` (fast) or
    ``PRNGKey(1234)`` (``get_mesh``)."""
    jeng, teng = pair
    mode, edit_steps, chunk, stop = CASES[case]
    if mode != "resample":
        _invert_both(pair, generated)
    else:
        jeng.update_latent_params(latent=X_T, seed=0)
        teng.update_latent_params(latent=X_T, seed=0, noises=jax_step_noises(
            jax.random.PRNGKey(1), SHAPE, jeng.sched.num_timesteps))
    seed = 5
    n_steps = edit_steps or CFG.edit.w_time
    done = chunk if stop else n_steps
    noises = fold_noises(seed, range(n_steps - 1, n_steps - 1 - done, -1))
    if stop:
        fin_key = jax.random.fold_in(jax.random.PRNGKey(seed), n_steps) if edit_steps else (
            jax.random.PRNGKey(1234))
        noises += jax_step_noises(fin_key, SHAPE, n_steps - done)

    def stopper(eng):
        def cb(p):
            if stop:
                eng.train_flag = False
        return cb

    kw = dict(scale=40.0, cof=0.3, seed=seed, chunk=chunk, noise_mode=mode, edit_steps=edit_steps)
    jmesh = jeng.drag_edit(SRC, TGT, progress_callback=stopper(jeng), **kw)
    ticks = []
    tmesh = teng.drag_edit(SRC, TGT, noises=noises,
                           progress_callback=lambda p: (ticks.append(p), stopper(teng)(p)), **kw)
    # from an inversion, the cached features and variance_noise carry the
    # batch-8 evaluations' 1e-5 differences, which scale * variance * grad
    # carries into a few elements over six guided steps: 1e-3 there
    atol = ATOL if mode == "resample" else 1e-3
    np.testing.assert_allclose(teng.edited_latent, jeng.edited_latent, atol=atol)
    for k in ("motion", "mask"):
        assert len(teng.last_drag_losses[k]) == done
        np.testing.assert_allclose(teng.last_drag_losses[k], jeng.last_drag_losses[k], rtol=1e-4, atol=1e-7)
    assert teng.drag_loss_summary() == pytest.approx(jeng.drag_loss_summary(), rel=1e-4)
    assert len(jmesh.vertices) > 0
    assert abs(len(tmesh.vertices) - len(jmesh.vertices)) <= 0.01 * len(jmesh.vertices)
    assert chamfer(tmesh.vertices, jmesh.vertices) < 5e-3
    assert ticks[0] == pytest.approx(1.0 - (n_steps - min(chunk, n_steps)) / max(n_steps - 1.0, 1.0))
    assert teng.last_phase_walls["path"] == "drag" and teng.last_phase_walls["edit_steps"] == n_steps
    teng.reset_params()
    assert teng.w is teng.w0


def test_drag_edit_refuses_what_jax_refuses(pair, generated):
    _, teng = pair
    teng.update_latent_params(latent=X_T, seed=0)
    with pytest.raises(RuntimeError, match="needs inversion-recorded"):
        teng.drag_edit(SRC, TGT, noise_mode="replay")
    with pytest.raises(ValueError, match="unknown noise_mode"):
        teng.drag_edit(SRC, TGT, noise_mode="bogus")
    teng.latent_inversion(generated)
    with pytest.raises(ValueError, match="fast editing"):
        teng.drag_edit(SRC, TGT, noise_mode="replay", edit_steps=3)
    teng.clear_params()
    assert teng.variances is None and teng.last_drag_losses is None
    with pytest.raises(RuntimeError, match="no cached latent"):
        teng.drag_edit(SRC, TGT)


def test_with_feat_store_dtype():
    cfg = preset("chairs")
    assert with_feat_store_dtype(cfg, None) is cfg
    assert with_feat_store_dtype(cfg, "bfloat16") is cfg
    assert with_feat_store_dtype(cfg, "float32").edit.feat_store_dtype == "float32"
    assert dataclasses.replace(with_feat_store_dtype(cfg, "float32"), edit=cfg.edit) == cfg


# ---------------------------------------------------------------------------
# the edit gate on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise_source", ["jax", "threefry"])
def test_edit_gate_on_cpu(noise_source):
    """The committed toy system's fixed-seed replay drag, with the recorded
    inversion noises (JAX's own draws, or the port's NumPy threefry, as
    ``chip_smoke.py`` runs it): the guided run's final motion loss is at
    least half the recorded reduction below the scale-0 run's, the scale-0
    baseline within 10% of the recorded one (the JAX gate's bounds), and the
    edited mesh is not empty."""
    from ishapediting_tpu_torch.edit.gate import engine_from_asset, gate_drags

    engine, asset = engine_from_asset(device="cpu")
    seed = int(asset["eval_seed"])
    noises = None
    if noise_source == "jax":
        noises = fold_noises(seed, range(engine.config.edit.w_time), (1,) + engine.config.latent_shape)
    base, guided, original, edited = gate_drags(engine, asset, noises=noises)
    assert len(base) == len(guided) == engine.config.edit.w_time
    assert base[-1] == pytest.approx(float(asset["achieved_motion0"]), rel=0.10)
    reduction = 1.0 - guided[-1] / base[-1]
    assert reduction >= 0.5 * float(asset["achieved_reduction"])
    assert len(original.vertices) > 0 and len(edited.vertices) > 0


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_threefry_replays_jax_random(seed):
    """The port's NumPy threefry: keys and bits equal to JAX's; normals to
    2e-5 (XLA evaluates erfinv by a fp32 polynomial, the port in fp64)."""
    from ishapediting_tpu_torch.utils import threefry as tf

    key, kk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    assert np.asarray(key).tolist() == kk.tolist()
    for t in (0, 3, 11, 2**31 + 1):
        assert np.asarray(jax.random.fold_in(key, t)).tolist() == tf.fold_in(kk, t).tolist()
    assert np.asarray(jax.random.split(key, 3)).tolist() == tf.split(kk, 3).tolist()
    np.testing.assert_array_equal(tf.random_bits(kk, (5, 3)),
                                  np.asarray(jax.random.bits(key, (5, 3), jnp.uint32)))
    for shape in (SHAPE, (7,), (3, 5)):
        want = np.asarray(jax.random.normal(key, shape, jnp.float32))
        got = tf.normal(kk, shape)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    with pytest.raises(ValueError):
        tf.prng_key(-1)
