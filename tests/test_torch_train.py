"""Port parity and behaviour, training: the UNet's dropout forward, one train
step's loss and gradients, the optimizer and EMA, one decoder train step and
the datasets, each against the JAX package on the same numpy-seeded inputs
and weights with JAX's own draws injected; then the port's own loop
(checkpoint/resume, NaN guard), decoder training and ``cli.train`` -> serve,
on the CPU at miniature sizes. Each test states its tolerance.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ishapediting_tpu.core.losses import training_losses as j_training_losses
from ishapediting_tpu.core.losses import update_ema as j_update_ema
from ishapediting_tpu.core.schedule import make_schedule as j_make_schedule
from ishapediting_tpu.io import dataset as jds
from ishapediting_tpu.io.model_dir import TriplaneStats as JTriplaneStats
from ishapediting_tpu.models.unet import unet_apply
from ishapediting_tpu.train.decoder import make_decoder_train_step as j_make_decoder_train_step
from ishapediting_tpu.train.trainer import make_optimizer as j_make_optimizer
from ishapediting_tpu_torch.cli import train as tcli
from ishapediting_tpu_torch.config import UNetConfig, preset
from ishapediting_tpu_torch.core.losses import update_ema
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.io import dataset as tds
from ishapediting_tpu_torch.io.checkpoint import load_train_state
from ishapediting_tpu_torch.io.convert import unet_state_dict_from_jax
from ishapediting_tpu_torch.io.model_dir import TriplaneStats
from ishapediting_tpu_torch.models.unet import UNetModel, dropout_sites, init_unet_
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder, decode_points
from ishapediting_tpu_torch.train.decoder import make_decoder_train_step, train_decoder
from ishapediting_tpu_torch.train.loop import latest_checkpoint, train
from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step
from tests.test_train_parallel import TINY as J_TINY
from torch_parity_helpers import decoder_pair, to_torch, unet_pair

torch.set_num_threads(2)

TINY = dataclasses.asdict(J_TINY)  # fp32, dropout 0.1, 8x8x6
SHAPE = (2, 8, 8, 6)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_masks(rng, batch, cfg=None):
    """JAX's keep masks of a train forward of ``cfg`` (default ``TINY``)
    with ``dropout_rng=rng``: one key per site (``split(rng, n_sites)``),
    ``bernoulli(key, 1 - p)`` at the ResBlocks."""
    cfg = TINY if cfg is None else cfg
    sites = dropout_sites(UNetConfig(**cfg), batch)
    keys = jax.random.split(rng, len(sites))
    return [None if s is None else torch.from_numpy(np.asarray(
        jax.random.bernoulli(k, 1.0 - cfg["dropout"], s))) for k, s in zip(keys, sites)]


@pytest.fixture(scope="module")
def tiny_pair():
    return unet_pair(TINY, seed=3)


def test_dropout_forward_matches_jax(tiny_pair):
    """The train forward with JAX's ``bernoulli`` masks, fp32: 1e-5 relative
    L2 (and it differs from the inference forward)."""
    jcfg, jparams, model = tiny_pair
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    t = np.array([3, 71], np.int32)
    rng = jax.random.PRNGKey(9)
    want, _ = jax.jit(lambda p, x, t: unet_apply(jcfg, p, x, t, train=True, dropout_rng=rng))(
        jparams, jnp.asarray(x), jnp.asarray(t))
    masks = jax_masks(rng, 2)
    with torch.no_grad():
        got, _ = model(to_torch(x), torch.from_numpy(t).long(), train=True, dropout_masks=masks)
        plain, _ = model(to_torch(x), torch.from_numpy(t).long())
    assert rel_l2(got, want) <= 1e-5
    assert rel_l2(plain, want) > 1e-2
    assert sum(m is not None for m in masks) == 10  # one per ResBlock: 3 input, 2 middle, 5 output
    with pytest.raises(ValueError, match="dropout_masks"):
        model(to_torch(x), torch.from_numpy(t).long(), train=True)
    with pytest.raises(ValueError, match="9 dropout masks for 15 sites"):
        model(to_torch(x), torch.from_numpy(t).long(), train=True, dropout_masks=masks[:9])


def test_train_step_loss_and_grads_match_jax(tiny_pair):
    """One train step against the JAX trainer's ``loss_fn`` (train forward
    under remat, ``training_losses``) on the same ``t``, noise and masks:
    loss, mse and vb at 1e-4 relative; every parameter's gradient at 1e-4
    relative L2, relative to the larger of its norm and 1e-4 of the global
    gradient norm (a conv bias feeding a GroupNorm of one channel per group
    has gradient zero up to rounding, about 1e-8 here). No t is 0: that
    term's decoder NLL differs in the last ulp of XLA's and torch's tanh
    (``test_torch_losses.py``)."""
    jcfg, jparams, model = tiny_pair
    jsched, sched = j_make_schedule(100, "linear", ""), make_schedule(100, "linear", "")
    batch = np.clip(np.random.default_rng(2).normal(size=SHAPE), -1, 1).astype(np.float32)
    t = np.array([7, 88], np.int32)
    r_loss, r_drop = jax.random.split(jax.random.PRNGKey(4))

    def loss_fn(params):
        def model_fn(x, t_orig):
            return unet_apply(jcfg, params, x, t_orig, train=True, dropout_rng=r_drop, remat=True)

        terms = j_training_losses(jsched, model_fn, jnp.asarray(batch), jnp.asarray(t), r_loss)
        return jnp.mean(terms["loss"]), terms

    (loss, terms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    noise = to_torch(jax.random.normal(r_loss, SHAPE, jnp.float32))

    model = UNetModel(UNetConfig(**TINY))
    model.load_state_dict(unet_state_dict_from_jax(jax.tree.map(np.asarray, jparams)))
    state = init_train_state(model, make_optimizer(model.parameters(), grad_clip=0.0))
    step = make_train_step(UNetConfig(**TINY), sched)
    metrics = step(state, batch, t=torch.from_numpy(t).long(), noise=noise,
                   dropout_masks=jax_masks(r_drop, 2))
    for k, want in (("loss", loss), ("mse", jnp.mean(terms["mse"])), ("vb", jnp.mean(terms["vb"]))):
        assert abs(metrics[k] - float(want)) <= 1e-4 * abs(float(want)), k
    want_grads = unet_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert got_grads.keys() == want_grads.keys()
    floor = 1e-4 * np.sqrt(sum(float(np.square(v.numpy()).sum()) for v in want_grads.values()))
    worst = max(float((got_grads[k] - want_grads[k]).norm()) / max(float(want_grads[k].norm()), floor)
                for k in want_grads)
    assert worst <= 1e-4, worst
    assert state.step == 1


@pytest.mark.parametrize("clip,scale,wd", [(1.0, 10.0, 0.0), (1.0, 0.01, 0.0), (0.0, 1.0, 0.01)],
                         ids=["clip-triggered", "clip-not-triggered", "no-clip-weight-decay"])
def test_optimizer_and_ema_match_optax(clip, scale, wd):
    """``make_optimizer`` + ``update_ema`` against the JAX trainer's
    ``make_optimizer`` (optax clip + adamw) and ``update_ema`` on identical
    gradients over 3 steps, each clipped by its global norm: parameters and
    EMA at 1e-6 relative."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    opt = j_make_optimizer(1e-2, weight_decay=wd, grad_clip=clip)
    jp, jema = dict(params), dict(params)
    jstate = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tema = {k: torch.tensor(v) for k, v in params.items()}
    topt = make_optimizer(tp.values(), lr=1e-2, weight_decay=wd, grad_clip=clip)
    for g in grads:
        updates, jstate = opt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        jema = j_update_ema(jema, jp, 0.9)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        # the train step hands the optimizer the whole gradient's global norm
        topt.step(norm=torch.linalg.vector_norm(torch.cat([p.grad.flatten() for p in tp.values()])))
        update_ema(tema.values(), tp.values(), 0.9)
    if clip:
        norm = np.sqrt(sum(np.square(g[k]).sum() for g in grads[-1:] for k in g))
        assert (norm > clip) == (scale > 1)
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]), rtol=1e-6, atol=1e-7)


def test_decoder_step_matches_jax():
    """One ``make_decoder_train_step`` step against the JAX package's with
    its uniform and normal draws injected: loss at 1e-5 relative; decoder
    and plane bank after the Adam step within 1e-5 relative + 1e-4 * lr
    absolute (a first Adam step is about lr * sign(g), so a gradient within
    fp32 noise of 0 moves its element by up to lr * |g| / eps)."""
    lr = 1e-3
    jdec, dec = decoder_pair(8, seed=2)
    rng = np.random.default_rng(6)
    bank = (0.1 * rng.normal(size=(2, 3, 16, 16, 8))).astype(np.float32)
    coords = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    labels = (np.linalg.norm(coords, axis=1) < 0.5).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    rand = jax.random.uniform(k1, coords.shape, jnp.float32, -1.0, 1.0)
    jitter = jax.random.normal(k2, coords.shape)

    opt, jstep = j_make_decoder_train_step(lr=lr)
    jparams, jbank, _, jm = jstep(jdec, jnp.asarray(bank), opt.init((jdec, jnp.asarray(bank))), 1,
                                  jnp.asarray(coords), jnp.asarray(labels), key)
    make_opt, step = make_decoder_train_step(lr=lr)
    tbank = torch.tensor(bank)
    m = step(dec, tbank, make_opt(dec, tbank), 1, coords, labels, rand=to_torch(rand), jitter=to_torch(jitter))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    want = TriplaneDecoder(8)
    from ishapediting_tpu_torch.io.convert import decoder_state_dict_from_jax

    want.load_state_dict(decoder_state_dict_from_jax(jax.tree.map(np.asarray, jparams)))
    for (k, got), ref in zip(dec.state_dict().items(), want.state_dict().values()):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4 * lr, err_msg=k)
    np.testing.assert_allclose(tbank.detach().numpy(), np.asarray(jbank), rtol=1e-5, atol=1e-4 * lr)
    assert not np.array_equal(tbank.detach().numpy(), bank)


def _tiny_model(seed=0):
    model = UNetModel(UNetConfig(**TINY))
    return init_unet_(model, torch.Generator().manual_seed(seed))


def test_remat_with_generator_dropout_equals_no_remat():
    """Masks drawn from the generator before any checkpointed block: the
    remat backward recomputes with the same masks, so the gradients equal
    those without remat (1e-6 relative L2), and the step's draws depend on
    the generator's seed."""
    cfg, sched = UNetConfig(**TINY), make_schedule(100, "linear", "")
    batch = np.clip(np.random.default_rng(3).normal(size=SHAPE), -1, 1).astype(np.float32)
    grads, losses = [], []
    for remat, seed in ((False, 1), (True, 1), (True, 2)):
        model = _tiny_model()
        with torch.no_grad():  # signal through the zero modules
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        state = init_train_state(model, make_optimizer(model.parameters()))
        m = make_train_step(cfg, sched, remat=remat)(state, batch, torch.Generator().manual_seed(seed))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
        losses.append(m["loss"])
    assert max(rel_l2(grads[1][k], grads[0][k]) for k in grads[0]) <= 1e-6
    assert losses[0] == pytest.approx(losses[1], rel=1e-6) and losses[2] != losses[1]


def _batches(rng, n=2):
    while True:
        yield np.clip(rng.standard_normal((n,) + SHAPE[1:]).astype(np.float32), -1, 1)


def _state_tensors(state):
    """Every tensor of a TrainState (params, EMA, Adam moments), by name."""
    out = {f"p.{k}": v.detach().clone() for k, v in state.model.named_parameters()}
    out.update({f"ema.{k}": v.clone() for k, v in state.ema_params.items()})
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v.clone() for k, v in s.items()})
    return out


def test_train_checkpoint_and_resume(tmp_path):
    """As the JAX package's loop test: 4 steps with a checkpoint every 2, then
    a resume to step 6; the checkpoint restores the saved state exactly."""
    cfg, sched = UNetConfig(**TINY), make_schedule(100, "linear", "")
    ckpt_dir = str(tmp_path / "ckpts")
    state = train(cfg, sched, _tiny_model(), _batches(np.random.default_rng(0)),
                  total_steps=4, ckpt_dir=ckpt_dir, ckpt_every=2, log_every=100)
    assert state.step == 4
    assert latest_checkpoint(ckpt_dir).endswith("step_4")
    assert sorted(os.listdir(ckpt_dir)) == ["step_2", "step_4"]

    fresh = init_train_state(_tiny_model(seed=1), make_optimizer(UNetModel(cfg).parameters()))
    fresh.optimizer = make_optimizer(fresh.model.parameters())
    load_train_state(latest_checkpoint(ckpt_dir), fresh)
    assert fresh.step == 4
    saved, restored = _state_tensors(state), _state_tensors(fresh)
    assert saved.keys() == restored.keys() and any(k.startswith("opt.") for k in saved)
    for k in saved:
        assert torch.equal(saved[k], restored[k]), k

    state2 = train(cfg, sched, _tiny_model(seed=1), _batches(np.random.default_rng(0)),
                   total_steps=6, ckpt_dir=ckpt_dir, ckpt_every=10, log_every=100)
    assert state2.step == 6
    assert latest_checkpoint(ckpt_dir).endswith("step_6")


def test_train_nan_guard_leaves_state_untouched():
    """Two good steps, then non-finite batches: ``max_bad_steps`` in a row
    raise FloatingPointError, and the params, EMA, Adam moments and step are
    those after the good steps, bit for bit."""
    cfg, sched = UNetConfig(**TINY), make_schedule(100, "linear", "")
    seen = {}

    def batches():
        good = _batches(np.random.default_rng(0))
        yield next(good)
        yield next(good)
        while True:
            yield np.full(SHAPE, np.nan, np.float32)

    def watch(step):
        def wrapped(state, batch, gen):
            if np.isnan(batch).any() and "before" not in seen:
                seen["state"], seen["before"] = state, _state_tensors(state)
            return step(state, batch, gen)

        return wrapped

    with pytest.raises(FloatingPointError):
        train(cfg, sched, _tiny_model(), batches(), total_steps=10, max_bad_steps=3,
              log_every=100, step_transform=watch)
    after = _state_tensors(seen["state"])
    assert seen["state"].step == 2
    for k, v in seen["before"].items():
        assert torch.equal(v, after[k]), k


def test_datasets_give_jax_batches(tmp_path):
    """TriplaneDataset, OccupancyDataset and MultiOccupancyDataset yield the
    JAX package's batches for the same seed, exactly."""
    rng = np.random.default_rng(0)
    for i in range(5):
        np.save(tmp_path / f"{i}.npy", rng.standard_normal((6, 8, 8)).astype(np.float32))
    half, mid = np.full(6, 2.0, np.float32), np.ones(6, np.float32)
    jt = jds.TriplaneDataset(str(tmp_path), JTriplaneStats(half_range=half, middle=mid), channels=6)
    tt = tds.TriplaneDataset(str(tmp_path), TriplaneStats(half_range=half, middle=mid), channels=6)
    pts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    occ = (rng.random(100) > 0.5).astype(np.float32)
    pairs = [
        (jt.batches(2, seed=3), tt.batches(2, seed=3)),
        (jds.OccupancyDataset(pts, occ).batches(16, seed=4), tds.OccupancyDataset(pts, occ).batches(16, seed=4)),
        (jds.MultiOccupancyDataset([jds.OccupancyDataset(pts, occ)] * 2).batches(8, seed=5),
         tds.MultiOccupancyDataset([tds.OccupancyDataset(pts, occ)] * 2).batches(8, seed=5)),
    ]
    for jb, tb in pairs:
        for _ in range(7):  # past an epoch of the triplane set
            a, b = next(jb), next(tb)
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_decoder_training_learns_sphere():
    """As the JAX package's test: joint decoder training fits a sphere's
    occupancy, held-out accuracy > 0.9."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    occ = (np.linalg.norm(pts, axis=1) < 0.5).astype(np.float32)
    multi = tds.MultiOccupancyDataset([tds.OccupancyDataset(pts, occ)])
    dec, bank = train_decoder(multi.batches(2048, seed=0), num_objs=1, steps=150, resolution=32,
                              channels=8, lr=3e-3, log_every=1000, device="cpu")
    test_pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    with torch.no_grad():
        logits = decode_points(dec, bank[0], to_torch(test_pts))[:, 0].numpy()
    acc = ((logits > 0) == (np.linalg.norm(test_pts, axis=1) < 0.5)).mean()
    assert acc > 0.9, acc


def _decoder_pt(path, plane_channels):
    torch.save(TriplaneDecoder(plane_channels).state_dict(), path)
    return str(path)


def test_cli_train_export_serves(tmp_path):
    """``cli.train --preset tiny --synthetic 4 --export_model_dir`` -> the
    JAX package's layout (unet.orbax, decoder.orbax, statistics/) ->
    ``DragEngine.from_model_dir`` samples a finite latent with the exported
    EMA weights; an export whose decoder comes from the JAX package's orbax
    dir serves that decoder."""
    out, ckpt = tmp_path / "model", tmp_path / "ckpt"
    dec = _decoder_pt(tmp_path / "dec.pt", preset("tiny").plane_channels)
    state = tcli.main(["--preset", "tiny", "--synthetic", "4", "--steps", "3", "--ckpt_every", "2",
                       "--batch_size", "2", "--ckpt_dir", str(ckpt), "--export_model_dir", str(out),
                       "--decoder_from", dec, "--device", "cpu"])
    assert state.step == 3 and sorted(os.listdir(ckpt)) == ["step_2", "step_3"]
    assert sorted(os.listdir(out)) == ["decoder.orbax", "statistics", "unet.orbax"]
    engine = DragEngine.from_model_dir(str(out), config=preset("tiny"), device="cpu")
    for k, v in engine.unet.state_dict().items():
        assert torch.equal(v, state.ema_params[k]), k
    lat = engine.sample_latent(seed=0)
    assert lat.shape == (1,) + preset("tiny").latent_shape and np.isfinite(lat).all()
    from ishapediting_tpu.io.checkpoint import save_params as jsave_params

    jdec, tdec = decoder_pair(preset("tiny").plane_channels, seed=4)
    jsave_params(str(tmp_path / "decoder.orbax"), jdec)  # --decoder_from the JAX package's orbax dir
    tcli.export_model_dir(str(tmp_path / "m2"), state.ema_params, decoder_from=str(tmp_path / "decoder.orbax"),
                          channels=6)
    served = DragEngine.from_model_dir(str(tmp_path / "m2"), config=preset("tiny"), device="cpu")
    for k, v in tdec.state_dict().items():
        assert torch.equal(served.decoder.state_dict()[k], v), k


@pytest.mark.parametrize("source", ["pt", "model_dir", "export"])
def test_cli_train_init_from(tmp_path, source):
    """``--init_from`` a reference ``.pt`` (or the category dir holding it,
    or a model dir ``--export_model_dir`` wrote: its ``unet.orbax``): the
    run starts from exactly those weights (0 steps)."""
    init = init_unet_(UNetModel(preset("tiny").unet), torch.Generator().manual_seed(8))
    ckpts = tmp_path / "src" / "ddpm_tiny_ckpts"
    ckpts.mkdir(parents=True)
    torch.save(init.state_dict(), ckpts / "ema_5.pt")
    if source == "export":
        tcli.export_model_dir(str(tmp_path / "exported"), init.state_dict(), channels=6)
    path = {"pt": ckpts / "ema_5.pt", "model_dir": tmp_path / "src", "export": tmp_path / "exported"}[source]
    state = tcli.main(["--preset", "tiny", "--synthetic", "2", "--steps", "0", "--batch_size", "2",
                       "--ckpt_dir", str(tmp_path / "ck"), "--init_from", str(path), "--device", "cpu"])
    for k, v in init.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_logger_writers_and_trace(tmp_path, capsys):
    """The port's KV logger writes what the JAX package's does (stdout,
    jsonl, csv, timing scopes), and ``start_trace``/``stop_trace`` write a
    ``torch.profiler`` trace holding the annotated region."""
    import json

    from ishapediting_tpu_torch.utils.logger import KVLogger, start_trace, stop_trace, trace_annotation

    logger = KVLogger(str(tmp_path), formats=("stdout", "json", "csv"))
    logger.logkv("loss", 1.5)
    logger.logkv_mean("acc", 1.0)
    logger.logkv_mean("acc", 0.0)
    with logger.profile_kv("fwd"):
        pass
    out = logger.dumpkvs()
    assert out["loss"] == 1.5 and out["acc"] == pytest.approx(0.5) and "time/fwd" in out
    assert "loss" in capsys.readouterr().out
    with open(tmp_path / "progress.jsonl") as f:
        assert json.loads(f.readline())["loss"] == 1.5
    assert os.path.exists(tmp_path / "progress.csv")

    trace_dir = tmp_path / "trace"
    start_trace(str(trace_dir))
    with trace_annotation("train_step_region"):
        torch.ones(4).sum()
    stop_trace()
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(traces) == 1
    assert "train_step_region" in (trace_dir / traces[0]).read_text()
