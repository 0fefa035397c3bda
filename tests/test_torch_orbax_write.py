"""Port parity, writing orbax as the JAX package does
(``ishapediting_tpu_torch/io/orbax.py::save_params`` and
``io/checkpoint.py``), with orbax, tensorstore and zstandard as the judges:
the JAX package's ``load_params`` restores every tree the port writes, with
and without a target, bit for bit; the port reads its own writes bit for
bit; the zstd frames of raw blocks decode everywhere; the OCDBT config and
the train state's tree are the fixture's (``tests/assets/orbax``, written
by orbax 0.11.32); the inverse layout maps of ``io/convert.py`` are exact;
JAX's ``train()`` resumes a port ``step_<N>`` (its next step against the
port's at 1e-4 relative, as ``test_torch_train.py``), JAX's
``DragEngine.from_model_dir`` serves a port export (DDIM-10 atol 1e-4, as
``test_torch_sampling.py``), and both packages' ``convert_model_dir`` write
the same trees.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.core import diffusion as jdiff
from ishapediting_tpu.core.schedule import make_schedule as j_make_schedule
from ishapediting_tpu.edit.engine import DragEngine as JDragEngine
from ishapediting_tpu.io.checkpoint import convert_model_dir as j_convert_model_dir
from ishapediting_tpu.io.checkpoint import load_params as j_load_params
from ishapediting_tpu.io.torch_convert import convert_decoder_state_dict, convert_torch_state_dict
from ishapediting_tpu.train.loop import train as j_train
from ishapediting_tpu_torch import native
from ishapediting_tpu_torch.cli import train as tcli
from ishapediting_tpu_torch.config import preset
from ishapediting_tpu_torch.core import diffusion as tdiff
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.io import orbax as torbax
from ishapediting_tpu_torch.io.checkpoint import (
    convert_model_dir,
    jax_train_tree,
    load_params,
    save_params,
    save_train_state,
    whole_state,
)
from ishapediting_tpu_torch.io.convert import (
    decoder_state_dict_from_jax,
    jax_decoder_from_state_dict,
    jax_params_from_unet_state_dict,
    unet_state_dict_from_jax,
)
from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder
from ishapediting_tpu_torch.train.loop import latest_checkpoint, train
from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer
from tests.test_torch_orbax import (
    ASSETS,
    ATOL,
    FORBIDDEN,
    ROOT,
    STEP3,
    TRAIN_TOL,
    assert_same_tree,
    leaf_bytes,
    tree_leaves,
)
from tests.test_torch_tensor_parallel import FAMILIES, worst_rel
from torch_tp_workers import train_tensors

torch.set_num_threads(2)

CFG = preset("tiny", 10, use_ddim=True)


def rand(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


def trees():
    """The trees ``save_params`` is held to, by name."""
    rng = np.random.default_rng(0)
    return {
        "fp32": {"w": rand(rng, (7, 13, 3)), "b": rand(rng, (5,)), "one": rand(rng, (1, 1))},
        "bf16": {"w": rand(rng, (33, 7), torch.bfloat16), "scalar": rand(rng, (), torch.bfloat16)},
        "int32": {"count": torch.tensor(3, dtype=torch.int32), "ids": torch.arange(-5, 7, dtype=torch.int32)},
        "int64": {"torch": torch.arange(12).reshape(3, 4) * 2**40, "numpy": np.arange(6, dtype=np.int64) - 3},
        "scalars": {"f": torch.tensor(2.5), "i": torch.tensor(-7, dtype=torch.int32), "n": np.array(1.5)},
        "nested": {"a": [rand(rng, (2,)), None, {"x": rand(rng, (3, 1)), "y": []}], "b": {}, "c": None,
                   "d": (np.ones((2, 2), np.float32), {"e": torch.tensor([True, False, True])})},
        "blocks": {"exact": rand(rng, (2, 32768)), "over": rand(rng, (32768 + 3,)), "wide": rand(rng, (300, 500))},
        "no_arrays": {"a": None, "b": {}},  # a store of no keys
    }


def as_jax(tree):
    """``tree`` as JAX holds it: tensors as jax arrays (64-bit ones, which
    JAX holds only with x64, as NumPy), tuples as lists."""
    if isinstance(tree, dict):
        return {k: as_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_jax(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return jnp.asarray(tree.view(torch.uint16).numpy().view(jnp.bfloat16))
        return tree.numpy() if tree.dtype in torbax.WIDE else jnp.asarray(tree.numpy())
    return tree


@pytest.mark.parametrize("name", list(trees()))
def test_save_params_restored_by_orbax(tmp_path, name):
    """The JAX package's ``load_params`` restores the port's save without a
    target and with one, bit for bit; tensorstore reads every key and value
    the port's reader reads; the port reads its own save bit for bit."""
    tree = trees()[name]
    path = str(tmp_path / f"{name}.orbax")
    assert save_params(path, tree) == torbax.dir_bytes(path)
    want = as_jax(tree)
    assert_same_tree(j_load_params(path), want)
    assert_same_tree(j_load_params(path, target=want), want)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + path}).result()
    store = torbax.OcdbtStore(path)
    assert store.keys() == sorted(kv.list().result())
    for k in store.keys():
        assert store.read(k) == kv.read(k).result().value, k
    assert_same_tree(load_params(path), want)


def test_load_params_with_a_target(tmp_path):
    """``load_params(path, target=)`` gives the target's structure (a tuple
    stays a tuple), dtypes and NumPy leaves; another shape or structure is
    refused by path."""
    path = str(tmp_path / "t.orbax")
    save_params(path, {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": [torch.tensor(1), None]})
    got = load_params(path, target={"a": np.zeros((2, 3), np.float64), "b": (torch.zeros((), dtype=torch.int32), None)})
    assert isinstance(got["b"], tuple) and got["b"][0].dtype == torch.int32 and int(got["b"][0]) == 1
    assert got["a"].dtype == np.float64 and np.array_equal(got["a"], np.arange(6).reshape(2, 3))
    with pytest.raises(ValueError, match="/a shape"):
        load_params(path, target={"a": torch.zeros(3, 2), "b": [torch.tensor(0), None]})
    with pytest.raises(ValueError, match="tree differs"):
        load_params(path, target={"a": torch.zeros(2, 3)})


def test_save_params_refusals(tmp_path):
    """A zero-size array (as orbax refuses it), a key that is not a string,
    a leaf of another type and a bare leaf are refused; nothing is left at
    the path."""
    path = tmp_path / "bad.orbax"
    with pytest.raises(ValueError, match="zero size"):
        save_params(str(path), {"a": torch.zeros(0, 3)})
    with pytest.raises(TypeError, match="not a string"):
        save_params(str(path), {1: torch.zeros(2)})
    with pytest.raises(TypeError, match="type str"):
        save_params(str(path), {"a": "text"})
    with pytest.raises(TypeError, match="bare leaf"):
        save_params(str(path), torch.zeros(2))
    assert not path.exists()


@pytest.mark.parametrize("n", [0, 1, 1000, 131071, 131072, 131073, 3 * 131072, 400_000])
def test_zstd_raw_frames(n):
    """``zstd_raw_frame`` of n bytes: one header and raw blocks of at most
    128 KiB with the content size; zstandard, the native decoder and the
    reader's strided path each give the bytes back; the strided path
    declines a compressed frame, which the native decoder reads."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    frame = torbax.zstd_raw_frame(data).tobytes()
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == n and not params.has_checksum
    assert len(frame) == 14 + 3 * max(1, -(-n // 131072)) + n
    assert zstandard.ZstdDecompressor().decompress(frame) == data.tobytes()
    assert native.zstd_decompress(frame) == data.tobytes()
    assert torbax._raw_frame_content(frame).tobytes() == data.tobytes()
    packed = zstandard.ZstdCompressor(level=1, write_content_size=True).compress(data.tobytes())
    assert torbax._raw_frame_content(packed) is None


def manifest_body(path):
    with open(os.path.join(path, "manifest.ocdbt"), "rb") as f:
        return torbax._unframe(f.read(), torbax.MANIFEST_MAGIC, path).b


def test_writer_config_and_metadata_are_orbaxs(tmp_path):
    """The manifest's OCDBT config after its uuid (inline values, node
    limit, version tree arity, compression) is byte for byte the fixture's;
    ``_METADATA``'s fields, ``_CHECKPOINT_METADATA``'s keys, the
    ``_sharding`` entries and the array metadata are the fixture's for the
    same tree (the fixture's decoder)."""
    fixture = os.path.join(ASSETS, "model", "decoder.orbax")
    path = str(tmp_path / "decoder.orbax")
    save_params(path, load_params(fixture))
    mine, theirs = manifest_body(path), manifest_body(fixture)
    table = b"\x01\x22\x00d/"  # one data file, d/<32 hex digits>
    assert mine[16 : mine.index(table)] == theirs[16 : theirs.index(table)]
    for name in ("_METADATA", "_sharding", os.path.join("array_metadatas", "process_0")):
        with open(os.path.join(path, name)) as f, open(os.path.join(fixture, name)) as g:
            assert json.load(f) == json.load(g), name
    a, b = (json.load(open(os.path.join(d, "_CHECKPOINT_METADATA"))) for d in (path, fixture))
    assert a.keys() == b.keys() and a["item_handlers"] == b["item_handlers"]
    store = torbax.OcdbtStore(path)
    for key in store.keys():
        if key.endswith(b".zarray"):
            assert store.read(key) == torbax.OcdbtStore(fixture).read(key), key


def test_writer_splits_nodes_as_tensorstore_reads_them(tmp_path):
    """A store written with 300-byte nodes and 16-byte inline values (a
    B+tree of interior nodes, inline and out-of-line values, empty values,
    keys sharing long prefixes): tensorstore and the port read every key
    and value back."""
    rng = np.random.default_rng(2)
    want = {f"group{i % 3}/key{i:04d}".encode(): rng.integers(0, 256, int(rng.integers(0, 60)), dtype=np.uint8)
            .tobytes() for i in range(300)}
    w = torbax.OcdbtWriter(str(tmp_path), max_inline=16, max_node=300)
    for k, v in want.items():
        w.put(k, v)
    w.close()
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}"}).result()
    assert {k: kv.read(k).result().value for k in kv.list().result()} == want
    store = torbax.OcdbtStore(str(tmp_path))
    assert store.inline["height"][0] >= 2 and store.inline["num_keys"] == [300]
    assert {k: store.read(k) for k in store.keys()} == want


# ---------------------------------------------------------------------------
# the layout maps
# ---------------------------------------------------------------------------


def signal_unet(cfg, seed):
    """A UNet whose every weight is random (the ADM init zeroes some)."""
    model = UNetModel(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)) / max(p[0].numel(), 1) ** 0.5)
    return model


@pytest.mark.parametrize("conditional", [False, True])
def test_inverse_layout_maps_are_exact(conditional):
    """``jax_params_from_unet_state_dict`` / ``jax_decoder_from_state_dict``
    equal the JAX package's converters bit for bit, and the round trips
    through ``unet_state_dict_from_jax`` / ``decoder_state_dict_from_jax``
    give every tensor back bit for bit (a class-conditional UNet's
    embedding table too)."""
    cfg = preset("tiny").unet
    sd = signal_unet(dataclasses.replace(cfg, num_classes=5) if conditional else cfg, seed=3).state_dict()
    mine = jax_params_from_unet_state_dict(sd)
    assert_same_tree(mine, convert_torch_state_dict(sd))
    back = unet_state_dict_from_jax(mine)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], v) for k, v in sd.items())
    assert_same_tree(jax_params_from_unet_state_dict(back), mine)
    dec = TriplaneDecoder(CFG.plane_channels)
    with torch.no_grad():
        for p in dec.parameters():
            p.normal_()
    dsd = dec.state_dict()
    assert_same_tree(jax_decoder_from_state_dict(dsd), convert_decoder_state_dict(dsd))
    back = decoder_state_dict_from_jax(jax_decoder_from_state_dict(dsd))
    assert back.keys() == dsd.keys() and all(torch.equal(back[k], v) for k, v in dsd.items())


# ---------------------------------------------------------------------------
# train states, exports and converted dirs across the packages
# ---------------------------------------------------------------------------


def port_train(tmp_path, steps):
    cfg = jpreset("tiny")
    rng = np.random.default_rng(5)
    data = np.clip(rng.standard_normal((4,) + cfg.latent_shape), -1, 1).astype(np.float32)

    def batches():
        while True:
            yield data[rng.integers(0, 4, 2)]

    model = signal_unet(CFG.unet, seed=7)
    sched = make_schedule(cfg.diffusion.base_steps, cfg.diffusion.noise_schedule, "")
    ckpt = str(tmp_path / "port")
    return train(CFG.unet, sched, model, batches(), total_steps=steps, ckpt_dir=ckpt, ckpt_every=steps,
                 log_every=100, seed=8), ckpt


def test_port_train_state_is_jaxs_tree(tmp_path):
    """A port ``step_3`` of the tiny preset has the fixture's (JAX's
    ``step_3``) tree metadata and zarr headers exactly: every key path, key
    type, value type, write shape, dtype and chunking."""
    state, ckpt = port_train(tmp_path, 3)
    path = latest_checkpoint(ckpt)
    assert path.endswith("step_3")
    with open(os.path.join(path, "_METADATA")) as f, open(os.path.join(STEP3, "_METADATA")) as g:
        assert json.load(f) == json.load(g)
    mine, theirs = torbax.OcdbtStore(path), torbax.OcdbtStore(STEP3)
    assert mine.keys() == theirs.keys()
    for key in mine.keys():
        if key.endswith(b".zarray"):
            assert mine.read(key) == theirs.read(key), key
    tree = load_params(path)
    assert int(tree["step"]) == 3 and int(tree["opt_state"][1][0]["count"]) == 3


def test_jax_train_resumes_a_port_train_state(tmp_path):
    """JAX's ``train()`` resumes the port's ``step_3`` through
    ``load_params(latest, target=state)`` and takes step 4; the port's
    ``train()`` resumed from the same ``step_3`` with JAX's draws injected
    (the tiny UNet has no dropout) equals it: the parameters, EMA and Adam
    moments at 1e-4 relative L2 per tensor against the larger of its norm
    and 1e-4 of its family's; both reach step 4."""
    _, ckpt = port_train(tmp_path, 3)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    shutil.copytree(ckpt, jdir)
    shutil.copytree(ckpt, tdir)
    cfg = jpreset("tiny")
    jsched = j_make_schedule(cfg.diffusion.base_steps, cfg.diffusion.noise_schedule, "")
    batch = np.clip(np.random.default_rng(6).normal(size=(2,) + cfg.latent_shape), -1, 1).astype(np.float32)
    template = j_load_params(str(jdir / "step_3"))["params"]  # its values are replaced by the resume
    jstate = j_train(cfg.unet, jsched, template, iter([batch]), total_steps=4, ckpt_dir=str(jdir), log_every=100,
                     seed=11)
    assert int(jstate.step) == 4 and latest_checkpoint(str(jdir)).endswith("step_4")
    _, sub = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(11), 3))
    r_t, r_loss, _ = jax.random.split(sub, 3)
    t = np.asarray(jax.random.randint(r_t, (2,), 0, jsched.num_timesteps, jnp.int32))
    assert t.min() > 0  # t = 0's decoder NLL differs in the last ulp of tanh (test_torch_losses.py)
    adam = jstate.opt_state[1][0]
    want = {}
    for fam, tree in (("p", jstate.params), ("ema", jstate.ema_params), ("exp_avg", adam.mu),
                      ("exp_avg_sq", adam.nu)):
        want.update({f"{fam}.{k}": v.numpy() for k, v in unet_state_dict_from_jax(
            jax.tree.map(np.asarray, tree)).items()})

    def inject(step):
        def run(state, batch, gen):
            noise = torch.from_numpy(np.asarray(jax.random.normal(r_loss, batch.shape)))
            return step(state, batch, t=torch.from_numpy(t).long(), noise=noise)
        return run

    sched = make_schedule(cfg.diffusion.base_steps, cfg.diffusion.noise_schedule, "")
    state = train(CFG.unet, sched, UNetModel(CFG.unet), iter([batch]), total_steps=4, ckpt_dir=str(tdir),
                  log_every=100, step_transform=inject)
    assert state.step == 4
    got = train_tensors(state, gather=False)
    assert got.keys() == want.keys()
    for fam in FAMILIES:
        assert worst_rel(got, want, fam) <= TRAIN_TOL, fam


def test_save_train_state_refuses_differing_adam_counts(tmp_path):
    """optax keeps one Adam count: a state whose parameters' counts differ
    is refused; a state before any step writes count 0 and zero moments."""
    model = UNetModel(CFG.unet)
    state = init_train_state(model, make_optimizer(model.parameters(), grad_clip=1.0))
    save_train_state(str(tmp_path / "step_0"), state)
    tree = load_params(str(tmp_path / "step_0"))
    assert int(tree["opt_state"][1][0]["count"]) == 0 and int(tree["step"]) == 0
    assert all(not v.any() for _, v in tree_leaves(tree["opt_state"][1][0]["mu"]))
    opt = state.optimizer.state_dict()
    p0 = dict(model.named_parameters())
    opt["state"] = {i: {"step": torch.tensor(float(1 + (i == 0))), "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.zeros_like(p)} for i, p in enumerate(p0.values())}
    state.optimizer.load_state_dict(opt)
    with pytest.raises(ValueError, match="Adam step counts"):
        jax_train_tree(whole_state(state), state)


def test_jax_serves_a_port_export(tmp_path):
    """``cli.train --init_from <signal weights> --export_model_dir`` (every
    weight random, so that a sample carries signal): the JAX package's
    ``DragEngine.from_model_dir`` loads the EMA and the decoder bit for bit,
    and its DDIM-10 from the fixture's x_T equals the port's engine's on
    the same dir (atol 1e-4)."""
    init = tmp_path / "init.pt"
    torch.save(signal_unet(CFG.unet, seed=9).state_dict(), init)
    dec = TriplaneDecoder(CFG.plane_channels)
    with torch.no_grad():
        for p in dec.parameters():
            p.normal_()
    torch.save(dec.state_dict(), tmp_path / "dec.pt")
    out = tmp_path / "exported"
    state = tcli.main(["--preset", "tiny", "--synthetic", "2", "--steps", "1", "--batch_size", "2", "--ckpt_dir",
                       str(tmp_path / "ck"), "--init_from", str(init), "--export_model_dir", str(out),
                       "--decoder_from", str(tmp_path / "dec.pt"), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["decoder.orbax", "statistics", "unet.orbax"]
    jeng = JDragEngine.from_model_dir(str(out), config=jpreset("tiny", 10, use_ddim=True))
    for k, v in unet_state_dict_from_jax(jax.tree.map(np.asarray, jeng.unet_params)).items():
        assert torch.equal(v, state.ema_params[k]), k
    for k, v in decoder_state_dict_from_jax(jax.tree.map(np.asarray, jeng.decoder_params)).items():
        assert torch.equal(v, dec.state_dict()[k]), k
    x_T = np.load(os.path.join(ASSETS, "jax_ddim.npz"))["x_T"]
    want = np.asarray(jdiff.ddim_sample_loop(jeng.sched, jeng._model_fn(False), jnp.asarray(x_T),
                                             jax.random.PRNGKey(4), clip_denoised=CFG.diffusion.clip_denoised))
    eng = DragEngine.from_model_dir(str(out), config=CFG, device="cpu")
    with torch.no_grad():
        got = tdiff.ddim_sample_loop(eng.sched, eng.model_fn(), torch.from_numpy(x_T),
                                     clip_denoised=CFG.diffusion.clip_denoised).numpy()
    assert np.abs(want).max() > 0.1  # the sample carries signal
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_convert_model_dir_matches_jax(tmp_path):
    """``convert_model_dir`` of a reference ``.pt`` dir, by the port and by
    the JAX package: orbax restores the two ``unet.orbax`` and the two
    ``decoder.orbax`` to equal trees, bit for bit, and the port reads its
    own to the same."""
    src = tmp_path / "src"
    (src / "ddpm_tiny_ckpts").mkdir(parents=True)
    torch.save(signal_unet(CFG.unet, seed=12).state_dict(), src / "ddpm_tiny_ckpts" / "ema_5.pt")
    torch.save(TriplaneDecoder(CFG.plane_channels).state_dict(), src / "tiny_decoder.pt")
    assert convert_model_dir(str(src), str(tmp_path / "port")) == str(tmp_path / "port")
    j_convert_model_dir(str(src), str(tmp_path / "jax"))
    for name in ("unet.orbax", "decoder.orbax"):
        want = j_load_params(str(tmp_path / "jax" / name))
        assert_same_tree(j_load_params(str(tmp_path / "port" / name)), want)
        assert_same_tree(load_params(str(tmp_path / "port" / name)), want)
    convert_model_dir(str(src))
    assert {"unet.orbax", "decoder.orbax"} <= set(os.listdir(src))
    leaves = [leaf_bytes(v) for _, v in tree_leaves(load_params(str(src / "decoder.orbax")))]
    assert [d for _, d, _ in leaves] == ["float32"] * len(leaves)


def test_writer_imports_no_jax(tmp_path):
    """A fresh interpreter trains the tiny preset for 2 steps with a
    checkpoint, exports a model dir and converts a ``.pt`` dir, all as
    orbax, and serves the export; no module of JAX, orbax, tensorstore,
    zstandard or the JAX package is imported."""
    code = (
        "import sys, torch\n"
        "from ishapediting_tpu_torch.cli.train import main\n"
        "from ishapediting_tpu_torch.config import preset\n"
        "from ishapediting_tpu_torch.edit.engine import DragEngine\n"
        "from ishapediting_tpu_torch.io.checkpoint import convert_model_dir\n"
        "from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder\n"
        f"root = {str(tmp_path)!r}\n"
        "torch.save(TriplaneDecoder(2).state_dict(), root + '/dec.pt')\n"
        "state = main(['--preset', 'tiny', '--synthetic', '2', '--steps', '2', '--batch_size', '2', '--ckpt_dir',"
        " root + '/ck', '--export_model_dir', root + '/m', '--decoder_from', root + '/dec.pt', '--device', 'cpu'])\n"
        "import os; os.makedirs(root + '/src/ddpm_tiny_ckpts')\n"
        "torch.save(state.model.state_dict(), root + '/src/ddpm_tiny_ckpts/ema_2.pt')\n"
        "torch.save(TriplaneDecoder(2).state_dict(), root + '/src/tiny_decoder.pt')\n"
        "convert_model_dir(root + '/src')\n"
        "DragEngine.from_model_dir(root + '/m', config=preset('tiny'), device='cpu')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(sorted(os.listdir(root + '/ck/step_2')), sorted(os.listdir(root + '/src')), bad)\n"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert run.returncode == 0, run.stderr[-3000:]
    last = run.stdout.strip().splitlines()[-1]
    assert last.endswith("[]") and "manifest.ocdbt" in last and "'unet.orbax'" in last, last
