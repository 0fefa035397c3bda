"""Port parity, reading the JAX package's orbax checkpoints
(``ishapediting_tpu_torch/io/orbax.py`` and the zstd decoder of
``native/native.cpp``): the decoder against ``zstandard`` on a corpus; the
OCDBT store's keys and values against tensorstore, bit for bit;
``load_params`` against orbax's restore, bit for bit; the model dir, the
CLIs and the train state of the JAX package served and resumed by the
port (DDIM latents atol 1e-4 as ``test_torch_sampling.py``; the resumed
step 1e-4 relative as ``test_torch_train.py``); the committed fixture
``tests/assets/orbax`` (``tests/assets/make_orbax_assets.py``) against its
hashes; and a reader that imports no JAX, orbax, tensorstore or zstandard.
"""

import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.core.schedule import make_schedule as j_make_schedule
from ishapediting_tpu.io.checkpoint import load_params as j_load_params
from ishapediting_tpu.io.checkpoint import save_params as j_save_params
from ishapediting_tpu.models.unet import init_unet_params
from ishapediting_tpu.train import trainer as jtrainer
from ishapediting_tpu_torch import native
from ishapediting_tpu_torch.cli import train as tcli
from ishapediting_tpu_torch.cli.decode import main as decode_main
from ishapediting_tpu_torch.config import preset
from ishapediting_tpu_torch.core import diffusion as tdiff
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.io import orbax as torbax
from ishapediting_tpu_torch.io.convert import decoder_state_dict_from_jax, unet_state_dict_from_jax
from ishapediting_tpu_torch.io.model_dir import discover_model_dir
from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder
from ishapediting_tpu_torch.train.loop import latest_checkpoint, train
from tests.test_torch_tensor_parallel import FAMILIES, worst_rel
from torch_tp_workers import train_tensors

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "tests", "assets", "orbax")
MODEL = os.path.join(ASSETS, "model")
STEP3 = os.path.join(ASSETS, "train", "step_3")
CFG = preset("tiny", 10, use_ddim=True)
ATOL = 1e-4
TRAIN_TOL = 1e-4
FORBIDDEN = ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "ishapediting_tpu")


def tree_leaves(tree):
    """(path, leaf) pairs, ``None`` leaves kept, paths as the fixture script
    writes them (dict keys and sequence indices joined by '/')."""
    pairs = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf) for path, leaf in pairs]


def leaf_bytes(leaf):
    """The leaf's bytes, dtype name and shape (a bf16 tensor by its bits)."""
    if isinstance(leaf, torch.Tensor):
        dtype = "bfloat16" if leaf.dtype == torch.bfloat16 else str(leaf.numpy().dtype)
        arr = leaf.view(torch.uint16).numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
    else:
        arr = np.asarray(leaf)
        dtype = str(arr.dtype)
    arr = np.ascontiguousarray(arr)
    return arr.tobytes(), dtype, list(arr.shape)


def assert_same_tree(got, want):
    """``load_params``'s tree against orbax's restore: the same paths, the
    same ``None`` leaves, each array's bytes, dtype and shape equal."""
    g, w = tree_leaves(got), tree_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if b is None:
            assert a is None, path
            continue
        assert leaf_bytes(a) == leaf_bytes(b), path


# ---------------------------------------------------------------------------
# the zstd decoder
# ---------------------------------------------------------------------------


def corpus():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 1000, 65536, 131072, 131073, 400_000, 8 << 20):
        yield f"random{n}", rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        yield f"float{n}", rng.normal(size=n // 4).astype(np.float32).tobytes()
        yield f"text{n}", (b"the quick brown fox jumps over the lazy dog %d " * (n // 40 + 1))[:n]
        yield f"lowentropy{n}", rng.integers(0, 4, n, dtype=np.uint8).tobytes()
        if n <= 400_000:
            yield f"zeros{n}", bytes(n)


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_matches_zstandard(level):
    """Random, float, text, low-entropy and zero data from 0 B to 8 MiB,
    with and without the content checksum and the content size, decoded
    to zstandard's input byte for byte (level 19 up to 400 kB)."""
    for name, data in corpus():
        if level == 19 and len(data) > 400_000:
            continue
        for checksum in (False, True):
            comp = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                            write_content_size=not checksum).compress(data)
            assert native.zstd_decompress(comp) == data, (name, checksum)


def test_zstd_frames_streams_and_refusals():
    """Several frames and a skippable frame in one buffer; a streamed frame
    (no content size); corrupt input raises ``ValueError`` at every one of
    200 single-byte flips, as do truncations; a frame naming a dictionary is
    refused by name."""
    rng = np.random.default_rng(1)
    a, b = b"hello world " * 900, rng.normal(size=3000).astype(np.float32).tobytes()
    z = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skippable = struct.pack("<II", 0x184D2A53, 9) + b"skip this"
    assert native.zstd_decompress(z.compress(a) + skippable + z.compress(b)) == a + b
    stream = z.compressobj()
    assert native.zstd_decompress(stream.compress(a * 50) + stream.flush()) == a * 50
    comp = z.compress(rng.normal(size=50_000).astype(np.float32).tobytes())
    for i in np.linspace(0, len(comp) - 1, 200).astype(int):
        bad = bytearray(comp)
        bad[i] ^= 0x5A
        with pytest.raises(ValueError, match="zstd"):
            native.zstd_decompress(bytes(bad))
    for cut in (0, 3, 10, len(comp) // 2, len(comp) - 1):
        with pytest.raises(ValueError, match="zstd"):
            native.zstd_decompress(comp[:cut])
    samples = [bytes(rng.integers(97, 105, 300, dtype=np.uint8)) for _ in range(200)]
    d = zstandard.train_dictionary(2048, samples)
    with pytest.raises(ValueError, match=f"dictionary {d.dict_id()}"):
        native.zstd_decompress(zstandard.ZstdCompressor(dict_data=d).compress(samples[0]))


# ---------------------------------------------------------------------------
# the OCDBT store and zarr
# ---------------------------------------------------------------------------


def ts_kv(path):
    return ts.KvStore.open({"driver": "ocdbt", "base": "file://" + os.path.abspath(path)}).result()


def assert_store_matches_tensorstore(path):
    kv = ts_kv(path)
    want = {k: kv.read(k).result().value for k in kv.list().result()}
    store = torbax.OcdbtStore(path)
    assert store.keys() == sorted(want)
    for k, v in want.items():
        assert store.read(k) == v, k


@pytest.fixture(scope="module")
def deep_store(tmp_path_factory):
    """A store tensorstore wrote with small nodes and inline values (so
    interior B+tree nodes, out-of-line values in shared data files, and a
    version tree behind 23 versions)."""
    path = tmp_path_factory.mktemp("ocdbt") / "deep"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                          "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16}}).result()
    rng = np.random.default_rng(2)
    txn = ts.Transaction()
    for i in range(60):
        kv.with_transaction(txn)[f"group{i % 3}/key{i:03d}"] = rng.integers(0, 256, int(rng.integers(1, 60)),
                                                                            dtype=np.uint8).tobytes()
    txn.commit_async().result()
    for j in range(21):
        kv[f"later{j}"] = b"x" * j
    return path


def test_ocdbt_keys_and_values_match_tensorstore(deep_store):
    """Every key and value, bit for bit, of the fixture's train state (the
    merged root store and its process's store) and of a store with interior
    nodes; the version tree lists every generation."""
    for path in (STEP3, os.path.join(STEP3, "ocdbt.process_0"), os.path.join(MODEL, "unet.orbax"), deep_store):
        assert_store_matches_tensorstore(path)
    store = torbax.OcdbtStore(deep_store)
    assert max(store.inline["height"]) >= 2 and store.version_nodes["generation"]
    assert store.versions() == list(range(1, 24))  # the empty first version, the transaction, 21 writes


def test_zarr_edge_and_missing_chunks(tmp_path):
    """zarr v2 arrays tensorstore wrote into an OCDBT store: chunks that do
    not divide the shape (edge chunks stored whole), chunks never written
    (the fill value), bf16, a 0-d array; another compressor is refused by
    name."""
    base = {"driver": "ocdbt", "base": f"file://{tmp_path / 'z'}"}
    rng = np.random.default_rng(3)
    cases = {
        "edge": ("<f4", [10, 7], [4, 3], None, rng.normal(size=(10, 7)).astype(np.float32)),
        "bf16": ("bfloat16", [5, 9], [2, 4], None, rng.normal(size=(5, 9)).astype(jnp.bfloat16)),
        "scalar": ("<i4", [], [], None, np.array(7, np.int32)),
    }
    for name, (dtype, shape, chunks, _, data) in cases.items():
        arr = ts.open({"driver": "zarr", "kvstore": base, "path": name,
                       "metadata": {"dtype": dtype, "shape": shape, "chunks": chunks,
                                    "compressor": {"id": "zstd", "level": 3}}}, create=True).result()
        arr.write(data).result()
    sparse = ts.open({"driver": "zarr", "kvstore": base, "path": "sparse",
                      "metadata": {"dtype": "<f8", "shape": [9, 4], "chunks": [4, 4], "fill_value": 2.5,
                                   "compressor": {"id": "zstd"}}}, create=True).result()
    sparse[4:8, :].write(np.ones((4, 4))).result()
    zlib = ts.open({"driver": "zarr", "kvstore": base, "path": "zlib",
                    "metadata": {"dtype": "<f4", "shape": [3], "chunks": [3], "compressor": {"id": "zlib"}}},
                   create=True).result()
    zlib.write(np.ones(3, np.float32)).result()
    store = torbax.OcdbtStore(tmp_path / "z")
    for name, (*_, data) in cases.items():
        assert leaf_bytes(torbax.read_zarr(store, name)) == leaf_bytes(
            torch.from_numpy(data.view(np.uint16)).view(torch.bfloat16) if name == "bf16" else data), name
    want = np.full((9, 4), 2.5)
    want[4:8] = 1.0
    np.testing.assert_array_equal(torbax.read_zarr(store, "sparse").numpy(), want)
    assert b"sparse/0.0" not in store and b"sparse/2.0" not in store
    with pytest.raises(torbax.OrbaxFormatError, match="compressor 'zlib'"):
        torbax.read_zarr(store, "zlib")


# ---------------------------------------------------------------------------
# load_params against orbax's restore
# ---------------------------------------------------------------------------


def test_load_params_matches_orbax_on_the_fixture():
    """The fixture's UNet, decoder and train state (with its ``None``
    optimizer leaves and lists), bit for bit."""
    for path in (os.path.join(MODEL, "unet.orbax"), os.path.join(MODEL, "decoder.orbax"), STEP3):
        assert_same_tree(torbax.load_params(path), j_load_params(path))


def test_load_params_bf16_and_sharded_saves(tmp_path):
    """``save_params`` of bf16, f16, int and bool leaves and of arrays
    sharded over the 8 virtual CPU devices (one chunk per shard), bit for
    bit against orbax's restore."""
    rng = np.random.default_rng(4)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    tree = {
        "bf16": {"w": jnp.asarray(rng.normal(size=(33, 7)), jnp.bfloat16),
                 "b": jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16)},
        "f16": jnp.asarray(rng.normal(size=(4, 4)), jnp.float16),
        "count": jnp.array(3, jnp.int32),
        "mask": jnp.asarray(rng.random(6) > 0.5),
        "big": jnp.asarray(rng.normal(size=(300, 500)).astype(np.float32)),
        "sharded": jax.device_put(jnp.asarray(rng.normal(size=(12, 6)).astype(np.float32)),
                                  NamedSharding(mesh, P("x", "y"))),
        "rows": jax.device_put(jnp.asarray(rng.normal(size=(16, 3)), jnp.bfloat16), NamedSharding(mesh, P("x"))),
    }
    path = str(tmp_path / "tree.orbax")
    j_save_params(path, tree)
    store = torbax.OcdbtStore(path)
    assert sum(k.startswith(b"sharded/") for k in store.keys()) == 9  # .zarray + 8 chunks
    assert_same_tree(torbax.load_params(path), j_load_params(path))


def test_load_params_refusals(tmp_path):
    """An empty dir names the missing file; zarr v3, a manifest kind the
    reader does not know and a corrupt manifest are refused by name."""
    empty = tmp_path / "decoder.orbax"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="manifest.ocdbt"):
        torbax.load_params(str(empty))
    shutil.rmtree(empty)
    shutil.copytree(os.path.join(MODEL, "decoder.orbax"), empty)
    os.remove(empty / "_METADATA")
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        torbax.load_params(str(empty))
    bad = tmp_path / "v3"
    shutil.copytree(os.path.join(MODEL, "decoder.orbax"), bad)
    meta = json.loads((bad / "_METADATA").read_text())
    (bad / "_METADATA").write_text(json.dumps(dict(meta, use_zarr3=True)))
    with pytest.raises(torbax.OrbaxFormatError, match="zarr v3"):
        torbax.load_params(str(bad))
    manifest = bytearray((bad / "manifest.ocdbt").read_bytes())
    manifest[20] ^= 1
    (bad / "manifest.ocdbt").write_bytes(bytes(manifest))
    with pytest.raises(torbax.OrbaxFormatError, match="CRC-32C"):
        torbax.OcdbtStore(str(bad))
    kind = tmp_path / "kind"
    kind.mkdir()
    raw = bytes(16) + bytes([1]) + bytes(8)  # uuid, manifest kind 1 (numbered), ...
    frame = struct.pack(">I", torbax.MANIFEST_MAGIC) + struct.pack("<Q", 14 + len(raw) + 4) + b"\x00\x00" + raw
    (kind / "manifest.ocdbt").write_bytes(frame + struct.pack("<I", native.crc32c(frame)))
    with pytest.raises(torbax.OrbaxFormatError, match="manifest kind 1"):
        torbax.OcdbtStore(str(kind))


def test_fixture_matches_its_hashes():
    """Every leaf of the committed fixture, read by the port, has the
    SHA-256, dtype and shape JAX's restore gave when it was written."""
    with open(os.path.join(ASSETS, "sha256.json")) as f:
        want = json.load(f)
    for name, leaves in want.items():
        got = {p: v for p, v in tree_leaves(torbax.load_params(os.path.join(ASSETS, name))) if v is not None}
        assert sorted(got) == sorted(leaves), name
        for p, leaf in got.items():
            data, dtype, shape = leaf_bytes(leaf)
            assert {"sha256": hashlib.sha256(data).hexdigest(), "dtype": dtype, "shape": shape} == leaves[p], p


def test_reader_imports_no_jax():
    """A fresh interpreter loads the fixture's trees and serves its model
    dir; no module of JAX, orbax, tensorstore, zstandard or the JAX package
    is imported."""
    code = (
        "import sys\n"
        "from ishapediting_tpu_torch.io.orbax import load_params\n"
        "from ishapediting_tpu_torch.edit.engine import DragEngine\n"
        "from ishapediting_tpu_torch.config import preset\n"
        f"load_params({STEP3!r})\n"
        f"DragEngine.from_model_dir({MODEL!r}, config=preset('tiny'), device='cpu')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=180, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# serving and decoding a model dir the JAX package wrote
# ---------------------------------------------------------------------------


def port_ddim(model_dir):
    eng = DragEngine.from_model_dir(model_dir, config=CFG, device="cpu")
    x_T = torch.from_numpy(np.load(os.path.join(ASSETS, "jax_ddim.npz"))["x_T"])
    with torch.no_grad():
        out = tdiff.ddim_sample_loop(eng.sched, eng.model_fn(), x_T, clip_denoised=CFG.diffusion.clip_denoised)
    return eng, out.numpy()


@pytest.mark.parametrize("layout", ["orbax_only", "both_formats"])
def test_from_model_dir_serves_the_jax_model(tmp_path, layout):
    """``DragEngine.from_model_dir`` on the JAX package's model dir (and on
    a copy that also holds ``.pt`` files of other weights: orbax wins, as in
    the JAX package): the weights are the orbax ones, and DDIM-10 from the
    fixture's x_T equals the JAX engine's latents (atol 1e-4)."""
    d = tmp_path / "model"
    shutil.copytree(MODEL, d)
    if layout == "both_formats":
        other = init_unet_(UNetModel(CFG.unet), torch.Generator().manual_seed(9))
        (d / "ddpm_tiny_ckpts").mkdir()
        torch.save(other.state_dict(), d / "ddpm_tiny_ckpts" / "ema_1.pt")
        torch.save(TriplaneDecoder(CFG.plane_channels).state_dict(), d / "tiny_decoder.pt")
        info = discover_model_dir(str(d))
        assert info.unet_ckpt and info.decoder_ckpt and info.unet_orbax and info.decoder_orbax
    eng, got = port_ddim(str(d))
    want_unet = unet_state_dict_from_jax(j_load_params(os.path.join(MODEL, "unet.orbax")))
    for k, v in eng.unet.state_dict().items():
        assert torch.equal(v, want_unet[k]), k
    want_dec = decoder_state_dict_from_jax(j_load_params(os.path.join(MODEL, "decoder.orbax")))
    for k, v in eng.decoder.state_dict().items():
        assert torch.equal(v, want_dec[k]), k
    np.testing.assert_allclose(got, np.load(os.path.join(ASSETS, "jax_ddim.npz"))["ddim"], atol=ATOL)


def test_cli_decode_reads_an_orbax_decoder(tmp_path):
    """``cli.decode --model_path <decoder.orbax>`` and ``--model_dir`` (its
    orbax decoder preferred over a ``.pt``) write the mesh a ``.pt`` of the
    same weights gives; an empty ``decoder.orbax`` names the missing file."""
    rng = np.random.default_rng(5)
    src = str(tmp_path / "p.npy")
    np.save(src, rng.normal(size=(3, CFG.plane_channels, 16, 16)).astype(np.float32))
    pt = tmp_path / "dec.pt"
    torch.save(decoder_state_dict_from_jax(j_load_params(os.path.join(MODEL, "decoder.orbax"))), pt)
    d = tmp_path / "model"
    shutil.copytree(MODEL, d)
    torch.save(TriplaneDecoder(CFG.plane_channels).state_dict(), d / "zeros_decoder.pt")
    common = ["--input", src, "--res", "24", "--device", "cpu"]
    outs = {}
    for name, flags in (("pt", ["--model_path", str(pt)]),
                        ("orbax", ["--model_path", os.path.join(MODEL, "decoder.orbax")]),
                        ("dir", ["--model_dir", str(d)])):
        out = tmp_path / f"{name}.obj"
        decode_main(common + ["--output", str(out)] + flags)
        outs[name] = out.read_bytes()
    assert outs["pt"] == outs["orbax"] == outs["dir"] and len(outs["pt"]) > 0
    empty = tmp_path / "empty" / "decoder.orbax"
    empty.mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="manifest.ocdbt"):
        decode_main(common + ["--output", str(tmp_path / "e.obj"), "--model_path", str(empty)])


def test_cli_train_decoder_from_orbax(tmp_path):
    """``cli.train --export_model_dir --decoder_from <decoder.orbax>``
    exports the JAX decoder as ``decoder.orbax``; the dir serves it."""
    out = tmp_path / "exported"
    tcli.main(["--preset", "tiny", "--synthetic", "2", "--steps", "1", "--batch_size", "2", "--ckpt_dir",
               str(tmp_path / "ck"), "--export_model_dir", str(out), "--decoder_from",
               os.path.join(MODEL, "decoder.orbax"), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["decoder.orbax", "statistics", "unet.orbax"]
    eng = DragEngine.from_model_dir(str(out), config=CFG, device="cpu")
    want = decoder_state_dict_from_jax(j_load_params(os.path.join(MODEL, "decoder.orbax")))
    for k, v in eng.decoder.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# resuming the JAX package's train state
# ---------------------------------------------------------------------------


def test_train_resumes_the_jax_train_state(tmp_path):
    """``train`` resumed from the JAX package's ``step_3`` (the newest
    ``step_<N>``, whatever its format) takes one step with JAX's draws
    injected (the tiny UNet has no dropout) and equals JAX's
    ``make_train_step`` from the same state: loss,
    mse, vb and grad_norm at 1e-4 relative; the parameters, EMA and Adam
    moments after the step at 1e-4 relative L2 per tensor against the
    larger of its norm and 1e-4 of its family's; the step reaches 4."""
    cfg = jpreset("tiny")
    opt = jtrainer.make_optimizer(1e-4, grad_clip=1.0)
    template = jtrainer.init_train_state(init_unet_params(jax.random.PRNGKey(0), cfg.unet), opt)
    jstate = j_load_params(STEP3, target=template)
    jsched = j_make_schedule(cfg.diffusion.base_steps, cfg.diffusion.noise_schedule, "")
    batch = np.clip(np.random.default_rng(6).normal(size=(2,) + cfg.latent_shape), -1, 1).astype(np.float32)
    rng = jax.random.PRNGKey(21)
    r_t, r_loss, _ = jax.random.split(rng, 3)
    t = np.asarray(jax.random.randint(r_t, (2,), 0, jsched.num_timesteps, jnp.int32))
    assert t.min() > 0  # t = 0's decoder NLL differs in the last ulp of tanh (test_torch_losses.py)
    new, metrics = jax.jit(jtrainer.make_train_step(cfg.unet, jsched, opt))(jstate, jnp.asarray(batch), rng)
    adam = next(s for s in jax.tree_util.tree_leaves(new.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))
    want = {}
    for fam, tree in (("p", new.params), ("ema", new.ema_params), ("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want.update({f"{fam}.{k}": v.numpy() for k, v in unet_state_dict_from_jax(
            jax.tree.map(np.asarray, tree)).items()})

    ckpt = tmp_path / "ckpts"
    shutil.copytree(os.path.dirname(STEP3), ckpt)
    assert latest_checkpoint(str(ckpt)).endswith("step_3")
    seen = {}

    def inject(step):
        def run(state, batch, gen):
            seen["metrics"] = step(state, batch, t=torch.from_numpy(t).long(),
                                   noise=torch.from_numpy(np.asarray(jax.random.normal(r_loss, batch.shape))))
            return seen["metrics"]
        return run

    model = UNetModel(CFG.unet)
    state = train(CFG.unet, make_schedule(cfg.diffusion.base_steps, cfg.diffusion.noise_schedule, ""), model,
                  iter([batch]), total_steps=4, ckpt_dir=str(ckpt), log_every=100, step_transform=inject)
    assert state.step == 4 and latest_checkpoint(str(ckpt)).endswith("step_4")
    for k in ("loss", "mse", "vb", "grad_norm"):
        assert abs(seen["metrics"][k] - float(metrics[k])) <= TRAIN_TOL * abs(float(metrics[k])), k
    got = train_tensors(state, gather=False)
    assert got.keys() == want.keys()
    for fam in FAMILIES:
        assert worst_rel(got, want, fam) <= TRAIN_TOL, fam
