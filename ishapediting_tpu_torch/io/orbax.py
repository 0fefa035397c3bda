"""Read the JAX package's orbax checkpoints without JAX, orbax or
tensorstore: model dirs (``unet.orbax``, ``decoder.orbax``, written by its
``io/checkpoint.py::save_params``) and train states (``step_<N>``).

An orbax checkpoint of the JAX package is three layers, each read here:

1. **OCDBT**, tensorstore's key-value store
   (https://google.github.io/tensorstore/kvstore/ocdbt/index.html). The
   root ``manifest.ocdbt`` names the store's versions; the newest names
   the root of a B+tree whose nodes, and the values too large to sit in a
   leaf, live at (file, offset, length) in data files under ``d/`` (the
   root tree of a multi-process save points into each process's
   ``ocdbt.process_<i>/d/``; each process's own ``manifest.ocdbt`` is a
   store of its own). Every manifest and node file is framed: a magic
   number, its length, a format version, a compression (zstd, decoded by
   ``native.zstd_decompress``), a CRC-32C footer. Keys in a node are
   prefix-compressed, and a child's keys drop the prefix its subtree
   shares. Older versions sit in a version tree (``versions``).
2. **zarr v2**: each array is ``<name>/.zarray`` (shape, chunks, dtype,
   order, fill value, compressor) and one value per chunk
   (``<name>/i.j.k``), each a zstd frame of the chunk's bytes in C order;
   edge chunks are stored whole, absent chunks hold the fill value.
3. **orbax** ``_METADATA``: the tree, each leaf's key path (dict keys or
   sequence indices) whose dotted join names its array.

``load_params(path)`` returns what the JAX package's ``load_params(path)``
restores without a target: nested dicts and lists, ``None`` where the tree
held one, each array a CPU ``torch.Tensor`` of the saved dtype (bf16 stays
``torch.bfloat16``). Anything the format allows that this reader does not
know (another compressor, zarr v3, a field of OCDBT it has not seen) is
refused by name. Writing orbax is not ported: the port saves torch files.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ishapediting_tpu_torch import native

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
NO_ROOT = 2**64 - 1  # the root location of an empty version

DTYPES = {"<f2": np.float16, "<f4": np.float32, "<f8": np.float64, "|i1": np.int8, "<i2": np.int16,
          "<i4": np.int32, "<i8": np.int64, "|u1": np.uint8, "<u2": np.uint16, "<u4": np.uint32,
          "<u8": np.uint64, "|b1": np.bool_, "bfloat16": np.uint16}


class OrbaxFormatError(ValueError):
    """The checkpoint holds something this reader does not know."""


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.b, self.i, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            raise OrbaxFormatError(f"{self.what}: truncated")
        out = self.b[self.i : self.i + n]
        self.i += n
        return out

    def varint(self) -> int:
        out = shift = 0
        while True:
            c = self.take(1)[0]
            out |= (c & 0x7F) << shift
            shift += 7
            if not c & 0x80:
                return out
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self) -> None:
        if self.i != len(self.b):
            raise OrbaxFormatError(f"{self.what}: {len(self.b) - self.i} bytes of unknown fields at the end")


def _unframe(data: bytes, magic: int, what: str) -> _Cursor:
    """The body of an OCDBT manifest or node file (checked and decoded)."""
    if len(data) < 18 or int.from_bytes(data[:4], "big") != magic:
        raise OrbaxFormatError(f"{what}: not an OCDBT file of magic {magic:#010x}")
    if int.from_bytes(data[4:12], "little") != len(data):
        raise OrbaxFormatError(f"{what}: length field {int.from_bytes(data[4:12], 'little')} for {len(data)} bytes")
    if native.crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OrbaxFormatError(f"{what}: CRC-32C mismatch")
    head = _Cursor(data[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: OCDBT format version {version} (this reader knows 0)")
    body = head.b[head.i :]
    if compression == 1:
        body = native.zstd_decompress(body)
    elif compression != 0:
        raise OrbaxFormatError(f"{what}: OCDBT compression {compression} (this reader knows none and zstd)")
    return _Cursor(body, what)


def _file_table(c: _Cursor) -> List[Tuple[str, str]]:
    """A data file table: (base path, relative path) per file, each full
    path prefix-compressed against the one before."""
    n = c.varint()
    shared = [0] + c.varints(n - 1) if n else []
    suffix, base = c.varints(n), c.varints(n)
    out, prev = [], b""
    for i in range(n):
        full = prev[: shared[i]] + c.take(suffix[i])
        out.append((full[: base[i]].decode(), full[base[i] :].decode()))
        prev = full
    return out


def _keys(c: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], Optional[List[int]]]:
    shared = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else None
    out, prev = [], b""
    for i in range(n):
        prev = prev[: shared[i]] + c.take(suffix[i])
        out.append(prev)
    return out, common


class OcdbtStore:
    """An OCDBT store on the local disk: ``keys()`` and ``read(key)`` of its
    newest version (``versions()`` lists every generation)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: no OCDBT manifest (an orbax checkpoint written with OCDBT has one)")
        with open(path, "rb") as f:
            c = _unframe(f.read(), MANIFEST_MAGIC, path)
        c.take(16)  # the store's uuid
        kind = c.varint()
        if kind != 0:
            raise OrbaxFormatError(f"{path}: manifest kind {kind} (this reader knows the single manifest, 0)")
        c.varint(), c.varint()  # max inline value bytes, max decoded node bytes
        c.u8s(1)  # version tree arity (log2)
        compression = c.varint()
        if compression == 1:
            c.varint()  # zstd level
            unknown = c.varints(3)
            if any(unknown):
                raise OrbaxFormatError(f"{path}: unknown zstd config fields {unknown}")
        elif compression != 0:
            raise OrbaxFormatError(f"{path}: config compression {compression} (this reader knows none and zstd)")
        self.files = _file_table(c)
        n = c.varint()
        self.inline = dict(generation=c.varints(n), height=c.u8s(n), file=c.varints(n), offset=c.varints(n),
                           length=c.varints(n), num_keys=c.varints(n), tree_bytes=c.varints(n),
                           indirect_bytes=c.varints(n), commit_time=c.u64s(n))
        m = c.varint()
        self.version_nodes = dict(generation=c.varints(m), file=c.varints(m), offset=c.varints(m),
                                  length=c.varints(m), num_generations=c.varints(m), commit_time=c.u64s(m),
                                  height=c.u8s(m))
        c.end()
        self._values: Optional[Dict[bytes, object]] = None

    def _path(self, files, fid: int) -> str:
        if fid >= len(files):
            raise OrbaxFormatError(f"{self.root}: data file {fid} of {len(files)}")
        rel = os.path.normpath(os.path.join(*files[fid]))
        if os.path.isabs(rel) or rel.startswith(".."):
            raise OrbaxFormatError(f"{self.root}: data file {rel} outside the store")
        return os.path.join(self.root, rel)

    def _read_at(self, files, fid: int, offset: int, length: int) -> bytes:
        path = self._path(files, fid)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OrbaxFormatError(f"{path}: {length} bytes at {offset} past its end")
        return data

    def _walk(self, files, loc, height: int, prefix: bytes, out: Dict[bytes, object]) -> None:
        what = f"{self._path(files, loc[0])}@{loc[1]}"
        c = _unframe(self._read_at(files, *loc), BTREE_NODE_MAGIC, what)
        if c.u8s(1)[0] != height:
            raise OrbaxFormatError(f"{what}: B+tree node height differs from its reference's")
        node_files = _file_table(c)
        n = c.varint()
        keys, common = _keys(c, n, height > 0)
        if height > 0:
            fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # each subtree's keys, tree bytes and indirect value bytes
            c.end()
            for i in range(n):
                self._walk(node_files, (fids[i], offs[i], lens[i]), height - 1, prefix + keys[i][: common[i]], out)
            return
        lens, kinds = c.varints(n), c.varints(n)
        if any(k > 1 for k in kinds):
            raise OrbaxFormatError(f"{what}: value kind {max(kinds)} (this reader knows inline 0 and indirect 1)")
        indirect = [i for i in range(n) if kinds[i] == 1]
        fids, offs = c.varints(len(indirect)), c.varints(len(indirect))
        where = dict(zip(indirect, zip(fids, offs)))
        for i in range(n):
            if kinds[i] == 0:
                out[prefix + keys[i]] = c.take(lens[i])
            else:
                out[prefix + keys[i]] = (node_files, where[i][0], where[i][1], lens[i])
        c.end()

    def _index(self) -> Dict[bytes, object]:
        if self._values is None:
            self._values = {}
            if self.inline["generation"]:
                i = int(np.argmax(self.inline["generation"]))
                if self.inline["length"][i] != NO_ROOT and self.inline["num_keys"][i]:
                    loc = (self.inline["file"][i], self.inline["offset"][i], self.inline["length"][i])
                    self._walk(self.files, loc, self.inline["height"][i], b"", self._values)
        return self._values

    def keys(self) -> List[bytes]:
        return sorted(self._index())

    def __contains__(self, key: bytes) -> bool:
        return key in self._index()

    def read(self, key: bytes) -> bytes:
        v = self._index()[key]
        return v if isinstance(v, bytes) else self._read_at(*v)

    def versions(self) -> List[int]:
        """Every generation the store holds, oldest first: those in the
        version tree's nodes and those inline in the manifest."""
        out = []

        def node(files, loc, height):
            what = f"{self._path(files, loc[0])}@{loc[1]}"
            c = _unframe(self._read_at(files, *loc), VERSION_NODE_MAGIC, what)
            _, h = c.u8s(2)  # arity (log2), height
            if h != height:
                raise OrbaxFormatError(f"{what}: version node height differs from its reference's")
            node_files = _file_table(c)
            n = c.varint()
            gens = c.varints(n)
            if height == 0:
                c.u8s(n), c.varints(6 * n), c.u64s(n)  # each version's root and statistics
                out.extend(gens)
            else:
                fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
                c.varints(n), c.u64s(n)  # generations per child, commit times
                for i in range(n):
                    node(node_files, (fids[i], offs[i], lens[i]), height - 1)
            c.end()

        v = self.version_nodes
        for i in range(len(v["generation"])):
            node(self.files, (v["file"][i], v["offset"][i], v["length"][i]), v["height"][i])
        return sorted(out + self.inline["generation"])


def _fill(value) -> object:
    """A zarr v2 fill value (JSON: a number, null or a name of a float)."""
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def read_zarr(store: OcdbtStore, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store``, whole, as a CPU tensor."""
    key = f"{name}/.zarray".encode()
    if key not in store:
        if f"{name}/zarr.json".encode() in store:
            raise OrbaxFormatError(f"{name}: a zarr v3 array (this reader knows zarr v2)")
        raise OrbaxFormatError(f"{name}: no .zarray in {store.root}")
    meta = json.loads(store.read(key))
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr format {meta.get('zarr_format')} (this reader knows 2)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')!r} (this reader knows zstd)")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters {meta['filters']} (this reader knows none)")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {meta['order']!r} (this reader knows C)")
    if meta["dtype"] not in DTYPES:
        raise OrbaxFormatError(f"{name}: dtype {meta['dtype']!r} (this reader knows {sorted(DTYPES)})")
    dtype, sep = np.dtype(DTYPES[meta["dtype"]]), meta.get("dimension_separator", ".")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} for shape {shape}")
    fill = _fill(meta.get("fill_value"))
    if meta["dtype"] == "bfloat16" and fill != 0:
        raise OrbaxFormatError(f"{name}: bfloat16 fill value {fill!r} (this reader knows 0 and null)")
    out = np.full(shape, fill, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        ckey = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        if ckey not in store:
            continue
        raw = store.read(ckey)
        if comp is not None:
            raw = native.zstd_decompress(raw)
        if len(raw) != dtype.itemsize * int(np.prod(chunks, dtype=np.int64)):
            raise OrbaxFormatError(f"{ckey.decode()}: {len(raw)} bytes for a chunk of {chunks} {meta['dtype']}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks)
        lo = [i * c for i, c in zip(idx, chunks)]
        region = tuple(slice(a, min(a + c, s)) for a, c, s in zip(lo, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


def load_params(path: str):
    """The tree of an orbax checkpoint directory of the JAX package, as its
    ``io/checkpoint.py::load_params(path)`` restores it without a target:
    dict keys as dicts, sequence indices as lists, ``None`` leaves as
    ``None``, arrays as CPU tensors (bf16 as ``torch.bfloat16``)."""
    path = os.path.abspath(path)
    store = OcdbtStore(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"{meta_path}: no orbax tree metadata")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: zarr v3 arrays (this reader knows zarr v2)")
    if not meta.get("use_ocdbt", False):
        raise OrbaxFormatError(f"{path}: saved without OCDBT (this reader knows OCDBT stores)")
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        kind = entry["value_metadata"]["value_type"]
        if kind in ("jax.Array", "np.ndarray"):
            value = read_zarr(store, ".".join(k["key"] for k in keys))
        elif kind == "None":
            value = None
        else:
            raise OrbaxFormatError(f"{path}: leaf {[k['key'] for k in keys]} of type {kind!r} "
                                   "(this reader knows jax.Array, np.ndarray and None)")
        leaves.append(([(k["key"], k["key_type"]) for k in keys], value))
    return _build_tree(leaves, path)


def _build_tree(leaves, path: str):
    """Nest (key path, value) pairs: key type 1 is a sequence index (a
    list), 2 a dict key."""
    if len(leaves) == 1 and not leaves[0][0]:
        return leaves[0][1]
    kinds = {keys[0][1] for keys, _ in leaves}
    if len(kinds) != 1 or kinds - {1, 2}:
        raise OrbaxFormatError(f"{path}: key types {sorted(kinds)} at one level (this reader knows 1 and 2)")
    groups: Dict[str, list] = {}
    for keys, value in leaves:
        groups.setdefault(keys[0][0], []).append((keys[1:], value))
    children = {k: _build_tree(v, path) for k, v in groups.items()}
    if kinds == {1}:
        order = sorted(children, key=int)
        if [int(k) for k in order] != list(range(len(order))):
            raise OrbaxFormatError(f"{path}: sequence indices {order}")
        return [children[k] for k in order]
    return children


def load_unet_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The port's UNet state_dict from the JAX package's ``unet.orbax``."""
    from ishapediting_tpu_torch.io.convert import unet_state_dict_from_jax

    return unet_state_dict_from_jax(load_params(path))


def load_decoder(path: str, decoder):
    """The JAX package's ``decoder.orbax`` into ``decoder`` (a
    ``TriplaneDecoder``); returns it."""
    from ishapediting_tpu_torch.io.convert import decoder_state_dict_from_jax

    decoder.load_state_dict(decoder_state_dict_from_jax(load_params(path)))
    return decoder


def _adam_states(tree, where: str, found: list) -> None:
    """Collect optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) in an
    opt_state tree; any other leaf has no counterpart here."""
    if tree is None:
        return
    if isinstance(tree, dict) and set(tree) == {"count", "mu", "nu"}:
        found.append((where, tree))
    elif isinstance(tree, (list, dict)):
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        for k, v in items:
            _adam_states(v, f"{where}/{k}", found)
    else:
        raise OrbaxFormatError(f"{where}: an optimizer leaf with no counterpart in ClippedAdamW "
                               "(this reader maps optax's clip_by_global_norm + adamw)")


def jax_train_state(path: str, state) -> dict:
    """The JAX package's orbax train state ``path`` (``TrainState(step,
    params, ema_params, opt_state)``, optax ``chain(clip_by_global_norm,
    adamw)``) as the port's checkpoint content for ``state``'s model and
    optimizer: whole tensors in the port's layout; ``count`` -> each
    parameter's ``step``, ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``."""
    from ishapediting_tpu_torch.io.checkpoint import _opt_names
    from ishapediting_tpu_torch.io.convert import unet_state_dict_from_jax

    tree = load_params(path)
    if not isinstance(tree, dict) or set(tree) != {"step", "params", "ema_params", "opt_state"}:
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise OrbaxFormatError(f"{path}: a train state holds step, params, ema_params and opt_state, not {got}")
    found: list = []
    _adam_states(tree["opt_state"], "opt_state", found)
    if len(found) != 1:
        raise OrbaxFormatError(f"{path}: {len(found)} Adam states in opt_state (this reader maps one)")
    where, adam = found[0]
    params = unet_state_dict_from_jax(tree["params"])
    mu, nu = unet_state_dict_from_jax(adam["mu"]), unet_state_dict_from_jax(adam["nu"])
    if mu.keys() != params.keys() or nu.keys() != params.keys():
        raise OrbaxFormatError(f"{path}: {where} moments do not match the parameters")
    count = float(adam["count"])
    opt = state.optimizer.state_dict()
    opt["state"] = {i: {"step": torch.tensor(count, dtype=torch.float32), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]} for i, name in enumerate(_opt_names(state))}
    return {"step": int(tree["step"]), "params": params, "ema_params": unet_state_dict_from_jax(tree["ema_params"]),
            "optimizer": opt}
