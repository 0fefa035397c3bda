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
``torch.bfloat16``); ``load_params(path, target=)`` gives the target's
structure, dtypes and devices. Anything the format allows that this reader
does not know (another compressor, zarr v3, a field of OCDBT it has not
seen) is refused by name.

``save_params(path, tree)`` writes what the JAX package's ``save_params``
(orbax 0.11.32's ``StandardCheckpointer``) writes, so that orbax restores
it: one OCDBT store (``manifest.ocdbt`` and one data file under ``d/``
holding the out-of-line values, then the B+tree's nodes), a zarr v2 array
of one chunk per leaf, and orbax's ``_METADATA``, ``_CHECKPOINT_METADATA``,
``_sharding`` and ``array_metadatas/process_0``. Every zstd frame it writes
(chunks, manifest, nodes) holds raw blocks: valid zstd that every decoder
reads, written without an encoder. The OCDBT config and the metadata's
fields are those orbax 0.11.32 writes (``tests/assets/orbax`` holds its
files).
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import struct
import time
from concurrent.futures import ThreadPoolExecutor
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
    out = None
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        ckey = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        if ckey not in store:
            continue
        raw = store.read(ckey)
        data = np.frombuffer(raw, np.uint8) if comp is None else _raw_frame_content(raw)
        if data is None:
            data = np.frombuffer(native.zstd_decompress(raw), np.uint8)
        if len(data) != dtype.itemsize * int(np.prod(chunks, dtype=np.int64)):
            raise OrbaxFormatError(f"{ckey.decode()}: {len(data)} bytes for a chunk of {chunks} {meta['dtype']}")
        chunk = data.view(dtype).reshape(chunks)
        if chunks == shape and data.flags.writeable:  # one chunk, decoded into memory of its own
            out = chunk
            continue
        if out is None:
            out = np.full(shape, fill, dtype)
        lo = [i * c for i, c in zip(idx, chunks)]
        region = tuple(slice(a, min(a + c, s)) for a, c, s in zip(lo, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    t = torch.from_numpy(np.full(shape, fill, dtype) if out is None else out)
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


def load_params(path: str, target=None):
    """The tree of an orbax checkpoint directory of the JAX package, as its
    ``io/checkpoint.py::load_params(path)`` restores it without a target:
    dict keys as dicts, sequence indices as lists, ``None`` leaves as
    ``None``, empty dicts and lists as such, arrays as CPU tensors (bf16 as
    ``torch.bfloat16``). With ``target`` (a tree of tensors, NumPy arrays
    and ``None``, as its ``load_params(path, target=)`` takes one) the
    result has the target's structure (tuples stay tuples) and each leaf
    the target leaf's dtype and device (a NumPy leaf stays NumPy); a leaf
    of another shape or a tree of another structure is refused."""
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
    entries = list(meta["tree_metadata"].values())
    for entry in entries:
        kind = entry["value_metadata"]["value_type"]
        if kind not in ("jax.Array", "np.ndarray") and kind not in EMPTY_LEAVES:
            raise OrbaxFormatError(f"{path}: leaf {[k['key'] for k in entry['key_metadata']]} of type {kind!r} "
                                   f"(this reader knows jax.Array, np.ndarray and {', '.join(EMPTY_LEAVES)})")

    def value(entry):
        kind = entry["value_metadata"]["value_type"]
        if kind in EMPTY_LEAVES:
            return EMPTY_LEAVES[kind]()
        return read_zarr(store, ".".join(k["key"] for k in entry["key_metadata"]))

    store.keys()  # the index, walked once before the threads read
    with ThreadPoolExecutor(IO_THREADS) as pool:
        values = list(pool.map(value, entries))
    leaves = [([(k["key"], k["key_type"]) for k in e["key_metadata"]], v) for e, v in zip(entries, values)]
    tree = _build_tree(leaves, path)
    return tree if target is None else _fit(tree, target, f"{path}:")


EMPTY_LEAVES = {"None": lambda: None, "Dict": dict, "List": list}


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


def _fit(tree, target, where: str):
    """``tree`` (as read) in the structure, dtypes and devices of ``target``."""
    if isinstance(target, dict) or isinstance(target, (list, tuple)):
        same = (isinstance(tree, dict) and isinstance(target, dict) and tree.keys() == target.keys()) or (
            isinstance(tree, list) and isinstance(target, (list, tuple)) and len(tree) == len(target))
        if not same:
            raise ValueError(f"{where} the checkpoint's tree differs from the target's")
        if isinstance(target, dict):
            return {k: _fit(tree[k], v, f"{where}/{k}") for k, v in target.items()}
        return type(target)(_fit(a, b, f"{where}/{i}") for i, (a, b) in enumerate(zip(tree, target)))
    if target is None or tree is None:
        if tree is not None or target is not None:
            raise ValueError(f"{where} None in only one of the checkpoint and the target")
        return None
    if tuple(tree.shape) != tuple(target.shape):
        raise ValueError(f"{where} shape {tuple(tree.shape)} in the checkpoint, {tuple(target.shape)} in the target")
    if isinstance(target, torch.Tensor):
        return tree.to(device=target.device, dtype=target.dtype)
    return tree.numpy().astype(np.asarray(target).dtype)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

# orbax 0.11.32's OCDBT config, as its manifests hold it: inline values up to
# 1 KiB, decoded nodes up to 100 MB, a version tree of arity 16, zstd
# (level 0, no further fields)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
ZARR_COMPRESSOR = {"id": "zstd", "level": 1}  # the .zarray's, as tensorstore writes it for orbax
SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
ITEM_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
RAW_BLOCK = 128 << 10  # the largest zstd block
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
ZARR_DTYPES = {torch.float16: "<f2", torch.float32: "<f4", torch.float64: "<f8", torch.bfloat16: "bfloat16",
               torch.int8: "|i1", torch.int16: "<i2", torch.int32: "<i4", torch.int64: "<i8",
               torch.uint8: "|u1", torch.bool: "|b1"}
# dtypes JAX holds only with x64 on: a tensor of one is written as orbax
# writes a NumPy array, so that the JAX package restores it unchanged
WIDE = (torch.float64, torch.int64)
IO_THREADS = min(8, os.cpu_count() or 1)  # leaves copied, framed and written (or read) at once


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _varints(ns) -> bytes:
    return b"".join(_varint(n) for n in ns)


def zstd_raw_frame(data: np.ndarray) -> np.ndarray:
    """A zstd frame of ``data`` (a 1-D uint8 array) in raw blocks: the frame
    header (no single segment, a 128 KiB window, the 8-byte content size),
    then blocks of up to 128 KiB, each a 3-byte header and its bytes. Built
    in one vectorised copy."""
    n = len(data)
    full, rest = divmod(n, RAW_BLOCK)
    blocks = full + (rest > 0 or n == 0)
    head = ZSTD_MAGIC + bytes([0xC0, (17 - 10) << 3]) + n.to_bytes(8, "little")
    out = np.empty(len(head) + 3 * blocks + n, np.uint8)
    out[: len(head)] = np.frombuffer(head, np.uint8)
    body = out[len(head) : len(head) + full * (RAW_BLOCK + 3)].reshape(full, RAW_BLOCK + 3)
    body[:, :3] = np.frombuffer((RAW_BLOCK << 3).to_bytes(3, "little"), np.uint8)
    body[:, 3:] = data[: full * RAW_BLOCK].reshape(full, RAW_BLOCK)
    if rest or n == 0:
        tail = out[len(head) + full * (RAW_BLOCK + 3) :]
        tail[:3] = np.frombuffer(((rest << 3) | 1).to_bytes(3, "little"), np.uint8)
        tail[3:] = data[full * RAW_BLOCK :]
    else:
        body[-1, 0] |= 1  # the last block
    return out


def _raw_frame_content(frame: bytes) -> Optional[np.ndarray]:
    """The content of a frame exactly as ``zstd_raw_frame`` writes it, by
    one strided copy (uint8, writable); ``None`` for any other input, which
    the general decoder then reads."""
    head = len(ZSTD_MAGIC) + 10
    if frame[:head - 8] != ZSTD_MAGIC + bytes([0xC0, (17 - 10) << 3]):
        return None
    n = int.from_bytes(frame[head - 8 : head], "little")
    full, rest = divmod(n, RAW_BLOCK)
    blocks = full + (rest > 0 or n == 0)
    if len(frame) != head + 3 * blocks + n:
        return None
    b = np.frombuffer(frame, np.uint8)
    body = b[head : head + full * (RAW_BLOCK + 3)].reshape(full, RAW_BLOCK + 3)
    tail = b[head + full * (RAW_BLOCK + 3) :]
    want = np.frombuffer((RAW_BLOCK << 3).to_bytes(3, "little"), np.uint8)
    last_full = rest == 0 and n > 0
    if (body[: full - last_full, :3] != want).any():
        return None
    if last_full and (body[-1, :3] != want | np.array([1, 0, 0], np.uint8)).any():
        return None
    if not last_full and bytes(tail[:3]) != ((rest << 3) | 1).to_bytes(3, "little"):
        return None
    out = np.empty(n, np.uint8)
    out[: full * RAW_BLOCK].reshape(full, RAW_BLOCK)[:] = body[:, 3:]
    out[full * RAW_BLOCK :] = tail[3:]
    return out


def _frame(magic: int, body: bytes) -> bytes:
    """An OCDBT manifest or node file: magic, length, format version 0,
    zstd, the body's frame, CRC-32C."""
    payload = b"\x00\x01" + zstd_raw_frame(np.frombuffer(body, np.uint8)).tobytes()
    data = magic.to_bytes(4, "big") + (12 + len(payload) + 4).to_bytes(8, "little") + payload
    return data + native.crc32c(data).to_bytes(4, "little")


def _file_table_bytes(files: List[str]) -> bytes:
    """The data file table of relative paths (base path empty), without
    prefix compression."""
    if not files:
        return _varint(0)
    raw = [f.encode() for f in files]
    return (_varint(len(raw)) + _varints([0] * (len(raw) - 1)) + _varints(len(r) for r in raw)
            + _varints([0] * len(raw)) + b"".join(raw))


def _shared(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _key_block(keys: List[bytes], common: Optional[List[int]] = None) -> bytes:
    """Prefix-compressed keys: the prefix each shares with the one before,
    each suffix's length, (interior nodes) each subtree's common prefix
    length, then the suffixes."""
    shared = [_shared(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    suffixes = [k[s:] for k, s in zip(keys, [0] + shared)]
    out = _varint(len(keys)) + _varints(shared) + _varints(len(s) for s in suffixes)
    if common is not None:
        out += _varints(common)
    return out + b"".join(suffixes)


class _Subtree:
    """A written B+tree node: its first and last keys (whole), where it
    lies, and its statistics (keys, node bytes, out-of-line value bytes)."""

    def __init__(self, first, last, offset, length, num_keys, tree_bytes, indirect_bytes):
        self.first, self.last, self.offset, self.length = first, last, offset, length
        self.num_keys, self.tree_bytes, self.indirect_bytes = num_keys, tree_bytes, indirect_bytes


class OcdbtWriter:
    """One version of a new OCDBT store at ``root``: ``put(key, bytes)`` in
    any order (values larger than ``max_inline`` go to the data file as
    they come), or ``reserve(key, n)`` for a value of n bytes that a
    thread then writes with ``write_at``; ``close()`` writes the B+tree's
    nodes into the same file after the values, then the manifest. Nodes are
    split so that none decodes to more than ``max_node`` bytes."""

    def __init__(self, root: str, max_inline: int = MAX_INLINE_VALUE_BYTES, max_node: int = MAX_DECODED_NODE_BYTES):
        self.root, self.max_inline, self.max_node = root, max_inline, max_node
        self.file = "d/" + os.urandom(16).hex()
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        self.fd = os.open(os.path.join(root, self.file), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        self.entries: Dict[bytes, object] = {}  # key -> inline bytes or (offset, length)
        self.end = 0  # the data file's length once every reserved value is written
        self.indirect_bytes = 0

    def reserve(self, key: bytes, n: int) -> Optional[int]:
        """The data file offset at which to ``write_at`` the value of ``key``
        (n bytes), or None when a value of n bytes sits inline (``put`` it)."""
        if key in self.entries:
            raise ValueError(f"OCDBT key {key!r} written twice")
        if n <= self.max_inline:
            return None
        self.entries[key] = (self.end, n)
        self.end += n
        self.indirect_bytes += n
        return self.end - n

    def write_at(self, offset: int, value) -> None:
        view = memoryview(value).cast("B")
        while view:
            done = os.pwrite(self.fd, view, offset)
            view, offset = view[done:], offset + done

    def put(self, key: bytes, value) -> None:
        """Store ``value`` (bytes or a uint8 array) under ``key``."""
        offset = self.reserve(key, len(value))
        if offset is None:
            self.entries[key] = bytes(value)
        else:
            self.write_at(offset, value)

    def __enter__(self) -> "OcdbtWriter":
        return self

    def __exit__(self, *exc) -> None:
        self._release()

    def _release(self) -> None:
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

    def _write_node(self, body: bytes) -> Tuple[int, int]:
        data = _frame(BTREE_NODE_MAGIC, body)
        offset, self.end = self.end, self.end + len(data)
        self.write_at(offset, data)
        return offset, len(data)

    def _groups(self, items, size):
        """``items`` in runs whose encoded size (``size`` per item, a bound)
        stays under the node limit."""
        run, total = [], 64
        for it in items:
            s = size(it)
            if run and total + s > self.max_node:
                yield run
                run, total = [], 64
            run.append(it)
            total += s
        if run:
            yield run

    def _leaf(self, run, prefix: bytes) -> bytes:
        keys = [k[len(prefix) :] for k, _ in run]
        indirect = [v for _, v in run if not isinstance(v, bytes)]
        body = bytes([0]) + _file_table_bytes([self.file] if indirect else []) + _key_block(keys)
        body += _varints(len(v) if isinstance(v, bytes) else v[1] for _, v in run)
        body += _varints(0 if isinstance(v, bytes) else 1 for _, v in run)
        body += _varints(0 for _ in indirect) + _varints(v[0] for v in indirect)  # file 0, offsets
        return body + b"".join(v for _, v in run if isinstance(v, bytes))

    def _interior(self, run: List[_Subtree], height: int, prefix: bytes) -> bytes:
        keys = [t.first[len(prefix) :] for t in run]
        common = [_shared(t.first, t.last) - len(prefix) for t in run]
        body = bytes([height]) + _file_table_bytes([self.file]) + _key_block(keys, common)
        body += _varints(0 for _ in run) + _varints(t.offset for t in run) + _varints(t.length for t in run)
        body += _varints(t.num_keys for t in run) + _varints(t.tree_bytes for t in run)
        return body + _varints(t.indirect_bytes for t in run)

    def close(self) -> None:
        """Write the tree and the manifest (a store of no keys has no root)."""
        items = sorted(self.entries.items())
        runs = list(self._groups(items, lambda kv: 40 + len(kv[0]) + (len(kv[1]) if isinstance(kv[1], bytes) else 0)))
        level, height = [], 0
        for run in runs:
            prefix = b"" if len(runs) == 1 else run[0][0][: _shared(run[0][0], run[-1][0])]
            offset, length = self._write_node(self._leaf(run, prefix))
            ind = sum(v[1] for _, v in run if not isinstance(v, bytes))
            level.append(_Subtree(run[0][0], run[-1][0], offset, length, len(run), length, ind))
        while len(level) > 1:
            height += 1
            runs = list(self._groups(level, lambda t: 80 + len(t.first)))
            parents = []
            for run in runs:
                prefix = b"" if len(runs) == 1 else run[0].first[: _shared(run[0].first, run[-1].last)]
                offset, length = self._write_node(self._interior(run, height, prefix))
                parents.append(_Subtree(run[0].first, run[-1].last, offset, length, sum(t.num_keys for t in run),
                                        length + sum(t.tree_bytes for t in run),
                                        sum(t.indirect_bytes for t in run)))
            level = parents
        self._release()
        root = level[0] if level else None
        config = (os.urandom(16) + _varint(0) + _varint(self.max_inline) + _varint(self.max_node)
                  + bytes([VERSION_TREE_ARITY_LOG2]) + _varints([1, 0, 0, 0, 0]))
        if root is None:
            version = _varints([1]) + bytes([0]) + _varints([0]) + _varint(NO_ROOT) * 2 + _varints([0, 0, 0])
        else:
            version = (_varints([1]) + bytes([height]) + _varints([0, root.offset, root.length, root.num_keys,
                                                                   root.tree_bytes, self.indirect_bytes]))
        manifest = _frame(MANIFEST_MAGIC, config + _file_table_bytes([self.file]) + _varint(1) + version
                          + struct.pack("<Q", time.time_ns()) + _varint(0))
        with open(os.path.join(self.root, "manifest.ocdbt"), "wb") as f:
            f.write(manifest)


def _flatten(tree, keys: tuple, out: list) -> None:
    """(key path, kind, value) per leaf in JAX's order (dict keys sorted,
    sequences in order); kind ``array``, or a name of ``EMPTY_LEAVES``."""
    if isinstance(tree, dict):
        if not tree:
            out.append((keys, "Dict", None))
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(f"{[k for k, _ in keys]}: dict key {k!r} is not a string")
            _flatten(tree[k], keys + ((k, 2),), out)
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out.append((keys, "List", None))
        for i, v in enumerate(tree):
            _flatten(v, keys + ((str(i), 1),), out)
    elif tree is None:
        out.append((keys, "None", None))
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        out.append((keys, "array", tree))
    else:
        raise TypeError(f"{[k for k, _ in keys]}: a leaf of type {type(tree).__name__} "
                        "(save_params writes tensors, NumPy arrays and None)")


def _array_meta(x, name: str) -> Tuple[str, list, str, int]:
    """A leaf's zarr dtype, shape, orbax value type and bytes."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in ZARR_DTYPES:
            raise TypeError(f"{name}: dtype {x.dtype} (save_params writes {sorted(map(str, ZARR_DTYPES))})")
        return (ZARR_DTYPES[x.dtype], list(x.shape), "np.ndarray" if x.dtype in WIDE else "jax.Array",
                x.numel() * x.element_size())
    dtype = "bfloat16" if x.dtype.name == "bfloat16" else x.dtype.str
    if dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} (save_params writes {sorted(DTYPES)})")
    return dtype, list(x.shape), "np.ndarray", x.nbytes


def _host_bytes(x) -> np.ndarray:
    """A leaf's bytes in C order, uint8, on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).cpu().view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _frame_bytes(n: int) -> int:
    """The length of ``zstd_raw_frame`` of n bytes."""
    return 14 + 3 * max(1, -(-n // RAW_BLOCK)) + n


def _dump(path: str, obj, compact: bool = False) -> None:
    with open(path, "w") as f:
        f.write(json.dumps(obj, separators=(",", ":") if compact else None))


def _write_checkpoint(tmp: str, leaves: list) -> None:
    """The store and orbax's metadata files of ``leaves`` into ``tmp``: the
    small values inline as they come, the large ones at offsets reserved in
    order and written by ``IO_THREADS`` threads (each copies its leaf to the
    host, frames it and writes it), so the data file is the same whatever
    the threads' timing."""
    started = time.time_ns()
    tree_meta, shardings, arrays, jobs = {}, {}, [], []
    with OcdbtWriter(tmp) as store:
        for keys, kind, value in leaves:
            name = ".".join(k for k, _ in keys)
            meta = {"value_type": kind, "skip_deserialize": True}
            if kind == "array":
                meta = _plan_array(store, name, value, jobs)
                if meta["value_type"] == "jax.Array":
                    shape = meta["write_shape"]
                    shardings[base64.b64encode(name.encode()).decode()] = SHARDING
                    arrays.append({"array_metadata": {"param_name": name, "write_shape": shape, "chunk_shape": shape,
                                                      "ext_metadata": None}})
            tree_meta[str(tuple(k for k, _ in keys))] = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys],
                                                        "value_metadata": meta}
        with ThreadPoolExecutor(IO_THREADS) as pool:
            list(pool.map(lambda job: store.write_at(job[0], zstd_raw_frame(_host_bytes(job[1]))), jobs))
        store.close()
    _dump(os.path.join(tmp, "_METADATA"), {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                                           "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    if shardings:
        _dump(os.path.join(tmp, "_sharding"), shardings, compact=True)
        os.makedirs(os.path.join(tmp, "array_metadatas"))
        _dump(os.path.join(tmp, "array_metadatas", "process_0"), {"array_metadatas": arrays})
    _dump(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
        "item_handlers": ITEM_HANDLER, "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": started,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})


def _plan_array(store: OcdbtWriter, name: str, value, jobs: list) -> dict:
    """A leaf as a zarr v2 array of one chunk: its ``.zarray`` stored, its
    chunk stored inline or its (offset, leaf) added to ``jobs``; returns its
    value metadata."""
    dtype, shape, value_type, nbytes = _array_meta(value, name)
    if not nbytes:
        raise ValueError(f"{name}: cannot save arrays with zero size (orbax refuses them)")
    zarray = {"chunks": shape, "compressor": ZARR_COMPRESSOR, "dimension_separator": ".", "dtype": dtype,
              "fill_value": None, "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    store.put(f"{name}/.zarray".encode(), json.dumps(zarray, separators=(",", ":"), sort_keys=True).encode())
    chunk = f"{name}/{'.'.join('0' * len(shape)) or '0'}".encode()
    offset = store.reserve(chunk, _frame_bytes(nbytes))
    if offset is None:
        store.put(chunk, zstd_raw_frame(_host_bytes(value)))
    else:
        jobs.append((offset, value))
    meta = {"value_type": value_type, "skip_deserialize": False}
    return dict(meta, write_shape=shape) if value_type == "jax.Array" else meta


def save_params(path: str, tree) -> int:
    """Write ``tree`` (nested dicts, lists and tuples of tensors on any
    device, NumPy arrays and ``None``; dict keys strings) as the JAX
    package's ``save_params`` writes one, replacing a directory at
    ``path``; returns the bytes written. A tensor is written as a
    ``jax.Array`` (a float64 or int64 one, and every NumPy array, as an
    ``np.ndarray``, which JAX restores without x64). The save goes to a
    sibling temporary directory renamed into place; a leaf of zero size is
    refused, as orbax refuses it."""
    path = os.path.abspath(path)
    leaves: list = []
    _flatten(tree, (), leaves)
    if not leaves or any(not keys for keys, _, _ in leaves):
        raise TypeError("save_params writes a tree of dicts and sequences, not a bare leaf")
    tmp = path + ".orbax-checkpoint-tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        _write_checkpoint(tmp, leaves)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return dir_bytes(path)


def dir_bytes(path: str) -> int:
    """The bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


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
