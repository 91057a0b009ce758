"""The JAX package trainer's Orbax checkpoints, read with numpy alone.

``ddsp_tpu/training/trainer.py:save_checkpoint`` writes a ``step_*``
directory through Orbax: a ``_METADATA`` JSON that lists every leaf of the
saved tree, and an OCDBT key-value store (tensorstore's "optionally
cooperative distributed B+tree") that holds each leaf as a zarr array under
its key path joined with ``.`` (``opt_state.0.0.mu.controller.gru...``).
This module reads both without tensorstore, orbax or jax:

* :class:`OcdbtStore`: the root ``manifest.ocdbt`` -> its newest version ->
  the B+tree's interior and leaf nodes -> a value, inline in its leaf or
  indirect (data file, offset, length).  Manifests and nodes are framed by a
  magic number, their length, a format version, a compression id and a
  CRC-32C, all checked; their bodies and the zarr chunks are zstd frames,
  decoded by ``native/zstd.py`` through the system's libzstd.  Keys are
  stored as a prefix shared with the previous key plus a suffix; an
  interior entry's child holds its keys below the entry's common prefix.
  Data files are named by a base path plus a relative path, from the
  store's root: Orbax's merged root reaches ``ocdbt.process_0/d/...``.
* :func:`read_orbax`: every leaf of ``_METADATA``'s ``tree_metadata`` as a
  numpy array (zarr v2 ``.zarray`` or zarr v3 ``zarr.json``; C or F order,
  either byte order, a missing chunk reads as ``fill_value``), in a nested
  dict keyed as the tree, digit keys turned into lists.  A leaf that Orbax
  stores no array for (optax's ``EmptyState``) reads as None.

Every error names the file and the key being read.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from ddsp_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
# offset and length of the root of a version that holds no key
EMPTY_ROOT = 2**64 - 1
# magic (4) + length (8) + version (1) + compression (1) + CRC-32C (4)
MIN_FILE_BYTES = 18


class OrbaxFormatError(ValueError):
    """A checkpoint file that is not what the OCDBT or zarr format says it
    should be; the message names the file and the key being read."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum that ends every manifest and node."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads the fields of one decoded manifest or node body."""

    def __init__(self, data: bytes, file: str, key: str):
        self.data, self.pos, self.file, self.key = data, 0, file, key

    def fail(self, what: str):
        raise OrbaxFormatError(f"{self.file}: {what} (reading key {self.key!r})")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"ends at byte {len(self.data)}, a field needs {self.pos + n}")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left after the last field")


def _read_bytes(path: str, offset: int, length: Optional[int], key: str) -> bytes:
    """``length`` bytes at ``offset`` of ``path`` (the whole file for None)."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
    except FileNotFoundError:
        raise FileNotFoundError(f"{path}: no such file (reading key {key!r})") from None
    if length is not None and len(data) != length:
        raise OrbaxFormatError(
            f"{path}: truncated: {length} bytes wanted at offset {offset}, "
            f"{len(data)} there (reading key {key!r})")
    return data


def _unframe(data: bytes, magic: int, file: str, key: str) -> _Cursor:
    """Check a manifest's or node's frame and decode its body."""
    cur = _Cursor(data, file, key)
    if len(data) < MIN_FILE_BYTES:
        cur.fail(f"{len(data)} bytes: shorter than an OCDBT header and checksum")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        cur.fail(f"bad magic {got:08x} (an OCDBT {'manifest' if magic == MANIFEST_MAGIC else 'B-tree node'} "
                 f"starts with {magic:08x})")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        cur.fail(f"truncated: its header says {length} bytes, {len(data)} are there")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        cur.fail("CRC-32C mismatch")
    cur.pos = 12
    version = cur.varint()
    if version != FORMAT_VERSION:
        cur.fail(f"format version {version}; this reader knows {FORMAT_VERSION}")
    compression = cur.varint()
    body = data[cur.pos: -4]
    if compression == COMPRESSION_ZSTD:
        try:
            body = zstd.decompress(body, what=f"{file} (reading key {key!r})")
        except zstd.ZstdError as e:
            raise OrbaxFormatError(str(e)) from None
    elif compression != COMPRESSION_NONE:
        cur.fail(f"compression id {compression}; this reader knows none (0) and zstd (1)")
    return _Cursor(body, file, key)


def _data_file_table(cur: _Cursor) -> List[str]:
    """The paths (base path + relative path) a manifest or node refers to
    by index, prefix-compressed against the previous path."""
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix, base = cur.varints(n), cur.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            cur.fail(f"data file {i} shares {prefix[i]} bytes of a {len(prev)}-byte path")
        prev = prev[: prefix[i]] + cur.take(suffix[i])
        if base[i] > len(prev):
            cur.fail(f"data file {i}: base path of {base[i]} bytes in a {len(prev)}-byte path")
        paths.append(prev.decode())
    return paths


def _refs(cur: _Cursor, n: int, paths: List[str], lengths: Optional[List[int]] = None):
    """``n`` indirect references as (path, offset, length) columns."""
    ids = cur.varints(n)
    offsets = cur.varints(n)
    if lengths is None:
        lengths = cur.varints(n)
    for i in ids:
        if i >= len(paths):
            cur.fail(f"data file id {i} of a table of {len(paths)}")
    return [(paths[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


class Ref(NamedTuple):
    """Where a node or a value lies: ``length`` bytes at ``offset`` of the
    data file ``path`` (relative to the store's root)."""

    path: str
    offset: int
    length: int


class Node(NamedTuple):
    height: int  # 0 for a leaf
    keys: List[bytes]  # below the node's inherited prefix
    # a leaf: bytes (inline) or Ref; an interior node: (child Ref, common prefix length)
    values: List[Any]


class OcdbtStore:
    """The OCDBT key-value store at ``root`` (a ``step_*`` directory), read
    through its newest version.  Nodes are read once and kept."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._root_node: Any = None  # the newest version's root Ref; False when empty
        self._nodes: Dict[Ref, Node] = {}

    def _manifest(self, key: str) -> Optional[Ref]:
        """The root node of the newest version, or None for an empty one."""
        if self._root_node is None:
            file = os.path.join(self.root, "manifest.ocdbt")
            cur = _unframe(_read_bytes(file, 0, None, key), MANIFEST_MAGIC, file, key)
            cur.take(16)  # the store's uuid
            kind = cur.varint()
            if kind != 0:
                cur.fail(f"manifest kind {kind}: numbered manifests are not read, only a "
                         "single manifest.ocdbt (kind 0)")
            # max_inline_value_bytes, max_decoded_node_bytes, version_tree_arity_log2
            cur.varints(2)
            cur.u8()
            compression = cur.varint()
            if compression == COMPRESSION_ZSTD:
                cur.take(4)  # the zstd level, int32
            elif compression != COMPRESSION_NONE:
                cur.fail(f"compression id {compression} in the config")
            paths = _data_file_table(cur)
            n = cur.varint()
            if n == 0:
                cur.fail("the manifest lists no version")
            generations = cur.varints(n)
            cur.take(n)  # each root's height (a node carries its own)
            roots = _refs(cur, n, paths)
            # the statistics and commit times follow, then the version-tree
            # nodes of older versions: the newest version is inline
            root = roots[max(range(n), key=generations.__getitem__)]
            self._root_node = False if root[1] == EMPTY_ROOT else Ref(*root)
        return self._root_node or None

    def _node(self, ref: Ref, key: str) -> Node:
        node = self._nodes.get(ref)
        if node is not None:
            return node
        file = os.path.join(self.root, ref.path)
        cur = _unframe(_read_bytes(file, ref.offset, ref.length, key), NODE_MAGIC, file, key)
        height = cur.u8()
        paths = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            cur.fail("a B-tree node with no entry")
        prefix = [0] + cur.varints(n - 1)
        suffix = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                cur.fail(f"entry {i} shares {prefix[i]} bytes of a {len(prev)}-byte key")
            prev = prev[: prefix[i]] + cur.take(suffix[i])
            keys.append(prev)
        if height:
            children = [Ref(*r) for r in _refs(cur, n, paths)]
            cur.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
            for i, c in enumerate(common):
                if c > len(keys[i]):
                    cur.fail(f"entry {i}: common prefix of {c} bytes in a {len(keys[i])}-byte key")
            values = list(zip(children, common))
        else:
            lengths = cur.varints(n)
            kinds = [cur.u8() for _ in range(n)]
            if any(k > 1 for k in kinds):
                cur.fail(f"value kinds {sorted(set(kinds))}; 0 (inline) and 1 (indirect) exist")
            indirect = [i for i, k in enumerate(kinds) if k]
            refs = iter(_refs(cur, len(indirect), paths, [lengths[i] for i in indirect]))
            values = [Ref(*next(refs)) if k else cur.take(ln) for k, ln in zip(kinds, lengths)]
        cur.end()
        node = self._nodes[ref] = Node(height, keys, values)
        return node

    def _find(self, key: str) -> Tuple[Any, Optional[Ref]]:
        """(the leaf entry's value: bytes inline or a Ref, or None; the
        leaf node's Ref) for ``key``."""
        ref = self._manifest(key)
        want, prefix = key.encode(), b""
        while ref is not None and want.startswith(prefix):
            node = self._node(ref, key)
            below = want[len(prefix):]
            if node.height == 0:
                return next((v for k, v in zip(node.keys, node.values) if k == below), None), ref
            # the last entry whose key is at most ``below`` spans it
            i = next((j for j in range(len(node.keys) - 1, -1, -1) if node.keys[j] <= below), None)
            if i is None:
                break
            ref, common = node.values[i]
            prefix += node.keys[i][:common]
        return None, None

    def get(self, key: str) -> Optional[bytes]:
        """The value stored under ``key``, or None."""
        value, _ = self._find(key)
        if isinstance(value, Ref):
            return _read_bytes(os.path.join(self.root, value.path), value.offset, value.length, key)
        return value

    def where(self, key: str) -> str:
        """The file that holds ``key``'s value, for error messages."""
        value, leaf = self._find(key)
        if isinstance(value, Ref):
            return f"{os.path.join(self.root, value.path)} (offset {value.offset}, {value.length} bytes)"
        if leaf is not None:
            return f"{os.path.join(self.root, leaf.path)} (inline in the B-tree leaf at {leaf.offset})"
        return self.root

    def keys(self) -> Iterator[str]:
        """Every key of the newest version, in order."""
        ref = self._manifest("")

        def walk(ref, prefix):
            node = self._node(ref, "")
            for k, v in zip(node.keys, node.values):
                if node.height:
                    yield from walk(v[0], prefix + k[: v[1]])
                else:
                    yield (prefix + k).decode()

        if ref is not None:
            yield from walk(ref, b"")


# --- zarr ---------------------------------------------------------------------------
_ZARR3_DTYPES = {name: np.dtype(name) for name in (
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64", "complex64", "complex128")}


def _fill(value, dtype: np.dtype, where: str):
    if value is None:
        return np.zeros((), dtype)
    if isinstance(value, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in named:
            raise OrbaxFormatError(f"{where}: fill_value {value!r} is not read")
        value = named[value]
    return np.asarray(value, dtype)


def _codecs(codecs: List[Dict], where: str):
    """zarr v3 codecs -> (transpose order or None, byte order, zstd?)."""
    order, endian, compressed = None, "little", False
    for codec in codecs:
        name, cfg = codec["name"], codec.get("configuration", {})
        if name == "transpose":
            order = tuple(cfg["order"])
        elif name == "bytes":
            endian = cfg.get("endian", "little")
        elif name == "zstd":
            compressed = True
        else:
            raise OrbaxFormatError(f"{where}: zarr codec {name!r} is not read "
                                   "(transpose, bytes and zstd are)")
    return order, endian, compressed


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr array stored under ``name`` (v2 ``.zarray`` or v3
    ``zarr.json``), native byte order."""
    meta = store.get(f"{name}/.zarray")
    if meta is not None:
        where = f"{store.root}: {name}/.zarray"
        meta = json.loads(meta)
        dtype = np.dtype(meta["dtype"])
        shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise OrbaxFormatError(f"{where}: compressor {compressor} is not read (zstd is)")
        if meta.get("filters"):
            raise OrbaxFormatError(f"{where}: filters {meta['filters']} are not read")
        sep = meta.get("dimension_separator", ".")
        order, compressed, transpose = meta.get("order", "C"), compressor is not None, None
        chunk_key = lambda idx: sep.join(map(str, idx)) if idx else "0"  # noqa: E731
    else:
        meta = store.get(f"{name}/zarr.json")
        if meta is None:
            raise KeyError(f"{store.root}: no array under key {name!r} "
                           "(neither .zarray nor zarr.json)")
        where = f"{store.root}: {name}/zarr.json"
        meta = json.loads(meta)
        if meta["data_type"] not in _ZARR3_DTYPES:
            raise OrbaxFormatError(f"{where}: data type {meta['data_type']!r} is not read")
        grid = meta["chunk_grid"]
        if grid["name"] != "regular":
            raise OrbaxFormatError(f"{where}: chunk grid {grid['name']!r} is not read")
        transpose, endian, compressed = _codecs(meta["codecs"], where)
        dtype = _ZARR3_DTYPES[meta["data_type"]].newbyteorder("<" if endian == "little" else ">")
        shape, chunks = tuple(meta["shape"]), tuple(grid["configuration"]["chunk_shape"])
        encoding = meta.get("chunk_key_encoding", {"name": "default"})
        sep = encoding.get("configuration", {}).get("separator",
                                                    "/" if encoding["name"] == "default" else ".")
        if encoding["name"] == "default":
            chunk_key = lambda idx: sep.join(["c", *map(str, idx)])  # noqa: E731
        else:
            chunk_key = lambda idx: sep.join(map(str, idx)) if idx else "0"  # noqa: E731
        order = "C"
    native = dtype.newbyteorder("=")
    out = np.empty(shape, native)
    fill = _fill(meta.get("fill_value"), native, where)
    stored = chunks if transpose is None else tuple(chunks[i] for i in transpose)
    grid_counts = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    for idx in itertools.product(*(range(g) for g in grid_counts)):
        key = f"{name}/{chunk_key(idx)}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        raw = store.get(key)
        if raw is None:
            out[region] = fill
            continue
        if compressed:
            try:
                raw = zstd.decompress(raw, what=f"{store.where(key)}: chunk {key!r}")
            except zstd.ZstdError as e:
                raise OrbaxFormatError(str(e)) from None
        if len(raw) != dtype.itemsize * math.prod(stored):
            raise OrbaxFormatError(
                f"{store.root}: chunk {key!r} holds {len(raw)} bytes, its shape {stored} of "
                f"{dtype} takes {dtype.itemsize * math.prod(stored)}")
        chunk = np.frombuffer(raw, dtype).reshape(stored, order=order)
        if transpose is not None:
            chunk = chunk.transpose(np.argsort(transpose))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


# --- the checkpoint ------------------------------------------------------------------
def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is a ``step_*`` directory written by Orbax (the JAX
    package's trainer, ``ddsp_tpu/training/trainer.py:373-443``)."""
    return any(os.path.exists(os.path.join(path, f)) for f in ("_METADATA", "manifest.ocdbt"))


def orbax_leaves(path: str) -> List[Tuple[List[str], Dict[str, Any]]]:
    """(key path, value metadata) of every leaf in an Orbax checkpoint's
    ``_METADATA``.  An unfinished save lists none and raises
    FileNotFoundError."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise FileNotFoundError(
            f"{path}: an Orbax checkpoint of the JAX package whose _METADATA lists no "
            "arrays (an unfinished save, or not its trainer's)")
    return [([str(k["key"]) for k in leaf["key_metadata"]], leaf.get("value_metadata", {}))
            for leaf in meta["tree_metadata"].values()]


def lists(node):
    """``{'0': a, '1': b}`` -> ``[a, b]`` throughout: the tree's sequences."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [lists(node[str(i)]) for i in range(len(node))]
    return {k: lists(v) for k, v in node.items()}


def read_orbax(path: str, prefix: Tuple[str, ...] = ()) -> Dict:
    """Every leaf of the Orbax checkpoint directory ``path`` whose key path
    starts with ``prefix``, as numpy arrays in a nested dict keyed as
    ``_METADATA``'s ``tree_metadata`` (digit keys turned into lists).  A
    leaf without an array (``value_type`` None: optax's ``EmptyState``)
    reads as None."""
    store = OcdbtStore(path)
    tree: Dict = {}
    for keys, value_meta in orbax_leaves(path):
        if tuple(keys[: len(prefix)]) != tuple(prefix):
            continue
        if value_meta.get("value_type") == "None":
            value = None
        else:
            value = read_array(store, ".".join(keys))
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return lists(tree)


def flatten(tree, path: str = "") -> Dict[str, Any]:
    """The leaves of a nested dict / list tree by ``.``-joined key path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {path: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{path}.{k}" if path else k))
    return out


def leaf_digest(leaf) -> str:
    """SHA-256 of an array over its dtype, its shape and its bytes in C
    order, so two leaves agree only when all three do."""
    a = np.ascontiguousarray(leaf)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()
