"""The part of HDF5 that Keras 3 ``save_weights`` writes, read and written
with numpy alone.

The JAX package reads and writes Keras ``.weights.h5`` files through
``h5py``; the card's machine has no ``h5py``, so the port carries this
module instead.  A file is a tree of groups whose leaves are float
arrays; here it is a nested ``dict``: a group is a ``dict`` of its
children in name order, a dataset an ``np.ndarray``.

The subset, which is what the HDF5 library writes for h5py's defaults
(``libver='earliest'``) and so what Keras 3 writes:

* superblock version 0 at offset 0, 8-byte offsets and lengths, no base
  address;
* version 1 object headers, with continuation blocks (message 0x10);
* old-style groups: a symbol-table message (0x11) naming a version 1
  B-tree of type 0 (``TREE``, any level) whose leaves are symbol-table
  nodes (``SNOD``), and a local heap (``HEAP``) holding the names; every
  link is a hard link;
* datasets: a dataspace (0x01), a little-endian IEEE float32 or float64
  datatype (0x03), and a version 3 contiguous layout (0x08), with no
  filter pipeline and no external storage;
* attributes (0x0C), fill values (0x04, 0x05), modification times,
  comments and NIL messages, which the reader skips: Keras' loader reads
  the group tree and the datasets, and an attribute only for bfloat16
  variables, which this subset does not carry.

:func:`read_tree` raises ``ValueError``, naming the file and the structure
it found, for anything outside the subset (other superblocks, version 2
object headers, new-style groups, soft links, chunked, compact or
filtered storage, another datatype, a shared message): it never returns a
guess.  :func:`write_tree` writes the same subset, plus the string
attributes Keras records on each ``vars`` group (a ``name``), as h5py
writes a ``str`` attribute: a variable-length UTF-8 string whose bytes sit
in a global heap collection (``GCOL``), so h5py reads them back as ``str``.
Its files open in h5py and in Keras' ``load_weights``.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF
# A local heap with no free block says so with offset 1 (the library's
# H5HL_FREE_NULL), not with the undefined address.
FREE_NULL = 1
# Symbol-table nodes hold up to 2 * LEAF_K names, B-tree nodes up to
# 2 * INTERNAL_K children: the library's defaults, stored in the
# superblock, by which every reader sizes the nodes it reads.
LEAF_K = 4
INTERNAL_K = 16
SNOD_BYTES = 8 + 2 * LEAF_K * 40
TREE_BYTES = 24 + 2 * INTERNAL_K * 8 + (2 * INTERNAL_K + 1) * 8
# Global heap collections are read 4 KiB at a time; none is smaller.
GCOL_MIN_BYTES = 4096

# NIL, old and new fill value, attribute, comment, old and new modification
# time, attribute info, reference count: nothing the datasets' values
# depend on.
_SKIPPED = {0x00, 0x04, 0x05, 0x0C, 0x0D, 0x0E, 0x12, 0x15, 0x16}
_REFUSED = {0x02: "link info (a new-style group)", 0x06: "link (a new-style group)",
            0x07: "external data files", 0x0A: "group info (a new-style group)",
            0x0B: "filter pipeline (compressed or filtered data)",
            0x13: "B-tree 'K' values", 0x14: "driver info", 0x17: "file space info"}
_LAYOUTS = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}
# (size, sign bit, precision, exponent location and size, mantissa location
# and size, exponent bias) of the IEEE formats read and written.
_IEEE = {4: (31, 32, 23, 8, 0, 23, 127), 8: (63, 64, 52, 11, 0, 52, 1023)}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Reader:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}; only the HDF5 subset that Keras 3 "
                         "save_weights writes is read (nerf_keras_tpu_torch/utils/h5.py)")

    def u(self, fmt: str, at: int):
        return struct.unpack_from("<" + fmt, self.buf, at)

    def tree(self) -> dict:
        if self.buf[:8] != SIGNATURE:
            self.fail("no HDF5 signature at offset 0")
        version = self.buf[8]
        if version != 0:
            self.fail(f"superblock version {version}")
        offsets, lengths = self.buf[13], self.buf[14]
        if (offsets, lengths) != (8, 8):
            self.fail(f"{offsets}-byte offsets and {lengths}-byte lengths")
        (base,) = self.u("Q", 24)
        if base != 0:
            self.fail(f"base address {base}")
        (root,) = self.u("Q", 64)
        tree = self.object(root, "/", frozenset())
        if not isinstance(tree, dict):
            self.fail("the root object is not a group")
        return tree

    def messages(self, addr: int, where: str) -> list[tuple[int, int, int]]:
        """``(type, data offset, data size)`` of an object header's messages,
        continuation blocks followed."""
        if self.buf[addr:addr + 4] == b"OHDR":
            self.fail(f"{where}: a version 2 object header")
        if self.buf[addr] != 1:
            self.fail(f"{where}: object header version {self.buf[addr]}")
        (size,) = self.u("I", addr + 8)
        blocks, seen, out = [(addr + 16, size)], set(), []
        while blocks:
            start, length = blocks.pop(0)
            if start in seen:
                self.fail(f"{where}: a continuation block that loops")
            seen.add(start)
            p, end = start, start + length
            while p + 8 <= end:
                kind, msize, flags = self.u("HHB", p)
                if flags & 0x02:
                    self.fail(f"{where}: a shared message of type {kind:#04x}")
                if kind == 0x10:
                    blocks.append(self.u("QQ", p + 8))
                else:
                    out.append((kind, p + 8, msize))
                p += 8 + msize
        return out

    def object(self, addr: int, where: str, ancestors: frozenset):
        found = {}
        for kind, at, size in self.messages(addr, where):
            if kind in _REFUSED:
                self.fail(f"{where}: message {kind:#04x}, {_REFUSED[kind]}")
            if kind not in _SKIPPED and kind not in (0x01, 0x03, 0x08, 0x11):
                self.fail(f"{where}: unknown message type {kind:#04x}")
            found.setdefault(kind, at)
        if 0x11 in found:
            if addr in ancestors:
                self.fail(f"{where}: a hard link to one of its own ancestors")
            return self.group(addr, where, ancestors, found[0x11])
        if 0x08 in found and 0x01 in found and 0x03 in found:
            return self.dataset(found, where)
        self.fail(f"{where}: an object that is neither an old-style group nor a dataset "
                  f"(messages {sorted(found)})")

    def group(self, addr: int, where: str, ancestors: frozenset, stab: int) -> dict:
        btree, heap = self.u("QQ", stab)
        names = self.heap(heap, where)
        out = {}
        for name, child in self.btree(btree, names, where, 0):
            out[name] = self.object(child, where.rstrip("/") + "/" + name,
                                    ancestors | {addr})
        return out

    def heap(self, addr: int, where: str) -> bytes:
        if self.buf[addr:addr + 4] != b"HEAP" or self.buf[addr + 4] != 0:
            self.fail(f"{where}: no version 0 local heap at {addr}")
        size, _, data = self.u("QQQ", addr + 8)
        return self.buf[data:data + size]

    def name(self, names: bytes, at: int, where: str) -> str:
        end = names.find(b"\0", at)
        if end < 0:
            self.fail(f"{where}: an unterminated name in the local heap")
        return names[at:end].decode("utf-8")

    def btree(self, addr: int, names: bytes, where: str, depth: int):
        if depth > 32:
            self.fail(f"{where}: a B-tree deeper than 32 levels")
        if self.buf[addr:addr + 4] != b"TREE":
            self.fail(f"{where}: no B-tree node at {addr}")
        kind, level, used = self.u("BBH", addr + 4)
        if kind != 0:
            self.fail(f"{where}: a B-tree of type {kind} where a group's (0) belongs")
        for i in range(used):
            (child,) = self.u("Q", addr + 24 + 16 * i + 8)
            if level > 0:
                yield from self.btree(child, names, where, depth + 1)
            else:
                yield from self.snod(child, names, where)

    def snod(self, addr: int, names: bytes, where: str):
        if self.buf[addr:addr + 4] != b"SNOD" or self.buf[addr + 4] != 1:
            self.fail(f"{where}: no version 1 symbol-table node at {addr}")
        (count,) = self.u("H", addr + 6)
        for i in range(count):
            at = addr + 8 + 40 * i
            name_at, header, cache = self.u("QQI", at)
            name = self.name(names, name_at, where)
            if cache not in (0, 1):
                self.fail(f"{where}/{name}: a link of cache type {cache} "
                          "(only hard links are read)")
            yield name, header

    def dataset(self, found: dict, where: str) -> np.ndarray:
        at = found[0x01]
        version, rank, flags = self.buf[at], self.buf[at + 1], self.buf[at + 2]
        if version == 1:
            if flags & 0x02:
                self.fail(f"{where}: a dataspace with a permutation")
            dims_at = at + 8
        elif version == 2:
            if self.buf[at + 3] == 2:
                self.fail(f"{where}: a null dataspace")
            dims_at = at + 4
        else:
            self.fail(f"{where}: dataspace version {version}")
        shape = self.u("Q" * rank, dims_at)

        at = found[0x03]
        cls, bits = self.buf[at] & 0x0F, self.buf[at + 1]
        (size,) = self.u("I", at + 4)
        if cls != 1:
            self.fail(f"{where}: datatype class {cls} (only IEEE floats are read)")
        if bits & 0x41 or size not in _IEEE:
            self.fail(f"{where}: a {size}-byte float in "
                      f"{'little' if not bits & 0x41 else 'big or VAX'}-endian order "
                      "(only little-endian float32 and float64 are read)")
        props = (self.buf[at + 2],) + self.u("HHBBBBI", at + 8)
        if bits & 0x0E or (bits >> 4) & 0x03 != 2 or props[1] != 0 \
                or (props[0],) + props[2:] != _IEEE[size]:
            self.fail(f"{where}: a {size}-byte float that is not IEEE 754 "
                      f"(bit fields {bits:#04x}, properties {props})")

        at = found[0x08]
        if self.buf[at] != 3:
            self.fail(f"{where}: data layout version {self.buf[at]}")
        if self.buf[at + 1] != 1:
            self.fail(f"{where}: {_LAYOUTS.get(self.buf[at + 1], 'unknown')} storage "
                      "(only contiguous storage is read)")
        addr, nbytes = self.u("QQ", at + 2)
        dtype = np.dtype("<f4" if size == 4 else "<f8")
        want = int(np.prod(shape, dtype=np.int64)) * size
        if nbytes != want:
            self.fail(f"{where}: {nbytes} bytes of storage for shape {shape}")
        if want == 0:
            return np.zeros(shape, dtype)
        if addr == UNDEFINED or addr + nbytes > len(self.buf):
            self.fail(f"{where}: storage at {addr} outside the file (never written?)")
        return np.frombuffer(self.buf, dtype, want // size, addr).reshape(shape).copy()


def read_tree(path: str) -> dict:
    """The groups and datasets of an HDF5 file in Keras' subset, as nested
    dicts (children in name order) with numpy arrays at the leaves.

    Raises:
        ValueError: for any structure outside the subset, naming the file
            and the structure.
    """
    reader = _Reader(path)
    try:
        return reader.tree()
    except (struct.error, IndexError, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: truncated or corrupt HDF5 file ({e})") from e


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def put(self, data: bytes) -> int:
        """Append ``data`` at the next 8-byte boundary; its address."""
        self.buf += bytes(_pad8(len(self.buf)) - len(self.buf))
        addr = len(self.buf)
        self.buf += data
        return addr

    def header(self, messages: list[tuple[int, int, bytes]]) -> int:
        """A version 1 object header holding ``(type, flags, data)``."""
        body = b"".join(struct.pack("<HHB3x", kind, _pad8(len(data)), flags)
                        + data + bytes(_pad8(len(data)) - len(data))
                        for kind, flags, data in messages)
        return self.put(struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body)

    def dataset(self, arr: np.ndarray, where: str) -> int:
        if arr.dtype not in (np.float32, np.float64):
            raise ValueError(f"{where}: dtype {arr.dtype}; only float32 and float64 "
                             "datasets are written")
        arr = np.asarray(arr, arr.dtype.newbyteorder("<"))
        size = arr.dtype.itemsize
        data = self.put(arr.tobytes()) if arr.nbytes else UNDEFINED
        sign, precision, e_at, e_size, m_at, m_size, bias = _IEEE[size]
        space = struct.pack("<BBB5x", 1, arr.ndim, 0) + struct.pack(
            f"<{arr.ndim}Q", *arr.shape)
        dtype = struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, precision,
                            e_at, e_size, m_at, m_size, bias)
        # Fill value (version 2) as h5py writes it: allocated late, written
        # if set, the default (zero bytes of a defined value).
        fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
        layout = struct.pack("<BBQQ", 3, 1, data, arr.nbytes)
        return self.header([(0x01, 0, space), (0x03, 1, dtype), (0x05, 1, fill),
                            (0x08, 0, layout)])

    def string_heap(self, strings: list[str]) -> tuple[int, dict[str, int]]:
        """One global heap collection holding ``strings``: its address and
        each string's object index."""
        objects, index = b"", {}
        for s in strings:
            if s in index:
                continue
            raw = s.encode("utf-8")
            index[s] = len(index) + 1
            objects += struct.pack("<HH4xQ", index[s], 1, len(raw)) + raw \
                + bytes(_pad8(len(raw)) - len(raw))
        size = max(GCOL_MIN_BYTES, _pad8(16 + len(objects) + 16))
        free = size - 16 - len(objects)
        blob = b"GCOL" + struct.pack("<B3xQ", 1, size) + objects \
            + struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16)
        return self.put(blob), index

    def group(self, tree: dict, where: str, attrs: dict, strings: tuple) -> tuple[int, int,
                                                                                  int]:
        """Write a group's children, then the group: its object header,
        B-tree and local heap addresses."""
        entries = []
        for name in sorted(tree, key=lambda n: n.encode("utf-8")):
            path = f"{where.rstrip('/')}/{name}"
            if not name or "/" in name or "\0" in name:
                raise ValueError(f"{path!r}: not a valid HDF5 link name")
            child = tree[name]
            if isinstance(child, dict):
                header, btree, heap = self.group(child, path, attrs, strings)
                entries.append((name, header, 1, struct.pack("<QQ", btree, heap)))
            else:
                entries.append((name, self.dataset(np.asarray(child), path), 0, bytes(16)))

        # Local heap: the empty name at offset 0 (the B-tree's first key),
        # then each name, NUL-terminated and padded to 8 bytes.
        names, offsets = bytearray(8), {}
        for name, *_ in entries:
            offsets[name] = len(names)
            raw = name.encode("utf-8") + b"\0"
            names += raw + bytes(_pad8(len(raw)) - len(raw))
        heap = self.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(names), FREE_NULL, 0))
        struct.pack_into("<Q", self.buf, heap + 24, self.put(bytes(names)))

        # Symbol-table nodes of up to 2K names, under B-tree nodes of up to
        # 2K children, level by level; each node's key i + 1 is the last
        # name below its child i, key 0 the empty name.
        # An empty group is a B-tree node with no children.
        level, nodes = 0, []
        per = 2 * LEAF_K
        for i in range(0, len(entries), per):
            chunk = entries[i:i + per]
            body = b"".join(struct.pack("<QQI4x", offsets[n], h, cache) + scratch
                            for n, h, cache, scratch in chunk)
            snod = self.put(b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) + body
                            + bytes(SNOD_BYTES - 8 - len(body)))
            nodes.append((snod, offsets[chunk[-1][0]]))
        while True:
            parents = []
            for i in range(0, len(nodes), 2 * INTERNAL_K):
                chunk = nodes[i:i + 2 * INTERNAL_K]
                body = struct.pack("<Q", 0) + b"".join(struct.pack("<QQ", child, key)
                                                       for child, key in chunk)
                addr = self.put(b"TREE" + struct.pack("<BBHQQ", 0, level, len(chunk),
                                                      UNDEFINED, UNDEFINED)
                                + body + bytes(TREE_BYTES - 24 - len(body)))
                parents.append((addr, chunk[-1][1]))
            for (left, _), (right, _) in zip(parents, parents[1:]):
                struct.pack_into("<Q", self.buf, left + 16, right)
                struct.pack_into("<Q", self.buf, right + 8, left)
            if not nodes:
                parents.append((self.put(b"TREE" + struct.pack(
                    "<BBHQQ", 0, 0, 0, UNDEFINED, UNDEFINED) + bytes(TREE_BYTES - 24)), 0))
            nodes, level = parents, level + 1
            if len(nodes) == 1:
                break
        btree = nodes[0][0]
        messages = [(0x11, 0, struct.pack("<QQ", btree, heap))]
        gcol, index = strings
        for key, value in attrs.get(where, {}).items():
            messages.append((0x0C, 0, _string_attribute(key, len(value.encode("utf-8")),
                                                        gcol, index[value])))
        return self.header(messages), btree, heap


def _string_attribute(name: str, nbytes: int, gcol: int, index: int) -> bytes:
    """A version 1 attribute message: a scalar variable-length UTF-8 string
    whose bytes are object ``index`` of the global heap at ``gcol``."""
    raw = name.encode("utf-8") + b"\0"
    # Variable-length (class 9) string (type 1), NUL-terminated, UTF-8,
    # over a 1-byte unsigned integer; 16 bytes in memory (length + pointer).
    dtype = struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) \
        + struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
    space = struct.pack("<BBB5x", 1, 0, 0)
    return (struct.pack("<BBHHH", 1, 0, len(raw), len(dtype), len(space))
            + raw + bytes(_pad8(len(raw)) - len(raw))
            + dtype + bytes(_pad8(len(dtype)) - len(dtype))
            + space + struct.pack("<IQI", nbytes, gcol, index))


def write_tree(path: str, tree: dict, attrs: dict[str, dict[str, str]] | None = None
               ) -> None:
    """Write nested dicts of float32/float64 arrays as an HDF5 file in the
    subset :func:`read_tree` reads.

    ``attrs`` maps a group's path (``"/"``, ``"/coarse_model/vars"``) to
    string attributes written on it, which h5py reads back as ``str``.

    Raises:
        ValueError: for another dtype, a name that is not a valid link
            name, or an attribute on a path that is not a group.
    """
    attrs = {("/" + k.strip("/")): v for k, v in (attrs or {}).items()}
    for where in attrs:
        node = tree
        for part in [p for p in where.split("/") if p]:
            node = node.get(part) if isinstance(node, dict) else None
        if not isinstance(node, dict):
            raise ValueError(f"attributes for {where!r}, which is not a group of the tree")
    w = _Writer()
    w.put(bytes(96))  # the superblock, filled in last
    values = [v for group in attrs.values() for v in group.values()]
    strings = w.string_heap(values) if values else (UNDEFINED, {})
    root, btree, heap = w.group(tree, "/", attrs, strings)
    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K,
                                 INTERNAL_K, 0)
    sb += struct.pack("<QQQQ", 0, UNDEFINED, len(w.buf), UNDEFINED)
    sb += struct.pack("<QQI4xQQ", 0, root, 1, btree, heap)
    w.buf[:96] = sb
    with open(path, "wb") as f:
        f.write(w.buf)
