"""HDF5 archive reader for Keras model files (port of
deeplearning4j_tpu/modelimport/hdf5.py).

The JAX package reads Keras files through h5py, the reference through
libhdf5 (`Hdf5Archive.java`). The port reads them itself, with numpy,
`struct` and the standard library only, so that a machine without h5py
or libhdf5 can import a Keras model. `Hdf5Archive` keeps the JAX class's
API; its `root` is this module's `Group`, which offers what the Keras
importer asks of a group: ``in``, ``[...]`` (a name may contain ``/``),
``.attrs`` and ``keys()``.

The reader covers the part of the HDF5 format that Keras HDF5 files use
(tf_keras and Keras 1 / 2 with h5py's default, "earliest" file format):

- superblock versions 0 and 1, offset and length sizes from the
  superblock, a user block before it;
- version-1 object headers, continuation messages (0x0010) followed;
- symbol-table groups: message 0x0011, the version-1 B-tree (type 0,
  internal and leaf nodes), the local heap for link names, `SNOD` nodes;
- attribute messages (0x000C) of versions 1-3 (version 1 pads name,
  datatype and dataspace to 8 bytes);
- datatypes: fixed-point, floating-point (2, 4, 8 bytes), fixed-length
  strings and variable-length strings (class 9, through the global heap's
  `GCOL` collections), little-endian;
- dataspaces: scalar and simple;
- data layout message version 3: contiguous, compact, and a contiguous
  dataset never written (undefined address), read as its fill value.

Anything else raises `NotImplementedError` naming the feature: superblock
versions 2 and 3, version-2 object headers (`OHDR`), link messages and
fractal-heap groups, dense attribute storage, shared messages, chunked or
filtered layouts, big-endian or other datatype classes. A read outside
the subset never passes silently.

Values follow h5py's conventions, so that the two can be compared
directly: a scalar attribute is a numpy scalar (`np.bytes_` for a
fixed-length string, `str` for a variable-length one), an array attribute
a numpy array (an object array of `str` for variable-length strings);
dataset bytes come from the file at their offset with `np.fromfile`.
"""
from __future__ import annotations

import json
import mmap
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 6, 8, 10, 11, 12
_COMMENT, _MTIME_OLD, _SHARED_TABLE, _CONTINUATION = 13, 14, 15, 16
_SYMBOL_TABLE, _MTIME, _BTREE_K, _VFD_INFO, _ATTR_INFO = 17, 18, 19, 20, 21
_REFCOUNT = 22
# messages that carry nothing the reader needs
_IGNORED = {_NIL, _FILL_OLD, _COMMENT, _MTIME_OLD, _MTIME, _BTREE_K,
            _REFCOUNT}
_REFUSED = {
    _LINK_INFO: "link-info messages (new-style groups with links in the "
                "object header or a fractal heap)",
    _LINK: "link messages (new-style groups)",
    _GROUP_INFO: "group-info messages (new-style groups)",
    _SHARED_TABLE: "the shared object header message table",
    _VFD_INFO: "virtual-file-layer info messages (0x0014)",
    _ATTR_INFO: "dense attribute storage (attribute-info message, "
                "fractal-heap attributes)",
}
# float layouts by size: (bit offset, precision, exponent location,
# exponent size, mantissa location, mantissa size, exponent bias)
_IEEE = {2: (0, 16, 10, 5, 0, 10, 15), 4: (0, 32, 23, 8, 0, 23, 127),
         8: (0, 64, 52, 11, 0, 52, 1023)}
_DATATYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                     7: "reference", 8: "enumerated", 10: "array"}


def _to_str(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8")
    if isinstance(v, np.ndarray) and v.dtype.kind == "S":
        return v.tobytes().decode("utf-8")
    return str(v)


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Datatype:
    """A decoded datatype message: the numpy dtype of one element, or a
    variable-length string (``vlen_str``, each element a length and a
    global-heap id in the raw data)."""

    def __init__(self, dtype: Optional[np.dtype], size: int,
                 vlen_str: bool = False, encoding: str = "ascii"):
        self.dtype = dtype
        self.size = size
        self.vlen_str = vlen_str
        self.encoding = encoding


class _Dataspace:
    def __init__(self, shape: Tuple[int, ...], scalar: bool):
        self.shape = shape
        self.scalar = scalar

    @property
    def count(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1


class _Header:
    """One object header's messages, parsed; values decoded on demand."""

    def __init__(self):
        self.dataspace: Optional[_Dataspace] = None
        self.datatype_at: Optional[int] = None     # decoded on a read
        self.layout: Optional[Tuple] = None
        self.fill: Optional[bytes] = None
        self.filters = False
        self.symbol_table: Optional[Tuple[int, int]] = None
        self.attributes: Dict[str, Tuple[int, int]] = {}
        self.continuations = 0      # continuation blocks followed


class Hdf5File:
    """The file: superblock, object headers, heaps, raw data. Every
    address in the file is relative to the superblock's base address."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._fh.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        except ValueError:          # an empty file
            self._fh.close()
            raise OSError(f"{path}: not an HDF5 file (empty)")
        self._headers: Dict[int, _Header] = {}
        self._collections: Dict[int, Dict[int, bytes]] = {}
        self._children: Dict[int, Dict[str, int]] = {}
        try:
            self._superblock()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._fh.close()

    # ------------------------------------------------------------ primitives
    def _u(self, pos: int, size: int) -> int:
        """An unsigned little-endian integer of ``size`` bytes at absolute
        file position ``pos``."""
        return int.from_bytes(self._mm[pos:pos + size], "little")

    def _addr(self, pos: int) -> Optional[int]:
        """An address field: None when undefined (all bits set)."""
        v = self._u(pos, self.so)
        if v == (1 << (8 * self.so)) - 1:
            return None
        return v + self.base

    def _sig(self, pos: int, sig: bytes, what: str) -> None:
        if self._mm[pos:pos + 4] != sig:
            raise ValueError(f"{self.path}: expected {what} ({sig!r}) at "
                             f"{pos}, found {bytes(self._mm[pos:pos + 4])!r}")

    # ------------------------------------------------------------ superblock
    def _superblock(self) -> None:
        pos = 0
        size = len(self._mm)
        while self._mm[pos:pos + 8] != SIGNATURE:
            pos = 512 if pos == 0 else pos * 2
            if pos + 8 > size:
                raise OSError(f"{self.path}: not an HDF5 file (no "
                              "signature)")
        version = self._mm[pos + 8]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{self.path}: superblock version {version} (files "
                "written with libver='latest' or 'v108'+); the reader "
                "covers versions 0 and 1")
        self.so = self._mm[pos + 13]        # size of offsets
        self.sl = self._mm[pos + 14]        # size of lengths
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise ValueError(f"{self.path}: offset / length sizes "
                             f"{self.so} / {self.sl}")
        p = pos + 24 + (4 if version == 1 else 0)
        self.base = self._u(p, self.so)
        p += 4 * self.so                    # base, free space, EOF, VFD info
        # root group symbol table entry: link name offset (a length),
        # object header address
        self.root_address = self._u(p + self.sl, self.so) + self.base

    # --------------------------------------------------------- object header
    def header(self, address: int) -> _Header:
        h = self._headers.get(address)
        if h is None:
            h = self._parse_header(address)
            self._headers[address] = h
        return h

    def _parse_header(self, address: int) -> _Header:
        mm = self._mm
        if mm[address:address + 4] == b"OHDR":
            raise NotImplementedError(
                f"{self.path}: version-2 object header (OHDR) at "
                f"{address}; the reader covers version-1 headers")
        version = mm[address]
        if version != 1:
            raise NotImplementedError(
                f"{self.path}: object header version {version} at "
                f"{address}")
        n_messages = self._u(address + 2, 2)
        blocks = [(address + 16, self._u(address + 8, 4))]
        h = _Header()
        seen = 0
        while blocks and seen < n_messages:
            start, length = blocks.pop(0)
            pos, end = start, start + length
            while pos + 8 <= end and seen < n_messages:
                mtype = self._u(pos, 2)
                msize = self._u(pos + 2, 2)
                flags = mm[pos + 4]
                body = pos + 8
                pos = body + msize
                seen += 1
                if flags & 0x02:
                    raise NotImplementedError(
                        f"{self.path}: shared message (type {mtype:#06x}) "
                        f"in the object header at {address}")
                if mtype == _CONTINUATION:
                    h.continuations += 1
                    blocks.append((self._addr(body),
                                   self._u(body + self.so, self.sl)))
                elif mtype in _REFUSED:
                    raise NotImplementedError(
                        f"{self.path}: {_REFUSED[mtype]} in the object "
                        f"header at {address}")
                elif mtype == _DATASPACE:
                    h.dataspace = self._dataspace(body)
                elif mtype == _DATATYPE:
                    h.datatype_at = body
                elif mtype == _FILL:
                    h.fill = self._fill_value(body)
                elif mtype == _LAYOUT:
                    h.layout = self._layout(body)
                elif mtype == _FILTERS:
                    h.filters = True
                elif mtype == _SYMBOL_TABLE:
                    h.symbol_table = (self._addr(body),
                                      self._addr(body + self.so))
                elif mtype == _ATTRIBUTE:
                    name = self._attribute_name(body)
                    h.attributes[name] = (body, msize)
                elif mtype not in _IGNORED:
                    raise NotImplementedError(
                        f"{self.path}: object header message type "
                        f"{mtype:#06x} at {address}")
        return h

    def _dataspace(self, pos: int) -> _Dataspace:
        mm = self._mm
        version, rank, flags = mm[pos], mm[pos + 1], mm[pos + 2]
        if version == 1:
            dims_at = pos + 8
            scalar = rank == 0
        elif version == 2:
            kind = mm[pos + 3]
            if kind == 2:
                raise NotImplementedError(
                    f"{self.path}: null dataspace (an empty attribute)")
            dims_at = pos + 4
            scalar = kind == 0
        else:
            raise NotImplementedError(
                f"{self.path}: dataspace message version {version}")
        if flags & 0x02:
            raise NotImplementedError(
                f"{self.path}: dataspace with permutation indices")
        shape = tuple(self._u(dims_at + i * self.sl, self.sl)
                      for i in range(rank))
        return _Dataspace(shape, scalar)

    def _datatype(self, pos: int) -> _Datatype:
        mm = self._mm
        cls, version = mm[pos] & 0x0F, mm[pos] >> 4
        bits = self._u(pos + 1, 3)
        size = self._u(pos + 4, 4)
        if cls == 0:                                    # fixed-point
            if bits & 0x01:
                raise NotImplementedError(
                    f"{self.path}: big-endian integer datatype")
            offset, precision = self._u(pos + 8, 2), self._u(pos + 10, 2)
            if size not in (1, 2, 4, 8) or offset != 0 or \
                    precision != 8 * size:
                raise NotImplementedError(
                    f"{self.path}: integer datatype of {size} bytes, bit "
                    f"offset {offset}, precision {precision}")
            kind = "i" if bits & 0x08 else "u"
            return _Datatype(np.dtype(f"<{kind}{size}"), size)
        if cls == 1:                                    # floating-point
            if bits & 0x01 or bits & 0x40:
                raise NotImplementedError(
                    f"{self.path}: big-endian or VAX float datatype")
            # bit offset, precision, exponent location and size, mantissa
            # location and size, exponent bias: IEEE 754 binary16/32/64
            layout = (self._u(pos + 8, 2), self._u(pos + 10, 2),
                      mm[pos + 12], mm[pos + 13], mm[pos + 14],
                      mm[pos + 15], self._u(pos + 16, 4))
            if _IEEE.get(size) != layout:
                raise NotImplementedError(
                    f"{self.path}: float datatype of {size} bytes with "
                    f"layout {layout}, not IEEE 754")
            return _Datatype(np.dtype(f"<f{size}"), size)
        if cls == 3:                                    # fixed-length string
            return _Datatype(np.dtype(f"S{size}"), size)
        if cls == 9:                                    # variable-length
            if bits & 0x0F != 1:
                raise NotImplementedError(
                    f"{self.path}: variable-length sequence datatype (only "
                    "variable-length strings are read)")
            encoding = "utf-8" if (bits >> 8) & 0x0F == 1 else "ascii"
            return _Datatype(None, size, vlen_str=True, encoding=encoding)
        raise NotImplementedError(
            f"{self.path}: {_DATATYPE_CLASSES.get(cls, f'class {cls}')} "
            f"datatype (version {version})")

    def _fill_value(self, pos: int) -> Optional[bytes]:
        mm = self._mm
        version = mm[pos]
        if version in (1, 2):
            defined = mm[pos + 3]
            if version == 2 and not defined:
                return None
            size = self._u(pos + 4, 4)
            return bytes(mm[pos + 8:pos + 8 + size]) if size else None
        if version == 3:
            if not mm[pos + 1] & 0x20:
                return None
            size = self._u(pos + 2, 4)
            return bytes(mm[pos + 6:pos + 6 + size]) if size else None
        raise NotImplementedError(
            f"{self.path}: fill value message version {version}")

    def _layout(self, pos: int) -> Tuple:
        mm = self._mm
        version = mm[pos]
        if version != 3:
            raise NotImplementedError(
                f"{self.path}: data layout message version {version} (the "
                "reader covers version 3)")
        cls = mm[pos + 1]
        if cls == 0:
            size = self._u(pos + 2, 2)
            return ("compact", pos + 4, size)
        if cls == 1:
            return ("contiguous", self._addr(pos + 2),
                    self._u(pos + 2 + self.so, self.sl))
        if cls == 2:
            return ("chunked",)
        return ("layout class %d" % cls,)

    # ------------------------------------------------------------ attributes
    def _attribute_parts(self, pos: int):
        """(name, datatype at, dataspace at, data at) of an attribute
        message."""
        mm = self._mm
        version = mm[pos]
        name_size = self._u(pos + 2, 2)
        dt_size = self._u(pos + 4, 2)
        ds_size = self._u(pos + 6, 2)
        if version == 1:
            name_at = pos + 8
            dt_at = name_at + _pad8(name_size)
            ds_at = dt_at + _pad8(dt_size)
            data_at = ds_at + _pad8(ds_size)
        elif version in (2, 3):
            if mm[pos + 1] & 0x03:
                raise NotImplementedError(
                    f"{self.path}: attribute with a shared datatype or "
                    "dataspace")
            name_at = pos + 8 + (1 if version == 3 else 0)
            dt_at = name_at + name_size
            ds_at = dt_at + dt_size
            data_at = ds_at + ds_size
        else:
            raise NotImplementedError(
                f"{self.path}: attribute message version {version}")
        name = bytes(mm[name_at:name_at + name_size]).rstrip(b"\0")
        return name.decode("utf-8"), dt_at, ds_at, data_at

    def _attribute_name(self, pos: int) -> str:
        return self._attribute_parts(pos)[0]

    def attribute(self, pos: int) -> Any:
        _, dt_at, ds_at, data_at = self._attribute_parts(pos)
        dtype = self._datatype(dt_at)
        space = self._dataspace(ds_at)
        nbytes = space.count * self._element_size(dtype)
        return self._values(dtype, space,
                            self._mm[data_at:data_at + nbytes],
                            as_str=True, scalar_item=True)

    def _element_size(self, dtype: _Datatype) -> int:
        """Bytes of one element in the file: a variable-length string is
        its length and a global-heap id (collection address, index)."""
        return 4 + self.so + 4 if dtype.vlen_str else dtype.size

    # ----------------------------------------------------------------- values
    def _values(self, dtype: _Datatype, space: _Dataspace, raw,
                as_str: bool, scalar_item: bool) -> Any:
        """Decode ``raw`` element bytes. Variable-length strings become
        ``str`` (attributes, as h5py reads them) or ``bytes`` (datasets);
        a scalar becomes a numpy scalar when ``scalar_item``."""
        if dtype.vlen_str:
            out = np.empty(space.count, dtype=object)
            step = self._element_size(dtype)
            for i in range(space.count):
                b = self._vlen_bytes(raw, i * step)
                out[i] = b.decode(dtype.encoding) if as_str else b
            arr = out.reshape(space.shape)
        else:
            arr = np.frombuffer(raw, dtype=dtype.dtype,
                                count=space.count).copy()
            arr = arr.reshape(space.shape)
        if space.scalar and scalar_item:
            return arr[()]
        return arr

    def _vlen_bytes(self, raw, at: int) -> bytes:
        length = int.from_bytes(raw[at:at + 4], "little")
        if length == 0:
            return b""
        coll = int.from_bytes(raw[at + 4:at + 4 + self.so], "little")
        index = int.from_bytes(raw[at + 4 + self.so:at + 8 + self.so],
                               "little")
        obj = self._collection(coll + self.base)[index]
        if len(obj) < length:
            raise ValueError(f"{self.path}: global heap object {index} "
                             f"holds {len(obj)} bytes of {length}")
        return obj[:length]

    def _collection(self, address: int) -> Dict[int, bytes]:
        """The objects of one global heap collection (`GCOL`), by index."""
        objs = self._collections.get(address)
        if objs is not None:
            return objs
        self._sig(address, b"GCOL", "a global heap collection")
        size = self._u(address + 8, self.sl)
        end = address + size
        pos = address + _pad8(8 + self.sl)     # the header, 8-aligned
        objs = {}
        while pos + 8 + self.sl <= end:
            index = self._u(pos, 2)
            if index == 0:          # free space: the rest of the collection
                break
            osize = self._u(pos + 8, self.sl)
            data_at = pos + _pad8(8 + self.sl)
            objs[index] = bytes(self._mm[data_at:data_at + osize])
            pos = data_at + _pad8(osize)
        self._collections[address] = objs
        return objs

    # ------------------------------------------------------------------ groups
    def children(self, address: int) -> Dict[str, int]:
        """A group's members: name -> object header address, in name
        order (the B-tree's order, which is h5py's)."""
        kids = self._children.get(address)
        if kids is not None:
            return kids
        h = self.header(address)
        if h.symbol_table is None:
            raise ValueError(f"{self.path}: object at {address} is not a "
                             "group")
        btree, heap = h.symbol_table
        heap_data = self._local_heap(heap)
        members: List[Tuple[str, int]] = []
        self._walk_btree(btree, heap_data, members)
        kids = dict(members)
        self._children[address] = kids
        return kids

    def _local_heap(self, address: int) -> int:
        self._sig(address, b"HEAP", "a local heap")
        return self._addr(address + 8 + 2 * self.sl)

    def _heap_name(self, heap_data: int, offset: int) -> str:
        end = self._mm.find(b"\0", heap_data + offset)
        return bytes(self._mm[heap_data + offset:end]).decode("utf-8")

    def _walk_btree(self, address: int, heap_data: int,
                    out: List[Tuple[str, int]]) -> None:
        self._sig(address, b"TREE", "a v1 B-tree node")
        mm = self._mm
        if mm[address + 4] != 0:
            raise NotImplementedError(
                f"{self.path}: v1 B-tree of type {mm[address + 4]} where a "
                "group's (type 0) was expected")
        level = mm[address + 5]
        used = self._u(address + 6, 2)
        pos = address + 8 + 2 * self.so         # past the sibling addresses
        for _ in range(used):
            pos += self.sl                      # key: a heap offset
            child = self._addr(pos)
            pos += self.so
            if level > 0:
                self._walk_btree(child, heap_data, out)
            else:
                self._read_snod(child, heap_data, out)

    def _read_snod(self, address: int, heap_data: int,
                   out: List[Tuple[str, int]]) -> None:
        self._sig(address, b"SNOD", "a symbol table node")
        n = self._u(address + 6, 2)
        # an entry: link name offset (a length), object header address,
        # cache type, reserved, 16 bytes of scratch-pad
        entry = self.sl + self.so + 24
        for i in range(n):
            pos = address + 8 + i * entry
            name = self._heap_name(heap_data, self._u(pos, self.sl))
            cache_type = self._u(pos + self.sl + self.so, 4)
            if cache_type == 2:
                raise NotImplementedError(
                    f"{self.path}: soft link '{name}'")
            out.append((name, self._addr(pos + self.sl)))

    # ---------------------------------------------------------------- datasets
    def read(self, address: int) -> np.ndarray:
        h = self.header(address)
        if h.dataspace is None or h.datatype_at is None or h.layout is None:
            raise ValueError(f"{self.path}: object at {address} is not a "
                             "dataset")
        if h.filters:
            raise NotImplementedError(
                f"{self.path}: filtered dataset (filter pipeline, e.g. "
                "gzip); the reader covers unfiltered data")
        kind = h.layout[0]
        if kind not in ("contiguous", "compact"):
            raise NotImplementedError(
                f"{self.path}: {kind} dataset layout; the reader covers "
                "contiguous and compact datasets")
        dt, space = self._datatype(h.datatype_at), h.dataspace
        nbytes = space.count * self._element_size(dt)
        if kind == "compact":
            raw = self._mm[h.layout[1]:h.layout[1] + h.layout[2]]
        elif h.layout[1] is None:           # never written: the fill value
            fill = h.fill if h.fill is not None else bytes(dt.size)
            if dt.vlen_str:
                raise NotImplementedError(
                    f"{self.path}: unwritten variable-length string "
                    "dataset")
            if len(fill) != dt.size:
                raise ValueError(f"{self.path}: fill value of {len(fill)} "
                                 f"bytes for {dt.size}-byte elements")
            raw = fill * space.count
        elif not dt.vlen_str:
            self._fh.seek(h.layout[1])
            arr = np.fromfile(self._fh, dtype=dt.dtype, count=space.count)
            if arr.size != space.count:
                raise ValueError(f"{self.path}: dataset at {address} runs "
                                 "past the end of the file")
            return arr.reshape(space.shape)
        else:
            raw = self._mm[h.layout[1]:h.layout[1] + nbytes]
        if len(raw) < nbytes:
            raise ValueError(f"{self.path}: dataset at {address} has "
                             f"{len(raw)} bytes of {nbytes}")
        return self._values(dt, space, raw, as_str=False,
                            scalar_item=False)


class Attributes:
    """An object's attributes, read on access (h5py's `AttributeManager`
    surface: ``in``, ``[...]``, ``get``, ``keys``, ``items``)."""

    def __init__(self, f: Hdf5File, header: _Header):
        self._f = f
        self._h = header

    def __contains__(self, name: str) -> bool:
        return name in self._h.attributes

    def __getitem__(self, name: str) -> Any:
        if name not in self._h.attributes:
            raise KeyError(name)
        return self._f.attribute(self._h.attributes[name][0])

    def get(self, name: str, default=None) -> Any:
        return self[name] if name in self else default

    def keys(self) -> List[str]:
        return list(self._h.attributes)

    def items(self):
        return [(k, self[k]) for k in self.keys()]


class _Object:
    def __init__(self, f: Hdf5File, address: int, name: str):
        self._file = f
        self.address = address
        self.name = name

    @property
    def attrs(self) -> Attributes:
        return Attributes(self._file, self._file.header(self.address))


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, ``attrs``, ``read()``."""

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._file.header(self.address).dataspace.shape

    @property
    def dtype(self) -> np.dtype:
        f = self._file
        dt = f._datatype(f.header(self.address).datatype_at)
        return dt.dtype if dt.dtype is not None else np.dtype(object)

    def read(self) -> np.ndarray:
        return self._file.read(self.address)


class Group(_Object):
    """A symbol-table group: ``in``, ``[...]`` (paths with ``/``),
    ``keys()``, ``attrs``, ``visititems``."""

    def keys(self) -> List[str]:
        return list(self._file.children(self.address))

    def _child(self, name: str) -> Optional[_Object]:
        addr = self._file.children(self.address).get(name)
        if addr is None:
            return None
        path = f"{self.name.rstrip('/')}/{name}"
        if self._file.header(addr).symbol_table is not None:
            return Group(self._file, addr, path)
        return Dataset(self._file, addr, path)

    def _lookup(self, path: str) -> Optional[_Object]:
        obj: Optional[_Object] = self
        for part in (p for p in path.split("/") if p):
            if not isinstance(obj, Group):
                return None
            obj = obj._child(part)
            if obj is None:
                return None
        return obj

    def __contains__(self, path: str) -> bool:
        return self._lookup(path) is not None

    def __getitem__(self, path: str) -> _Object:
        obj = self._lookup(path)
        if obj is None:
            raise KeyError(f"{path!r} not in group {self.name!r}")
        return obj

    def visititems(self, fn: Callable[[str, _Object], Any],
                   _prefix: str = "") -> Any:
        """Call ``fn(relative_name, obj)`` on every object below this
        group, depth first in name order; stop at a non-None return."""
        for name in self.keys():
            obj = self[name]
            rel = f"{_prefix}{name}"
            r = fn(rel, obj)
            if r is not None:
                return r
            if isinstance(obj, Group):
                r = obj.visititems(fn, rel + "/")
                if r is not None:
                    return r
        return None


class Hdf5Archive:
    """Read-only view of a Keras .h5 file (the reference's
    Hdf5Archive.java surface)."""

    def __init__(self, path: str):
        self._f = Hdf5File(path)
        self._root = Group(self._f, self._f.root_address, "/")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Hdf5Archive":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- attributes --------------------------------------------------------
    def read_attribute_as_json(self, name: str,
                               *group_path: str) -> Optional[Dict]:
        """Reference: Hdf5Archive.readAttributeAsJson."""
        g = self._group(*group_path)
        if g is None or name not in g.attrs:
            return None
        return json.loads(_to_str(g.attrs[name]))

    def read_attribute_as_string(self, name: str,
                                 *group_path: str) -> Optional[str]:
        g = self._group(*group_path)
        if g is None or name not in g.attrs:
            return None
        return _to_str(g.attrs[name])

    def read_attribute_as_string_list(self, name: str,
                                      *group_path: str) -> List[str]:
        g = self._group(*group_path)
        if g is None or name not in g.attrs:
            return []
        return [_to_str(v) for v in g.attrs[name]]

    # -- groups / datasets -------------------------------------------------
    def _group(self, *path: str) -> Optional[Group]:
        g: Any = self._root
        for p in path:
            if not isinstance(g, Group) or p not in g:
                return None
            g = g[p]
        return g if isinstance(g, Group) else None

    def has_group(self, *path: str) -> bool:
        return self._group(*path) is not None

    def groups(self, *path: str) -> List[str]:
        g = self._group(*path)
        if g is None:
            return []
        return [k for k in g.keys() if isinstance(g[k], Group)]

    def datasets(self, *path: str) -> List[str]:
        g = self._group(*path)
        if g is None:
            return []
        return [k for k in g.keys() if isinstance(g[k], Dataset)]

    def read_dataset(self, *path: str) -> np.ndarray:
        """Read a dataset by path; a component may itself contain '/'
        separators (Keras weight names like 'dense_1/kernel:0')."""
        obj: Any = self._root
        for p in path:
            obj = obj[p]
        return obj.read()

    def layer_weights(self, layer_group) -> Dict[str, np.ndarray]:
        """All datasets under a layer group keyed by their Keras weight
        name (attr `weight_names`), e.g. {'dense_1/kernel:0': array}."""
        out: Dict[str, np.ndarray] = {}
        names = [_to_str(n) for n in layer_group.attrs.get("weight_names",
                                                           [])]
        if names:
            for n in names:
                out[n] = layer_group[n].read()
            return out

        # Keras 1 files have no weight_names on some groups: walk datasets
        def visit(name, obj):
            if isinstance(obj, Dataset):
                out[name] = obj.read()
        layer_group.visititems(visit)
        return out

    @property
    def root(self) -> Group:
        return self._root
