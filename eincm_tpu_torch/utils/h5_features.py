"""The HDF5 structures that point elsewhere, for `utils/h5_lite.py`.

What h5py writes beside plain datasets, following the HDF5 File Format
Specification (version 3.0) and, where the specification leaves it to the
library, what HDF5 1.14 does:

- shared messages stored in another object header (committed datatypes),
  in the shared message encodings versions 1 to 3 (`shared_address`); a
  message shared through the superblock extension's SOHM table raises;
- dataspace selections as HDF5 serializes them (`decode_selection`): none,
  all, points (versions 1 and 2) and hyperslabs (version 1 blocks,
  version 2 regular, version 3 regular or blocks), for dataset region
  references and virtual dataset mappings alike; a selection gives its
  elements' flat indices in HDF5's order of iteration (C order, points as
  listed), and an unlimited one is clipped to an extent;
- references: `Reference` (object) and `RegionReference` (dataset region),
  which `h5_lite.File.dereference` resolves;
- the virtual dataset mapping blob (`vds_mappings`) and printf-style
  source names (`%b`, `%%`: `printf_name`);
- the external data files message (`external_files`);
- where HDF5 looks for a file that a link, a mapping or an external data
  file names (`candidates`), and h5py's `Empty`.
"""

from __future__ import annotations

import math
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from eincm_tpu_torch.utils.h5_latest import Cursor, check_sum

UNDEF = 0xFFFFFFFFFFFFFFFF
# shared message types of encoding versions 2 and 3 (H5O_SHARE_TYPE_*)
_SHARED_SOHM, _SHARED_COMMITTED = 1, 2
_SELECTIONS = {0: "none", 1: "points", 2: "hyperslab", 3: "all"}


class UnsupportedHDF5(ValueError):
    """An HDF5 feature outside the subset `utils/h5_lite.py` reads."""


class Empty:
    """A dataset or attribute with a null dataspace, as h5py's `Empty`: no
    data, only its dtype."""

    __slots__ = ("dtype",)

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __hash__(self):
        return hash(("Empty", self.dtype.str))

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


class Reference:
    """An object reference: the object header's address in `file` (the
    path of the file it was read from). A null reference is false."""

    __slots__ = ("file", "addr")

    def __init__(self, file: str, addr: int):
        self.file, self.addr = file, addr

    def __bool__(self):
        return self.addr not in (0, UNDEF)

    def __eq__(self, other):
        return type(other) is type(self) and (other.file, other.addr) == (self.file, self.addr)

    def __hash__(self):
        return hash((type(self).__name__, self.file, self.addr))

    def __repr__(self):
        return f"{type(self).__name__}({self.file!r}, {self.addr})"


class RegionReference(Reference):
    """A dataset region reference: its global heap object (`addr` is the
    collection's address, `index` the object's), which holds the dataset's
    address and the selection."""

    __slots__ = ("index",)

    def __init__(self, file: str, addr: int, index: int):
        super().__init__(file, addr)
        self.index = index

    def __eq__(self, other):
        return super().__eq__(other) and other.index == self.index

    def __hash__(self):
        return hash((super().__hash__(), self.index))

    def __repr__(self):
        return f"RegionReference({self.file!r}, {self.addr}, {self.index})"


# ----------------------------------------------------------- shared messages

def shared_address(body: bytes, where: str) -> int:
    """The object header that holds a shared message, from its encoding
    (versions 1 to 3); a message in the SOHM heap raises."""
    c = Cursor(body, f"{where}: shared message")
    version, kind = c.u8(), c.u8()
    if version == 1:
        c.take(6)  # reserved; version 1 knew only committed messages
        return c.u64()
    if version not in (2, 3):
        raise UnsupportedHDF5(f"{where}: shared message encoding v{version} is not supported")
    if kind == _SHARED_COMMITTED:
        return c.u64()
    if version == 3 and kind == _SHARED_SOHM:
        raise UnsupportedHDF5(f"{where}: a message shared through the SOHM table (SMTB/SMLI, "
                              "heap ID " + c.take(8).hex() + ") is not supported")
    raise ValueError(f"{where}: shared message encoding v{version} of type {kind}")


# ---------------------------------------------------------------- selections

class Selection:
    """A dataspace selection: `kind` "none", "all", "points" (`points`, an
    (n, rank) array in the order listed), or "hyperslab", either `regular`
    ([(start, stride, count, block)] a dimension; None for an unlimited
    count or block) or `blocks` (an (n, 2, rank) array of inclusive
    starts and ends)."""

    __slots__ = ("kind", "points", "regular", "blocks")

    def __init__(self, kind, points=None, regular=None, blocks=None):
        self.kind, self.points, self.regular, self.blocks = kind, points, regular, blocks

    def unlimited_dim(self) -> Optional[int]:
        if self.regular is None:
            return None
        dims = [d for d, (_, _, n, b) in enumerate(self.regular) if n is None or b is None]
        if len(dims) > 1:
            raise UnsupportedHDF5(f"a selection unlimited in dimensions {dims}")
        return dims[0] if dims else None

    def clip(self, d: int, extent: int) -> "Selection":
        """This unlimited selection cut to the whole blocks that lie below
        `extent` along dimension d."""
        start, stride, count, block = self.regular[d]
        if block is None:  # one block, as long as the extent allows
            count, block = (1, extent - start) if extent > start else (0, 1)
        else:
            count = (extent - start - block) // stride + 1 if extent >= start + block else 0
        regular = list(self.regular)
        regular[d] = (start, stride, count, block)
        return Selection("hyperslab", regular=regular)

    def with_count(self, d: int, count: int) -> "Selection":
        """This unlimited selection with `count` blocks (or, where the
        block is unlimited, one block of `count`) along dimension d."""
        start, stride, n, block = self.regular[d]
        regular = list(self.regular)
        regular[d] = (start, stride, 1, count) if block is None else (start, stride, count, block)
        return Selection("hyperslab", regular=regular)

    def block(self, d: int, j: int) -> "Selection":
        """Block j along dimension d of this regular selection alone."""
        start, stride, _, block = self.regular[d]
        regular = list(self.regular)
        regular[d] = (start + j * stride, 1, 1, block)
        return Selection("hyperslab", regular=regular)

    def extent(self, d: int) -> int:
        """One past the last coordinate along dimension d (0 if empty)."""
        if self.kind == "points":
            return int(self.points[:, d].max()) + 1 if len(self.points) else 0
        if self.kind == "hyperslab" and self.regular is not None:
            start, stride, count, block = self.regular[d]
            return start + stride * (count - 1) + block if count and block else 0
        if self.kind == "hyperslab":
            return int(self.blocks[:, 1, d].max()) + 1 if len(self.blocks) else 0
        return 0

    def slices(self, rank: int):
        """The selection as a tuple of slices where it is one (all, or a
        regular hyperslab of one block or of single elements a
        dimension), else None: its elements in C order either way."""
        if self.kind == "all":
            return (slice(None),) * rank
        if self.regular is None or self.unlimited_dim() is not None:
            return None
        out = []
        for start, stride, count, block in self.regular:
            if count == 1 or block == 0:
                out.append(slice(start, start + block * min(count, 1)))
            elif block == 1:
                out.append(slice(start, start + stride * (count - 1) + 1, stride))
            else:
                return None
        return tuple(out)

    def along(self, d: int) -> int:
        """Elements along dimension d of a regular selection."""
        _, _, count, block = self.regular[d]
        return count * block

    def indices(self, shape: Tuple[int, ...], where: str) -> np.ndarray:
        """The selected elements' flat C-order indices in a dataspace of
        `shape`, in HDF5's order of iteration."""
        rank = len(shape)
        if self.kind == "none":
            return np.zeros(0, np.int64)
        if self.kind == "all":
            return np.arange(math.prod(shape), dtype=np.int64)
        if self.kind == "points":
            pts = self.points
            if pts.shape[1] != rank or (len(pts) and (pts >= np.asarray(shape)).any()):
                raise ValueError(f"{where}: points outside a dataspace of {shape}")
            return (np.ravel_multi_index(tuple(pts.T.astype(np.int64)), shape).astype(np.int64)
                    if len(pts) else np.zeros(0, np.int64))
        if self.regular is not None:
            if len(self.regular) != rank or self.unlimited_dim() is not None:
                raise ValueError(f"{where}: a hyperslab of rank {len(self.regular)} "
                                 f"(unlimited: {self.unlimited_dim()}) on {shape}")
            axes = []
            for (start, stride, count, block), n in zip(self.regular, shape):
                c = (start + stride * np.arange(count, dtype=np.int64)[:, None]
                     + np.arange(block, dtype=np.int64)[None, :]).reshape(-1)
                # sorted and distinct already unless the blocks overlap
                axes.append(np.unique(c) if count > 1 and block > stride else c)
            return _grid(axes, shape, where)
        if self.blocks.shape[2:] != (rank,):
            raise ValueError(f"{where}: blocks of rank {self.blocks.shape[2:]} on {shape}")
        parts = [_grid([np.arange(s, e + 1, dtype=np.int64) for s, e in zip(b[0], b[1])],
                       shape, where) for b in self.blocks.astype(np.int64)]
        return np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)

    def guess_shape(self, shape: Tuple[int, ...], flat: np.ndarray) -> Tuple[int, ...]:
        """The shape h5py gives the elements (at `flat`) of this selection
        of a dataspace of `shape` (h5py's `selections.guess_shape`): the
        dataspace's for "all", (n,) for points, else the elements along
        each axis where they fill a box, (n,) where they do not."""
        n = len(flat)
        if self.kind == "all":
            return tuple(shape)
        if self.kind == "points":
            return (n,)
        if n == 0:
            return (0,) * len(shape)
        coords = np.unravel_index(flat, shape)
        # along an axis: the elements over those at its lowest coordinate
        out = tuple(n // int((c == c.min()).sum()) for c in coords)
        return out if math.prod(out) == n else (n,)


def _grid(axes: List[np.ndarray], shape, where: str) -> np.ndarray:
    """Flat indices of the product of per-dimension coordinates, C order."""
    if any(len(a) and (a[0] < 0 or a[-1] >= n) for a, n in zip(axes, shape)):
        raise ValueError(f"{where}: a hyperslab outside a dataspace of {shape}")
    flat = np.zeros(1, np.int64)
    for a, n in zip(axes, shape):
        flat = (flat[:, None] * n + a[None, :]).reshape(-1)
    return flat


def decode_selection(c: Cursor) -> Selection:
    """A selection as `H5S_SELECT_SERIALIZE` writes it, from the cursor."""
    kind, version = c.u32(), c.u32()
    name = _SELECTIONS.get(kind)
    if name is None:
        raise ValueError(f"{c.where}: selection type {kind}")
    if name in ("none", "all"):
        if version != 1:
            raise UnsupportedHDF5(f"{c.where}: {name} selection v{version} is not supported")
        c.take(8)  # reserved, length
        return Selection(name)
    if name == "points":
        if version == 1:
            c.take(8)
            rank, n, enc = c.u32(), c.u32(), 4
        elif version == 2:
            enc = c.u8()
            rank = c.u32()
            n = c.uint(enc)
        else:
            raise UnsupportedHDF5(f"{c.where}: point selection v{version} is not supported")
        return Selection("points", points=_coords(c, n * rank, enc).reshape(n, rank))
    if version == 1:
        c.take(8)
        rank, n = c.u32(), c.u32()
        return Selection("hyperslab", blocks=_coords(c, 2 * n * rank, 4).reshape(n, 2, rank))
    if version == 2:
        flags = c.u8()
        c.take(4)  # length
        rank, enc = c.u32(), 8
    elif version == 3:
        flags, enc = c.u8(), c.u8()
        rank = c.u32()
    else:
        raise UnsupportedHDF5(f"{c.where}: hyperslab selection v{version} is not supported")
    if enc not in (2, 4, 8) or rank > 32:
        raise ValueError(f"{c.where}: {enc}-byte hyperslab values of rank {rank}")
    if flags & 0x01:  # regular: start, stride, count, block a dimension
        unlim = (1 << (8 * enc)) - 1
        regular = []
        for _ in range(rank):
            start, stride, count, block = (c.uint(enc) for _ in range(4))
            regular.append((start, stride, None if count == unlim else count,
                            None if block == unlim else block))
        return Selection("hyperslab", regular=regular)
    if version == 2:
        raise ValueError(f"{c.where}: an irregular hyperslab in selection v2")
    n = c.uint(enc)
    return Selection("hyperslab", blocks=_coords(c, 2 * n * rank, enc).reshape(n, 2, rank))


def _coords(c: Cursor, n: int, enc: int) -> np.ndarray:
    if n > c.left():
        raise ValueError(f"{c.where}: {n} coordinates of {enc} bytes run past the block")
    return np.frombuffer(c.take(n * enc), f"<u{enc}").astype(np.uint64)


# ------------------------------------------------------------ virtual layout

def vds_mappings(blob: bytes, where: str) -> List[Tuple[str, str, Selection, Selection]]:
    """[(source file, source dataset, source selection, virtual
    selection)] of a virtual dataset's global heap blob (version 0,
    checksummed)."""
    check_sum(blob, f"{where}: virtual dataset mappings")
    c = Cursor(blob[:-4], f"{where}: virtual dataset mappings")
    version = c.u8()
    if version != 0:
        raise UnsupportedHDF5(f"{where}: virtual dataset mapping encoding v{version} is not "
                              "supported")
    out = []
    for _ in range(c.u64()):
        names = []
        for _ in range(2):
            end = c.buf.find(b"\0", c.pos)
            if end < 0:
                raise ValueError(f"{c.where}: a source name without its end")
            names.append(c.take(end - c.pos).decode("utf-8"))
            c.take(1)
        src = decode_selection(c)
        out.append((names[0], names[1], src, decode_selection(c)))
    return out


_PRINTF = re.compile(r"%(.)", re.S)


def printf_name(name: str, where: str, block: Optional[int] = None) -> Tuple[str, bool]:
    """(the name with `%b` replaced by `block` and `%%` by `%`, whether it
    has a `%b`), as HDF5 parses a virtual dataset's source names."""
    has_block = False

    def sub(m):
        nonlocal has_block
        if m.group(1) == "%":
            return "%"
        if m.group(1) == "b":
            has_block = True
            return "" if block is None else str(block)
        raise UnsupportedHDF5(f"{where}: the source name {name!r}: '%{m.group(1)}' is not a "
                              "printf-style sequence HDF5 takes")

    if name.endswith("%") and not name.endswith("%%"):
        raise ValueError(f"{where}: the source name {name!r} ends in a lone '%'")
    return _PRINTF.sub(sub, name), has_block


# ---------------------------------------------------------- external files

def external_files(body: bytes, where: str) -> Tuple[int, List[Tuple[int, int, int]]]:
    """(the local heap's address, [(name offset, file offset, size)]) of an
    external data files message; a size of UNDEF runs to the end."""
    c = Cursor(body, f"{where}: external data files message")
    version = c.u8()
    if version != 1:
        raise UnsupportedHDF5(f"{where}: external data files message v{version} is not "
                              "supported")
    c.take(3)
    c.u16()  # allocated slots
    used, heap = c.u16(), c.u64()
    return heap, [tuple(c.u64() for _ in range(3)) for _ in range(used)]


def read_external(path: str, offset: int, size: int, where: str) -> bytes:
    """`size` bytes at `offset` of a raw data file, as HDF5 reads them:
    zeros past the file's end."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(size)
    except FileNotFoundError:
        raise FileNotFoundError(f"{where}: the external data file {path!r} does not "
                                "exist") from None
    return data + bytes(size - len(data))


# ----------------------------------------------------------- finding files

def _origin(prefix: str, origin: str) -> str:
    return origin + prefix[len("${ORIGIN}"):] if prefix.startswith("${ORIGIN}") else prefix


def candidates(name: str, kind: str, origin: str) -> List[str]:
    """The paths at which HDF5 1.14 looks for the file `name` names, in its
    order, for `kind` "link" (an external link), "vds" (a virtual
    dataset's source) or "efile" (an external data file), named in a file
    in directory `origin`:

    - link, vds: an absolute name as given (if it is not there, its last
      component stands for it below); each directory of HDF5_EXT_PREFIX
      (link) or HDF5_VDS_PREFIX (vds), split at ':'; for vds, the whole
      HDF5_VDS_PREFIX with a leading ${ORIGIN} read as `origin`; then
      `origin`, then the working directory.
    - efile: HDF5_EXTFILE_PREFIX (a leading ${ORIGIN} read as `origin`)
      joined to the name, else the name as given: one place only.
    """
    if kind == "efile":
        prefix = os.environ.get("HDF5_EXTFILE_PREFIX", "")
        if prefix in ("", "."):
            return [name]
        return [os.path.join(_origin(prefix, origin), name)]
    out = []
    if os.path.isabs(name):
        out.append(name)
        name = os.path.basename(name)
    env = os.environ.get("HDF5_EXT_PREFIX" if kind == "link" else "HDF5_VDS_PREFIX", "")
    out += [os.path.join(p, name) for p in env.split(":") if p]
    if kind == "vds" and env and env != ".":
        out.append(os.path.join(_origin(env, origin), name))
    out += [os.path.join(origin, name), name]
    return out
