"""netCDF classic format (CDF-2, "64-bit offset") in numpy alone.

The port's fallback where h5py, and with it netCDF-4/HDF5, is not
installed: :mod:`probunet_torch.data.netcdf` writes its output (and the
synthetic inputs) in this format there and reads either format by the
file's signature. Only what those files need is covered: fixed-size
variables (no record dimension), big-endian data laid out one variable after
the other, and attributes of the classic types. Any netCDF reader (netCDF-C,
xarray, ``scipy.io.netcdf_file``) opens these files. A variable holds at
most 4 GiB in CDF-2.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

MAGIC_CDF1, MAGIC_CDF2 = b"CDF\x01", b"CDF\x02"
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C
_NC_CHAR = 2
# nc_type <-> big-endian numpy dtype
_TYPES = {1: ">i1", 3: ">i2", 4: ">i4", 5: ">f4", 6: ">f8"}
_CODES = {np.dtype(v).newbyteorder("="): k for k, v in _TYPES.items()}


def _pad4(n: int) -> int:
    return (n + 3) & ~3


class _Out:
    def __init__(self):
        self.parts = []

    def int32(self, v: int) -> None:
        self.parts.append(struct.pack(">i", v))

    def raw(self, b: bytes) -> None:
        self.parts.append(b + b"\x00" * (_pad4(len(b)) - len(b)))

    def name(self, s: str) -> None:
        b = s.encode()
        self.int32(len(b))
        self.raw(b)

    def attrs(self, attrs: Dict[str, object]) -> None:
        if not attrs:
            self.int32(0)
            self.int32(0)
            return
        self.int32(_NC_ATTRIBUTE)
        self.int32(len(attrs))
        for key, val in attrs.items():
            self.name(key)
            if isinstance(val, (str, bytes, np.bytes_)):
                b = val.encode() if isinstance(val, str) else bytes(val)
                self.int32(_NC_CHAR)
                self.int32(len(b))
                self.raw(b)
            else:
                a = np.atleast_1d(np.asarray(val))
                code = _CODES[a.dtype]
                self.int32(code)
                self.int32(a.size)
                self.raw(a.astype(_TYPES[code]).tobytes())

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class ClassicWriter:
    """A CDF-2 file of fixed-size variables, created at full size and filled
    in slabs along each variable's first axis (``write``), so a caller can
    stream a long time axis through O(slab) memory.

    ``variables``: {name: (dim names, dtype, attrs)}, in file order.
    """

    def __init__(self, path: str, dims: Dict[str, int],
                 variables: Dict[str, Tuple[Sequence[str], object, Dict[str, object]]],
                 attrs: Optional[Dict[str, object]] = None):
        if any(n <= 0 for n in dims.values()):
            raise ValueError(f"classic-format dimensions must be positive: {dims}")
        dim_ids = {d: i for i, d in enumerate(dims)}
        self._layout = {}
        sizes = []
        for name, (vdims, dtype, _) in variables.items():
            dt = np.dtype(dtype)
            if dt not in _CODES:
                raise TypeError(f"{name}: no classic netCDF type for {dt}")
            shape = tuple(dims[d] for d in vdims)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            if nbytes >= 2 ** 32 - 4:
                raise ValueError(f"{name}: {nbytes} bytes exceed a CDF-2 variable's 4 GiB")
            sizes.append(_pad4(nbytes))
            self._layout[name] = (shape, np.dtype(_TYPES[_CODES[dt]]))

        def header(begins) -> bytes:
            out = _Out()
            out.raw(MAGIC_CDF2)
            out.int32(0)  # numrecs: no record dimension
            out.int32(_NC_DIMENSION)
            out.int32(len(dims))
            for d, n in dims.items():
                out.name(d)
                out.int32(n)
            out.attrs(attrs or {})
            out.int32(_NC_VARIABLE)
            out.int32(len(variables))
            for (name, (vdims, dtype, vattrs)), size, begin in zip(variables.items(), sizes,
                                                                    begins):
                out.name(name)
                out.int32(len(vdims))
                for d in vdims:
                    out.int32(dim_ids[d])
                out.attrs(vattrs)
                out.int32(_CODES[np.dtype(dtype)])
                out.int32(size)
                out.parts.append(struct.pack(">q", begin))
            return out.bytes()

        offset = len(header([0] * len(variables)))
        begins = []
        for size in sizes:
            begins.append(offset)
            offset += size
        self._begin = dict(zip(variables, begins))
        self._f = open(path, "wb")
        self._f.write(header(begins))
        self._f.truncate(offset)

    def write(self, name: str, t0: int, arr: np.ndarray) -> None:
        """Store ``arr`` at index ``t0`` of ``name``'s first axis."""
        shape, dtype = self._layout[name]
        arr = np.asarray(arr)
        if arr.shape[1:] != shape[1:] or t0 < 0 or t0 + arr.shape[0] > shape[0]:
            raise ValueError(f"{name}: slab {arr.shape} at {t0} does not fit {shape}")
        row = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
        self._f.seek(self._begin[name] + t0 * row)
        self._f.write(np.ascontiguousarray(arr, dtype=dtype).tobytes())

    def close(self) -> None:
        self._f.close()


class _Var:
    """One variable of a classic file: h5py-like ``attrs``, ``shape``, ``ndim``
    and slicing (which reads only the slice)."""

    def __init__(self, path: str, shape, dtype, begin: int, attrs):
        self.attrs = attrs
        self.shape = tuple(shape)
        self.ndim = len(self.shape)
        self._data = np.memmap(path, dtype=dtype, mode="r", offset=begin, shape=self.shape)

    def __getitem__(self, idx) -> np.ndarray:
        a = np.asarray(self._data[idx])
        return a.astype(a.dtype.newbyteorder("="))


class ClassicFile:
    """Reader of classic (CDF-1 / CDF-2) files with fixed-size variables:
    ``f[name]`` gives a variable with h5py's reading surface."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            head = fh.read(1 << 20)  # headers are small; the data is mapped
        try:
            self._parse(path, head)
        except EOFError:
            with open(path, "rb") as fh:
                self._parse(path, fh.read())

    def _parse(self, path: str, buf: bytes) -> None:
        magic = buf[:4]
        if magic not in (MAGIC_CDF1, MAGIC_CDF2):
            raise ValueError(f"{path} is not a classic netCDF file")
        pos = [8]  # after the magic and numrecs

        def int32() -> int:
            return int.from_bytes(raw(4), "big", signed=True)

        def raw(n: int) -> bytes:
            if pos[0] + n > len(buf):
                raise EOFError
            b = buf[pos[0]:pos[0] + n]
            pos[0] += _pad4(n)
            return b

        def name() -> str:
            return raw(int32()).decode()

        def attrs() -> Dict[str, object]:
            int32()  # NC_ATTRIBUTE or ABSENT
            out = {}
            for _ in range(int32()):
                key, code = name(), int32()
                n = int32()
                if code == _NC_CHAR:
                    out[key] = raw(n)
                else:
                    dt = np.dtype(_TYPES[code])
                    a = np.frombuffer(raw(n * dt.itemsize), dtype=dt)
                    a = a.astype(dt.newbyteorder("="))
                    out[key] = a[0] if n == 1 else a
            return out

        int32()  # NC_DIMENSION or ABSENT
        dims = [(name(), int32()) for _ in range(int32())]
        if any(n == 0 for _, n in dims):
            raise ValueError(f"{path}: record dimensions are not supported")
        self.attrs = attrs()
        int32()  # NC_VARIABLE or ABSENT
        self._vars = {}
        for _ in range(int32()):
            vname = name()
            shape = [dims[int32()][1] for _ in range(int32())]
            vattrs = attrs()
            code = int32()
            int32()  # vsize
            if magic == MAGIC_CDF2:
                begin = int.from_bytes(raw(8), "big", signed=True)
            else:
                begin = int32()
            self._vars[vname] = _Var(path, shape, np.dtype(_TYPES[code]), begin, vattrs)

    def __getitem__(self, name: str) -> _Var:
        return self._vars[name]

    def __contains__(self, name: str) -> bool:
        return name in self._vars

    def close(self) -> None:
        self._vars.clear()
