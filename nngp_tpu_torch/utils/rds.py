"""Minimal reader for R's RDS serialization format (version 2/3, XDR).

Copy of ``nngp_tpu/utils/rds.py``.  Lets the port consume the reference's
shipped dataset (Heavy_metals/processed_data.RDS, loaded by
Heavy_metals/run_script.R:9-11 via readRDS) without an R installation.

Supports the subset of R's serialization needed for typical data payloads:
atomic vectors (logical/int/real/string), lists, pairlist attributes,
symbols + reference table, factors (-> numpy string arrays via levels),
matrices (dim attribute -> reshaped arrays, column-major), data.frames
(-> dict of columns, or pandas DataFrame via ``as_dataframe``).

Format notes (R internals 'serialization formats'): gzip-wrapped XDR
stream; per-item 32-bit flags word packs the SEXP type (low byte), an
object bit (0x100), attribute bit (0x200) and tag bit (0x400); vectors are
big-endian; strings are CHARSXP items; NILVALUE (254) terminates attribute
pairlists; REFSXP (255) indexes a running reference table.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

# SEXP type codes
_SYMSXP = 1
_LISTSXP = 2
_CHARSXP = 9
_LGLSXP = 10
_INTSXP = 13
_REALSXP = 14
_CPLXSXP = 15
_STRSXP = 16
_VECSXP = 19
_EXPRSXP = 20
_RAWSXP = 24
_S4SXP = 25
_ALTREP = 238
_ATTRLISTSXP = 239  # not a real code; internal marker
_NAMESPACESXP = 249
_PACKAGESXP = 250
_PERSISTSXP = 247
_CLASSREFSXP = 246
_GENERICREFSXP = 245
_EMPTYENV = 242
_BASEENV = 241
_GLOBALENV = 253
_UNBOUNDVALUE = 252
_MISSINGARG = 251
_NILVALUE = 254
_REFSXP = 255

_NA_INT = -2147483648


class _Reader:
    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0
        self.refs = []

    def _read(self, n):
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def u32(self):
        return struct.unpack(">I", self._read(4))[0]

    def i32(self):
        return struct.unpack(">i", self._read(4))[0]

    def f64s(self, n):
        out = np.frombuffer(self._read(8 * n), dtype=">f8").astype(np.float64)
        return out

    def i32s(self, n):
        return np.frombuffer(self._read(4 * n), dtype=">i4").astype(np.int64)

    def length(self):
        n = self.i32()
        if n == -1:  # long vector
            hi = self.u32()
            lo = self.u32()
            return (hi << 32) | lo
        return n

    def charsxp(self):
        flags = self.u32()
        assert flags & 255 == _CHARSXP, f"expected CHARSXP, got {flags & 255}"
        n = self.i32()
        if n == -1:
            return None  # NA_character_
        return self._read(n).decode("utf-8", errors="replace")

    def item(self):
        flags = self.u32()
        typ = flags & 255
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if typ == _NILVALUE:
            return None
        if typ == _REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            return self.refs[idx - 1]
        if typ == _SYMSXP:
            name = self.charsxp()
            self.refs.append(("symbol", name))
            return ("symbol", name)
        if typ in (_GLOBALENV, _BASEENV, _EMPTYENV, _UNBOUNDVALUE, _MISSINGARG):
            return ("special", typ)
        if typ == _LISTSXP:
            # pairlist node: [attr][tag] car cdr
            attr = self.item() if has_attr else None
            tag = self.item() if has_tag else None
            car = self.item()
            cdr = self.item()
            return ("pairlist", tag, car, cdr, attr)
        if typ == _CHARSXP:
            n = self.i32()
            if n == -1:
                return None
            return self._read(n).decode("utf-8", errors="replace")
        if typ == _LGLSXP:
            n = self.length()
            raw = self.i32s(n)
            vals = np.where(raw == _NA_INT, np.nan, raw.astype(np.float64))
            obj = vals.astype(object)
            obj[raw != _NA_INT] = raw[raw != _NA_INT].astype(bool)
            out = np.array(
                [None if r == _NA_INT else bool(r) for r in raw], dtype=object
            )
            return self._with_attrs(out, has_attr)
        if typ == _INTSXP:
            n = self.length()
            vals = self.i32s(n)
            return self._with_attrs(vals, has_attr)
        if typ == _REALSXP:
            n = self.length()
            return self._with_attrs(self.f64s(n), has_attr)
        if typ == _CPLXSXP:
            n = self.length()
            re = np.frombuffer(self._read(16 * n), dtype=">f8").astype(np.float64)
            vals = re[0::2] + 1j * re[1::2]
            return self._with_attrs(vals, has_attr)
        if typ == _STRSXP:
            n = self.length()
            vals = np.array([self.charsxp() for _ in range(n)], dtype=object)
            return self._with_attrs(vals, has_attr)
        if typ == _VECSXP or typ == _EXPRSXP:
            n = self.length()
            vals = [self.item() for _ in range(n)]
            return self._with_attrs(vals, has_attr)
        if typ == _RAWSXP:
            n = self.length()
            return self._with_attrs(np.frombuffer(self._read(n), dtype=np.uint8),
                                    has_attr)
        if typ == _ALTREP:
            # ALTREP: info (pairlist-ish), state, attr — unwrap via the
            # serialized state for the common compact-intseq/wrap cases
            info = self.item()
            state = self.item()
            attr = self.item()
            return _decode_altrep(info, state)
        raise NotImplementedError(f"RDS SEXP type {typ} not supported")

    def _with_attrs(self, value, has_attr):
        if not has_attr:
            return value
        attrs = {}
        node = self.item()
        while isinstance(node, tuple) and node[0] == "pairlist":
            _, tag, car, cdr, _ = node
            name = tag[1] if isinstance(tag, tuple) and tag[0] == "symbol" else tag
            attrs[name] = car
            node = cdr
        return _apply_attrs(value, attrs)


def _decode_altrep(info, state):
    # info is a pairlist whose car is the class symbol
    name = None
    if isinstance(info, tuple) and info[0] == "pairlist":
        car = info[2]
        if isinstance(car, tuple) and car[0] == "symbol":
            name = car[1]
    if name == "compact_intseq":
        n, start, step = state
        n = int(np.asarray(n).ravel()[0])
        start = int(np.asarray(start).ravel()[0]) if not isinstance(state[1], float) else int(state[1])
        vals = np.arange(n) * int(np.asarray(step).ravel()[0]) + start
        return vals.astype(np.int64)
    if name in ("wrap_real", "wrap_integer", "wrap_string", "wrap_logical"):
        return _first_payload(state)
    if name == "deferred_string":
        payload = np.asarray(_first_payload(state))
        if payload.dtype.kind == "f" and np.all(payload == np.round(payload)):
            payload = payload.astype(np.int64)
        return payload.astype(str).astype(object)
    raise NotImplementedError(f"ALTREP class {name!r} not supported")


def _first_payload(state):
    """Unwrap the first value from an ALTREP state (list or pairlist)."""
    if isinstance(state, tuple) and state[0] == "pairlist":
        return state[2]  # car
    if isinstance(state, list):
        return state[0]
    return state


class RFactor(np.ndarray):
    """String array carrying its original factor levels."""

    levels: list

    def __new__(cls, strings, levels):
        obj = np.asarray(strings, dtype=object).view(cls)
        obj.levels = levels
        return obj


def _apply_attrs(value, attrs):
    names = attrs.get("names")
    klass = attrs.get("class")
    klass = list(klass) if klass is not None else []
    if "factor" in klass:
        levels = list(attrs["levels"])
        idx = np.asarray(value, dtype=np.int64)
        out = np.array(
            [None if i == _NA_INT else levels[i - 1] for i in idx], dtype=object
        )
        return RFactor(out, levels)
    if "data.frame" in klass:
        cols = list(names)
        return {"__data.frame__": True, **dict(zip(cols, value))}
    if "dim" in attrs:
        dim = tuple(int(d) for d in np.asarray(attrs["dim"]).ravel())
        arr = np.asarray(value).reshape(dim, order="F")
        dimnames = attrs.get("dimnames")
        if dimnames is not None and isinstance(dimnames, list):
            colnames = dimnames[1] if len(dimnames) > 1 else None
            if colnames is not None:
                return {"__matrix__": arr, "colnames": list(colnames)}
        return arr
    if names is not None and isinstance(value, list):
        return dict(zip(list(names), value))
    return value


def read_rds(path: str):
    """Read an .RDS file into nested Python/NumPy structures."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        raw = f.read()
    if head == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    elif head[:1] == b"B":  # bzip2
        import bz2

        raw = bz2.decompress(raw)
    elif head == b"\xfd7":  # xz
        import lzma

        raw = lzma.decompress(raw)
    r = _Reader(raw)
    magic = r._read(2)
    if magic != b"X\n":
        raise ValueError(f"not an XDR RDS stream (magic {magic!r})")
    version = r.u32()
    r.u32()  # writer version
    r.u32()  # min reader version
    if version >= 3:
        enc_len = r.u32()
        r._read(enc_len)
    return r.item()


def dataframe_to_pandas(df_dict):
    """Convert a parsed data.frame dict to a pandas DataFrame."""
    import pandas as pd

    cols = {k: v for k, v in df_dict.items() if k != "__data.frame__"}
    return pd.DataFrame(
        {k: (np.asarray(v) if not isinstance(v, dict) else v) for k, v in cols.items()}
    )
