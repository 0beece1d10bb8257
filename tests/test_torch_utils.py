"""The port's RDS reader and dataset loader against nngp_tpu's."""

import gzip
import struct

import numpy as np

from nngp_tpu.utils import datasets as jax_datasets
from nngp_tpu.utils.rds import read_rds as jax_read_rds
from nngp_tpu_torch.utils import datasets
from nngp_tpu_torch.utils.rds import read_rds


def _u32(x):
    return struct.pack(">I", x)


def _i32(x):
    return struct.pack(">i", x)


def _charsxp(s):
    b = s.encode()
    return _u32(9) + _i32(len(b)) + b


def test_rds_roundtrip_synthetic_types_both_readers(tmp_path):
    """A hand-built XDR stream (tests/test_utils.py's, plus a string vector
    and a logical) read the same by both readers:
    list(a=1.5, b=2L, c=c("x","y"), d=TRUE)."""
    payload = b"X\n" + _u32(2) + _u32(0x30000) + _u32(0x20000)
    payload += _u32(19 | 0x200) + _i32(4)               # VECSXP, 4, attrs
    payload += _u32(14) + _i32(1) + struct.pack(">d", 1.5)
    payload += _u32(13) + _i32(1) + _i32(2)
    payload += _u32(16) + _i32(2) + _charsxp("x") + _charsxp("y")
    payload += _u32(10) + _i32(1) + _i32(1)             # LGLSXP [TRUE]
    payload += _u32(2 | 0x400) + _u32(1) + _charsxp("names")
    payload += _u32(16) + _i32(4) + b"".join(_charsxp(c) for c in "abcd")
    payload += _u32(254)
    path = tmp_path / "t.rds"
    path.write_bytes(gzip.compress(payload))
    got, want = read_rds(str(path)), jax_read_rds(str(path))
    assert list(got) == list(want) == ["a", "b", "c", "d"]
    assert got["a"][0] == 1.5 and got["b"][0] == 2
    for k in "abcd":
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_load_heavy_metals_falls_back_to_nngp_tpus_synthetic(tmp_path):
    missing = str(tmp_path / "absent.RDS")
    locs, y, X = datasets.load_heavy_metals(missing)
    jl, jy, jX = jax_datasets.load_heavy_metals(missing)
    assert locs.shape == (64274, 2) and len(X) == 14
    np.testing.assert_array_equal(locs, jl)
    np.testing.assert_array_equal(y, jy)
    for k in jX:
        np.testing.assert_array_equal(X[k], jX[k])
