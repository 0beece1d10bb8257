"""The gather microbenchmarks of the port (nngp_tpu_torch/experiments)
against the JAX scripts experiments/gather_bench.py, gather_probe.py and
gather_probe2.py, on the CPU.

The scripts are loaded from their files (experiments/ is not a package);
their bodies are local to ``main()``, so each is restated here verbatim and
run both as its jnp expression and through ``pl.pallas_call(...,
interpret=True)``.  The CUDA kernels against the plain twins are in
tests/test_torch_cuda.py.

Tolerances: the data bit for bit; gathers, roll, transpose and scatter
exactly (atol 0); the X1 sweeps within 1e-5 * max(1, |w|_inf) (float32
sums in another order through 600 dependent steps of a linear map whose
field grows to ~6e14); the matmul within 1e-5 * max(1, |C|_inf) (float32
sums of 1,024 products in another order: elementwise, a near-zero entry
differs by a large relative amount between any two summation orders).
"""

import copy
import functools
import importlib.util
import os
import pathlib
import types

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
import pytest
import torch

from nngp_tpu_torch.experiments import (data, gather_bench, gather_ops,
                                        gather_probe, gather_probe2)
from nngp_tpu_torch.ops import _build

torch.set_num_threads(1)

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"
REL_TOL = 1e-5


def _load(name):
    """experiments/<name>.py as a module.  On import the scripts create a
    cache folder and set jax's compilation cache directory: the folder is
    not created, and the setting is restored."""
    spec = importlib.util.spec_from_file_location(
        f"experiments_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    before = jax.config.jax_compilation_cache_dir
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "makedirs", lambda *a, **k: None)
        try:
            spec.loader.exec_module(mod)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return types.SimpleNamespace(bench=_load("gather_bench"),
                                 probe=_load("gather_probe"),
                                 probe2=_load("gather_probe2"))


def _main_draws(script, mod):
    """What the script's main() draws after its module-level arrays, in
    its order, from a copy of its generator."""
    rng = copy.deepcopy(mod.rng)
    if script == "probe":
        R, C, RI = mod.R, mod.C, mod.RI
        return {"x2": rng.normal(size=(RI, C)).astype(np.float32),
                "scat_val": rng.normal(size=(RI, C)).astype(np.float32),
                "scat_idx": rng.integers(0, R, size=(RI, C)).astype(np.int32),
                "mm_a": rng.normal(size=(R, RI)).astype(np.float32),
                "mm_b": rng.normal(size=(RI, C)).astype(np.float32)}
    if script == "probe2":
        R, C = mod.R, mod.C
        return {"src_big": rng.normal(size=(4096, C)).astype(np.float32),
                "idx_small": rng.integers(0, 4096, size=(512, C)).astype(np.int32),
                "srci": rng.integers(0, 99, size=(R, C)).astype(np.int32)}
    return {}


MODULE_ARRAYS = {
    "bench": (data.bench_arrays, ("w0", "sites", "nbrs", "q", "P", "noise")),
    "probe": (data.probe_arrays, ("src", "row_idx", "lane_idx")),
    "probe2": (data.probe2_arrays, ("src", "idx_eq", "lane_idx")),
}


@pytest.mark.parametrize("script", sorted(MODULE_ARRAYS))
def test_data_bit_identical(scripts, script):
    mod = getattr(scripts, script)
    make, names = MODULE_ARRAYS[script]
    port = make()
    want = {k: np.asarray(getattr(mod, k)) for k in names}
    want.update(_main_draws(script, mod))
    assert set(port) == set(want)
    for k, v in want.items():
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        assert np.array_equal(port[k], v), k


def test_x1_plain_matches_xla_sweeps(scripts):
    want = np.asarray(scripts.bench.xla_sweeps(scripts.bench.w0,
                                                scripts.bench.noise))
    t = gather_bench.inputs("cpu")
    before = gather_ops.gather_sweeps.launches
    got = gather_ops.gather_sweeps(t["w0"].clone(),
                                   *gather_bench.sweep_args(t)).numpy()
    assert gather_ops.gather_sweeps.launches == before
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * max(1.0, np.abs(want).max()))


# --- X2 / X3: each body of main(), restated verbatim from the script ------

def k_sub(src_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(src_ref[:], idx_ref[:], axis=0)


def k_lane(src_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(src_ref[:], idx_ref[:], axis=1)


def k_chain(src_ref, ridx_ref, lidx_ref, out_ref):
    a = jnp.take_along_axis(src_ref[:], ridx_ref[:], axis=0)
    out_ref[:] = jnp.take_along_axis(a, lidx_ref[:], axis=1)


def k_scat(val_ref, idx_ref, out_ref):
    out_ref[:] = jnp.zeros_like(out_ref)
    cur = out_ref[:]
    out_ref[:] = cur.at[idx_ref[:, 0], 0].set(val_ref[:, 0])


def k_mm(oh_ref, val_ref, out_ref):
    out_ref[:] = jnp.dot(oh_ref[:], val_ref[:],
                         preferred_element_type=jnp.float32)


def k_benes(src_ref, a_ref, b_ref, c_ref, out_ref):
    x = jnp.take_along_axis(src_ref[:], a_ref[:], axis=1)
    y = jnp.take_along_axis(x, b_ref[:], axis=0)
    out_ref[:] = jnp.take_along_axis(y, c_ref[:], axis=1)


def k_roll(src_ref, out_ref):
    out_ref[:] = pltpu.roll(src_ref[:], 3, 0)


def k_tr(src_ref, out_ref):
    out_ref[:] = src_ref[: data.C, :].T


HIGHEST = lax.Precision.HIGHEST
take = jnp.take_along_axis
# (script, index in the port's probes()): the Pallas body, its jnp
# expression, and the names of its arguments
BODIES = {
    ("probe", 0): (k_sub, lambda s, i: take(s, i, axis=0), ("src", "row_idx")),
    ("probe", 1): (k_lane, lambda s, i: take(s, i, axis=1), ("x2", "lane_idx")),
    ("probe", 2): (k_chain, lambda s, r, c: take(take(s, r, axis=0), c, axis=1),
                   ("src", "row_idx", "lane_idx")),
    ("probe", 3): (k_scat, lambda v, i: jnp.zeros((data.R, data.C), jnp.float32)
                   .at[i[:, 0], 0].set(v[:, 0]), ("scat_val", "scat_idx")),
    ("probe", 4): (k_mm, lambda a, b: jnp.dot(a, b, precision=HIGHEST),
                   ("mm_a", "mm_b")),
    ("probe2", 0): (k_sub, lambda s, i: take(s, i, axis=0), ("src", "idx_eq")),
    ("probe2", 1): (k_lane, lambda s, i: take(s, i, axis=1), ("src", "lane_idx")),
    ("probe2", 2): (k_benes, lambda s, a, b, c: take(take(take(
        s, a, axis=1), b, axis=0), c, axis=1),
        ("src", "lane_idx", "idx_eq", "lane_idx")),
    ("probe2", 3): (k_roll, lambda s: jnp.roll(s, 3, 0), ("src",)),
    ("probe2", 4): (k_tr, lambda s: s[: data.C].T, ("src",)),
    ("probe2", 5): (k_sub, lambda s, i: take(s, i, axis=0),
                    ("src_big", "idx_small")),
    ("probe2", 6): (k_lane, lambda s, i: take(s, i, axis=1), ("srci", "lane_idx")),
}
PROBE_IDS = [f"{s}-{i}" for s, i in BODIES]


def _jax_args(scripts, script, names):
    mod = getattr(scripts, script)
    extra = _main_draws(script, mod)
    return [jnp.asarray(extra[n]) if n in extra else getattr(mod, n)
            for n in names]


def _port(script, index):
    """The port's probe on CPU tensors of its own data, and its output."""
    mod, make = {"probe": (gather_probe, data.probe_arrays),
                 "probe2": (gather_probe2, data.probe2_arrays)}[script]
    p = mod.probes(data.to_device(make(), "cpu"))[index]
    before = p.op.launches
    out = p.op(*p.args)
    assert p.op.launches == before          # CPU tensors: the plain twin
    np.testing.assert_array_equal(out.numpy(), p.plain(*p.args).numpy())
    return p, out.numpy()


def _assert_close(p, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if p.op is gather_ops.matmul_f32:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=REL_TOL * max(1.0, np.abs(want).max()))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", list(BODIES), ids=PROBE_IDS)
def test_probe_plain_matches_jnp(scripts, key):
    _, expr, names = BODIES[key]
    p, got = _port(*key)
    _assert_close(p, got, np.asarray(expr(*_jax_args(scripts, key[0], names))))


@pytest.mark.parametrize("key", list(BODIES), ids=PROBE_IDS)
def test_probe_plain_matches_pallas_interpret(scripts, key):
    body, _, names = BODIES[key]
    p, got = _port(*key)
    args = _jax_args(scripts, key[0], names)
    f = pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(got.shape, got.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    _assert_close(p, got, np.asarray(f(*args)))


# --- the matmul kernel's numeric scheme (3xTF32), emulated in float32 ------

F32 = np.float32
TF32_EDGES = {
    "zero": [0.0, -0.0],
    "subnormal": [np.nextafter(F32(0), F32(1)), -np.nextafter(F32(0), F32(1)),
                  np.finfo(F32).tiny - np.nextafter(F32(0), F32(1)),
                  -(np.finfo(F32).tiny - np.nextafter(F32(0), F32(1)))],
    # the largest TF32 value, and the largest float32 that rounds to it
    "max finite": [np.uint32(0x7F7FE000).view(F32), np.uint32(0xFF7FE000).view(F32),
                   np.uint32(0x7F7FEFFF).view(F32), np.uint32(0xFF7FEFFF).view(F32)],
}


def _tf32_cases(kind):
    if kind == "random":
        rng = np.random.default_rng(7)
        x = rng.normal(size=4096) * np.exp2(rng.integers(-120, 120, size=4096))
        return x.astype(F32)
    return np.array(TF32_EDGES[kind], dtype=F32)


@pytest.mark.parametrize("kind", ["random", *TF32_EDGES])
def test_tf32_round_splits_exactly(kind):
    """hi = tf32(x) has its low 13 bits zero, lies within half a TF32 ulp
    of x, and x - hi is exact in float32: hi + (x - hi) == x."""
    x = torch.from_numpy(_tf32_cases(kind))
    hi = gather_ops.tf32_round(x)
    assert torch.isfinite(hi).all()
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    # TF32 keeps 11 significant bits; below 2**-126 its spacing is 2**-136
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                      torch.frexp(x.double())[1].clamp(min=-125) - 11)
    assert ((hi.double() - x.double()).abs() <= ulp / 2).all()
    assert torch.equal(hi + (x - hi), x)
    lo = gather_ops.tf32_round(x - hi)
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()


def test_tf32_round_ties_away_and_overflow():
    """Exact ties round away from zero, as cvt.rna does; a magnitude past
    the largest TF32 value rounds to infinity (no .satfinite)."""
    tie = np.array([1 + 2.0**-11, 3 + 2.0**-10, 2.0**-130 + 2.0**-137],
                   dtype=np.float64)
    x = torch.from_numpy(np.concatenate([tie, -tie]).astype(F32))
    hi = gather_ops.tf32_round(x)
    assert (hi.abs() > x.abs()).all()
    assert torch.equal(hi[:3], -hi[3:])
    big = torch.tensor([np.finfo(F32).max, -np.finfo(F32).max])
    assert torch.equal(gather_ops.tf32_round(big),
                       torch.tensor([float("inf"), float("-inf")]))


def _mm_inputs(scripts):
    a, b = _jax_args(scripts, "probe", ("mm_a", "mm_b"))
    return (a, b), (torch.tensor(np.asarray(a)), torch.tensor(np.asarray(b)))


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_3xtf32_emulation_matches_script(scripts, ref):
    """The kernel's splits and three products, in plain float32, against
    k_mm at X2's own data within 1e-5 * max(1, |C|_inf)."""
    (ja, jb), (a, b) = _mm_inputs(scripts)
    if ref == "jnp":
        want = np.asarray(jnp.dot(ja, jb, precision=HIGHEST))
    else:
        want = np.asarray(pl.pallas_call(
            k_mm, out_shape=jax.ShapeDtypeStruct((data.R, data.C), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(ja, jb))
    got = gather_ops.matmul_3xtf32_emulated(a, b).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * max(1.0, np.abs(want).max()))


def test_1xtf32_misses_the_tolerance(scripts):
    """Negative control: one TF32 product (hi x hi) is ~30x outside the
    tolerance that three pass, at the same shape and data."""
    (ja, jb), (a, b) = _mm_inputs(scripts)
    want = np.asarray(jnp.dot(ja, jb, precision=HIGHEST))
    one = (gather_ops.tf32_round(a) @ gather_ops.tf32_round(b)).numpy()
    tol = REL_TOL * max(1.0, np.abs(want).max())
    assert np.abs(one - want).max() > 10 * tol


SPLIT_SHAPES = [(512, 1024, 128), (2048, 512, 2048), (1, 4, 4), (65, 1028, 132),
                (130, 36, 260), (64, 8192, 128), (4096, 64, 4096), (256, 96, 128)]


@pytest.mark.parametrize("M,K,N", SPLIT_SHAPES)
def test_matmul_split_k(M, K, N):
    """The depth split: a power of two up to MM_MAX_SPLIT and up to the
    number of 32-deep tiles, the largest whose blocks fit on MM_SMS SMs;
    8 at the probe's shape, 1 at 2048 x 512 x 2048."""
    ks = gather_ops.matmul_split_k(M, N, K)
    tiles = -(-M // 64) * -(-N // 128)
    depth_tiles = -(-K // 32)
    assert ks in (1, 2, 4, 8) and ks <= gather_ops.MM_MAX_SPLIT
    assert ks == 1 or (tiles * ks <= gather_ops.MM_SMS and ks <= depth_tiles)
    bigger = 2 * ks
    assert (bigger > gather_ops.MM_MAX_SPLIT or bigger > depth_tiles
            or tiles * bigger > gather_ops.MM_SMS)
    expect = {(512, 1024, 128): 8, (2048, 512, 2048): 1, (1, 4, 4): 1}
    if (M, K, N) in expect:
        assert ks == expect[(M, K, N)]


# --- duplicate indices: the last occurrence wins, in both packages --------

def test_last_occurrence():
    x = torch.tensor([[1, 1, 2, 2, 1, 0, 0, 3], [5, 5, 5, 5, 4, 4, 4, 4]])
    want = [[0, 0, 0, 1, 1, 0, 1, 1], [0, 0, 0, 1, 0, 0, 0, 1]]
    assert gather_ops.last_occurrence(x).tolist() == np.array(want, bool).tolist()


def test_duplicates_scatter():
    idx = np.zeros((8, 4), np.int32)
    idx[:, 0] = [1, 1, 2, 2, 1, 0, 0, 3]
    val = np.tile(np.arange(8, dtype=np.float32)[:, None], (1, 4))
    got = gather_ops.column_scatter(torch.from_numpy(val),
                                    torch.from_numpy(idx), 4).numpy()
    want = np.zeros((4, 4), np.float32)
    want[:, 0] = [6, 4, 3, 7]
    np.testing.assert_array_equal(got, want)
    interp = pl.pallas_call(
        k_scat, out_shape=jax.ShapeDtypeStruct((4, 4), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    np.testing.assert_array_equal(np.asarray(interp(val, idx)), want)


# --- column_scatter's partition: the kernel's algorithm on the CPU --------

SCATTER_N_IN = (0, 1, 7, 1024, 4097)
SCATTER_N_ROWS = (1, 31, 512, 513)
SCATTER_COLS = (1, 3, 4, 128, 131)
SCATTER_CASES = (
    [(n, r, c, "random") for n in SCATTER_N_IN for r in SCATTER_N_ROWS
     for c in SCATTER_COLS]
    + [(n, r, SCATTER_COLS[k % 5], "one row") for k, (n, r) in enumerate(
        (n, r) for n in SCATTER_N_IN[1:] for r in SCATTER_N_ROWS)]
    + [(n, r, SCATTER_COLS[k % 5], "distinct") for k, (n, r) in enumerate(
        [(n, r) for n in SCATTER_N_IN[1:] for r in SCATTER_N_ROWS if n <= r]
        + [(512, 512), (512, 513)])])


def scatter_case(n_in, n_rows, cols, pattern, seed=0):
    """(val, idx) as numpy: idx's column 0 random, one row for every index,
    or all distinct; its other columns random (the kernel ignores them)."""
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(n_in, cols)).astype(np.float32)
    idx = rng.integers(0, n_rows, size=(n_in, cols)).astype(np.int32)
    if pattern == "one row":
        idx[:, 0] = rng.integers(0, n_rows)
    elif pattern == "distinct":
        idx[:, 0] = rng.permutation(n_rows)[:n_in]
    return val, idx


@pytest.mark.parametrize("n_in,n_rows,cols,pattern", SCATTER_CASES,
                         ids=["-".join(map(str, c)).replace(" ", "")
                              for c in SCATTER_CASES])
def test_column_scatter_partition(n_in, n_rows, cols, pattern):
    """The kernel's algorithm (its row tiles, index batches and 64-bit key
    max, ``column_scatter_emulated``), the plain twin and the script's
    k_scat through pl.pallas_call(interpret=True) agree bit for bit.  With
    no index, Pallas takes no empty operand: k_scat's expression in XLA."""
    val, idx = scatter_case(n_in, n_rows, cols, pattern)
    tv, ti = torch.from_numpy(val), torch.from_numpy(idx)
    emulated = gather_ops.column_scatter_emulated(tv, ti, n_rows).numpy()
    plain = gather_ops.column_scatter_reference(tv, ti, n_rows).numpy()
    if n_in:
        script = pl.pallas_call(
            k_scat, out_shape=jax.ShapeDtypeStruct((n_rows, cols), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(
                val, idx)
    else:
        script = jnp.zeros((n_rows, cols), jnp.float32).at[
            idx[:, 0], 0].set(val[:, 0])
    script = np.asarray(script)
    assert emulated.shape == plain.shape == script.shape == (n_rows, cols)
    np.testing.assert_array_equal(emulated.view(np.int32), plain.view(np.int32))
    np.testing.assert_array_equal(script.view(np.int32), plain.view(np.int32))


@pytest.mark.parametrize("n_rows", [1, 8, 512, 1056, 1057, 10**5, 811008,
                                    811009, 2**24])
def test_scatter_rows_per_block(n_rows):
    """At least SCATTER_ROWS[0] and at most SCATTER_ROWS[1] rows a block,
    the fewest for which the blocks fit one wave of SCATTER_WAVE; 8 rows
    and 64 blocks at the probe's 512."""
    lo, hi = gather_ops.SCATTER_ROWS
    R = gather_ops.scatter_rows_per_block(n_rows)
    blocks = -(-n_rows // R)
    assert lo <= R <= hi
    assert blocks <= gather_ops.SCATTER_WAVE or R == hi
    assert R == lo or -(-n_rows // (R - 1)) > gather_ops.SCATTER_WAVE
    if n_rows == data.R:
        assert (R, blocks) == (8, 64)


def _duplicate_case():
    """A small X1 case whose block steps repeat most sites: (w0, sites,
    nbrs, q, P, noise) as numpy arrays."""
    rng = np.random.default_rng(3)
    n, NB, B, W, S = 40, 3, 16, 16, 2
    w0 = rng.normal(size=n).astype(np.float32)
    sites = rng.integers(0, 6, size=(NB, B)).astype(np.int32)
    nbrs = rng.integers(0, n, size=(NB, B, W)).astype(np.int32)
    q = (0.1 * rng.normal(size=(NB, B, W))).astype(np.float32)
    P = rng.uniform(1.0, 2.0, size=(NB, B)).astype(np.float32)
    noise = rng.normal(size=(S, NB, B)).astype(np.float32)
    return w0, sites, nbrs, q, P, noise


def test_duplicates_sweeps():
    """A small X1 case whose block steps repeat most sites, against the
    script's xla_sweeps loop restated over explicit arrays."""
    w0, sites, nbrs, q, P, noise = _duplicate_case()
    NB, S = sites.shape[0], noise.shape[0]
    j_sites, j_nbrs, j_q, j_P = map(jnp.asarray, (sites, nbrs, q, P))

    @jax.jit
    def xla_sweeps(w, noise):
        def one_sweep(s, w):
            def block(b, w):
                g = w[j_nbrs[b]]
                mean = jnp.sum(j_q[b] * g, axis=1) / j_P[b]
                return w.at[j_sites[b]].set(mean + noise[s, b] * lax.rsqrt(j_P[b]))
            return lax.fori_loop(0, NB, block, w)
        return lax.fori_loop(0, S, one_sweep, w)

    want = np.asarray(xla_sweeps(jnp.asarray(w0), jnp.asarray(noise)))
    t = {k: torch.from_numpy(v) for k, v in
         dict(sites=sites, nbrs=nbrs, q=q, P=P, noise=noise).items()}
    got = gather_ops.gather_sweeps(
        torch.from_numpy(w0.copy()), t["sites"], t["nbrs"], t["q"], t["P"],
        t["noise"], gather_ops.last_occurrence(t["sites"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * max(1.0, np.abs(want).max()))
    # the first occurrence winning would give another field
    first = gather_ops.last_occurrence(t["sites"].flip(-1)).flip(-1)
    other = gather_ops.gather_sweeps(
        torch.from_numpy(w0.copy()), t["sites"], t["nbrs"], t["q"], t["P"],
        t["noise"], first).numpy()
    assert np.abs(other - want).max() > 1e-3


# --- X1's plan: routing of the owner-computes kernel, and its sums ---------

def _x1_case(case):
    """(w0, sites, nbrs, q, P, noise, keep) as tensors: the script's arrays
    or the duplicate-heavy case."""
    if case == "script":
        t = gather_bench.inputs("cpu")
        return (t["w0"], *gather_bench.sweep_args(t)[:5], t["keep"])
    arrays = [torch.from_numpy(a) for a in _duplicate_case()]
    return (*arrays, gather_ops.last_occurrence(arrays[1]))


def _plan_pairs(plan):
    """Every push decoded through the owners' slot tables: (b, i, j,
    source rank, neighbour slot, q bits, destination rank) as int64
    tensors; padding dropped."""
    cs, W = plan.cluster, gather_ops._W
    valid = plan.owned[..., 0] >= 0
    orow, ok = valid.nonzero(as_tuple=True)
    slot = plan.where[orow, ok].long()                         # [K, W]
    inverse = torch.full((len(plan.owned), plan.slots), -1, dtype=torch.long)
    inverse[orow[:, None], slot] = ok[:, None] * W + torch.arange(W)
    row, col = (plan.pushes[..., 2] >= 0).nonzero(as_tuple=True)
    e = plan.pushes[row, col].long()
    b, src, dst = row // cs, row % cs, e[:, 2]
    kj = inverse[b * cs + dst, e[:, 3]]
    assert bool((kj >= 0).all())
    i = plan.owned[b * cs + dst, kj // W, 1].long()
    return b, i, kj % W, src, e[:, 0], e[:, 1], dst


@pytest.mark.parametrize("case", ["script", "duplicates"])
@pytest.mark.parametrize("cluster", gather_ops.CLUSTERS)
def test_x1_plan_routes_every_kept_pair_once(cluster, case):
    """Every kept (i, j) pair is pushed exactly once, from the rank that
    owns nbrs[b, i, j] to the rank that owns sites[b, i]; no pair of a site
    that is not kept; the owned rows are the kept sites of each rank in
    order of i, padding last; the shared memory the plan asks for fits."""
    w0, sites, nbrs, q, P, noise, keep = _x1_case(case)
    NB, B = sites.shape
    W, cs = gather_ops._W, cluster
    plan = gather_ops.gather_sweeps_plan(sites, nbrs, q, keep, cs)
    b, i, j, src, slot, qbits, dst = _plan_pairs(plan)
    assert bool(keep[b, i].all())
    key = (b * B + i) * W + j
    assert len(key) == int(keep.sum()) * W == len(torch.unique(key))
    assert torch.equal(slot * cs + src, nbrs[b, i, j].long())
    assert torch.equal(qbits.int(), q[b, i, j].view(torch.int32))
    assert torch.equal(dst, sites[b, i].long() % cs)
    valid = plan.owned[..., 0] >= 0
    assert bool((valid[:, 1:] <= valid[:, :-1]).all())   # padding last
    row, _ = valid.nonzero(as_tuple=True)
    own = plan.owned[valid].long()
    assert torch.equal(own[:, 0] * cs + row % cs,
                       sites[row // cs, own[:, 1]].long())
    kb, ki = keep.nonzero(as_tuple=True)
    want = torch.sort((kb * cs + sites[kb, ki].long() % cs) * B + ki).values
    assert torch.equal(row * B + own[:, 1], want)
    assert plan.slots == int(valid.sum(1).max()) * W
    # each owner's slots: a permutation of its first count * W floats, and
    # the products one rank sends it in a step side by side
    used = plan.where[valid].long()
    assert torch.equal(torch.sort(used.flatten() + row.repeat_interleave(W)
                                  * plan.slots).values,
                       torch.cat([torch.arange(int(c) * W) + r * plan.slots
                                  for r, c in enumerate(valid.sum(1))]))
    prow, _ = (plan.pushes[..., 2] >= 0).nonzero(as_tuple=True)
    e = plan.pushes[plan.pushes[..., 2] >= 0].long()
    run = prow * cs + e[:, 2]
    assert torch.equal(run, torch.sort(run, stable=True).values)
    same = run[1:] == run[:-1]
    assert bool((e[1:, 3][same] == e[:-1, 3][same] + 1).all())
    assert gather_ops.gather_sweeps_smem_floats(w0.shape[0], plan) \
        <= gather_ops._SMEM_FLOATS


def _emulate_plan(w, P, noise, plan):
    """The kernel's steps in plain torch: each rank's products pushed into
    its owners' partial slots, each owned site's W slots summed in
    neighbour order (a test helper, not a plain version of X1)."""
    cs, W = plan.cluster, gather_ops._W
    S, NB, _ = noise.shape
    pushes, owned, where = (plan.pushes.long(), plan.owned.long(),
                            plan.where.long())
    for s in range(S):
        for b in range(NB):
            bufs = torch.zeros(cs, max(plan.slots, 1))
            for r in range(cs):
                e = pushes[b * cs + r]
                e = e[e[:, 2] >= 0]
                bufs[e[:, 2], e[:, 3]] = (w[e[:, 0] * cs + r]
                                          * e[:, 1].int().view(torch.float32))
            for r in range(cs):
                o = owned[b * cs + r]
                valid = o[:, 0] >= 0
                o = o[valid]
                parts = bufs[r, where[b * cs + r][valid]]   # [k, W]
                acc = torch.zeros(len(o))
                for j in range(W):
                    acc = acc + parts[:, j]
                p = P[b, o[:, 1]]
                w[o[:, 0] * cs + r] = (acc / p
                                       + noise[s, b, o[:, 1]] * torch.rsqrt(p))
    return w


def _neighbour_order(w, sites, nbrs, q, P, noise, keep):
    """The sweeps with each site's products summed in neighbour order."""
    S, NB, _ = noise.shape
    for s in range(S):
        for b in range(NB):
            k = keep[b].nonzero().squeeze(1)
            acc = torch.zeros(len(k))
            for j in range(nbrs.shape[-1]):
                acc = acc + q[b, k, j] * w[nbrs[b, k, j].long()]
            p = P[b, k]
            w[sites[b, k].long()] = acc / p + noise[s, b, k] * torch.rsqrt(p)
    return w


@functools.cache
def _x1_sums(case):
    w0, sites, nbrs, q, P, noise, keep = _x1_case(case)
    args = (sites, nbrs, q, P, noise, keep)
    return (_neighbour_order(w0.clone(), *args),
            gather_ops.gather_sweeps_reference(w0.clone(), *args))


@pytest.mark.parametrize("case", ["script", "duplicates"])
@pytest.mark.parametrize("cluster", gather_ops.CLUSTERS)
def test_x1_plan_sums_in_neighbour_order(cluster, case):
    """Walking the plan gives the neighbour-order sums bit for bit, and
    gather_sweeps_reference within 1e-5 * max(1, |w|_inf)."""
    w0, sites, nbrs, q, P, noise, keep = _x1_case(case)
    plan = gather_ops.gather_sweeps_plan(sites, nbrs, q, keep, cluster)
    got = _emulate_plan(w0.clone(), P, noise, plan)
    ordered, want = _x1_sums(case)
    assert torch.equal(got, ordered)
    tol = REL_TOL * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


def _stale(case, args, plan):
    """The call's arguments and plan after ``case`` (one way of passing a
    plan that does not belong to the call)."""
    sites, nbrs, q, P, noise, keep = args
    if case == "other-tensor":
        return (sites.clone(), nbrs, q, P, noise, keep), plan
    if case == "changed-since":
        q = q.clone()
        plan = gather_ops.gather_sweeps_plan(sites, nbrs, q, keep, plan.cluster)
        q[0, 0, 0] += 1.0
        return (sites, nbrs, q, P, noise, keep), plan
    if case == "other-cluster":
        return args, gather_ops.gather_sweeps_plan(sites, nbrs, q, keep, 2)
    return args, plan._replace(source=())                   # hand-made


@pytest.mark.parametrize("case", ["other-tensor", "changed-since",
                                  "other-cluster", "hand-made"])
def test_x1_plan_must_belong_to_the_call(case):
    """The kernel reads only the plan, the plain version only the tensors:
    the wrapper raises on a plan not built from the call's very tensors,
    or built before they changed, on the CPU as on a card; the plan of the
    call itself gives the plain version's field."""
    w0, *args = _x1_case("duplicates")
    plan = gather_ops.gather_sweeps_plan(args[0], args[1], args[2], args[5])
    got = gather_ops.gather_sweeps(w0.clone(), *args, plan=plan)
    assert torch.equal(got, gather_ops.gather_sweeps_reference(w0.clone(),
                                                               *args))
    bad_args, bad_plan = _stale(case, args, plan)
    with pytest.raises(ValueError):
        gather_ops.gather_sweeps(w0.clone(), *bad_args, plan=bad_plan)


@pytest.mark.parametrize("field,align", [("pushes", 16), ("where", 16),
                                         ("owned", 8)])
def test_x1_plan_alignment_checked(field, align):
    """The kernel loads pushes and where as 16-byte vectors and owned as
    8-byte ones: a plan table off that alignment raises before a launch."""
    w0, *args = _x1_case("duplicates")
    plan = gather_ops.gather_sweeps_plan(args[0], args[1], args[2], args[5])
    NB, cpu = args[0].shape[0], torch.device("cpu")
    gather_ops._check_plan(plan, w0.shape[0], NB, cpu)
    t = getattr(plan, field)
    for off in range(1, align // t.element_size()):
        moved = t.new_empty(t.numel() + off)[off:].view(t.shape).copy_(t)
        with pytest.raises(ValueError, match=f"{align}-byte aligned"):
            gather_ops._check_plan(plan._replace(**{field: moved}),
                                   w0.shape[0], NB, cpu)


# --- dispatch, validation and entry points --------------------------------

WRAPPERS = {
    "gather_sweeps": (gather_ops._sweep_library, 7),
    "staged_gather": (gather_ops._probe_library, 2),
    "column_scatter": (gather_ops._probe_library, 3),
    "matmul_f32": (gather_ops._probe_library, 2),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cuda_branch_raises_without_kernel(monkeypatch, name):
    """A CUDA tensor goes to the kernel or raises: with no nvcc the wrapper
    fails loudly and never runs its plain twin."""
    library, n_args = WRAPPERS[name]
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    _build.cuda_library.cache_clear()
    library.cache_clear()
    calls = []
    monkeypatch.setattr(gather_ops, f"{name}_reference",
                        lambda *a: calls.append(a))
    op = getattr(gather_ops, name)
    fake = types.SimpleNamespace(device=torch.device("cuda"))
    before = op.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        op(fake, *([None] * (n_args - 1)))
    assert not calls and op.launches == before
    library.cache_clear()


@pytest.mark.parametrize("stages", [
    [("rows", torch.zeros(4, 3, dtype=torch.int32))],
    [("cols", torch.zeros(5, 2, dtype=torch.int32))],
    [("spin", 1)],
    [("roll", 1)] * 5,
], ids=["rows-width", "cols-height", "unknown", "too-many"])
def test_staged_gather_rejects_malformed_chain(stages):
    with pytest.raises(ValueError):
        gather_ops.staged_gather(torch.zeros(4, 2), stages)


@pytest.mark.parametrize("entry", [gather_bench, gather_probe, gather_probe2],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_point_needs_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        entry.main()
