"""The port's per-chain draws (``nngp_tpu_torch/ops/draws.py``) on the CPU.

``nngp_tpu`` keys chain i of a cycle with ``fold_in(fold_in(key(seed),
iter_start), i)``, so its chains do not depend on how they are batched or
sharded (tests/test_parallel.py::test_sharded_cycle_matches_vmap).  The
port draws from Philox4x32-10 under per-chain counters.  Checked here:

- the twin's Philox4x32-10 gives the published Random123 known answers,
  and an independent numpy uint64 version on 1e4 random counters;
- a chain's rows are the same bits in any batch of chains;
- another cycle start or iteration changes every field;
- uniforms lie strictly inside (0, 1), normals are finite at the extreme
  words;
- moments, a KS test and correlations between chains, fields and
  iterations at 1e6 numbers;
- the packing refuses what would overflow it;
- ``IterationDraws.draw`` keeps its fields' shapes and dtypes;
- the kernel's packing (aligned bases, contiguous views, the cache) and
  the SASS count behind its FP64 floor, on a made-up listing.
"""

import math

import numpy as np
import pytest
import scipy.stats
import torch

from nngp_tpu_torch.models import gaussian as G
from nngp_tpu_torch.ops import draws
from nngp_tpu_torch.ops.draws import DrawKey, chain_draws, philox4x32_10

F = 0xFFFFFFFF
# Random123's known-answer vectors for Philox4x32-10 (kat_vectors)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((F, F, F, F), (F, F), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
# the main path's fields at a small width: K = 2 ASIS pairs, d = 2,
# p = 3, 1 location covariate, 10 sweeps over 37 sites, 10 noise steps
LAYOUT = {"anc_z": (2, 2), "anc_u": (2,), "suf_z": (2, 2), "suf_u": (2,),
          "adapt_z": (2,), "beta0_z": (), "beta_z": (4,), "locs_z": (2,),
          "sweep_z": (10, 37), "noise_z": (10,), "noise_u": (10,)}
SEED = 0x1234_5678_9ABC


@pytest.mark.parametrize("counter,key,want", KAT,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = philox4x32_10(torch.tensor(counter), torch.tensor(key))
    assert got.tolist() == list(want)
    assert philox4x32_10(torch.tensor(counter), key).tolist() == list(want)


def _philox_numpy(ctr, key):
    """Philox4x32-10 in numpy uint64: each 32 x 32 product whole."""
    M0, M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    m32, s32 = np.uint64(F), np.uint64(32)
    c = [ctr[:, j].astype(np.uint64) for j in range(4)]
    k0, k1 = key[:, 0].astype(np.uint64), key[:, 1].astype(np.uint64)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m32
            k1 = (k1 + np.uint64(0xBB67AE85)) & m32
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> s32) ^ c[1] ^ k0, p1 & m32, (p0 >> s32) ^ c[3] ^ k1,
             p0 & m32]
    return np.stack(c, axis=1)


def test_philox_matches_a_numpy_oracle():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, size=(10_000, 4), dtype=np.uint64)
    key = rng.integers(0, 2**32, size=(10_000, 2), dtype=np.uint64)
    got = philox4x32_10(torch.from_numpy(ctr.astype(np.int64)),
                        torch.from_numpy(key.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  _philox_numpy(ctr, key))


def _draw(chains, cycle_start=7, it=3, layout=LAYOUT, seed=SEED):
    return chain_draws(seed, cycle_start, torch.as_tensor(chains), it, layout)


@pytest.mark.parametrize("batch", [4, 96])
def test_a_chains_rows_do_not_depend_on_the_batch(batch):
    """Chains 2 and 3 drawn alone, in a batch of 4 and of 96: the same
    bits in every field (also as int32 ids)."""
    alone = _draw(torch.arange(2, 4))
    many = _draw(torch.arange(batch))
    ids32 = _draw(torch.arange(2, 4, dtype=torch.int32))
    for name in LAYOUT:
        assert alone[name].dtype == torch.float32
        assert alone[name].shape == (2,) + LAYOUT[name]
        assert torch.equal(alone[name], many[name][2:4]), name
        assert torch.equal(alone[name], ids32[name]), name


def test_a_field_does_not_depend_on_the_others():
    """A field's numbers do not depend on which fields are drawn with it,
    nor on how its elements are shaped."""
    full = _draw(torch.arange(3))
    alone = _draw(torch.arange(3), layout={"sweep_z": (370,)})
    assert torch.equal(alone["sweep_z"], full["sweep_z"].reshape(3, 370))


@pytest.mark.parametrize("change", ["cycle_start", "it", "seed", "chain"])
def test_the_key_changes_every_field(change):
    base = _draw(torch.arange(4))
    other = _draw(torch.arange(4) + (4 if change == "chain" else 0),
                  cycle_start=8 if change == "cycle_start" else 7,
                  it=4 if change == "it" else 3,
                  seed=SEED + (2**32 if change == "seed" else 0))
    for name in LAYOUT:
        same = (base[name] == other[name]).double().mean().item()
        assert same < 0.05, (name, same)


def test_uniforms_lie_inside_the_open_interval():
    words = torch.tensor([0, 1, 511, 512, F - 511, F], dtype=torch.int64)
    u = draws.uniform01(words)
    assert u.dtype == torch.float32
    assert (u > 0).all() and (u < 1).all()
    assert u[0].item() == 2.0**-24 and u[-1].item() == 1 - 2.0**-24
    z0, z1 = draws.normal(words, words.flip(0))
    assert torch.isfinite(z0).all() and torch.isfinite(z1).all()
    # the tail: u1 = 2^-33 gives r = sqrt(66 ln 2)
    assert abs(z0[0].item()) <= math.sqrt(66 * math.log(2)) + 1e-5
    got = _draw(torch.arange(8), layout={"anc_u": (5000,),
                                         "noise_u": (300,)})
    for u in got.values():
        assert (u > 0).all() and (u < 1).all()


def _big(it=0, chains=100, per=10_000):
    return _draw(torch.arange(chains), it=it,
                 layout={"sweep_z": (per,), "noise_u": (per,),
                         "noise_z": (per,)})


def test_normal_and_uniform_moments():
    """1e6 numbers of each kind: the normals' mean and variance within
    5e-3 and a KS test at p > 1e-3; the uniforms' KS test too."""
    got = _big()
    z = got["sweep_z"].double().flatten().numpy()
    assert abs(z.mean()) < 5e-3 and abs(z.var() - 1) < 5e-3
    assert scipy.stats.kstest(z, "norm").pvalue > 1e-3
    u = got["noise_u"].double().flatten().numpy()
    assert scipy.stats.kstest(u, "uniform").pvalue > 1e-3


def _corr(a, b):
    return float(np.corrcoef(a.double().flatten().numpy(),
                             b.double().flatten().numpy())[0, 1])


def test_chains_fields_and_iterations_are_uncorrelated():
    """|correlation| < 5e-3 at 1e6 pairs (its standard error 1e-3):
    neighbouring chains, two normal fields, normals and uniforms, and
    consecutive iterations."""
    got, nxt = _big(it=0, chains=101), _big(it=1, chains=101)
    z = got["sweep_z"]
    pairs = {"chains": (z[:-1], z[1:]),
             "fields": (z[:-1], got["noise_z"][:-1]),
             "kinds": (z[:-1], got["noise_u"][:-1]),
             "iterations": (z[:-1], nxt["sweep_z"][:-1]),
             "pair halves": (z[:-1, 0::2], z[:-1, 1::2])}
    for name, (a, b) in pairs.items():
        assert abs(_corr(a, b)) < 5e-3, name


@pytest.mark.parametrize("bad", [
    dict(seed=-1), dict(seed=2**64), dict(cycle_start=2**32),
    dict(it=2**20), dict(it=-1), dict(layout={"z": (3,)}),
    dict(layout={"sweep_z": (2**31,)})])
def test_the_packing_refuses_overflow(bad):
    kw = dict(seed=1, cycle_start=0, it=0, layout={"anc_u": (1,)})
    kw.update(bad)
    with pytest.raises(ValueError):
        chain_draws(kw["seed"], kw["cycle_start"], torch.arange(2), kw["it"],
                    kw["layout"])


def test_chain_ids_must_fit_the_counter():
    with pytest.raises(ValueError):
        _draw(torch.tensor([2**32]))
    with pytest.raises(ValueError):
        _draw(torch.tensor([-1]))
    with pytest.raises(TypeError):
        _draw(torch.arange(2.0))
    with pytest.raises(ValueError):
        DrawKey.of(1, 0, 0, 2**32 + 1, "cpu")


def test_iteration_draws_shapes_and_key_rows():
    """``IterationDraws.draw`` keeps its fields' shapes and dtype, and a
    selected key draws its chains' rows of the whole key's draws."""
    cfg = G.UpdateConfig(n_iterations=1, shape_names=("log_range",),
                         locs_cols=(0,), covparams_steps=2, n_chromatic=3)
    key = DrawKey.of(5, 40, 0, 4, "cpu")
    d = G.IterationDraws.draw(key, 2, cfg, n=11, p=3)
    shapes = {"anc_z": (2, 4, 2), "anc_u": (2, 4), "suf_z": (2, 4, 2),
              "suf_u": (2, 4), "adapt_z": (4, 2), "beta0_z": (4,),
              "beta_z": (4, 4), "locs_z": (4, 2), "sweep_z": (4, 3, 11),
              "noise_z": (4, 10), "noise_u": (4, 10)}
    for name, shape in shapes.items():
        t = getattr(d, name)
        assert tuple(t.shape) == shape and t.dtype == torch.float32, name
    part = G.IterationDraws.draw(key.select(1, 3), 2, cfg, n=11, p=3)
    for name in shapes:
        full, got = getattr(d, name), getattr(part, name)
        want = full[:, 1:3] if name in ("anc_z", "anc_u", "suf_z",
                                        "suf_u") else full[1:3]
        assert torch.equal(got, want), name
    d64 = G.IterationDraws.draw(key, 2, cfg, n=11, p=3, dtype=torch.float64)
    assert d64.sweep_z.dtype == torch.float64
    assert torch.equal(d64.sweep_z.float(), d.sweep_z)


def test_chain_words_are_the_fields_words():
    """``chain_words`` gives the words a field's numbers come from: the
    uniforms are their uniform01, the normals Box-Muller of their pairs."""
    ids = torch.arange(3, 6)
    w = draws.chain_words(SEED, 7, ids, 3, "anc_u", 9)
    assert w.shape == (3, 9) and w.dtype == torch.int64
    assert torch.equal(draws.uniform01(w),
                       _draw(ids, layout={"anc_u": (9,)})["anc_u"])
    ws = draws.chain_words(SEED, 7, ids, 3, "sweep_z", 8)
    z0, z1 = draws.normal(ws[:, 0::2], ws[:, 1::2])
    got = _draw(ids, layout={"sweep_z": (8,)})["sweep_z"]
    assert torch.equal(got[:, 0::2], z0) and torch.equal(got[:, 1::2], z1)


def test_run_cycle_refuses_another_chains_key():
    from nngp_tpu_torch.entry import _toy_problem

    mc = _toy_problem(n=96, n_chains=2, device="cpu")
    cfg = G.UpdateConfig(n_iterations=1, shape_names=("log_range",),
                         locs_cols=(), n_chromatic=1)
    with pytest.raises(ValueError, match="draw key"):
        G.run_cycle(mc.graph, mc.data, cfg, mc.states,
                    DrawKey.of(1, 0, 0, 3, "cpu"), 0)
    state, rec = G.run_cycle(mc.graph, mc.data, cfg, mc.states,
                             DrawKey.of(1, 0, 4, 6, "cpu"), 0)
    assert torch.isfinite(state.field).all()
    assert rec["log_scale"].shape == (1, 2)


# --- the kernel's packing (ops/draws.py:packing, views), checked on the CPU --

# the layouts the card tests draw: the main path's fields with the sweep
# normals at 20,001 sites (200,010 numbers a chain, not a multiple of 4),
# every field at 0, 1, 3, 5 and 7 numbers a chain, and the small LAYOUT
PACK_LAYOUTS = {
    "small": LAYOUT,
    "sweep-20001": G.IterationDraws.layout(
        G.UpdateConfig(n_iterations=1, shape_names=("log_range",),
                       locs_cols=tuple(range(14))), 20_001, 14),
    **{f"every-{k}": {name: (k,) for name in draws.FIELDS}
       for k in (0, 1, 3, 5, 7)},
}


@pytest.mark.parametrize("C", [1, 3, 97])
@pytest.mark.parametrize("name", PACK_LAYOUTS)
def test_packing_bases_are_aligned_and_fields_apart(name, C):
    """Every field's base is a multiple of 4 numbers; the fields lie in
    layout order, neither overlap nor leave the buffer; the launcher's
    arrays hold the same bases, counts, ids and kinds."""
    layout = PACK_LAYOUTS[name]
    pk = draws.packing(layout, C)
    F, base, count, fid, kind = pk.args
    assert F == len(layout) == len(pk.fields)
    end = 0
    for j, ((field, at, _, _), (lname, shape)) in enumerate(
            zip(pk.fields, layout.items())):
        n = math.prod(shape)
        assert field == lname
        assert at % 4 == 0 and at >= end
        end = at + C * n
        assert end <= pk.size
        assert (base[j], count[j]) == (at, n)
        assert (fid[j], kind[j]) == (
            draws.FIELDS[field][0], draws.KIND_CODES[draws.FIELDS[field][1]])
    assert end == pk.size


@pytest.mark.parametrize("C", [1, 3, 97])
@pytest.mark.parametrize("name", PACK_LAYOUTS)
def test_packing_views_are_contiguous_chain_major(name, C):
    """Each field is a contiguous [C, *shape] view of the one buffer from
    its base, and writing every view covers each field's numbers once."""
    layout = PACK_LAYOUTS[name]
    pk = draws.packing(layout, C)
    buf = torch.zeros(pk.size, dtype=torch.int32)
    got = draws.views(buf, pk)
    assert list(got) == list(layout)
    for (field, at, _, _), (_, shape) in zip(pk.fields, layout.items()):
        v = got[field]
        assert v.shape == (C,) + tuple(shape) and v.is_contiguous()
        assert v.storage_offset() == at
        assert v.untyped_storage().data_ptr() == buf.untyped_storage(
            ).data_ptr()
        v += 1
    assert int(buf.sum()) == C * sum(math.prod(s) for s in layout.values())
    assert bool((buf <= 1).all())


def test_packing_of_the_main_path_aligns_every_sweep_row():
    """At the main path's 64,274 sites every sweep_z row starts on 4
    numbers (16 bytes), so the kernel writes the rows as float4s."""
    layout = G.IterationDraws.layout(
        G.UpdateConfig(n_iterations=1, shape_names=("log_range",),
                       locs_cols=tuple(range(14))), 64_274, 14)
    for C in (3, 96):
        (at,) = [f[1] for f in draws.packing(layout, C).fields
                 if f[0] == "sweep_z"]
        count = math.prod(layout["sweep_z"])
        assert count % 4 == 0
        assert all((at + c * count) % 4 == 0 for c in range(C))


def test_packing_is_cached_per_layout_and_chain_count():
    a = draws.packing(LAYOUT, 3)
    assert draws.packing(dict(LAYOUT), 3) is a
    assert draws.packing({k: list(v) for k, v in LAYOUT.items()}, 3) is a
    b = draws.packing(LAYOUT, 4)
    assert b is not a and b.size > a.size
    w = draws.packing(LAYOUT, 3, words=True)
    assert w is not a and w.size == a.size
    assert list(w.args[4]) == [draws.KIND_CODES[draws.WORDS]] * len(LAYOUT)


@pytest.mark.parametrize("bad", [{"z": (3,)}, {"sweep_z": (2**31,)},
                                 {"anc_u": (1,), "sweep_z": (2**16, 2**15)}])
def test_packing_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        draws.packing(bad, 2)


def test_the_twin_draws_empty_fields_and_no_chains():
    """A field of 0 numbers a chain, and 0 chains, give empty fields of
    the right shapes (as the kernel's views are)."""
    empty = {name: (0,) for name in draws.FIELDS}
    got = _draw(torch.arange(3), layout=empty)
    assert all(v.shape == (3, 0) for v in got.values())
    none = _draw(torch.arange(0), layout=LAYOUT)
    assert all(none[k].shape == (0,) + LAYOUT[k] for k in LAYOUT)
    assert draws.chain_words(SEED, 7, torch.arange(2), 3, "anc_u",
                             0).shape == (2, 0)


# --- the SASS count behind the kernel's FP64 floor (experiments/draws_bench)

def _listing(calls, body):
    """A cuobjdump -sass listing of chain_draws_kernel<calls> whose
    instructions are ``body`` [(address, text)]."""
    lines = [f"\t\tFunction : _ZN4anon18chain_draws_kernelILi{calls}EEEvPf"]
    lines += [f"        /*{a:04x}*/                   {t} ;"
              f"        /* 0x0000000000000000 */" for a, t in body]
    return "\n" + "\n".join(lines) + "\n"


# a dispatch, another kind's tile, then one call of normals: a slow path
# reached by a CALL, a vector store and the scalar stores it jumps over,
# and the out-of-line slow path itself
ONE_CALL = [
    (0x00, "IMAD R0, R1, R2, RZ"), (0x10, "@P0 BRA 0x40"),
    (0x20, "STG.E.128 desc[UR6][R2.64], R4"), (0x30, "EXIT"),
    (0x40, "DMUL R0, R2, R4"), (0x50, "MUFU.RSQ64H R1, R3"),
    (0x60, "@!P0 BRA 0x90"), (0x70, "MOV R6, 0x80"),
    (0x80, "CALL.REL.NOINC 0x110"), (0x90, "DFMA R0, R2, R4, R6"),
    (0xa0, "MUFU.RSQ64H R1, R5"), (0xb0, "I2F.F64 R2, R3"),
    (0xc0, "@!P1 BRA P2, 0xf0"), (0xd0, "STG.E desc[UR6][R2.64], R4"),
    (0xe0, "EXIT"), (0xf0, "STG.E.128 desc[UR6][R2.64], R4"),
    (0x100, "EXIT"), (0x110, "DADD R0, R2, R4"),
    (0x120, "RET.REL.NODEC R6 0x0"),
]


def test_sass_count_follows_the_tile_of_normals():
    """The tile is the straight code of one call of normals (not the
    dispatch nor the other kind's store), less the slow path a CALL is
    reached by and the scalar stores the vector store jumps over."""
    from nngp_tpu_torch.experiments import draws_bench

    got = draws_bench.sass_counts(_listing(1, ONE_CALL), 1)
    assert got == {"f64": 2, "f64_conv": 1, "mufu64": 2, "total": 9,
                   "skipped": 4, "tile": 0x40}
    f64_ms, issue_ms = draws_bench.floors(10**6, got, 1000.0)
    assert f64_ms == pytest.approx(1e3 * 3e6 / (132 * 64 * 1e9))
    assert issue_ms == pytest.approx(1e3 * 9e6 / (132 * 128 * 1e9))


@pytest.mark.parametrize("calls", [1, 4])
def test_sass_count_refuses_a_listing_without_the_tile(calls):
    """No straight tile of 2 x calls MUFU.RSQ64H and calls vector stores
    (a loop, or another kernel): the count raises."""
    from nngp_tpu_torch.experiments import draws_bench

    looped = [(a, "@P3 BRA 0x40" if a == 0x100 else t) for a, t in ONE_CALL]
    with pytest.raises(RuntimeError):
        draws_bench.sass_counts(_listing(calls, looped if calls == 1
                                         else ONE_CALL), calls)
