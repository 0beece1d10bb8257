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
- ``IterationDraws.draw`` keeps its fields' shapes and dtypes.
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
