"""The port's examples (nngp_tpu_torch/examples/) against the JAX scripts of
examples/: each simulate draws bit for bit what its JAX counterpart draws
from the same seed, and each example's initialize arguments give the same
graph and starting states in both packages (at reduced n)."""

import ast
import importlib.util
import os

import numpy as np
import pytest
import torch
from scipy.special import gamma as sp_gamma, kv as sp_kv

import nngp_tpu
import nngp_tpu_torch
from nngp_tpu_torch.examples import (heavy_metals, heavy_metals_96,
                                     matern_fit, synthetic_families,
                                     vignette_toy)
from nngp_tpu_torch.utils.datasets import synthetic_heavy_metals
from test_torch_preprocess import assert_same_setup

torch.set_num_threads(1)

JAX_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _jax_example(name):
    """examples/<name>.py loaded from its file, unchanged."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(JAX_EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_matern_simulate():
    """examples/matern_fit.py's simulate, taken out with ast and run with
    numpy/scipy: importing that script would switch on jax's persistent
    compile cache in this process."""
    path = os.path.join(JAX_EXAMPLES, "matern_fit.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "simulate")
    ns = {"np": np, "sp_gamma": sp_gamma, "sp_kv": sp_kv}
    exec(compile(ast.Module([fn], type_ignores=[]), path, "exec"), ns)
    return ns["simulate"]


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype


@pytest.mark.parametrize("n_obs", [600, 2000])
def test_vignette_simulate_bit_equal(n_obs):
    ref = _jax_example("vignette_toy").simulate
    _same(vignette_toy.simulate(np.random.default_rng(1), n_obs),
          ref(np.random.default_rng(1), n_obs))


@pytest.mark.parametrize("family,ranges,label", synthetic_families.FAMILIES,
                         ids=[f[2] for f in synthetic_families.FAMILIES])
@pytest.mark.parametrize("n", [synthetic_families.QUICK["n"], 1600])
def test_families_simulate_bit_equal(family, ranges, label, n):
    ref = _jax_example("synthetic_families").simulate
    args = (family, n, ranges, 2.0, 0.5, 1.0)
    _same(synthetic_families.simulate(np.random.default_rng(7), *args),
          ref(np.random.default_rng(7), *args))


@pytest.mark.parametrize("n", [matern_fit.parse_args(["--quick"]).n, 2000])
def test_matern_simulate_bit_equal(n):
    args = (n, 0.8, 0.12, 2.0, 0.4, 1.0)
    _same(matern_fit.simulate(np.random.default_rng(11), *args),
          _jax_matern_simulate()(np.random.default_rng(11), *args))


def _heavy_metals_sites(k=1500):
    locs, y, X = synthetic_heavy_metals()
    return locs[:k], y[:k], {n: v[:k] for n, v in X.items()}


def _vignette(kind):
    locs, y, X, _, _ = vignette_toy.simulate(np.random.default_rng(1), 600)
    return locs, y, {kind: X}, vignette_toy.INIT


def _hm(chains):
    locs, y, X = _heavy_metals_sites()
    if chains == 3:
        return locs, y, {"X_locs": X}, heavy_metals.INIT
    return locs, y, {"X_locs": X}, {**heavy_metals_96.INIT,
                                     "n_chains": chains}


def _matern():
    locs, y = matern_fit.simulate(np.random.default_rng(11), 300, 0.8, 0.12,
                                  2.0, 0.4, 1.0)
    return locs, y, {}, {**matern_fit.INIT, "n_chains": 6}


def _family(label):
    covfun, ranges, _ = next(f for f in synthetic_families.FAMILIES
                             if f[2] == label)
    locs, y = synthetic_families.simulate(np.random.default_rng(7), covfun,
                                          300, ranges, 2.0, 0.5, 1.0)
    return locs, y, {}, {**synthetic_families.INIT,
                         "stationary_covfun": covfun, "seed": 7}


SETUPS = {
    "vignette_X_locs": lambda: _vignette("X_locs"),
    "vignette_X_obs": lambda: _vignette("X_obs"),
    "heavy_metals_3": lambda: _hm(3),
    "heavy_metals_96": lambda: _hm(96),
    "matern": _matern,
    "scaledim": lambda: _family("scaledim"),
    "spacetime": lambda: _family("spacetime"),
}


@pytest.mark.parametrize("case", list(SETUPS))
def test_example_initialize_bit_identical(case):
    locs, y, covariates, init = SETUPS[case]()
    ref = nngp_tpu.initialize(locs, y, **covariates, **init)
    mc = nngp_tpu_torch.initialize(locs, y, device="cpu", verbose=False,
                                   **covariates, **init)
    assert mc.n_chains == ref.n_chains == init["n_chains"]
    assert_same_setup(mc, ref)
