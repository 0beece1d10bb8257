"""Per-chain random numbers of a Gibbs iteration: a counter-based generator
(Philox4x32-10), the CUDA kernel and its plain PyTorch twin.

``nngp_tpu`` keys chain i of a cycle with ``fold_in(fold_in(key(seed),
iter_start), i)`` (``nngp_tpu/api.py:599-601``, the analog of
``set.seed(iter_start + i)`` in mcmc_nngp_update_Gaussian.R:36), so a
chain's numbers never depend on how the chains are batched or sharded.
The port keeps that property with Philox4x32-10 (Salmon et al., SC'11,
"Parallel random numbers: as easy as 1, 2, 3"): every number is a pure
function of a 128-bit counter and a 64-bit key, so

- every field of an iteration, for every chain of a rank, comes from one
  launch (``csrc/chain_draws.cu``);
- the rows of chain c are the same bits whatever the other chains, the
  rank's first chain, the number of ranks or the device (the twin is
  integer arithmetic plus IEEE float64 ``log``/``cos``/``sin``/``sqrt``;
  the card's libm may differ from the CPU's by an ulp of a double, which
  moves about one float32 normal in 1e8-1e9 by one float32 ulp);
- the counters are arguments, so a CUDA graph can capture the launch.

The packing.  Number ``e`` (row-major within the chain's slice of the
field) of field ``f`` for chain ``c`` at iteration ``it`` of the cycle that
starts at iteration ``cycle_start`` is word ``e % 4`` of

    philox4x32_10(counter = (e // 4, cycle_start, c, f << 20 | it),
                  key     = (seed mod 2^32, seed >> 32))

with 0 <= seed < 2^64, cycle_start < 2^32, c < 2^32, it < 2^20, f < 2^12
and a chain's slice of a field under 2^31 elements; ``chain_draws`` refuses
anything else.  ``FIELDS`` gives each field of ``IterationDraws``
(``models/gaussian.py``) its id ``f``, so a field's numbers never depend on
which other fields are drawn.

The maps from 32-bit words:
- ``uniform01``: ((x >> 9) + 0.5) * 2^-23 in float32, exact, strictly
  inside (0, 1) (the MH steps take log(u)); 23 bits, because (2^24 - 0.5)
  / 2^24 would round to 1.0 in float32;
- ``normal``: Box-Muller in float64, u1 = (a + 0.5) 2^-32 and u2 = (b +
  0.5) 2^-32 from two words, sqrt(-2 log u1) times cos and sin of 2 pi u2,
  each rounded once to float32: one Philox call gives two normal pairs,
  from words (0, 1) and (2, 3).  The tail reaches sqrt(2 * 33 ln 2) = 6.8
  sigma (JAX's float32 ``erfinv`` route stops near 5.4).

``chain_draws`` launches the kernel on a CUDA ``chains`` tensor and runs
``chain_draws_reference`` on a CPU one; ``chain_draws.launches`` counts
kernel launches.  There is no fallback: on a card the kernel runs or the
call raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from nngp_tpu_torch.ops import _build

NORMAL, UNIFORM, WORDS = "normal", "uniform", "words"
KIND_CODES = {UNIFORM: 0, NORMAL: 1, WORDS: 2}   # csrc/chain_draws.cu's
# each field of models/gaussian.py:IterationDraws: (id f, kind)
FIELDS = {
    "anc_z": (0, NORMAL),
    "anc_u": (1, UNIFORM),
    "suf_z": (2, NORMAL),
    "suf_u": (3, UNIFORM),
    "adapt_z": (4, NORMAL),
    "beta0_z": (5, NORMAL),
    "beta_z": (6, NORMAL),
    "locs_z": (7, NORMAL),
    "sweep_z": (8, NORMAL),
    "noise_z": (9, NORMAL),
    "noise_u": (10, UNIFORM),
}

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)      # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)      # Weyl key bumps
TWO_PI = 2.0 * math.pi                   # rounded to a double, as the kernel's
IT_BITS = 20                             # the iteration's bits in counter word 3
MAX_ELEMENTS = 2**31                     # of one chain's slice of a field


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64 x
    holding 32-bit words: from m's 16-bit limbs, so that no int64 product
    exceeds 2^48."""
    p_lo = (m & 0xFFFF) * x
    t = (m >> 16) * x + (p_lo >> 16)                # m * x = t 2^16 + ...
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(counter: torch.Tensor, key) -> torch.Tensor:
    """Philox4x32-10 of int64 tensors holding uint32 words: ``counter``
    [..., 4] and ``key`` [..., 2] (or two ints), broadcast; returns the
    four output words [..., 4] as int64."""
    c0, c1, c2, c3 = counter.to(torch.int64).unbind(-1)
    if isinstance(key, torch.Tensor):
        k0, k1 = key.to(torch.int64).unbind(-1)
    else:
        k0, k1 = (int(k) & MASK32 for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def uniform01(x: torch.Tensor) -> torch.Tensor:
    """float32 ((x >> 9) + 0.5) 2^-23 of 32-bit words: exact, in (0, 1)."""
    return ((x >> 9).to(torch.float32) + 0.5) * 2.0**-23


def normal(a: torch.Tensor, b: torch.Tensor):
    """Box-Muller on two words each: (r cos(2 pi u2), r sin(2 pi u2)) with
    r = sqrt(-2 log u1), in float64, each rounded once to float32."""
    u1 = (a.to(torch.float64) + 0.5) * 2.0**-32
    u2 = (b.to(torch.float64) + 0.5) * 2.0**-32
    r = torch.sqrt(-2.0 * torch.log(u1))
    t = TWO_PI * u2
    return (r * torch.cos(t)).to(torch.float32), (r * torch.sin(t)).to(
        torch.float32)


def _words_to_values(words: torch.Tensor, kind: str) -> torch.Tensor:
    """[..., 4] words of Philox calls -> [..., 4] float32 numbers."""
    if kind == UNIFORM:
        return uniform01(words)
    z0, z1 = normal(words[..., 0], words[..., 1])
    z2, z3 = normal(words[..., 2], words[..., 3])
    return torch.stack([z0, z1, z2, z3], dim=-1)


def _check_key(seed: int, cycle_start: int, it: int):
    """Refuse what would overflow a word of the counter or the key."""
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed {seed} outside [0, 2^64)")
    if not 0 <= cycle_start < 2**32:
        raise ValueError(f"cycle start {cycle_start} outside [0, 2^32)")
    if not 0 <= it < 2**IT_BITS:
        raise ValueError(f"iteration {it} of the cycle outside "
                         f"[0, 2^{IT_BITS})")


def _check_layout(layout):
    """Refuse an unknown field, or one whose slice of a chain would
    overflow the counter's element block."""
    for name, shape in layout:
        if name not in FIELDS:
            raise ValueError(f"unknown draw field {name!r}; known: "
                             f"{sorted(FIELDS)}")
        if math.prod(shape) >= MAX_ELEMENTS:
            raise ValueError(f"field {name} holds {math.prod(shape)} "
                             f"numbers a chain, at most {MAX_ELEMENTS - 1}")


def _check_packing(seed: int, cycle_start: int, it: int, layout: dict):
    """Refuse what would overflow a field of the counter or the key."""
    _check_key(seed, cycle_start, it)
    _check_layout(layout.items())


def _check_chains(chains: torch.Tensor):
    if chains.dim() != 1 or chains.dtype not in (torch.int32, torch.int64):
        raise TypeError("chains must be a 1-D int32 or int64 tensor of "
                        "global chain ids")
    if chains.device.type == "cpu" and chains.numel() and not (
            0 <= int(chains.min()) and int(chains.max()) <= MASK32):
        raise ValueError("chain ids must lie in [0, 2^32)")


def _field_words(seed: int, cycle_start: int, chains, it: int, fid: int,
                 count: int) -> torch.Tensor:
    """The Philox words of field ``fid``'s first ``count`` numbers for
    ``chains``: int64 [C, ceil(count / 4), 4], on ``chains``' device."""
    blocks = torch.arange(-(-count // 4), dtype=torch.int64,
                          device=chains.device)[None]
    counter = torch.stack(torch.broadcast_tensors(
        blocks, torch.full_like(blocks, cycle_start),
        chains.to(torch.int64)[:, None],
        torch.full_like(blocks, fid << IT_BITS | it)), dim=-1)
    return philox4x32_10(counter, (seed & MASK32, seed >> 32))


def chain_draws_reference(seed: int, cycle_start: int, chains, it: int,
                          layout: dict) -> dict:
    """Plain PyTorch version on ``chains``' device: {field: float32 [C,
    *shape]} for the global chain ids ``chains`` [C] and ``layout``
    {field: per-chain shape}."""
    _check_packing(seed, cycle_start, it, layout)
    _check_chains(chains)
    out = {}
    for name, shape in layout.items():
        fid, kind = FIELDS[name]
        count = math.prod(shape)
        vals = _words_to_values(
            _field_words(seed, cycle_start, chains, it, fid, count), kind)
        out[name] = vals.flatten(1)[:, :count].reshape(
            (len(chains),) + tuple(shape))
    return out


@functools.cache
def _library():
    lib = _build.cuda_library("chain_draws")
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.chain_draws_launch.argtypes = [
        p, p, i, i, p, p, p, p, u64, ctypes.c_uint, ctypes.c_uint, p]
    lib.chain_draws_launch.restype = i
    lib.chain_draws_sincos_check.argtypes = [p, p]
    lib.chain_draws_sincos_check.restype = i
    lib.chain_draws_tile_calls.argtypes = [ctypes.c_longlong]
    lib.chain_draws_tile_calls.restype = i
    return lib


@dataclass(frozen=True)
class Packing:
    """Where ``chain_draws_cuda`` puts a layout's fields for C chains in
    its one float32 buffer of ``size`` numbers: each field a contiguous
    [C, *shape] block from ``base`` (a multiple of 4 numbers, so that a
    row of 4k numbers a chain starts 16-byte aligned and the kernel
    writes it in float4s).  ``args`` are the launcher's per-field
    arguments (n_fields, then ctypes arrays of the bases, counts, field
    ids and kinds)."""

    size: int
    fields: tuple          # (name, base, [C, *shape], its strides)
    args: tuple


@functools.lru_cache(maxsize=64)
def _pack(items: tuple, C: int, words: bool) -> Packing:
    _check_layout(items)
    fields, base, count = [], [], []
    at = 0
    for name, shape in items:
        at = -(-at // 4) * 4
        n = math.prod(shape)
        view = torch.empty((C,) + shape, device="meta")
        fields.append((name, at, view.shape, view.stride()))
        base.append(at)
        count.append(n)
        at += C * n
    F = len(items)
    ll, ci = ctypes.c_longlong * F, ctypes.c_int * F
    fids = [FIELDS[k][0] for k, _ in items]
    kinds = [KIND_CODES[WORDS if words else FIELDS[k][1]] for k, _ in items]
    return Packing(at, tuple(fields),
                   (F, ll(*base), ci(*count), ci(*fids), ci(*kinds)))


def packing(layout: dict, C: int, words: bool = False) -> Packing:
    """The cached ``Packing`` of ``layout`` ({field: per-chain shape}) for
    C chains; ``words`` packs every field as Philox words."""
    return _pack(tuple((k, tuple(v)) for k, v in layout.items()), C, words)


def views(buf: torch.Tensor, pk: Packing) -> dict:
    """{field: its [C, *shape] view of ``buf``} under ``pk``."""
    return {name: buf.as_strided(shape, stride, base)
            for name, base, shape, stride in pk.fields}


def chain_draws_cuda(seed: int, cycle_start: int, chains, it: int,
                     layout: dict, words: bool = False) -> dict:
    """The kernel: one launch writes every field for every chain into one
    buffer, each field a contiguous [C, *shape] view of it.  ``words``
    makes every field hold its Philox words' bits instead
    (``chain_words``)."""
    _check_key(seed, cycle_start, it)
    _check_chains(chains)
    ids = chains.to(torch.int64).contiguous()
    pk = packing(layout, ids.numel(), words)
    buf = torch.empty(pk.size, dtype=torch.float32, device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = _library().chain_draws_launch(
        buf.data_ptr(), ids.data_ptr(), ids.numel(), *pk.args, seed,
        cycle_start, it, stream)
    if err != 0:
        raise RuntimeError(f"chain_draws kernel launch failed: CUDA error "
                           f"{err}")
    chain_draws.launches += 1
    return views(buf, pk)


def sincos_differ(device) -> int:
    """How many of the 2^32 words b give an angle 2 pi (b + 0.5) 2^-32 (as
    the kernel computes it) whose ``sincos`` on the card differs in a bit
    from its ``cos`` and ``sin`` computed alone, as the twin computes them:
    the check behind the kernel's one ``sincos`` a normal pair (0, or the
    kernel's normals are not the twin's)."""
    out = torch.zeros(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = _library().chain_draws_sincos_check(out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sincos check launch failed: CUDA error {err}")
    return int(out.item())


def chain_draws(seed: int, cycle_start: int, chains, it: int,
                layout: dict) -> dict:
    """Every field of ``layout`` ({name in FIELDS: per-chain shape}) for
    the global chain ids ``chains`` at iteration ``it`` of the cycle that
    starts at ``cycle_start``: {name: float32 [C, *shape]} on ``chains``'
    device.  The kernel on a CUDA tensor, the plain version on a CPU one."""
    if chains.device.type == "cuda":
        return chain_draws_cuda(seed, cycle_start, chains, it, layout)
    if chains.device.type == "cpu":
        return chain_draws_reference(seed, cycle_start, chains, it, layout)
    raise ValueError(f"chain_draws: no implementation for {chains.device}")


chain_draws.launches = 0


def chain_words(seed: int, cycle_start: int, chains, it: int, name: str,
                count: int) -> torch.Tensor:
    """The first ``count`` Philox words of field ``name`` for ``chains``,
    int64 [C, count] (words 0-3 of block 0, then of block 1, ...): the
    kernel's own on a CUDA tensor (a launch that writes the words' bits,
    not counted in ``chain_draws.launches``), the twin's on a CPU one; for
    the tests that hold the kernel's integer rounds to the twin's."""
    layout = {name: (count,)}
    if chains.device.type == "cuda":
        before = chain_draws.launches
        bits = chain_draws_cuda(seed, cycle_start, chains, it, layout,
                                words=True)[name]
        chain_draws.launches = before
        return bits.view(torch.int32).to(torch.int64) & MASK32
    _check_packing(seed, cycle_start, it, layout)
    _check_chains(chains)
    words = _field_words(seed, cycle_start, chains, it, FIELDS[name][0],
                         count)
    return words.flatten(1)[:, :count]


@dataclass(frozen=True)
class DrawKey:
    """The random stream of a cycle for some chains: (seed, the cycle's
    first iteration, global chain ids [C] on the chains' device)."""

    seed: int
    cycle_start: int
    chains: torch.Tensor

    @classmethod
    def of(cls, seed: int, cycle_start: int, lo: int, hi: int,
           device) -> "DrawKey":
        """The key of chains [lo, hi)."""
        if not 0 <= lo <= hi <= MASK32 + 1:
            raise ValueError(f"chains [{lo}, {hi}) outside [0, 2^32)")
        _check_packing(int(seed), int(cycle_start), 0, {})
        return cls(int(seed), int(cycle_start),
                   torch.arange(lo, hi, dtype=torch.int64, device=device))

    def select(self, lo: int, hi: int) -> "DrawKey":
        """The key of this key's chains [lo, hi) (positions, not ids)."""
        return DrawKey(self.seed, self.cycle_start, self.chains[lo:hi])

    def draws(self, it: int, layout: dict) -> dict:
        """``chain_draws`` of iteration ``it`` of the cycle."""
        return chain_draws(self.seed, self.cycle_start, self.chains, it,
                           layout)
