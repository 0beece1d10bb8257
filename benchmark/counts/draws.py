"""Bytes and float64 operations of one call of the draws kernel (every
random number of an iteration for every chain).

Bytes: the float32 numbers written, and the chain ids read.  Operations:
a fixed count a normal, from Box-Muller in float64 on a pair: two word
maps (4), -2 log u1 with its log (1 + 20), the square root (8), the angle
(1), its cosine and sine (20 each), two products (2): 76 a pair, 38 a
normal; a uniform takes none in float64.  A transcendental counts 20 and a
square root 8, as in ``factor_build``'s count.  It counts the work, not
the instructions of one implementation."""

F64_OPS_PER_NORMAL = 38


def draws_bytes_flops(C, normals_per_chain, uniforms_per_chain):
    nbytes = 4 * C * (normals_per_chain + uniforms_per_chain) + 8 * C
    return nbytes, F64_OPS_PER_NORMAL * C * normals_per_chain
