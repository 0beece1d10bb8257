"""Bytes of one call of the level solve (L x = v for every chain over the
Vecchia DAG): the factor rows linv [C, n, k] read, v [C, n] read and x
[C, n] written, float32, and the graph's step tables read once (each
site's index and its k - 1 parent columns, int32).  Each byte is counted
once, whatever a kernel reads again.

The bytes are not what bounds a call in practice: a level can start only
when the one before has written its x, so a call also costs at least one
round trip of a dependent load and a barrier for each of the DAG's levels
(about 1.1 us each on an H100 with one block a chain; 73 levels on a
64,274-site Heavy-metals-like graph).  The share this count gives is of
the bytes bound alone."""


def level_solve_bytes(C, n, k):
    return 4 * (C * n * (k + 2) + n * k)
