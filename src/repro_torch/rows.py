"""Fixed row blocks: the batch invariance of the decode step.

Matrix products, reductions and vectorized elementwise functions pick
their algorithm from the shape: cuBLAS and the host BLAS give a row other
bits at M=1 than at M=4, and a reduction kernel splits its work by the
number of rows.  Run every row-local operation of a decode step at one
shape, and a row's bits do not depend on how many rows rode with it, so a
request decoded in a composed batch equals its solo decode.
"""
from __future__ import annotations

import torch

# rows per block: every row-local product and reduction of a decode step
# runs at this many rows
ROW_BLOCK = 8


def row_blocks(fn, *xs):
    """Apply the row-local ``fn`` to ``xs`` (tensors sharing a leading row
    axis) in zero-padded blocks of exactly ``ROW_BLOCK`` rows, and return
    its outputs (a tensor, or a tuple of tensors or ``None``) for the real
    rows, in storage of their own: an output kept as state (a Mamba ``h``)
    does not hold the padding rows alive."""
    n, r = xs[0].shape[0], ROW_BLOCK
    pad = (-n) % r
    if pad:
        xs = tuple(torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) for x in xs)
    outs = [fn(*(x[i:i + r] for x in xs)) for i in range(0, n + pad, r)]

    def real(parts):
        return torch.cat(list(parts[:-1]) + [parts[-1][:r - pad]])

    if isinstance(outs[0], tuple):
        return tuple(None if parts[0] is None else real(parts) for parts in zip(*outs))
    return real(outs)
