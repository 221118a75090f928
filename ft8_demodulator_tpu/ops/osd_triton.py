"""OSD GF(2) elimination as one Pallas kernel compiled through Triton.

The plain form (ops/osd.py `_reduce_basis_packed`, vmapped) is an XLA
while-loop: every one of its ~91-174 strictly sequential pivot steps
is several small kernel launches plus a read of the loop predicate by
the host.  Here the whole loop runs inside one kernel.

Layout: each program owns one candidate on one warp (the fastest of the
candidates-per-program x warps shapes measured on the H100, PERF.md).
The packed basis of a candidate (91 rows x 6 uint32 words, ops/osd.py)
is padded to 128 rows x 8 words so every block dimension is a power of
two, and the whole (128, 8) state stays in registers for the loop.  A
program stops as soon as its candidate has placed all 91 pivots (the
early exit of `_reduce_basis_packed`, exact for the same reason) and
depends on no other program, so programs run in any order.

Results equal `_reduce_basis_packed` bit for bit (tests/test_osd.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..protocol import constants as C

__all__ = ["reduce_basis_triton"]

_N, _K = C.LDPC_N, C.LDPC_K
_ROWS = 128              # 91 basis rows, padded
_WORDS = 8               # 6 packed words (174 + 14 syndrome bits), padded


def _kernel(a_ref, red_ref, pcol_ref):
    state = a_ref[...]                                   # (128, 8)
    row = jax.lax.broadcasted_iota(jnp.int32, (_ROWS,), 0)
    word = jax.lax.broadcasted_iota(jnp.int32, (_ROWS, _WORDS), 1)
    # padding rows start "used": they never hold a pivot and count toward
    # the early exit
    used0 = (row >= _K).astype(jnp.int32)

    def cond(carry):
        _, used, _, j = carry
        return (j < _N) & (jnp.sum(used) < _ROWS)

    def body(carry):
        state, used, pcol, j = carry
        bit = (j & 31).astype(jnp.uint32)
        words = jnp.sum(jnp.where(word == (j >> 5), state, jnp.uint32(0)),
                        axis=1)                          # (128,)
        col = ((words >> bit) & jnp.uint32(1)).astype(jnp.int32)
        avail = col * (1 - used)
        # first available row; _ROWS when the column has no pivot
        idx = jnp.min(jnp.where(avail > 0, row, _ROWS))
        hot = row == idx                                 # (128,)
        pivot = jnp.sum(jnp.where(hot[:, None], state, jnp.uint32(0)),
                        axis=0)                          # (8,)
        # no pivot -> `pivot` is all zeros and the XOR changes nothing
        elim = (col > 0) & ~hot
        state = state ^ jnp.where(elim[:, None], pivot[None, :],
                                  jnp.uint32(0))
        used = jnp.where(hot, 1, used)
        pcol = jnp.where(hot, j, pcol)
        return state, used, pcol, j + 1

    state, _, pcol, _ = jax.lax.while_loop(
        cond, body, (state, used0, jnp.zeros_like(row), jnp.int32(0)))
    red_ref[...] = state
    pcol_ref[...] = pcol


@functools.partial(jax.jit, static_argnames=("interpret",))
def reduce_basis_triton(a_packed: jnp.ndarray, interpret: bool = False):
    """Batched GF(2) elimination: (B, 91, 6) uint32 -> (reduced, pcol).

    Same outputs as ``jax.vmap(_reduce_basis_packed)``: the row-reduced
    packed basis (B, 91, 6) and each row's pivot column (B, 91).
    `interpret` runs the kernel with the Pallas interpreter (tests on the
    CPU).
    """
    b, rows, words = a_packed.shape
    a = jnp.pad(a_packed.astype(jnp.uint32),
                ((0, 0), (0, _ROWS - rows), (0, _WORDS - words)))
    red, pcol = pl.pallas_call(
        _kernel,
        grid=(b,),
        in_specs=[pl.BlockSpec((None, _ROWS, _WORDS), lambda i: (i, 0, 0))],
        out_specs=(pl.BlockSpec((None, _ROWS, _WORDS), lambda i: (i, 0, 0)),
                   pl.BlockSpec((None, _ROWS), lambda i: (i, 0))),
        out_shape=(jax.ShapeDtypeStruct((b, _ROWS, _WORDS), jnp.uint32),
                   jax.ShapeDtypeStruct((b, _ROWS), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="osd_gf2_elimination",
    )(a)
    return red[:, :rows, :words], pcol[:, :rows]
