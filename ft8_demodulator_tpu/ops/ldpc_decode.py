"""LDPC(174,91) sum-product belief propagation, batched.

The reference decoder (src/ft8_tools/ft8_demodulator/ldpc_decoder.py:54)
runs a Python triple loop per iteration with data-dependent early exit.
Here one iteration is a handful of wide vector ops on flat, SLOT-MAJOR
message arrays:

* messages live as (..., 522) variable->check and (..., 581) check->variable
  arrays laid out slot-major (slot j's block of all 174 variables / slot i's
  block of all 83 checks is contiguous), so per-slot views are static
  contiguous slices — no reshapes, no relayouts;
* routing between the two layouts is three constant 0/1 one-hot matrices
  applied as matmuls (exact routing: one unit entry per output column)
  in place of minor-axis index gathers — wide (B, 522/581) x
  (522/581, 581/522) products (their A/B against gathers on the GPU is
  open, ROADMAP §1.5);
* the leave-one-out product over each check's <=7 slots is an unrolled
  exclusive prefix/suffix product over 7 contiguous (..., 83) blocks —
  exact, no division;
* the syndrome is one (174, 83) matmul mod 2.

The whole kernel is natively batched over candidates, a jax.lax.scan runs a
static number of iterations, and the reference's early-exit semantics are
reproduced with a "halted" mask:

* hard-decision converging to the (forbidden) all-zero codeword freezes the
  state without improving min_errors (ldpc_decoder.py:76-78),
* reaching zero parity errors freezes the state with that codeword,
* otherwise min_errors tracks the best syndrome weight seen.

tanh/atanh use the same rational (Pade) approximations as the reference —
division+multiply only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol import constants as C

__all__ = ["fast_tanh", "fast_atanh", "ldpc_check", "bp_decode",
           "bp_decode_batch"]

_M, _N = C.LDPC_M, C.LDPC_N
_CD, _VD = C.CHECK_MAX_DEG, C.VAR_MAX_DEG
_NMI = _M * _CD     # 581 flat (slot, check) pairs, slot-major: mi = i*83 + m
_NNJ = _N * _VD     # 522 flat (slot, var) pairs, slot-major: nj = j*174 + n


def _build_routing():
    """Constant routing index vectors between the two slot-major layouts."""
    var_of_mi = np.zeros(_NMI, np.int32)   # variable read by check-slot mi
    nj_of_mi = np.zeros(_NMI, np.int32)    # (var, slot) excluded by mi
    mi_of_nj = np.full(_NNJ, 0, np.int32)  # check-slot feeding var-slot nj
    mask = np.zeros(_NMI, np.float32)
    for m in range(_M):
        for i in range(C.CHECK_DEG[m]):
            mi = i * _M + m
            n = C.CHECK_ADJ[m, i]
            j = C.CHECK_SLOT_IN_VAR[m, i]
            var_of_mi[mi] = n
            nj_of_mi[mi] = j * _N + n
            mi_of_nj[j * _N + n] = mi
            mask[mi] = 1.0
    return var_of_mi, nj_of_mi, mi_of_nj, mask


_VAR_OF_MI, _NJ_OF_MI, _MI_OF_NJ, _MI_MASK = _build_routing()
_MI_MASK_D = jnp.asarray(_MI_MASK)
_PARITY_T = jnp.asarray(C.PARITY_CHECK.astype(np.float32).T)  # (174, 83)


def _onehot_route(idx: np.ndarray, num_src: int) -> np.ndarray:
    """(num_src, len(idx)) 0/1 matrix with R[idx[j], j] = 1: x @ R == x[idx]."""
    return (np.arange(num_src)[:, None] == idx[None, :]).astype(np.float32)


_R_VAR_OF_MI = jnp.asarray(_onehot_route(_VAR_OF_MI, _N))    # (174, 581)
_R_MI_OF_NJ = jnp.asarray(_onehot_route(_MI_OF_NJ, _NMI))    # (581, 522)


def _build_leave_one_out() -> np.ndarray:
    """(522, 581) +-1 matrix M with tov @ M == (per-check var sums minus the
    excluded slot), so tnm = llrs @ R_VAR_OF_MI + tov @ M in ONE matmul."""
    s_sum = np.zeros((_NNJ, _N), np.float32)       # sums a var's 3 slots
    for j in range(_VD):
        s_sum[j * _N: (j + 1) * _N] = np.eye(_N, dtype=np.float32)
    return s_sum @ _onehot_route(_VAR_OF_MI, _N) \
        - _onehot_route(_NJ_OF_MI, _NNJ)


_M_LOO = jnp.asarray(_build_leave_one_out())                  # (522, 581)


# Routing-matmul precision.  The routing matrices are 0/+-1 (exact at any
# precision); the operand format only rounds the message VALUES.  DEFAULT
# (TF32 operands on the GPU, ~1e-3 relative; bf16 elsewhere, ~4e-3) is
# far inside BP's robustness margin (hardware decoders run 4-6 bit
# messages) and was decode-set-identical to HIGH/HIGHEST at the
# sensitivity cliff.  Override with FT8_BP_PRECISION=high|highest.
_BP_PRECISION = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}[__import__("os").environ.get("FT8_BP_PRECISION", "default").lower()]


def _route(x: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Gather-by-matmul: x (..., S) routed through r (S, D).

    Precision: see _BP_PRECISION note above.
    """
    return jnp.matmul(x, r, precision=_BP_PRECISION,
                      preferred_element_type=jnp.float32)


def fast_tanh(x: jnp.ndarray) -> jnp.ndarray:
    """Rational tanh approximation, input clipped to +-4.97 (ft8_lib form)."""
    x = jnp.clip(x, -4.97, 4.97)
    x2 = x * x
    a = x * (945.0 + x2 * (105.0 + x2))
    b = 945.0 + x2 * (420.0 + x2 * 15.0)
    return a / b


def fast_atanh(x: jnp.ndarray) -> jnp.ndarray:
    """Rational atanh approximation (ft8_lib form)."""
    x2 = x * x
    a = x * (945.0 + x2 * (-735.0 + x2 * 64.0))
    b = 945.0 + x2 * (-1050.0 + x2 * 225.0)
    return a / b


def ldpc_check(plain: jnp.ndarray) -> jnp.ndarray:
    """(..., 174) hard bits -> number of failed parity checks.

    DEFAULT precision is EXACT here, not an approximation: both operands
    are 0/1 (exact in TF32 and bf16) and partial sums accumulate in
    float32, so the dot products (integers <= check degree 7) carry no
    rounding at any precision (tests/test_gpu.py asserts it on the
    card) — and this matmul runs inside every BP iteration.
    """
    syndrome = jnp.mod(
        jnp.matmul(plain.astype(jnp.float32), _PARITY_T,
                   precision=jax.lax.Precision.DEFAULT), 2.0)
    return jnp.sum(syndrome, axis=-1).astype(jnp.int32)


def _bp_iteration(llr_routed, tov):
    """One sum-product iteration; tov is slot-major (..., 522).

    llr_routed = llrs @ R_VAR_OF_MI is loop-invariant (precomputed once);
    the leave-one-out message sum is a single +-1 routing matmul.
    """
    tnm = llr_routed + _route(tov, _M_LOO)                     # (.., 581)
    toc = jnp.where(_MI_MASK_D > 0, fast_tanh(-tnm / 2.0), 1.0)

    # leave-one-out products over the 7 slot blocks (exclusive prefix/suffix)
    blocks = [toc[..., i * _M: (i + 1) * _M] for i in range(_CD)]
    pre = [None] * _CD
    suf = [None] * _CD
    acc = jnp.ones_like(blocks[0])
    for i in range(_CD):
        pre[i] = acc
        acc = acc * blocks[i]
    acc = jnp.ones_like(blocks[0])
    for i in range(_CD - 1, -1, -1):
        suf[i] = acc
        acc = acc * blocks[i]
    excl = jnp.concatenate([pre[i] * suf[i] for i in range(_CD)], axis=-1)

    tmn = _route(excl, _R_MI_OF_NJ)                            # (..., 522)
    return -2.0 * fast_atanh(tmn)


def _tov_sum(llrs, tov):
    """llr + per-variable sum of the 3 slot blocks (slot-major layout)."""
    return (llrs + tov[..., 0 * _N: 1 * _N] + tov[..., 1 * _N: 2 * _N]
            + tov[..., 2 * _N: 3 * _N])


@functools.partial(jax.jit, static_argnames=("max_iterations",))
def bp_decode_batch(llrs: jnp.ndarray, max_iterations: int = 20):
    """(..., 174) LLRs -> (plain (..., 174) int32, min_errors (..., ) int32).

    Fixed-shape equivalent of the reference bp_decode (ldpc_decoder.py:54):
    the scan always runs max_iterations steps; a halted mask freezes each
    row's state once the reference would have broken out of its loop.
    """
    batch_shape = llrs.shape[:-1]
    # derive zero inits from the input so they inherit its sharding/varying
    # axes — plain constants break the loop carry-type check in shard_map
    zero = llrs[..., 0] * 0.0
    tov0 = jnp.zeros((*batch_shape, _NNJ), jnp.float32) + zero[..., None]
    plain0 = jnp.zeros((*batch_shape, _N), jnp.int32) \
        + zero[..., None].astype(jnp.int32)
    min0 = jnp.int32(_M) + zero.astype(jnp.int32)
    halted0 = zero != 0.0

    llr_routed = _route(llrs, _R_VAR_OF_MI)   # loop-invariant

    def cond(state):
        it, _, _, _, halted = state
        return (it < max_iterations) & ~jnp.all(halted)

    def step(state):
        it, tov, plain_out, min_err, halted = state
        tov_sum = _tov_sum(llrs, tov)
        plain = (tov_sum > 0).astype(jnp.int32)
        zero_cw = jnp.sum(plain, axis=-1) == 0
        errors = ldpc_check(plain)

        live = ~halted
        # reference order: the zero-codeword break happens before the error
        # check, so min_errors must not absorb the zero codeword's syndrome
        new_min = jnp.where(live & ~zero_cw, jnp.minimum(min_err, errors),
                            min_err)
        new_plain = jnp.where(live[..., None], plain, plain_out)
        new_halted = halted | (live & (zero_cw | (errors == 0)))

        tov_next = _bp_iteration(llr_routed, tov)
        tov = jnp.where(new_halted[..., None], tov, tov_next)
        return (it + 1, tov, new_plain, new_min, new_halted)

    # while_loop with an all-halted early exit: bit-identical to running
    # all max_iterations steps under the halted mask (frozen rows never
    # change), but a batch whose rows all converge/stall stops early —
    # the reference's per-candidate `break` (ldpc_decoder.py:76-86), lifted
    # to the batch level.
    state0 = (jnp.int32(0), tov0, plain0, min0, halted0)
    state = jax.lax.while_loop(cond, step, state0)
    _, _, plain, min_err, _ = state
    return plain, min_err


def bp_decode(llr: jnp.ndarray, max_iterations: int = 20):
    """Single-codeword convenience wrapper: (174,) -> ((174,), scalar)."""
    plain, err = bp_decode_batch(llr[None, :], max_iterations)
    return plain[0], err[0]
