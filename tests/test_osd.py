"""Ordered-statistics decoder tests (beyond-reference sensitivity layer)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ft8_demodulator_tpu.ops.ldpc_decode import bp_decode_batch, ldpc_check
from ft8_demodulator_tpu.ops.osd import osd_decode_batch, osd_decode_masked
from ft8_demodulator_tpu.protocol import constants as C


def _codewords(rng, n):
    pay = rng.integers(0, 2, (n, 77)).astype(np.float32)
    return (pay @ C.ENCODE_MATRIX.T) % 2


def test_osd_decodes_clean_codewords():
    rng = np.random.default_rng(5)
    cw = _codewords(rng, 8)
    llr = jnp.asarray(((2 * cw - 1) * 4.0).astype(np.float32))
    plain, ok = osd_decode_batch(llr)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(plain), cw)
    assert np.all(np.asarray(ldpc_check(plain)) == 0)


def test_osd_beats_bp_at_the_cliff():
    rng = np.random.default_rng(6)
    cw = _codewords(rng, 60)
    sigma = 0.85
    noise = rng.standard_normal(cw.shape)
    llr = jnp.asarray(((2 * cw - 1) * 2.0 + 2.0 * sigma * noise)
                      .astype(np.float32))

    p_bp, e_bp = bp_decode_batch(llr, 20)
    bp_ok = (np.asarray(e_bp) == 0) \
        & (np.asarray(p_bp) == cw).all(axis=1)

    p_o, ok_o = osd_decode_batch(llr)
    right = np.asarray(ok_o) & (np.asarray(p_o) == cw).all(axis=1)
    wrong = np.asarray(ok_o) & ~(np.asarray(p_o) == cw).all(axis=1)

    assert wrong.sum() == 0, "OSD must never accept a wrong codeword here"
    assert (bp_ok | right).sum() > bp_ok.sum(), \
        "OSD should add decodes over BP at the cliff"


def test_osd_rejects_pure_noise():
    rng = np.random.default_rng(7)
    llr = jnp.asarray((3.0 * rng.standard_normal((400, 174)))
                      .astype(np.float32))
    _, ok = osd_decode_batch(llr)
    assert int(np.asarray(ok).sum()) == 0


def test_decode_with_osd_recovers_what_bp_alone_cannot(goldens):
    from ft8_demodulator_tpu.demod.decode import decode_ft8_message
    from ft8_demodulator_tpu.ops.gfsk import ft8_passband

    fs = 2000.0
    payload = goldens["p1_payload"].copy()
    payload[9] &= 0xF8
    wave = np.asarray(ft8_passband(payload, fs, 400.0, 0.0))
    sig = np.zeros(int(fs * 15), np.float64)
    sig[400: 400 + len(wave)] = wave
    # seed 5 at -14 dB: BP-only fails, OSD succeeds (deterministic fixture,
    # re-pinned after the TX alignment fix re-rolled the trial)
    local = np.random.default_rng(5)
    noise_scale = np.sqrt(np.mean(wave ** 2) / 10 ** (-14.0 / 10.0))
    sig += noise_scale * local.standard_normal(len(sig))
    sig32 = sig.astype(np.float32)

    base = {r.message.payload.hex()
            for r in decode_ft8_message(sig32, fs, min_score=1.0)}
    deep = {r.message.payload.hex()
            for r in decode_ft8_message(sig32, fs, min_score=1.0,
                                        use_osd=True)}
    want = payload.tobytes().hex()
    assert want not in base, "fixture should be beyond BP-only reach"
    assert want in deep


def _packed_bases(n, seed):
    """(n, 91, 6) column-permuted packed bases of random reliability
    orders (ops/osd.py _permute_pack)."""
    from ft8_demodulator_tpu.ops import osd as O

    rng = np.random.default_rng(seed)
    llr = jnp.asarray((rng.standard_normal((n, 174)) * 3).astype(np.float32))
    order = jnp.argsort(-jnp.abs(llr), axis=-1).astype(jnp.int32)
    ranks = jnp.argsort(order, axis=-1).astype(jnp.int32)
    return O._permute_pack(ranks), order


def test_pallas_elimination_matches_jnp_interpret():
    """The matmul permute+pack equals the gather + bit-pack reference, and
    the Triton elimination kernel (Pallas interpreter) equals the jnp
    while-loop."""
    import jax

    from ft8_demodulator_tpu.ops import osd as O
    from ft8_demodulator_tpu.ops.osd_triton import reduce_basis_triton

    a_packed, order = _packed_bases(9, 8)
    ref_bits = jnp.swapaxes(O._BASIS_BITS[:, order], 0, 1)
    aug = jnp.broadcast_to(jnp.asarray(O._ROW_SYNDROMES_NP)[None],
                           (9, 91, 14))
    ref_packed = O._pack(jnp.concatenate([ref_bits, aug], axis=-1))
    assert bool(jnp.all(a_packed == ref_packed))
    r1, p1 = jax.vmap(O._reduce_basis_packed)(a_packed)
    r2, p2 = reduce_basis_triton(a_packed, interpret=True)
    assert bool(jnp.all(r1 == r2)) and bool(jnp.all(p1 == p2))


@pytest.mark.parametrize("batch", [1, 37, 128, 300])
def test_triton_elimination_batches_interpret(batch):
    """One program per candidate at any batch size, the output cut back
    from the kernel's padded rows and words."""
    import jax

    from ft8_demodulator_tpu.ops import osd as O
    from ft8_demodulator_tpu.ops.osd_triton import reduce_basis_triton

    a_packed, _ = _packed_bases(batch, 100 + batch)
    r1, p1 = jax.vmap(O._reduce_basis_packed)(a_packed)
    r2, p2 = reduce_basis_triton(a_packed, interpret=True)
    assert r2.shape == (batch, 91, 6) and p2.shape == (batch, 91)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def test_triton_elimination_rank_deficient_interpret():
    """A rank-deficient basis never places 91 pivots: its program runs
    all 174 columns while full-rank neighbours exit early, and every
    candidate still equals the jnp elimination."""
    import jax

    from ft8_demodulator_tpu.ops import osd as O
    from ft8_demodulator_tpu.ops.osd_triton import reduce_basis_triton

    a_packed, _ = _packed_bases(6, 9)
    a_packed = a_packed.at[2, 10:14].set(a_packed[2, 3])   # rank 87
    r1, p1 = jax.vmap(O._reduce_basis_packed)(a_packed)
    r2, p2 = reduce_basis_triton(a_packed, interpret=True)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    # the duplicated rows reduce to zero and never hold a pivot
    assert not np.asarray(r2[2, 10:14]).any()


def test_elimination_early_exit_is_exact():
    """The rank-91 early exit must yield EXACTLY the full-174-step
    result (the claim in _reduce_basis_packed: once `used` is full,
    every later step has avail==0 and changes nothing)."""
    import jax

    from ft8_demodulator_tpu.ops import osd as O

    def reduce_full(a):
        """_reduce_basis_packed without the early exit: all 174 steps."""
        rows_idx = jnp.arange(O._K)

        def step(j, state):
            a, used, pcol = state
            word = j >> 5
            bit = (j & 31).astype(jnp.uint32)
            col = (jax.lax.dynamic_index_in_dim(
                a, word, axis=1, keepdims=False) >> bit) & jnp.uint32(1)
            avail = col * (1 - used)
            i = jnp.argmax(avail)
            found = avail[i] > 0
            row = a[i]
            elim = (col * jnp.where(found, 1, 0)).at[i].set(0)
            a = a ^ (elim[:, None].astype(jnp.uint32) * row[None, :])
            used = used.at[i].add(jnp.where(found, 1, 0))
            pcol = jnp.where((rows_idx == i) & found, j, pcol)
            return a, used, pcol

        used0 = a[:, 0] ^ a[:, 0]
        a, _, pcol = jax.lax.fori_loop(
            0, O._N, step, (a, used0, used0.astype(jnp.int32)))
        return a, pcol

    rng = np.random.default_rng(21)
    llr = jnp.asarray((rng.standard_normal((7, 174)) * 3)
                      .astype(np.float32))
    order = jnp.argsort(-jnp.abs(llr), axis=-1).astype(jnp.int32)
    ranks = jnp.argsort(order, axis=-1).astype(jnp.int32)
    a_packed = O._permute_pack(ranks)
    r_fast, p_fast = jax.vmap(O._reduce_basis_packed)(a_packed)
    r_full, p_full = jax.vmap(reduce_full)(a_packed)
    assert bool(jnp.all(r_fast == r_full))
    assert bool(jnp.all(p_fast == p_full))


def test_osd_order2_recovers_double_pivot_errors():
    """Construct LLRs where TWO low-reliability pivot bits are wrong: the
    order-1 search cannot fix both with one flip, partial order-2 can."""
    rng = np.random.default_rng(11)
    cw = _codewords(rng, 40)
    # reliability design: two WRONG bits at |llr|=2 rank just above a mass
    # of correct |llr|=1 bits, so they enter the pivot set near its bottom
    # — order-0/1 re-derivation keeps (or singly fixes) them and fails the
    # CRC; only an XOR-pair flip of both pivots recovers the codeword
    llr = (2 * cw - 1) * 4.0
    for r in range(cw.shape[0]):
        picks = rng.choice(174, size=87, replace=False)
        wrong, weak = picks[:2], picks[2:]
        llr[r, weak] *= 0.25          # correct, low reliability: non-pivots
        llr[r, wrong] *= -0.5         # wrong, bottom-of-pivot reliability
    llr = jnp.asarray(llr.astype(np.float32))
    p1, ok1 = osd_decode_batch(llr, order2=0)
    p2, ok2 = osd_decode_batch(llr, order2=16)
    right1 = np.asarray(ok1) & (np.asarray(p1) == cw).all(axis=1)
    right2 = np.asarray(ok2) & (np.asarray(p2) == cw).all(axis=1)
    wrong2 = np.asarray(ok2) & ~(np.asarray(p2) == cw).all(axis=1)
    assert wrong2.sum() == 0
    assert right2.sum() > right1.sum()          # order-2 adds real decodes
    assert right2.sum() >= 30


def test_osd_order2_rejects_pure_noise():
    """The deeper search must not raise the false-accept rate: 400 pure
    noise vectors through the order-2 path accept nothing."""
    rng = np.random.default_rng(12)
    llr = jnp.asarray((rng.standard_normal((400, 174)) * 4.0)
                      .astype(np.float32))
    _, ok = osd_decode_batch(llr, order2=16)
    assert np.asarray(ok).sum() == 0


def test_osd_order3_adds_decodes_and_stays_clean():
    """Partial order-3 (triples of the least-reliable pivots) decodes a
    superset of the order-2 search at the cliff, never accepts a wrong
    codeword there, and still rejects pure noise."""
    rng = np.random.default_rng(8)
    cw = _codewords(rng, 60)
    sigma = 0.95
    noise = rng.standard_normal(cw.shape)
    llr = jnp.asarray(((2 * cw - 1) * 2.0 + 2.0 * sigma * noise)
                      .astype(np.float32))

    p2, ok2 = osd_decode_batch(llr)
    p3, ok3 = osd_decode_batch(llr, order3=12)
    right2 = np.asarray(ok2) & (np.asarray(p2) == cw).all(axis=1)
    right3 = np.asarray(ok3) & (np.asarray(p3) == cw).all(axis=1)
    wrong3 = np.asarray(ok3) & ~(np.asarray(p3) == cw).all(axis=1)
    assert wrong3.sum() == 0
    assert right3.sum() >= right2.sum()
    # every order-3 acceptance is a valid codeword (flip assembly check)
    assert np.all(np.asarray(ldpc_check(p3))[np.asarray(ok3)] == 0)

    noise_llr = jnp.asarray((3.0 * rng.standard_normal((400, 174)))
                            .astype(np.float32))
    _, okn = osd_decode_batch(noise_llr, order3=12)
    assert int(np.asarray(okn).sum()) == 0


def test_osd_order3_below_three_is_a_noop():
    """order3 in {1, 2} has no triples — must behave exactly like 0."""
    rng = np.random.default_rng(9)
    llr = jnp.asarray((3.0 * rng.standard_normal((16, 174)))
                      .astype(np.float32))
    p0, ok0 = osd_decode_batch(llr)
    p2, ok2 = osd_decode_batch(llr, order3=2)
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(ok0), np.asarray(ok2))

    import pytest
    with pytest.raises(ValueError):
        osd_decode_batch(llr, order2=4, order3=8)


def test_osd_masked_matches_batch_on_needed_rows():
    """osd_decode_masked == osd_decode_batch on need rows; (0, False)
    elsewhere — across multi-chunk, single-chunk and all/none masks."""
    rng = np.random.default_rng(13)
    cw = _codewords(rng, 300)
    llr = jnp.asarray(((2 * cw - 1) * 2.0
                       + 1.8 * rng.standard_normal(cw.shape))
                      .astype(np.float32))
    p_all, ok_all = osd_decode_batch(llr)

    for seed in (0, 1):
        need = jnp.asarray(np.random.default_rng(seed)
                           .random(300) < (0.3 if seed == 0 else 1.0))
        p_m, ok_m = osd_decode_masked(llr, need, chunk=128)
        needn = np.asarray(need)
        np.testing.assert_array_equal(np.asarray(ok_m)[needn],
                                      np.asarray(ok_all)[needn])
        np.testing.assert_array_equal(np.asarray(p_m)[needn],
                                      np.asarray(p_all)[needn])
        assert not np.asarray(ok_m)[~needn].any()
        assert (np.asarray(p_m)[~needn] == 0).all()

    # nothing needed: no chunk runs, everything comes back empty
    p_z, ok_z = osd_decode_masked(llr, jnp.zeros(300, bool), chunk=128)
    assert not np.asarray(ok_z).any() and (np.asarray(p_z) == 0).all()

    # single-chunk shape (the lax.cond branch) and 2-D leading shape
    p_s, ok_s = osd_decode_masked(llr[:40].reshape(2, 20, 174),
                                  need[:40].reshape(2, 20), chunk=128)
    np.testing.assert_array_equal(
        np.asarray(ok_s).ravel() & np.asarray(need[:40]),
        np.asarray(ok_all[:40]) & np.asarray(need[:40]))


def test_osd_masked_under_vmap():
    """decode_slots' non-block fallback vmaps finish_decode, so the
    masked OSD's while_loop + scatter must batch correctly."""
    import jax

    rng = np.random.default_rng(14)
    cw = _codewords(rng, 24)
    llr = jnp.asarray(((2 * cw - 1) * 2.0
                       + 1.6 * rng.standard_normal(cw.shape))
                      .astype(np.float32)).reshape(3, 8, 174)
    need = jnp.asarray(rng.random((3, 8)) < 0.5)
    p_v, ok_v = jax.vmap(lambda l, m: osd_decode_masked(l, m, chunk=128))(
        llr, need)
    p_f, ok_f = osd_decode_masked(llr.reshape(-1, 174), need.reshape(-1),
                                  chunk=128)
    np.testing.assert_array_equal(np.asarray(ok_v).ravel(),
                                  np.asarray(ok_f))
    np.testing.assert_array_equal(np.asarray(p_v).reshape(-1, 174),
                                  np.asarray(p_f))


def test_finish_decode_gated_osd_mask_identity():
    """finish_decode(use_osd=True) success masks and surviving payloads
    are identical to the pre-gating unconditional-OSD formulation."""
    import jax

    from ft8_demodulator_tpu.demod.decode import _crc_of_plain, \
        finish_decode
    from ft8_demodulator_tpu.ops.ldpc_decode import bp_decode_batch

    rng = np.random.default_rng(15)
    cw = _codewords(rng, 160)
    llr = jnp.asarray(((2 * cw - 1) * 2.0
                       + 1.9 * rng.standard_normal(cw.shape))
                      .astype(np.float32))
    k = llr.shape[0]
    abs_t = jnp.zeros(k, jnp.int32)
    abs_f = jnp.zeros(k, jnp.int32)
    score = jnp.zeros(k, jnp.float32)
    valid = jnp.asarray(rng.random(k) < 0.9)

    res = finish_decode(llr, abs_t, abs_f, score, valid, 20, use_osd=True)

    # reference formulation: unconditional OSD over every row
    plain, errs = bp_decode_batch(llr, 20)
    cc, ce = _crc_of_plain(plain)
    bp_ok = (errs == 0) & (cc == ce)
    op, ook = osd_decode_batch(llr)
    take = ~bp_ok & ook
    plain = jnp.where(take[:, None], op, plain)
    cc, ce = _crc_of_plain(plain)
    want = np.asarray(valid & jnp.where(take, True, errs == 0)
                      & (cc == ce))

    got = np.asarray(res.success)
    np.testing.assert_array_equal(got, want)
    # payloads agree on every surviving row
    bits77 = np.asarray(plain)[:, :77]
    weights = 2 ** np.arange(7, -1, -1)
    pay = (np.pad(bits77, ((0, 0), (0, 3))).reshape(-1, 10, 8)
           * weights).sum(-1).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(res.payload)[got], pay[got])
