"""FHE AES-128 (CTR) on the batched WoPBS primitive layer — the "Server".

Reference counterpart: src/server/server.rs (facade), encrypt/decrypt modules
and key_expansion.  Layout: the state is [B, 16, 8, big+1] u64 — B CTR
blocks, 16 bytes column-major (state[4*col + row], shift_rows.rs:5-21), 8
one-bit blocks per byte LSB-first, each a big-LWE row.

XOR is u64 addition of ciphertext rows (message_modulus 2, no carry — the
reference's unchecked_add, server.rs:278-282).  All nonlinearity runs through
many-LUT WoPBS with the GF(2^8) multiple tables fused into the S-box LUTs
(sbox.rs:68-97), so MixColumns costs addition depth 4 and AddRoundKey 1 —
exactly the <=5-additions noise budget the parameters were optimized for
(README.md:176-180).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import wopbs
from ..ops.keys import DeviceKeys
from . import aes_plain, luts, tables

U64 = jnp.uint64

# Column-major ShiftRows permutation: new[i] = old[_SHIFT[i]].
SHIFT = tuple(aes_plain._SHIFT)
INV_SHIFT = tuple(aes_plain._INV_SHIFT)

# MixColumns as (byte index, variant) gathers over the fused-LUT outputs
# [x, mul2(x), mul3(x)] (variant order of many_sbox, sbox.rs:78-94).
# Row r of column c sums variants per the circulant matrix [2 3 1 1].
_MC_VAR = np.array([[1, 2, 0, 0],
                    [0, 1, 2, 0],
                    [0, 0, 1, 2],
                    [2, 0, 0, 1]])  # [row, which-input-byte] -> variant
# Inverse MixColumns over variants [mul9, mul11, mul13, mul14] (sbox.rs:73-77):
# matrix rows (14 11 13 9; 9 14 11 13; 13 9 14 11; 11 13 9 14).
_IMC_VAR = np.array([[3, 1, 2, 0],
                     [0, 3, 1, 2],
                     [2, 0, 3, 1],
                     [1, 2, 0, 3]])


def _mix_indices(var_table: np.ndarray):
    byte_idx = np.zeros((16, 4), dtype=np.int32)
    var_idx = np.zeros((16, 4), dtype=np.int32)
    for col in range(4):
        for row in range(4):
            o = 4 * col + row
            byte_idx[o] = 4 * col + np.arange(4)
            var_idx[o] = var_table[row]
    return byte_idx, var_idx


@functools.lru_cache(maxsize=None)
def _fwd_luts(params) -> np.ndarray:
    """3 fused LUTs {SBOX, mul2 o SBOX, mul3 o SBOX} -> [1, 24, C, N]."""
    s = tables.sbox()
    return luts.lut_polys_from_tables(
        params, np.stack([s, tables.gf_mul_table(2)[s],
                          tables.gf_mul_table(3)[s]]), 8)


@functools.lru_cache(maxsize=None)
def _inv_mul_luts(params) -> np.ndarray:
    """4 LUTs {mul9, mul11, mul13, mul14} (decrypt path)."""
    return luts.lut_polys_from_tables(
        params, np.stack([tables.gf_mul_table(c) for c in (9, 11, 13, 14)]), 8)


@functools.lru_cache(maxsize=None)
def _sbox_lut(params, inv: bool) -> np.ndarray:
    t = tables.inv_sbox() if inv else tables.sbox()
    return luts.lut_polys_from_tables(params, t[None], 8)


@functools.lru_cache(maxsize=None)
def _identity_lut(params) -> np.ndarray:
    """Noise-refresh LUT for key expansion (server.rs:118-119)."""
    return luts.lut_polys_from_tables(
        params, np.arange(256, dtype=np.uint64)[None], 8)


@functools.lru_cache(maxsize=None)
def _refresh_sbox_lut(params) -> np.ndarray:
    """Fused {identity, SBOX} stack for the 1-WoPBS key-expansion round:
    L 0..7 = refreshed input bits, L 8..15 = SBOX output bits."""
    return luts.lut_polys_from_tables(
        params, np.stack([np.arange(256, dtype=np.uint64), tables.sbox()]), 8)


def add_round_key(state, rk):
    """XOR = componentwise u64 LWE addition (server.rs:278-282)."""
    return state + rk


def shift_rows(state):
    return state[:, SHIFT, ...]


def inv_shift_rows(state):
    return state[:, INV_SHIFT, ...]


def _byte_wopbs(keys: DeviceKeys, state, lut):
    """Apply a LUT stack to every byte: [B,16,8,big+1] -> [B,16,L,big+1]."""
    B = state.shape[0]
    flat = state.reshape((B * 16,) + state.shape[2:])
    out = wopbs.many_wopbs_jit(keys, flat, jnp.asarray(lut))
    return out.reshape((B, 16) + out.shape[1:])


def _mix(mul_state, var_table):
    """mul_state [B,16,V,8,big+1] -> state [B,16,8,big+1] via 4-term sums."""
    byte_idx, var_idx = _mix_indices(var_table)
    gathered = mul_state[:, byte_idx, var_idx]     # [B,16,4,8,big+1]
    return gathered.sum(axis=2, dtype=U64)


def aes_encrypt(keys: DeviceKeys, round_keys, state):
    """Batched AES-128 encryption (server.rs:39-64).

    round_keys: [11, 16, 8, big+1]; state: [B, 16, 8, big+1].  The nine
    identical middle rounds are a lax.fori_loop so the whole cipher traces to
    ONE compact XLA program — a single device dispatch per batch, no
    per-round host round-trips (the reference pays per-op dispatch on every
    rayon thread instead, main.rs:55-64)."""
    p = keys.params
    fwd_l = jnp.asarray(_fwd_luts(p))
    state = add_round_key(state, round_keys[0])

    def round_body(rnd, st):
        mul = _byte_wopbs(keys, st, fwd_l)                 # [B,16,24,big+1]
        mul = mul.reshape(mul.shape[:2] + (3, 8) + mul.shape[3:])
        mul = shift_rows(mul)                              # permute bytes
        st = _mix(mul, _MC_VAR)                            # depth-4 adds
        rk = jax.lax.dynamic_index_in_dim(round_keys, rnd, 0, keepdims=False)
        return add_round_key(st, rk)

    state = jax.lax.fori_loop(1, 10, round_body, state)
    out = _byte_wopbs(keys, state, _sbox_lut(p, inv=False))  # final SubBytes
    state = shift_rows(out)
    return add_round_key(state, round_keys[10])


def aes_decrypt(keys: DeviceKeys, round_keys, state):
    """Batched AES-128 decryption (server.rs:67-105): ~2x encrypt cost —
    the round-key add between InvSubBytes and InvMixColumns forces a second
    many-LUT pass for the mul9/11/13/14 multiples."""
    p = keys.params
    inv_sbox_l = jnp.asarray(_sbox_lut(p, inv=True))
    inv_mul_l = jnp.asarray(_inv_mul_luts(p))
    state = add_round_key(state, round_keys[10])

    def round_body(i, st):
        rnd = 10 - i
        st = inv_shift_rows(st)
        st = _byte_wopbs(keys, st, inv_sbox_l)
        rk = jax.lax.dynamic_index_in_dim(round_keys, rnd - 1, 0,
                                          keepdims=False)
        st = add_round_key(st, rk)
        mul = _byte_wopbs(keys, st, inv_mul_l)             # [B,16,32,big+1]
        mul = mul.reshape(mul.shape[:2] + (4, 8) + mul.shape[3:])
        return _mix(mul, _IMC_VAR)

    state = jax.lax.fori_loop(0, 9, round_body, state)
    state = inv_shift_rows(state)
    state = _byte_wopbs(keys, state, _sbox_lut(p, inv=True))
    return add_round_key(state, round_keys[0])


# ---------------------------------------------------------------------------
# Key expansion (server.rs:107-167)
# ---------------------------------------------------------------------------

def trivial_rcon(params) -> np.ndarray:
    """RCON bytes as trivial (noiseless) LWE encodings: [10, 8, big+1].

    RCON is a PUBLIC constant (key_expansion_utils.rs:10-12); a trivial
    ciphertext (zero mask, body = bit * 2^63) is a valid noise-level-0
    encoding that needs no key material at all.  The reference instead
    public-key-encrypts RCON (server.rs:139-140) — a fresh level-1
    ciphertext; pass its output as rcon_cts for the reference-faithful path.
    """
    out = np.zeros((10, 8, params.big_lwe_dimension + 1), np.uint64)
    for i, r in enumerate(tables.RCON):
        for j in range(8):
            out[i, j, -1] = np.uint64(((int(r) >> j) & 1)) << np.uint64(63)
    return out


def aes_key_expansion(keys: DeviceKeys, enc_key, rcon_cts=None, *,
                      rcon_fresh: bool | None = None):
    """enc_key [16, 8, big+1] -> round keys [11, 16, 8, big+1].

    rcon_cts: optional [10, 8, big+1].  Default (None) uses trivial
    noise-free RCON encodings (trivial_rcon); passing public-key-encrypted
    RCON (level 1, server.rs:139-140) selects the 3-WoPBS schedule.  Every
    generated round-key byte exits at nominal noise through an identity
    WoPBS (server.rs:150).

    Scheduling: one lax.scan over the 10 rounds.  With noise-free
    RCON each round is ONE 16-byte WoPBS call instead of the reference's
    five (1 SubWord + 4 per-word refreshes, server.rs:131-154): the four
    new words chain as leveled sums of fresh inputs —
    n0 = w0 + sub (2), n1 = w1 + n0 (3), n2 = w2 + n1 (4),
    n3 = w3 + n2 (5 = budget) — and ONE many-LUT WoPBS (L=16: identity +
    SBOX outputs per byte) both refreshes all 16 bytes AND evaluates the
    NEXT round's SubWord on n3's shared circuit bootstraps.  SBOX sees n3
    at level 5 — identical noise to the refresh input itself, within the
    parameter budget — and n3's bits are circuit-bootstrapped once instead
    of twice (the refresh reads the identity LUT, SubWord the SBOX LUT, off
    the same GGSWs: the many-LUT split of many_wopbs.rs:28-30 applied to
    the key schedule).  With fresh (level-1) RCON the chain would hit
    6, so n3 completes from the refreshed n2 in a separate WoPBS:
    n0 (3), n1 (4), n2 (5) -> refresh; n3 = w3 + n2' (2).
    Budget discipline per README.md:176-180; both schedules are checked by
    the circuit-derived audit (utils/noise.py) and the oracle tests.
    """
    p = keys.params
    ident = jnp.asarray(_identity_lut(p))
    sbox_l = jnp.asarray(_sbox_lut(p, inv=False))
    refresh_sbox_l = jnp.asarray(_refresh_sbox_lut(p))
    if rcon_fresh is None:
        rcon_fresh = rcon_cts is not None
    if rcon_cts is None:
        rcon_cts = jnp.asarray(trivial_rcon(p))
    rk0 = enc_key

    def round_body_trivial(carry, rcon):
        prev_rk, sub = carry   # sub = SBOX(RotWord(prev w3)), fresh (lvl 1)
        temp = sub.at[0].add(rcon)                     # += trivial: still 1
        w = prev_rk.reshape(4, 4, 8, prev_rk.shape[-1])
        n0 = w[0] + temp                               # lvl 2 (byte 0)
        n1 = w[1] + n0                                 # lvl 3
        n2 = w[2] + n1                                 # lvl 4
        n3 = w[3] + n2                                 # lvl 5 = budget
        out = wopbs.many_wopbs(
            keys, jnp.concatenate([n0, n1, n2, n3], axis=0), refresh_sbox_l)
        new_rk = out[:, :8]                            # identity outputs
        # SBOX outputs of n3's bytes in RotWord order = next round's SubWord
        # (the final round's value is computed and discarded — scan bodies
        # are uniform; the waste is 4 of 16 vertical packings, no extra CBS).
        next_sub = out[jnp.array([13, 14, 15, 12]), 8:]
        return (new_rk, next_sub), new_rk

    def round_body_pk(prev_rk, rcon):
        w = prev_rk.reshape(4, 4, 8, prev_rk.shape[-1])
        temp = w[3][np.array([1, 2, 3, 0])]
        temp = wopbs.many_wopbs(keys, temp, sbox_l)
        temp = temp.at[0].add(rcon)                    # += RCON ct (lvl 2)
        n0 = w[0] + temp                               # lvl 3 (byte 0)
        n1 = w[1] + n0                                 # lvl 4
        n2 = w[2] + n1                                 # lvl 5 = budget
        fresh = wopbs.many_wopbs(
            keys, jnp.concatenate([n0, n1, n2], axis=0), ident)
        n3 = w[3] + fresh[8:12]                        # w3 + n2' -> lvl 2
        n3 = wopbs.many_wopbs(keys, n3, ident)
        new_rk = jnp.concatenate([fresh, n3], axis=0)  # [16, 8, big+1]
        return new_rk, new_rk

    if rcon_fresh:
        _, rks = jax.lax.scan(round_body_pk, rk0, rcon_cts)
    else:
        # Prologue SubWord on the (fresh, level-1) client key's last word;
        # every later SubWord rides the fused round WoPBS above.
        w3 = rk0.reshape(4, 4, 8, rk0.shape[-1])[3]
        sub0 = wopbs.many_wopbs(keys, w3[np.array([1, 2, 3, 0])], sbox_l)
        (_, _), rks = jax.lax.scan(round_body_trivial, (rk0, sub0), rcon_cts)
    return jnp.concatenate([rk0[None], rks], axis=0)


aes_key_expansion_jit = jax.jit(aes_key_expansion,
                                static_argnames=("rcon_fresh",))


@jax.jit
def _expand_glue(prev_rk, sub, rcon):
    """Leveled chain of one trivial-RCON expansion round: the n0..n3 sums
    of round_body_trivial as one tiny jitted program."""
    temp = sub.at[0].add(rcon)
    w = prev_rk.reshape(4, 4, 8, prev_rk.shape[-1])
    n0 = w[0] + temp
    n1 = w[1] + n0
    n2 = w[2] + n1
    n3 = w[3] + n2
    return jnp.concatenate([n0, n1, n2, n3], axis=0)


def aes_key_expansion_staged(keys: DeviceKeys, enc_key):
    """Trivial-RCON key expansion as 11 dispatches of ONE compiled WoPBS.

    Bit-identical to aes_key_expansion(rcon_fresh=False), but instead of
    tracing the whole 10-round schedule into one XLA megaprogram (75-378 s
    to compile on a machine with an empty XLA cache, PERF.md round 3), it
    reuses a single jitted many_wopbs program — same batch (16 bytes) and
    LUT stack (identity+SBOX) for every round INCLUDING the prologue, which
    is padded from 4 to 16 bytes by running it on the whole (reordered)
    input key and keeping the four RotWord outputs.  Cold-start compile is
    one WoPBS program + one tiny glue program; warm throughput is the same
    (the WoPBS dominates each round).
    """
    p = keys.params
    refresh_sbox_l = jnp.asarray(_refresh_sbox_lut(p))
    rcon_cts = jnp.asarray(trivial_rcon(p))
    rk0 = enc_key

    # Prologue SubWord, padded to the round shape: bytes 12..15 of the
    # reordered input are RotWord(w3); the other 12 outputs are discarded
    # (4 extra vertical packings, no extra circuit bootstraps of interest).
    order = np.concatenate([np.arange(12), np.array([13, 14, 15, 12])])
    out = wopbs.many_wopbs_jit(keys, rk0[order], refresh_sbox_l)
    sub = out[12:16, 8:]

    rk = rk0
    rks = [rk0]
    for r in range(10):
        n = _expand_glue(rk, sub, rcon_cts[r])
        out = wopbs.many_wopbs_jit(keys, n, refresh_sbox_l)
        rk = out[:, :8]
        sub = out[jnp.array([13, 14, 15, 12]), 8:]
        rks.append(rk)
    return jnp.stack(rks)


# ---------------------------------------------------------------------------
# Homomorphic CTR increment (server.rs:172-274), exact-carry version
# ---------------------------------------------------------------------------

def add_scalar_luts(params, i_bytes: np.ndarray):
    """Host-side LUT construction for add_scalar.

    i_bytes: numpy [B, 16], byte decomposition (MSB-first) of each block's
    counter offset.  Returns (lut_lsb [B,9,C8,N], luts_rest [15,B,9,C9,N]):
    per-block {sum, carry} tables — 8 sum bits + 1 carry bit per step.
    """
    x8 = np.arange(256)
    i_lsb = i_bytes[:, 15].astype(np.uint64)
    t_sum = ((x8[None] + i_lsb[:, None]) % 256).astype(np.uint64)
    t_car = ((x8[None] + i_lsb[:, None]) > 255).astype(np.uint64)
    lut_lsb = np.concatenate([
        luts.lut_polys_per_batch(params, t_sum[:, None], 8, out_bits=8),
        luts.lut_polys_per_batch(params, t_car[:, None], 8, out_bits=1)],
        axis=1)

    x9 = np.arange(512)
    rest = []
    for idx in range(14, -1, -1):
        ib = i_bytes[:, idx].astype(np.uint64)
        val = (x9[None] & 0xFF) + (x9[None] >> 8) + ib[:, None]
        t_sum = (val % 256).astype(np.uint64)
        t_car = (val > 255).astype(np.uint64)
        rest.append(np.concatenate([
            luts.lut_polys_per_batch(params, t_sum[:, None], 9, out_bits=8),
            luts.lut_polys_per_batch(params, t_car[:, None], 9, out_bits=1)],
            axis=1))
    return lut_lsb, np.stack(rest)


def add_scalar_device(keys: DeviceKeys, state, lut_lsb, luts_rest):
    """Pure-JAX ripple-carry add: state [B,16,8,big+1] += counters.

    16 sequential 9-bit many-LUT WoPBS steps, one CBS each (the reference's
    structure, server.rs:181-252).

    Deviation from the reference (documented): the reference's LSB carry LUT
    tests `x + i > 255` with the FULL scalar i (server.rs:182), which is only
    correct for i < 256; we use the exact per-byte carry (SURVEY.md 3.4).
    """
    out = wopbs.many_wopbs(keys, state[:, 15], lut_lsb)
    state = state.at[:, 15].set(out[:, :8])
    carry = out[:, 8:9]                                # [B,1,big+1]

    def body(step, sc):
        st, car = sc
        idx = 14 - step
        byte = jax.lax.dynamic_index_in_dim(st, idx, 1, keepdims=False)
        bits9 = jnp.concatenate([byte, car], axis=1)
        lut = jax.lax.dynamic_index_in_dim(luts_rest, step, 0, keepdims=False)
        out = wopbs.many_wopbs(keys, bits9, lut)
        st = jax.lax.dynamic_update_index_in_dim(
            st, out[:, None, :8], idx, 1)
        return st, out[:, 8:9]

    state, _ = jax.lax.fori_loop(0, 15, body, (state, carry))
    return state


add_scalar_device_jit = jax.jit(add_scalar_device)


def add_scalar(keys: DeviceKeys, state, i_bytes: np.ndarray):
    """Convenience wrapper: build LUTs on host, run the device ripple-add."""
    lut_lsb, luts_rest = add_scalar_luts(keys.params, i_bytes)
    return add_scalar_device_jit(keys, jnp.asarray(state),
                                 jnp.asarray(lut_lsb), jnp.asarray(luts_rest))


def ctr_step(keys: DeviceKeys, round_keys, enc_iv, lut_lsb, luts_rest):
    """One fused CTR batch: broadcast IV -> ripple-add counters -> AES.

    The whole step (16 ripple WoPBS + 10 AES rounds) is one XLA program;
    jitted as ctr_step_jit this is the unit ctr_keystream dispatches for
    batches up to block_chunk blocks and the sharded mesh runner builds on.
    Batch size comes from the LUT stacks' leading axis.  Per-stage working
    sets are bounded by the byte-chunked WoPBS tail (ops/wopbs.many_wopbs).
    """
    B = lut_lsb.shape[0]
    state = jnp.broadcast_to(enc_iv[None], (B,) + enc_iv.shape)
    state = add_scalar_device(keys, state, lut_lsb, luts_rest)
    return aes_encrypt(keys, round_keys, state)


ctr_step_jit = jax.jit(ctr_step)
aes_encrypt_jit = jax.jit(aes_encrypt)
aes_decrypt_jit = jax.jit(aes_decrypt)


def ctr_keystream(keys: DeviceKeys, round_keys, enc_iv, n_blocks: int,
                  offset: int = 0, *, block_chunk: int = 32):
    """FHE keystream blocks AES(key, iv + offset + t), t = 0..n_blocks-1.

    The CTR batch axis is the framework's data-parallel axis (main.rs:55-64's
    rayon loop, reborn as one device batch / shard_map axis).

    Batches up to `block_chunk` run as the single fused ctr_step program.
    Larger batches run the ripple-carry counter add ONCE at the full batch
    (its 16 sequential small WoPBS are latency-bound and amortize with B —
    the whole point of big batches) and then dispatch the AES rounds in
    balanced <=block_chunk chunks (ragged tail wrap-padded), all reusing
    ONE compiled aes_encrypt program.

    block_chunk=32 bounds one program's batch, and with it the size of
    the compiled AES program and its device working set.  It is a constant
    still to be re-swept against the card's memory (ROADMAP.md, Speed).
    """
    i_bytes = counter_bytes(n_blocks, offset)
    lut_lsb, luts_rest = add_scalar_luts(keys.params, i_bytes)
    if n_blocks <= block_chunk:
        return ctr_step_jit(keys, round_keys, jnp.asarray(enc_iv),
                            jnp.asarray(lut_lsb), jnp.asarray(luts_rest))
    state = jnp.broadcast_to(enc_iv[None], (n_blocks,) + enc_iv.shape)
    state = add_scalar_device_jit(keys, state, jnp.asarray(lut_lsb),
                                  jnp.asarray(luts_rest))
    from ..ops.wopbs import _chunk_size
    bc = _chunk_size(n_blocks, block_chunk)
    outs = []
    for i in range(0, n_blocks, bc):
        sl = state[i:i + bc]
        pad = bc - sl.shape[0]
        if pad:     # ragged tail: wrap-pad so every chunk reuses the ONE
            sl = jnp.concatenate([sl, state[:pad]])      # compiled program
        out = aes_encrypt_jit(keys, round_keys, sl)
        outs.append(out[:bc - pad] if pad else out)
    return jnp.concatenate(outs, axis=0)


def counter_bytes(n_blocks: int, offset: int = 0) -> np.ndarray:
    """[B, 16] MSB-first byte decomposition of offsets offset..offset+B-1."""
    return np.stack([
        np.array(aes_plain.u128_to_bytes_be((offset + t) % (1 << 128)),
                 dtype=np.uint64)
        for t in range(n_blocks)])
