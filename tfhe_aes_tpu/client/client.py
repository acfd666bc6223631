"""Client (trusted party): keygen, bit-level encryption, decryption, verify.

Mirrors the reference Client (client.rs:68-218): generates all key material,
encrypts the AES key and IV byte-by-byte as 8 one-bit blocks at delta 2^63
under the *big* key (encryption_key_choice = Big), hands the evaluation keys
plus a public key across the trust boundary, and verifies decrypted CTR
keystream blocks against the plaintext AES oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import ParamSet, PARAM_OPT
from ..backend import numpy_backend as nb
from ..ops import keys as keys_mod
from ..models import aes_plain

U64 = np.uint64


@dataclasses.dataclass
class PublicKey:
    """LWE public key: zero-encryptions under the big key; server-side
    encryption = random binary combination + message (reference parity:
    PublicKey::new at client.rs:141, used for RCON at server.rs:139-140)."""
    zeros: np.ndarray  # [n_pk, big+1] u64

    def encrypt_bits(self, bits: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
        """bits [...] in {0,1} -> [..., big+1] u64 at delta 2^63."""
        bits = np.asarray(bits, dtype=np.uint64)
        sel = rng.integers(0, 2, size=bits.shape + (self.zeros.shape[0],),
                           dtype=np.uint64)
        ct = np.einsum("...s,sj->...j", sel, self.zeros,
                       dtype=np.uint64, casting="unsafe").astype(np.uint64)
        ct[..., -1] += bits << U64(63)
        return ct


class Client:
    def __init__(self, params: ParamSet = PARAM_OPT, seed: int | None = None):
        """seed=None (production): all key/mask/noise randomness comes from
        the ChaCha20 CSPRNG seeded with OS entropy (utils/csprng.py; the
        reference uses tfhe-csprng, SURVEY.md 2b).  An integer seed selects
        numpy PCG64 — reproducible but NOT cryptographically secure, for
        tests and benches only."""
        from ..utils import csprng
        self.params = params
        self.rng = csprng.default_rng(seed)
        self.sk = nb.gen_secret_keys(params, self.rng)

    # -- key material for the server (the trust boundary) -------------------
    def make_device_keys(self, fast: bool = True) -> keys_mod.DeviceKeys:
        """Evaluation keys in device layout.  fast=True routes the GLWE
        mask products + BSK NTT staging through the accelerator
        (client.keygen_fast); fast=False is the pure-host golden path."""
        if fast:
            from . import keygen_fast
            return keygen_fast.make_device_keys_fast(self.sk, self.rng)
        return keys_mod.make_device_keys(self.sk, self.rng)

    def make_public_key(self, n_pk: int | None = None) -> PublicKey:
        p = self.params
        n_pk = n_pk or (p.big_lwe_dimension + 128)
        zeros = nb.lwe_encrypt(self.sk.big_lwe_key,
                               np.zeros(n_pk, dtype=np.uint64),
                               p.glwe_noise_std, self.rng)
        return PublicKey(zeros)

    # -- encryption ----------------------------------------------------------
    def encrypt_byte(self, byte: int) -> np.ndarray:
        """byte -> [8, big+1] u64, bit j (LSB first) at delta 2^63."""
        bits = np.array([(byte >> j) & 1 for j in range(8)], dtype=np.uint64)
        return nb.lwe_encrypt(self.sk.big_lwe_key, bits << U64(63),
                              self.params.glwe_noise_std, self.rng)

    def encrypt_u128(self, x: int) -> np.ndarray:
        """u128 -> [16, 8, big+1], bytes MSB-first (client.rs:126-138)."""
        return np.stack([self.encrypt_byte(b)
                         for b in aes_plain.u128_to_bytes_be(x)])

    # -- decryption / verification -------------------------------------------
    def decrypt_bits(self, cts: np.ndarray) -> np.ndarray:
        return nb.lwe_decrypt_bit(self.sk.big_lwe_key, cts)

    def decrypt_byte(self, ct_bits: np.ndarray) -> int:
        bits = self.decrypt_bits(ct_bits)
        return int(sum(int(b) << j for j, b in enumerate(bits)))

    def decrypt_state_u128(self, state: np.ndarray) -> int:
        """state [16, 8, big+1] (bytes MSB-first) -> u128."""
        return aes_plain.bytes_be_to_u128(
            [self.decrypt_byte(state[i]) for i in range(16)])

    def decrypt_and_verify_ctr(self, states: np.ndarray, key: int, iv: int,
                               offset: int = 0) -> list[int]:
        """states [n, 16, 8, big+1]; asserts block i == AES(key, iv+offset+i)
        (client_decrypt_and_verify, client.rs:147-175)."""
        want = aes_plain.ctr_keystream(key, iv + offset, states.shape[0])
        got = [self.decrypt_state_u128(states[i])
               for i in range(states.shape[0])]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, (f"CTR block {i}: FHE {g:#034x} != plain {w:#034x}")
        return got
