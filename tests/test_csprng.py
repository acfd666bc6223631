"""CSPRNG validation: RFC 8439 known answer, native/numpy agreement,
statistical smoke, and client keygen integration."""

import numpy as np
import pytest

from tfhe_aes_tpu.utils import csprng


RFC_KEY = bytes(range(32))
RFC_NONCE = bytes([0, 0, 0, 9, 0, 0, 0, 0x4A, 0, 0, 0, 0])
# RFC 8439 section 2.3.2: serialized keystream block at counter=1 (first 16
# bytes; the cross-implementation test pins the full stream).
RFC_KEYSTREAM_16 = bytes.fromhex("10f1e7e4d13b5915500fdd1fa32071c4")


def test_rfc8439_known_answer():
    ks = csprng.chacha20_keystream_u64(RFC_KEY, RFC_NONCE, 1, 8)
    assert ks.tobytes()[:16] == RFC_KEYSTREAM_16


def test_numpy_fallback_matches_rfc_vector():
    key_words = np.frombuffer(RFC_KEY, dtype="<u4")
    nonce_words = np.frombuffer(RFC_NONCE, dtype="<u4")
    ks = csprng._chacha20_blocks_numpy(key_words, nonce_words, 1, 1)
    assert ks.tobytes()[:16] == RFC_KEYSTREAM_16


def test_native_matches_numpy_fallback():
    from tfhe_aes_tpu.runtime import get_lib
    if get_lib() is None:
        pytest.skip("native library unavailable")
    key = bytes(range(7, 39))
    nonce = bytes(range(12))
    native = csprng.chacha20_keystream_u64(key, nonce, 5, 4096)
    fallback = csprng._chacha20_blocks_numpy(
        np.frombuffer(key, dtype="<u4"), np.frombuffer(nonce, dtype="<u4"),
        5, 512)[:4096]
    np.testing.assert_array_equal(native, fallback)


def test_statistical_smoke():
    rng = csprng.Csprng(key32=bytes(range(100, 132)))
    n = 1 << 17
    u = rng._u64(n)
    bits = np.unpackbits(u.view(np.uint8))
    # Monobit: ~0.5 within 5 sigma of binomial std for 8.4M bits.
    freq = bits.mean()
    sigma = 0.5 / np.sqrt(bits.size)
    assert abs(freq - 0.5) < 5 * sigma
    # No duplicate u64s expected in 131k samples (collision p ~ 2^-30).
    assert np.unique(u).size == n
    # Serial correlation of adjacent words ~ 0.
    x = u.astype(np.float64)
    c = np.corrcoef(x[:-1], x[1:])[0, 1]
    assert abs(c) < 0.02


def test_generator_surface():
    rng = csprng.Csprng(key32=bytes(32))
    bits = rng.integers(0, 2, size=1000, dtype=np.uint64)
    assert set(np.unique(bits)) <= {0, 1} and 400 < bits.sum() < 600
    words = rng.integers(0, 1 << 64, size=(3, 4), dtype=np.uint64)
    assert words.shape == (3, 4) and words.dtype == np.uint64
    z = rng.normal(0.0, 1.0, size=100_000)
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02
    assert len(rng.bytes(17)) == 17
    with pytest.raises(AssertionError):
        rng.integers(0, 3, size=4)  # non-power-of-two span unsupported


def test_client_keygen_via_csprng():
    """Client(seed=None) routes keygen through ChaCha20 and still produces a
    consistent encrypt/decrypt pipeline."""
    from tfhe_aes_tpu.params import PARAM_TOY
    from tfhe_aes_tpu.client.client import Client

    client = Client(PARAM_TOY, seed=None)
    assert isinstance(client.rng, csprng.Csprng)
    for byte in (0, 0x5A, 0xFF):
        assert client.decrypt_byte(client.encrypt_byte(byte)) == byte
