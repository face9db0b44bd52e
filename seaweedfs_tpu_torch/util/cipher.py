"""AES-256-GCM chunk encryption for filer encrypt-at-rest.

Parity with weed/util/cipher.go: a fresh random 32-byte key per chunk
(stored on the chunk record in filer metadata, never on the volume
server), ciphertext laid out nonce || sealed-data || tag — the same
framing Go's gcm.Seal(nonce, nonce, plaintext, nil) produces.  Volume
servers only ever see ciphertext; whoever holds the filer metadata holds
the keys (filer_server_handlers_write_cipher.go).

The port's own copy of seaweedfs_tpu/util/cipher.py.
"""

from __future__ import annotations

import os

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # pragma: no cover - baked into the image
    AESGCM = None

KEY_SIZE = 32
NONCE_SIZE = 12  # GCM standard nonce


def cipher_available() -> bool:
    return AESGCM is not None


def gen_cipher_key() -> bytes:
    """Random 256-bit per-chunk key (cipher.go GenCipherKey)."""
    return os.urandom(KEY_SIZE)


def encrypt(plaintext: bytes, key: bytes) -> bytes:
    """nonce || AES-256-GCM(plaintext) (cipher.go Encrypt)."""
    if AESGCM is None:
        raise RuntimeError("cryptography library unavailable; "
                           "cannot encrypt chunk data")
    nonce = os.urandom(NONCE_SIZE)
    return nonce + AESGCM(key).encrypt(nonce, bytes(plaintext), None)


def decrypt(ciphertext: bytes, key: bytes) -> bytes:
    """Inverse of encrypt; raises ValueError on truncation or a bad tag
    (cipher.go Decrypt)."""
    if AESGCM is None:
        raise RuntimeError("cryptography library unavailable; "
                           "cannot decrypt chunk data")
    if len(ciphertext) < NONCE_SIZE:
        raise ValueError("ciphertext shorter than its nonce")
    try:
        return AESGCM(key).decrypt(ciphertext[:NONCE_SIZE],
                                   bytes(ciphertext[NONCE_SIZE:]), None)
    except Exception as e:  # InvalidTag and friends
        raise ValueError(f"chunk decrypt failed: {e}") from e
