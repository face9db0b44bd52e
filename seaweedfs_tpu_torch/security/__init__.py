"""Counterpart of seaweedfs_tpu/security: JWT tokens and the IP guard."""

from .jwt_auth import (Guard, SigningKey, decode_jwt, encode_jwt,
                       gen_write_jwt, gen_read_jwt, token_from_request)

__all__ = ["Guard", "SigningKey", "decode_jwt", "encode_jwt",
           "gen_write_jwt", "gen_read_jwt", "token_from_request"]
