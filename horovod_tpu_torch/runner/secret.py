"""Shared-secret generation for the launcher's RPC plane.

Counterpart of ``horovod_tpu/runner/secret.py``, copied.

Parity: horovod/spark/util/secret.py (reference :21-36) — a random key is
generated by the driver and handed to workers through the environment
(``_HOROVOD_SECRET_KEY`` there, :envvar:`HOROVOD_TPU_SECRET_KEY` here); every
RPC message is authenticated with HMAC over it before being unpickled.
"""

from __future__ import annotations

import base64
import os

SECRET_ENV = "HOROVOD_TPU_SECRET_KEY"


def make_secret_key() -> bytes:
    """16 random bytes, like the reference's ``os.urandom(16)``."""
    return os.urandom(16)


def encode_key(key: bytes) -> str:
    return base64.urlsafe_b64encode(key).decode("ascii")


def decode_key(encoded: str) -> bytes:
    return base64.urlsafe_b64decode(encoded.encode("ascii"))


def key_from_env() -> bytes:
    v = os.environ.get(SECRET_ENV)
    if not v:
        raise RuntimeError(
            f"{SECRET_ENV} is not set; worker processes must be launched by "
            "the horovod_tpu_torch runner (or export the key manually)")
    return decode_key(v)
