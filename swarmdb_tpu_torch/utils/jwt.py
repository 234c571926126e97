"""Minimal HS256 JSON Web Token implementation (stdlib only): a copy of
``swarmdb_tpu/utils/jwt.py``.

Claims ``sub`` (agent id) and ``exp``, HMAC-SHA256 over base64url
segments: exactly the subset the wire API needs. Tokens interoperate with
any standard JWT library, and with the JAX package's server given the
same secret.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Dict, Optional


class JWTError(Exception):
    pass


class ExpiredTokenError(JWTError):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def encode(claims: Dict[str, Any], secret: str) -> str:
    header = {"alg": "HS256", "typ": "JWT"}
    h = _b64url(json.dumps(header, separators=(",", ":")).encode())
    p = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{h}.{p}".encode("ascii")
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{h}.{p}.{_b64url(sig)}"


def decode(token: str, secret: str, verify_exp: bool = True) -> Dict[str, Any]:
    # Any malformation in an attacker-supplied token must surface as
    # JWTError (-> HTTP 401), never as a stray exception (-> HTTP 500):
    # non-ascii header chars, bad base64, non-dict payloads, non-numeric exp.
    try:
        try:
            h, p, s = token.split(".")
            signing_input = f"{h}.{p}".encode("ascii")
            provided = _b64url_decode(s)
        except JWTError:
            raise
        except Exception:
            raise JWTError("malformed token")
        expected = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, provided):
            raise JWTError("signature mismatch")
        try:
            header = json.loads(_b64url_decode(h))
            claims = json.loads(_b64url_decode(p))
        except Exception:
            raise JWTError("malformed payload")
        if not isinstance(header, dict) or not isinstance(claims, dict):
            raise JWTError("malformed payload")
        if header.get("alg") != "HS256":
            raise JWTError(f"unsupported alg: {header.get('alg')}")
        exp = claims.get("exp")
        if verify_exp and exp is not None:
            try:
                expired = time.time() > float(exp)
            except (TypeError, ValueError):
                raise JWTError("malformed exp claim")
            if expired:
                raise ExpiredTokenError("token expired")
        return claims
    except JWTError:
        raise
    except Exception as exc:  # absolute backstop
        raise JWTError(f"undecodable token: {type(exc).__name__}")


def create_access_token(
    subject: str, secret: str, expires_minutes: float = 30.0,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """A token with ``sub`` and ``exp`` claims (plus ``extra``)."""
    claims = {"sub": subject, "exp": time.time() + expires_minutes * 60.0}
    if extra:
        claims.update(extra)
    return encode(claims, secret)
