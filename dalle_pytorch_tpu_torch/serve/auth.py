"""The token check behind the server's ``/admin/*`` endpoints.

Port of ``dalle_pytorch_tpu/serve/auth.py``: a constant-time comparison
(no timing oracle on the token's bytes), strings only, and an EMPTY
expected token always refuses.
"""

from __future__ import annotations

import hmac
from typing import Mapping


def check_token(provided, expected) -> bool:
    """Constant-time token check. False for non-strings and for an
    empty ``expected`` — absence of a configured secret is a refusal,
    never a wildcard."""
    if not isinstance(provided, str) or not isinstance(expected, str):
        return False
    if not expected:
        return False
    return hmac.compare_digest(provided, expected)


def http_token(headers: Mapping[str, str],
               fallback_header: str = "X-Admin-Token") -> str:
    """Extract the caller's token from HTTP headers: ``Authorization:
    Bearer <token>`` wins, else the fallback header (``X-Admin-Token``
    for admin surfaces, ``X-API-Key`` for gateway tenants). Returns
    ``""`` when neither is present — which ``check_token`` refuses."""
    auth = headers.get("Authorization", "") or ""
    if auth.startswith("Bearer "):
        return auth[7:]
    return headers.get(fallback_header) or ""


def check_http(headers: Mapping[str, str], expected: str,
               fallback_header: str = "X-Admin-Token") -> bool:
    """The composed form every HTTP handler wants: pull the token out
    of ``headers``, compare against ``expected``."""
    return check_token(http_token(headers, fallback_header), expected)
