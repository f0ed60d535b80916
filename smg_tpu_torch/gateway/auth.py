"""Auth: API keys with roles, HMAC- and RSA-signed bearer tokens, audit log.

Reference: ``crates/auth`` (smg-auth, ``src/lib.rs:1-20``) — control-plane
JWT/OIDC + API keys with roles + audit (SURVEY.md §2.2).  OIDC/JWKS:
RS256 verification against a JWKS document through an INJECTABLE fetcher —
discovery needs egress, so deployments hand the verifier a callable that
reads ``{issuer}/.well-known/jwks.json`` (and tests hand it fakes); key
rotation is handled by one forced refresh on an unknown ``kid``.  The RSA
signature check is pure Python (modular exponentiation + PKCS1-v1_5
padding) — no crypto-library dependency at runtime.

The port's copy of ``smg_tpu/gateway/auth.py``, unchanged but for its imports.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field

from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.auth")


@dataclass
class Principal:
    id: str
    roles: tuple[str, ...] = ("user",)
    tenant: str = "default"


@dataclass
class AuthConfig:
    enabled: bool = False
    api_keys: dict[str, Principal] = field(default_factory=dict)  # key -> principal
    jwt_secret: str | None = None  # enables HS256 bearer verification
    jwks: "JwksVerifier | None" = None  # enables RS256/OIDC bearer verification
    # routes that skip auth (probes)
    public_paths: tuple[str, ...] = ("/health", "/liveness", "/readiness",
                                     "/metrics")


class AuthError(Exception):
    def __init__(self, message: str, status: int = 401):
        super().__init__(message)
        self.status = status
        self.message = message


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def verify_hs256(token: str, secret: str) -> dict:
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
    except ValueError:
        raise AuthError("malformed token")
    try:
        header = json.loads(_b64url_decode(header_b64))
        if header.get("alg") != "HS256":
            raise AuthError(f"unsupported alg {header.get('alg')}")
        expected = hmac.new(
            secret.encode(), f"{header_b64}.{payload_b64}".encode(), hashlib.sha256
        ).digest()
        if not hmac.compare_digest(expected, _b64url_decode(sig_b64)):
            raise AuthError("bad signature")
        payload = json.loads(_b64url_decode(payload_b64))
    except AuthError:
        raise
    except Exception:
        # malformed base64/JSON anywhere in the token is a credential error
        raise AuthError("malformed token")
    if "exp" in payload and payload["exp"] < time.time():
        raise AuthError("token expired")
    return payload


# ---- RS256 / JWKS (OIDC) ----

#: DER DigestInfo prefix for SHA-256 (RFC 8017 §9.2 notes)
_SHA256_DIGEST_INFO = bytes.fromhex(
    "3031300d060960864801650304020105000420"
)


def _rsa_pkcs1_verify(signing_input: bytes, sig: bytes, n: int, e: int) -> bool:
    """RSASSA-PKCS1-v1_5 / SHA-256 verification by modular exponentiation."""
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n)
    em = m.to_bytes(k, "big")
    digest = hashlib.sha256(signing_input).digest()
    expected = (
        b"\x00\x01"
        + b"\xff" * (k - 3 - len(_SHA256_DIGEST_INFO) - len(digest))
        + b"\x00" + _SHA256_DIGEST_INFO + digest
    )
    return hmac.compare_digest(em, expected)


class JwksVerifier:
    """RS256 bearer verification against a JWKS document.

    ``fetcher`` is a zero-arg callable returning the parsed JWKS dict
    (``{"keys": [{"kty": "RSA", "kid": ..., "n": ..., "e": ...}, ...]}``).
    Keys cache for ``cache_ttl`` seconds; an unknown ``kid`` forces ONE
    refresh (standard IdP key rotation) before failing."""

    def __init__(self, fetcher, issuer: str | None = None,
                 audience: str | None = None, cache_ttl: float = 300.0,
                 min_refresh_interval: float = 10.0):
        self.fetcher = fetcher
        self.issuer = issuer
        self.audience = audience
        self.cache_ttl = cache_ttl
        # rotation-refresh cooldown: unauthenticated garbage kids must not
        # turn every request into a blocking IdP fetch
        self.min_refresh_interval = min_refresh_interval
        self._keys: dict[str, tuple[int, int]] = {}
        self._fetched_at = 0.0  # last SUCCESSFUL fetch (TTL)
        self._last_attempt = -1e9  # last fetch attempt incl. failures (cooldown)

    def _refresh(self) -> None:
        # the attempt timestamp moves even on failure: an IdP outage must
        # not turn every request (incl. garbage tokens) into blocking
        # fetches — the cooldown negative-caches the failure
        self._last_attempt = time.monotonic()
        doc = self.fetcher()
        keys: dict[str, tuple[int, int]] = {}
        for jwk in (doc or {}).get("keys", []):
            if jwk.get("kty") != "RSA" or "n" not in jwk or "e" not in jwk:
                continue
            n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
            e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
            keys[jwk.get("kid", "")] = (n, e)
        self._keys = keys
        self._fetched_at = time.monotonic()

    def _cooled(self) -> bool:
        return time.monotonic() - self._last_attempt > self.min_refresh_interval

    def _refresh_background(self) -> None:
        """Off-request refresh: a slow IdP must not stall the event loop
        (the fetcher may be blocking I/O).  One thread at a time."""
        import threading

        if getattr(self, "_refreshing", False):
            return
        self._refreshing = True
        self._last_attempt = time.monotonic()

        def run():
            try:
                self._refresh()
            except Exception as e:
                logger.warning("JWKS background refresh failed: %s", e)
            finally:
                self._refreshing = False

        threading.Thread(target=run, daemon=True, name="jwks-refresh").start()

    def _key_for(self, kid: str) -> "tuple[int, int] | None":
        now = time.monotonic()
        stale = not self._keys or now - self._fetched_at > self.cache_ttl
        if stale and self._cooled():
            if self._keys:
                # serve the cached keys; refresh off-loop (TTL expiry must
                # not block the request on IdP latency)
                self._refresh_background()
            else:
                # cold start: nothing to serve yet — this one blocks
                try:
                    self._refresh()
                except Exception as e:
                    logger.warning("JWKS fetch failed: %s", e)
        if kid not in self._keys and self._cooled():
            # rotation: the IdP may have published a new key since our
            # cache.  SYNCHRONOUS on purpose — the newly rotated token must
            # verify on its first presentation; the cooldown bounds how
            # often unknown kids can force this blocking fetch
            try:
                self._refresh()
            except Exception as e:
                logger.warning("JWKS refresh failed: %s", e)
        return self._keys.get(kid)

    def verify(self, token: str) -> dict:
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url_decode(header_b64))
        except Exception:
            raise AuthError("malformed token")
        if header.get("alg") != "RS256":
            raise AuthError(f"unsupported alg {header.get('alg')}")
        key = self._key_for(header.get("kid", ""))
        if key is None:
            raise AuthError("unknown key id")
        try:
            sig = _b64url_decode(sig_b64)
            payload = json.loads(_b64url_decode(payload_b64))
        except Exception:
            raise AuthError("malformed token")
        if not _rsa_pkcs1_verify(
            f"{header_b64}.{payload_b64}".encode(), sig, key[0], key[1]
        ):
            raise AuthError("bad signature")
        if "exp" in payload and payload["exp"] < time.time():
            raise AuthError("token expired")
        if self.issuer is not None and payload.get("iss") != self.issuer:
            raise AuthError("wrong issuer", 403)
        if self.audience is not None:
            aud = payload.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise AuthError("wrong audience", 403)
        return payload


def _jwt_alg(token: str) -> str | None:
    """Peek a bearer token's JOSE header alg (None = not a JWT)."""
    parts = token.split(".")
    if len(parts) != 3:
        return None
    try:
        return json.loads(_b64url_decode(parts[0])).get("alg")
    except Exception:
        return None


class Authenticator:
    def __init__(self, config: AuthConfig):
        self.config = config
        self.audit: list[dict] = []  # bounded audit ring

    def authenticate(self, path: str, headers) -> Principal | None:
        """Returns the principal, or None when auth is disabled/public.
        Raises AuthError when credentials are missing/invalid."""
        if not self.config.enabled or path in self.config.public_paths:
            return None
        if path.startswith("/v1/realtime") and path != "/v1/realtime/client_secrets":
            # realtime WS handshakes enforce their own credential check
            # in-handler (ephemeral client secrets ride the query string —
            # browsers can't set WS headers); minting a secret still
            # authenticates normally
            return None
        authz = headers.get("Authorization", "")
        api_key = headers.get("X-API-Key") or (
            authz[7:] if authz.startswith("Bearer ") else None
        )
        if not api_key:
            raise AuthError("missing credentials")
        principal = self.config.api_keys.get(api_key)
        if principal is None:
            alg = _jwt_alg(api_key)
            payload = None
            if alg == "RS256" and self.config.jwks is not None:
                payload = self.config.jwks.verify(api_key)
            elif alg == "HS256" and self.config.jwt_secret:
                payload = verify_hs256(api_key, self.config.jwt_secret)
            if payload is not None:
                principal = Principal(
                    id=str(payload.get("sub", "jwt-user")),
                    roles=tuple(payload.get("roles", ["user"])),
                    tenant=str(payload.get("tenant", "default")),
                )
        if principal is None:
            self._audit("denied", path, None)
            raise AuthError("invalid credentials", 403)
        self._audit("allowed", path, principal)
        return principal

    def _audit(self, outcome: str, path: str, principal: Principal | None) -> None:
        self.audit.append(
            {
                "ts": time.time(),
                "outcome": outcome,
                "path": path,
                "principal": principal.id if principal else None,
            }
        )
        if len(self.audit) > 10000:
            del self.audit[:5000]
