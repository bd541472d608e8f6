"""Per-session wire auth: HMAC-signed session tokens, verified at admission.

A multi-tenant serving tier that shares one device pipeline across clients
needs an identity check BEFORE any shared resource is touched: a bad or
missing credential must cost the attacker one admission decision, not a
queue slot, a doc slot, or a device round.  The scheme here is the
smallest honest one:

* a :class:`SessionKeyring` holds named HMAC-SHA256 keys; exactly one is
  the **minting** key, any number are **accepted** for verification;
* a token is ``kid.hex(hmac(key_kid, client))`` — it binds the CLIENT
  identity (the string a session is opened under), so a token leaked from
  one tenant cannot open sessions as another;
* the mux verifies at ``open_session`` (session admission) and — when
  ``auth_per_frame`` — at every ``submit``; failure is the typed
  ``shed(reason="unauthorized")`` verdict, counted like every other shed.

**Key rotation without dropping live sessions**:
:meth:`SessionKeyring.rotate` installs a new minting key while keeping the
old key in the accepted set — tokens minted before the rotation keep
verifying, so live sessions (and per-frame-auth clients that cached their
token) ride through the rotation untouched.  :meth:`retire` removes a key
from the accepted set once its tokens are known-drained; only THEN do its
tokens start shedding ``unauthorized``.

Timing discipline: verification uses ``hmac.compare_digest`` (constant
time in the token length), and an unknown ``kid`` takes the same comparison
path against a dummy key so key-name probing learns nothing.
"""

from __future__ import annotations

import hmac
import hashlib
from typing import Dict, List, Optional

_DIGEST = hashlib.sha256
#: compared against when the token names an unknown key: the code path
#: (one HMAC + one compare_digest) is identical to the known-key path
_DUMMY_KEY = b"\x00" * 32


def _sig(key: bytes, client: str) -> str:
    return hmac.new(key, client.encode("utf-8"), _DIGEST).hexdigest()


class AuthError(ValueError):
    """Keyring misuse (unknown/duplicate key id) — an operator error, never
    the verdict path (bad TOKENS shed typed, they do not raise)."""


class SessionKeyring:
    """Named HMAC keys with one minting key and an accepted set (see
    module doc).  ``keys`` maps key id -> secret bytes; ``minting``
    defaults to the first (sorted) key id."""

    def __init__(self, keys: Dict[str, bytes],
                 minting: Optional[str] = None) -> None:
        if not keys:
            raise AuthError("a keyring needs at least one key")
        self._keys: Dict[str, bytes] = {
            str(k): bytes(v) for k, v in keys.items()
        }
        self._minting = minting if minting is not None else sorted(self._keys)[0]
        if self._minting not in self._keys:
            raise AuthError(f"minting key {self._minting!r} not in keyring")
        self.verified = 0
        self.rejected = 0
        self.rotations = 0

    # -- lifecycle ------------------------------------------------------------

    @property
    def minting_key_id(self) -> str:
        return self._minting

    def key_ids(self) -> List[str]:
        return sorted(self._keys)

    def rotate(self, kid: str, secret: bytes) -> None:
        """Install ``kid`` as the NEW minting key.  Every previously
        accepted key stays accepted — tokens minted before the rotation
        keep verifying, so no live session drops."""
        kid = str(kid)
        if kid in self._keys:
            raise AuthError(f"key {kid!r} already in keyring")
        self._keys[kid] = bytes(secret)
        self._minting = kid
        self.rotations += 1

    def retire(self, kid: str) -> None:
        """Remove ``kid`` from the accepted set (its tokens start shedding
        ``unauthorized``).  The minting key cannot be retired — rotate
        first."""
        kid = str(kid)
        if kid == self._minting:
            raise AuthError("cannot retire the minting key; rotate first")
        if kid not in self._keys:
            raise AuthError(f"unknown key {kid!r}")
        del self._keys[kid]

    # -- tokens ---------------------------------------------------------------

    def mint(self, client: str) -> str:
        """A session token for ``client`` under the current minting key."""
        return f"{self._minting}.{_sig(self._keys[self._minting], client)}"

    def verify(self, client: str, token: Optional[str]) -> bool:
        """Whether ``token`` authorizes ``client``.  Never raises on bad
        input — a malformed token is just unauthorized."""
        if not token or "." not in token:
            self.rejected += 1
            return False
        kid, _, sig = token.partition(".")
        key = self._keys.get(kid, _DUMMY_KEY)
        ok = hmac.compare_digest(_sig(key, client), sig) and kid in self._keys
        if ok:
            self.verified += 1
        else:
            self.rejected += 1
        return ok

    def snapshot(self) -> Dict:
        """JSON-serializable keyring state — key IDS only, never secrets
        (the mux snapshot's ``auth`` section)."""
        return {
            "keys": self.key_ids(),
            "minting": self._minting,
            "verified": self.verified,
            "rejected": self.rejected,
            "rotations": self.rotations,
        }
