"""Crash-safe KV handoff between a prefill engine and a decode engine: the
port's own copy of ``ray_tpu/serve/handoff.py``.

A prefill-role engine runs the prompt, samples the first token and
EXPORTS the slot's K/V (trimmed to the true prompt length) instead of
keeping the slot; a decode-role engine IMPORTS those bytes into its own
pool and decodes the rest.

- **Payloads** are self-verifying: :func:`build_payload` stamps a SHA-256
  digest over the K/V bytes and every replay-relevant field, and
  :func:`verify_payload` re-hashes on the importing side. A torn or
  corrupted payload degrades to a local re-prefill (the stream is a
  deterministic function of prompt, knobs and seed), never a wrong cache.
  The digest is the reference's, over the same bytes in the same order,
  so payloads and digests are byte-equal across the two packages.
- **Leases** bound a shipped payload's lifetime: the prefill engine
  grants an epoch-stamped lease per handoff; a decode engine that claims
  in time releases it, and the sweep run from the prefill engine's driver
  loop reclaims the rest at expiry.

The port has no object plane: every payload ships inline in its
descriptor, which is what the reference does when no runtime is running
(``handoff.py:159-201``). A descriptor that names an object-plane
``ref`` cannot be resolved here and raises :class:`HandoffError`, so the
importer falls back to a local prefill.

Wire format of bfloat16 K/V: numpy has no bfloat16, so the port ships a
bfloat16 pool's K/V as ``np.uint16`` bit patterns. The bytes, and so the
digest, are the reference's (whose arrays are ``ml_dtypes.bfloat16``);
the port's import views either form's bits
(:func:`~ray_tpu_torch.models.gpt_decode.kv_from_host`).
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np


class HandoffError(RuntimeError):
    """A shipped KV payload could not be resolved or verified (no inline
    payload, bytes that fail the digest, a shape or layout this engine
    cannot take). Always recoverable: the descriptor carries prompt and
    seed, so the importer falls back to a local re-prefill that is
    token-identical by determinism."""


#: The reference's inline/object-plane threshold. The port ships every
#: payload inline whatever its size; the constant is kept so that code
#: written against the reference's module reads the same.
SHIP_INLINE_MAX = 64 * 1024


def _meta_bytes(payload: Dict[str, Any]) -> bytes:
    return (f"pos={int(payload['pos'])};first={int(payload['first'])};"
            f"seed={int(payload['seed'])};"
            f"max_new={int(payload['max_new'])}").encode()


def payload_digest(payload: Dict[str, Any]) -> str:
    """SHA-256 over the shipped K/V bytes and every replay-relevant field
    (``handoff.py:61``): K, V, the prompt (int32), the PRNG lane
    (uint32), the meta string; for int8 payloads also the per-page
    scales and the layout identity (``kv_dtype``, ``page_size``); a
    non-canonical ``layout`` stamp last."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(payload["k"]).tobytes())
    h.update(np.ascontiguousarray(payload["v"]).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(payload["prompt"], np.int32)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(payload["rng"], np.uint32)).tobytes())
    h.update(_meta_bytes(payload))
    if payload.get("ks") is not None:
        h.update(np.ascontiguousarray(
            np.asarray(payload["ks"], np.float32)).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(payload["vs"], np.float32)).tobytes())
        h.update((f"kv_dtype={payload.get('kv_dtype', 'int8')};"
                  f"page_size={int(payload.get('page_size', 0))}"
                  ).encode())
    if payload.get("layout", "canonical") != "canonical":
        h.update(f"layout={payload['layout']}".encode())
    return h.hexdigest()


def build_payload(*, k: np.ndarray, v: np.ndarray, prompt: np.ndarray,
                  pos: int, first: int, rng: np.ndarray, seed: int,
                  max_new: int, ks: Optional[np.ndarray] = None,
                  vs: Optional[np.ndarray] = None,
                  kv_dtype: Optional[str] = None,
                  page_size: Optional[int] = None,
                  layout: Optional[str] = None) -> Dict[str, Any]:
    """One ship buffer (``handoff.py:100``): the slot's K/V trimmed to
    ``pos`` (``[L, pos, H, hd]``, contiguous), the first sampled token,
    the post-prefill PRNG lane and the replay identity (prompt, seed,
    max_new). int8 exporters add the codes' per-page scales ``ks``/``vs``
    (``[L, n_cover, H]``) and the layout identity. Stamped with its
    digest."""
    payload = {
        "k": np.ascontiguousarray(k),
        "v": np.ascontiguousarray(v),
        "prompt": np.ascontiguousarray(np.asarray(prompt, np.int32)),
        "pos": int(pos),
        "first": int(first),
        "rng": np.ascontiguousarray(np.asarray(rng, np.uint32)),
        "seed": int(seed),
        "max_new": int(max_new),
    }
    if ks is not None:
        payload["ks"] = np.ascontiguousarray(np.asarray(ks, np.float32))
        payload["vs"] = np.ascontiguousarray(np.asarray(vs, np.float32))
        payload["kv_dtype"] = str(kv_dtype or "int8")
        payload["page_size"] = int(page_size or 0)
    if layout is not None and layout != "canonical":
        payload["layout"] = str(layout)
    payload["digest"] = payload_digest(payload)
    return payload


def verify_payload(payload: Dict[str, Any]) -> None:
    """Byte-verify a resolved payload against its stamped digest."""
    want = payload.get("digest")
    if not want:
        raise HandoffError("handoff payload carries no digest")
    got = payload_digest(payload)
    if got != want:
        raise HandoffError(
            f"handoff payload failed byte verification "
            f"(digest {got[:12]} != shipped {want[:12]})")


def payload_nbytes(payload: Dict[str, Any]) -> int:
    n = int(payload["k"].nbytes) + int(payload["v"].nbytes)
    if payload.get("ks") is not None:
        n += int(payload["ks"].nbytes) + int(payload["vs"].nbytes)
    return n


def ship_payload(payload: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """A payload's wire half of the descriptor: always inline here (the
    port has no object plane). Returns ``(fields, nbytes)``; ``fields``
    carries ``payload``, and the caller merges the lease and routing
    fields on top."""
    return {"payload": payload}, payload_nbytes(payload)


def resolve_payload(desc: Dict[str, Any],
                    timeout_s: float = 30.0) -> Dict[str, Any]:
    """A descriptor's payload: its inline copy. A descriptor with only
    an object-plane ``ref`` (shipped by an engine under the reference's
    runtime), or with neither, raises :class:`HandoffError`, and the
    caller falls back to a local re-prefill. ``timeout_s`` is accepted
    for the reference's signature; an inline payload never waits."""
    if "payload" in desc:
        return desc["payload"]
    if desc.get("ref") is not None:
        raise HandoffError(
            "handoff descriptor names an object-plane ref; this package "
            "has no object plane, so only inline payloads resolve")
    raise HandoffError("handoff descriptor has neither payload nor ref")


class HandoffLease:
    """One granted handoff: the pin keeping the shipped payload alive
    (None for inline ships), its epoch stamp, and its expiry on the
    lease clock."""

    __slots__ = ("lease_id", "epoch", "expires_at", "pin", "nbytes")

    def __init__(self, lease_id: str, epoch: int, expires_at: float,
                 pin: Any, nbytes: int):
        self.lease_id = lease_id
        self.epoch = epoch
        self.expires_at = expires_at
        self.pin = pin
        self.nbytes = nbytes


class LeaseTable:
    """Epoch-stamped lease bookkeeping for shipped KV payloads
    (``handoff.py:222``). The prefill engine grants a lease per handoff;
    :meth:`claim` (the decode side imported) and :meth:`sweep` (expired
    unclaimed) each drop it exactly once. Used from the engine's driver
    thread (grant, sweep) and from callers' threads (claim), so every
    mutation holds ``_lock``."""

    def __init__(self, ttl_s: float = 30.0):
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._leases: Dict[str, HandoffLease] = {}
        self._counter = 0
        self.granted = 0
        self.claimed = 0
        self.reclaimed = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._leases)

    def grant(self, *, epoch: int, pin: Any = None, nbytes: int = 0,
              ttl_s: Optional[float] = None) -> Tuple[str, float]:
        """Grant one lease; returns ``(lease_id, expires_at)`` (monotonic
        clock)."""
        ttl = self.ttl_s if ttl_s is None else float(ttl_s)
        with self._lock:
            self._counter += 1
            lease_id = f"ho-{self._counter}-{epoch}"
            expires = time.monotonic() + ttl
            self._leases[lease_id] = HandoffLease(
                lease_id, int(epoch), expires, pin, int(nbytes))
            self.granted += 1
        return lease_id, expires

    def claim(self, lease_id: str, epoch: int) -> bool:
        """Release a lease after a successful import. False when the
        lease is unknown (already swept) or its epoch does not match (a
        stale claim from before a restart)."""
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or lease.epoch != int(epoch):
                return False
            del self._leases[lease_id]
            self.claimed += 1
            lease.pin = None
            return True

    def sweep(self, now: Optional[float] = None) -> int:
        """Reclaim every lease past expiry at ``now`` (default: the
        monotonic clock); returns how many."""
        now = time.monotonic() if now is None else now
        with self._lock:
            expired = [lid for lid, lease in self._leases.items()
                       if lease.expires_at <= now]
            for lid in expired:
                self._leases.pop(lid).pin = None
            self.reclaimed += len(expired)
        return len(expired)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"granted": self.granted, "claimed": self.claimed,
                    "reclaimed": self.reclaimed,
                    "outstanding": len(self._leases)}
