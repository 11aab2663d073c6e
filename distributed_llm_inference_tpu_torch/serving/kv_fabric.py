"""Cross-replica KV fabric: shadowed KV blocks as a WIRE format.

The JAX package's serving/kv_fabric.py, copied: it imports no jax, and
the port keeps its own copy (importing any module of the JAX package
would import jax). The wire is the JAX package's byte for byte, so a
blob one package encodes the other decodes.

The shadow store (engine/shadow.py) makes filled paged-KV blocks a
content-keyed, host-portable artifact for crash recovery and, with the
disk tier, a cache whose logical depth is bounded by disk. This module
makes that artifact a wire format, so N replicas' caches behave as one
logical cache: prefill-class replicas compute long prefixes,
decode-class replicas pull them by digest and run the token loop.

Pieces, all strictly host-side:

  * WIRE FORMAT: encode_chain/decode_chain serialize one shadow chain —
    parents-first blocks of one token prefix — as an npz blob: a JSON
    manifest (version, block_size, per-block token chunks) plus the
    stacked per-leaf KV arrays, the exact layout ShadowStore entries
    hold (engine/paged.pool_leaves order; the port carries bf16 as its
    int16 view). The manifest carries the TOKENS, not the digest: the
    fetcher recomputes the parent-chained digests (engine/block_prefix.
    chunk_digests) from the payload's own tokens and rejects any blob
    whose recomputed digest differs from the one it asked for. That
    content-key recheck is the whole consistency protocol — KV is a pure
    function of the token prefix under teacher forcing, so a verified
    chain is bit-identical to one computed locally, and a corrupt,
    truncated, or wrong-prefix payload can only produce a REJECTION
    (cold local prefill), never wrong output. A fetcher that passes its
    pool's leaf `layout` also refuses a verified chain whose leaves are
    not its pool's (another dtype, --kv-quant or width): such bytes are
    never reinterpreted.
  * STREAM FORMAT: encode_frame/decode_frame carry ONE block per frame —
    [8-byte big-endian length][npz: manifest {version, block_size,
    c: chunk tokens, d: claimed running digest} + per-leaf single-block
    arrays], terminated by a zero-length frame. The fetcher verifies the
    RUNNING parent-chained digest after every frame (early abort on the
    first bad one) and the final digest against the one it asked for, so
    a streamed chain meets exactly the whole-blob bar — but the importer
    can scatter block i into the pool while block i+1 is still on the
    wire (GET /kv/{digest} with X-KV-Stream: 1; old peers ignore the
    header and answer whole-blob, which the client detects by
    Content-Type and falls back to transparently).
  * SERVER: serve_chain(shadow, digest) -> npz bytes | None and
    serve_chain_stream(shadow, digest) -> (n_chunks, tier, frame iter) |
    None back the replica's GET /kv/{digest} route (serving/server.py);
    the stream side encodes chunk-at-a-time, so time-to-first-byte is
    O(1) in chain length. A miss — never resident, or churned out of
    every tier — is a 404 the fetcher treats as "prefill locally".
    decode_push validates a proactively POSTed chain against its OWN
    content key (the digest is recomputed from the payload's tokens, so
    a push needs no out-of-band name to be verifiable).
  * CLIENT: KVFabricClient.fetch / fetch_stream with a hard deadline —
    EVERY failure (connect refused on a killed peer, a wedged socket
    timing out, 404, a payload failing the recheck or the layout
    mid-stream) ends at None / FabricPayloadError and the fallback
    ladder ends at local re-prefill, never at an error. push_chain POSTs
    a finished chain to the decode peer at the prefill->decode handoff
    so the decode side never round-trips a pull. Counts
    dli_kv_fabric_{fetches,hits,misses}_total{role},
    dli_kv_fabric_bytes_total{role,tier} (tier = the SERVING tier at
    the peer — host|disk — or "push"), and
    dli_kv_fabric_fetch_seconds (families pre-registered by the engine;
    role = this replica's --replica-class). With a `store` (the
    replica's serving/trace_store.TraceStore) and a trace context, each
    pull records a `fabric.pull` span and each push a `fabric.push` span
    under the request's span.
"""

from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

from ..engine.block_prefix import chunk_digests
from ..utils.logging import get_logger, request_id_context

log = get_logger("kv_fabric")

WIRE_VERSION = 1

# stream framing: 8-byte big-endian length prefix per frame, zero-length
# frame terminates; Content-Type distinguishes streamed from whole-blob
STREAM_CONTENT_TYPE = "application/x-dli-kv-stream"
_FRAME_LEN = 8
_MAX_FRAME = 1 << 31  # sanity bound before allocating for a frame

# hex digests only (block_prefix.chunk_digests emits truncated sha1 hex);
# the /kv route validates against this so a probing client cannot make
# the digest index do arbitrary-string lookups
_DIGEST_CHARS = frozenset("0123456789abcdef")
MAX_DIGEST_LEN = 64


def valid_digest(digest: str) -> bool:
    return (
        0 < len(digest) <= MAX_DIGEST_LEN
        and all(c in _DIGEST_CHARS for c in digest)
    )


class FabricPayloadError(ValueError):
    """A /kv payload failed structural validation, the content-key
    recheck or the importer's leaf layout. Callers degrade to local
    prefill — never an error."""


def chain_digest(ids, block_size: int) -> Optional[str]:
    """The deepest parent-chained digest of `ids`' full blocks — the name
    a peer would serve this prefix under — or None when `ids` has no full
    block."""
    n = len(ids) // block_size
    if n <= 0:
        return None
    return chunk_digests(ids, block_size, max_chunks=n)[-1]


def check_layout(leaves, layout) -> None:
    """Refuse one block's leaves unless they are `layout`'s: a list of
    (numpy dtype, shape) per leaf, the importing pool's (None: no check).
    A chain from a replica of another dtype or --kv-quant verifies by its
    tokens but is not this pool's bytes: FabricPayloadError, a cold
    prefill, never a reinterpretation."""
    if layout is None:
        return
    got = [(np.dtype(a.dtype), tuple(a.shape)) for a in leaves]
    want = [(np.dtype(dt), tuple(shape)) for dt, shape in layout]
    if got != want:
        raise FabricPayloadError(
            f"chain leaves {[(str(d), s) for d, s in got]} are not this "
            f"pool's {[(str(d), s) for d, s in want]}"
        )


def encode_chain(block_size: int, keys: list, entries: list) -> bytes:
    """Serialize one parents-first chain. keys[i] is the token prefix
    block i completes (len == (i+1) * block_size, each extending the
    previous by one chunk); entries[i] carries .leaves — the per-leaf
    arrays in the pool's leaf order, exactly as the shadow store holds
    them."""
    if not keys:
        raise ValueError("encode_chain needs a non-empty chain")
    chunks = []
    for i, key in enumerate(keys):
        if len(key) != (i + 1) * block_size:
            raise ValueError(
                f"chain key {i} has {len(key)} tokens, expected "
                f"{(i + 1) * block_size}"
            )
        chunks.append([int(t) for t in key[-block_size:]])
    manifest = {
        "version": WIRE_VERSION,
        "block_size": int(block_size),
        "chunks": chunks,
    }
    arrays = {"manifest": np.array(json.dumps(manifest))}
    for j in range(len(entries[0].leaves)):
        arrays[f"leaf_{j}"] = np.stack([e.leaves[j] for e in entries])
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _parse_chain(data: bytes, block_size: int) -> tuple:
    """Structural half of chain validation (no digest comparison):
    parse + validate one wire blob, returning (keys, per_block_leaves,
    ids). Raises FabricPayloadError on any malformation."""
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            manifest = json.loads(str(z["manifest"]))
            leaves = []
            j = 0
            while f"leaf_{j}" in z.files:
                leaves.append(z[f"leaf_{j}"])
                j += 1
    except Exception as e:
        raise FabricPayloadError(f"unparseable /kv payload: {e}") from e
    if manifest.get("version") != WIRE_VERSION:
        raise FabricPayloadError(
            f"wire version {manifest.get('version')!r} != {WIRE_VERSION}"
        )
    if manifest.get("block_size") != block_size:
        raise FabricPayloadError(
            f"peer block_size {manifest.get('block_size')!r} != local "
            f"{block_size} — replicas must share --kv-block-size"
        )
    chunks = manifest.get("chunks") or []
    if not chunks or not leaves or any(
        leaf.shape[0] != len(chunks) for leaf in leaves
    ):
        raise FabricPayloadError("empty or ragged /kv payload")
    ids: list = []
    keys = []
    for chunk in chunks:
        if len(chunk) != block_size:
            raise FabricPayloadError("chunk length != block_size")
        ids.extend(int(t) for t in chunk)
        keys.append(tuple(ids))
    per_block = [
        [leaf[i] for leaf in leaves] for i in range(len(chunks))
    ]
    return keys, per_block, ids


def decode_chain(data: bytes, block_size: int,
                 expected_digest: str) -> tuple:
    """Parse + VERIFY one wire chain. Returns (keys, per_block_leaves):
    keys parents-first, per_block_leaves[i] the list of per-leaf arrays
    for block i (the put_host / restore-scatter layout).

    The content-key recheck: the parent-chained digest is recomputed
    from the payload's OWN token chunks and must equal the digest the
    caller fetched by. A tampered token, a truncated chain, a
    block-size mismatch, or a peer answering with the wrong prefix all
    land here as FabricPayloadError — the caller prefills locally."""
    keys, per_block, ids = _parse_chain(data, block_size)
    got = chunk_digests(ids, block_size, max_chunks=len(keys))[-1]
    if got != expected_digest:
        raise FabricPayloadError(
            f"content-key recheck failed: payload tokens digest to "
            f"{got}, fetched {expected_digest}"
        )
    return keys, per_block


def decode_push(data: bytes, block_size: int) -> tuple:
    """Validate a proactively PUSHED chain (POST /kv) against its OWN
    content key: the digest is recomputed from the payload's tokens —
    there is nothing external to compare against, and nothing needed;
    content keying means the payload names itself, and a tampered one
    simply names a prefix nobody will ever look up (plus the structural
    checks reject ragged/malformed blobs outright). Returns
    (digest, keys, per_block_leaves)."""
    keys, per_block, ids = _parse_chain(data, block_size)
    digest = chunk_digests(ids, block_size, max_chunks=len(keys))[-1]
    return digest, keys, per_block


def encode_frame(block_size: int, chunk, digest: str, leaves) -> bytes:
    """Serialize ONE stream frame (no length prefix): the block's own
    token chunk, the claimed RUNNING parent-chained digest through this
    block, and the per-leaf single-block arrays."""
    manifest = {
        "version": WIRE_VERSION,
        "block_size": int(block_size),
        "c": [int(t) for t in chunk],
        "d": str(digest),
    }
    arrays = {"manifest": np.array(json.dumps(manifest))}
    for j, leaf in enumerate(leaves):
        arrays[f"leaf_{j}"] = np.asarray(leaf)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_frame(data: bytes, block_size: int) -> tuple:
    """Parse one stream frame -> (chunk_tokens, claimed_digest, leaves).
    Structural checks only — the RUNNING digest comparison is the
    stream consumer's (it owns the accumulated token prefix)."""
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            manifest = json.loads(str(z["manifest"]))
            leaves = []
            j = 0
            while f"leaf_{j}" in z.files:
                leaves.append(np.array(z[f"leaf_{j}"]))
                j += 1
    except Exception as e:
        raise FabricPayloadError(f"unparseable /kv frame: {e}") from e
    if manifest.get("version") != WIRE_VERSION:
        raise FabricPayloadError(
            f"frame version {manifest.get('version')!r} != {WIRE_VERSION}"
        )
    if manifest.get("block_size") != block_size:
        raise FabricPayloadError(
            f"frame block_size {manifest.get('block_size')!r} != local "
            f"{block_size}"
        )
    chunk = manifest.get("c") or []
    digest = manifest.get("d") or ""
    if len(chunk) != block_size or not valid_digest(digest) or not leaves:
        raise FabricPayloadError("malformed /kv frame")
    return [int(t) for t in chunk], digest, leaves


def serve_chain(shadow, digest: str) -> Optional[bytes]:
    """The /kv route's whole-blob body: the resident chain ending at
    `digest`, wire-encoded, or None (-> 404) when not resident / not a
    valid digest."""
    if not valid_digest(digest):
        return None
    chain = shadow.chain_for_digest(digest)
    if chain is None:
        return None
    keys, entries = chain
    return encode_chain(shadow.block_size, keys, entries)


def serve_chain_stream(shadow, digest: str) -> Optional[tuple]:
    """The /kv route's STREAMED body: (n_chunks, tier, frame iterator)
    or None (-> 404). `tier` is where the chain tip was resident BEFORE
    this lookup promoted it ("host" | "disk" — the response's X-KV-Tier
    and the peer's bytes{tier} label). Frames are length-prefixed and
    encoded lazily, one block at a time, ending with the zero-length
    terminator — time-to-first-byte is O(1) in chain length."""
    if not valid_digest(digest):
        return None
    tier = shadow.digest_tier(digest) or "host"
    chain = shadow.chain_for_digest(digest)
    if chain is None:
        return None
    keys, entries = chain
    bs = shadow.block_size
    digests = chunk_digests(keys[-1], bs, max_chunks=len(keys))

    def frames():
        for i, (key, e) in enumerate(zip(keys, entries)):
            payload = encode_frame(bs, key[-bs:], digests[i], e.leaves)
            yield len(payload).to_bytes(_FRAME_LEN, "big") + payload
        yield (0).to_bytes(_FRAME_LEN, "big")

    return len(keys), tier, frames()


def _read_exact(r, n: int) -> bytes:
    """Read exactly n bytes from the response (r.read(n) may return
    short on a chunked socket) — short final read = truncated stream."""
    out = b""
    while len(out) < n:
        piece = r.read(n - len(out))
        if not piece:
            raise FabricPayloadError("truncated /kv stream")
        out += piece
    return out


class KVFabricClient:
    """One replica's fetching/pushing half of the fabric. Deadline'd,
    metric'd, and failure-silent: fetch()/fetch_stream()/push_chain()
    return the verified result or None."""

    def __init__(self, registry=None, role: str = "mixed",
                 timeout_s: float = 5.0):
        self.role = str(role)
        self.timeout_s = float(timeout_s)
        self.fetches = 0
        self.hits = 0
        self.misses = 0
        self.bytes = 0
        self.pushes = 0
        self.pushed_blocks = 0
        # serving tier of the last successful fetch (observability for
        # the single-threaded prefetch caller's flight event)
        self.last_tier = "host"
        self._m_fetches = self._m_hits = None
        self._m_misses = self._m_seconds = None
        self._m_bytes: dict = {}
        if registry is not None:
            self._m_fetches = registry.counter(
                "dli_kv_fabric_fetches_total",
                "cross-replica /kv chain fetches attempted", ("role",),
            ).labels(role=self.role)
            self._m_hits = registry.counter(
                "dli_kv_fabric_hits_total",
                "fabric fetches that returned a verified chain", ("role",),
            ).labels(role=self.role)
            self._m_misses = registry.counter(
                "dli_kv_fabric_misses_total",
                "fabric fetches that fell back to local prefill (404, "
                "dead/wedged peer, failed content-key recheck)", ("role",),
            ).labels(role=self.role)
            fam = registry.counter(
                "dli_kv_fabric_bytes_total",
                "wire bytes of verified fabric chains moved, by serving "
                "tier (host/disk = pull source at the peer, push = "
                "proactive POST /kv at the prefill->decode handoff)",
                ("role", "tier"),
            )
            for tier in ("host", "disk", "push"):
                self._m_bytes[tier] = fam.labels(role=self.role, tier=tier)
            self._m_seconds = registry.histogram(
                "dli_kv_fabric_fetch_seconds",
                "fabric fetch wall time, failures included",
            ).labels()

    def _account_link(self, nbytes: int, tier: str):
        """Count verified /kv wire bytes, by the serving tier at the peer
        (host | disk | push)."""
        self.bytes += int(nbytes)
        m = self._m_bytes.get(tier if tier in self._m_bytes else "host")
        if m is not None:
            m.inc(int(nbytes))

    def _headers(self, ctx, request_id, stream: bool = False) -> dict:
        headers = {}
        if ctx is not None:
            headers["traceparent"] = ctx.header()
        if request_id:
            headers["X-Request-Id"] = request_id
        if stream:
            headers["X-KV-Stream"] = "1"
        return headers

    def fetch(self, peer_url: str, digest: str, block_size: int,
              ctx=None, request_id=None, store=None,
              layout=None) -> Optional[tuple]:
        """GET {peer}/kv/{digest}, verify, return (keys, per_block_leaves)
        or None. Bounded by timeout_s end to end (a wedged peer costs one
        deadline, then the caller prefills locally). `layout` (the
        importing pool's, check_layout) refuses a chain of another
        configuration as a miss.

        `ctx` (a tracing.SpanContext) rides the request as a
        `traceparent` header so the serving peer's /kv span joins the
        same trace, `request_id` rides as X-Request-Id (echoed back by
        the peer), and `store` (a trace store, or None) records this
        side's `fabric.pull` span around the whole fetch."""
        self.fetches += 1
        if self._m_fetches is not None:
            self._m_fetches.inc()
        t0 = time.perf_counter()
        wall0 = time.time()
        ok = False
        tier = "host"
        with request_id_context(request_id, getattr(ctx, "trace_id", None)):
            try:
                if not valid_digest(digest):
                    raise FabricPayloadError(
                        f"invalid digest {digest[:80]!r}"
                    )
                url = peer_url.rstrip("/") + "/kv/" + digest
                req = urllib.request.Request(
                    url, headers=self._headers(ctx, request_id)
                )
                with urllib.request.urlopen(
                    req, timeout=self.timeout_s
                ) as r:
                    tier = r.headers.get("X-KV-Tier") or "host"
                    data = r.read()
                out = decode_chain(data, block_size, digest)
                for leaves in out[1]:
                    check_layout(leaves, layout)
                ok = True
            except FabricPayloadError as e:
                log.warning("kv_fabric_payload_rejected", peer=peer_url,
                            digest=digest, error=str(e))
                out = None
            except (urllib.error.URLError, urllib.error.HTTPError, OSError,
                    TimeoutError, ValueError) as e:
                # 404 (evicted / never resident), connect refused (peer
                # killed mid-handoff), socket timeout (wedged peer) —
                # all one outcome: prefill locally
                log.info("kv_fabric_miss", peer=peer_url, digest=digest,
                         error=str(e))
                out = None
            finally:
                if self._m_seconds is not None:
                    self._m_seconds.observe(time.perf_counter() - t0)
                if store is not None and ctx is not None:
                    store.add_span(
                        ctx.trace_id, "fabric.pull", wall0, time.time(),
                        parent_id=ctx.span_id,
                        attrs={
                            "peer": peer_url, "digest": str(digest)[:16],
                            "hit": ok, "streamed": False, "tier": tier,
                        },
                    )
        if not ok or out is None:
            self.misses += 1
            if self._m_misses is not None:
                self._m_misses.inc()
            return None
        self.hits += 1
        self.last_tier = tier
        self._account_link(len(data), tier)
        if self._m_hits is not None:
            self._m_hits.inc()
        return out

    def fetch_stream(self, peer_url: str, digest: str, block_size: int,
                     ctx=None, request_id=None, store=None,
                     layout=None) -> Optional[tuple]:
        """GET {peer}/kv/{digest} with X-KV-Stream: 1 — returns
        (n_chunks, tier, blocks_iter) or None (connect/404/invalid).
        blocks_iter yields (key, leaves) per block, parents-first, each
        verified against the RUNNING recomputed digest (and `layout`,
        check_layout) as it arrives (the final one against the digest
        asked for), and raises FabricPayloadError / OSError
        mid-iteration on tamper, truncation, a foreign layout or a died
        socket — the consumer discards everything it scattered (nothing
        was registered yet) and prefills locally. Fully consuming OR
        closing the iterator settles the hit/miss metrics and the
        `fabric.pull` span.

        A pre-stream peer ignores the header and answers whole-blob
        (Content-Type octet-stream): detected and decoded in one piece,
        then yielded block-at-a-time — same contract, no overlap."""
        self.fetches += 1
        if self._m_fetches is not None:
            self._m_fetches.inc()
        t0 = time.perf_counter()
        wall0 = time.time()
        if not valid_digest(digest):
            self.misses += 1
            if self._m_misses is not None:
                self._m_misses.inc()
            return None
        url = peer_url.rstrip("/") + "/kv/" + digest
        req = urllib.request.Request(
            url, headers=self._headers(ctx, request_id, stream=True)
        )
        try:
            r = urllib.request.urlopen(req, timeout=self.timeout_s)
        except (urllib.error.URLError, urllib.error.HTTPError, OSError,
                TimeoutError, ValueError) as e:
            log.info("kv_fabric_miss", peer=peer_url, digest=digest,
                     error=str(e))
            if self._m_seconds is not None:
                self._m_seconds.observe(time.perf_counter() - t0)
            self.misses += 1
            if self._m_misses is not None:
                self._m_misses.inc()
            return None
        streamed = (
            (r.headers.get("Content-Type") or "") == STREAM_CONTENT_TYPE
        )
        tier = r.headers.get("X-KV-Tier") or "host"
        try:
            n_chunks = max(0, int(r.headers.get("X-KV-Chain-Len") or 0))
        except ValueError:
            n_chunks = 0

        def blocks():
            ok = False
            nbytes = 0
            try:
                if not streamed:
                    # pre-stream peer: whole blob, verified in one piece
                    data = r.read()
                    nbytes = len(data)
                    keys, per_block = decode_chain(data, block_size, digest)
                    for leaves in per_block:
                        check_layout(leaves, layout)
                    for key, leaves in zip(keys, per_block):
                        yield key, leaves
                    ok = True
                    return
                ids: list = []
                deadline = time.monotonic() + self.timeout_s
                while True:
                    if time.monotonic() > deadline:
                        raise FabricPayloadError("/kv stream overran the "
                                                 "fetch deadline")
                    hdr = _read_exact(r, _FRAME_LEN)
                    length = int.from_bytes(hdr, "big")
                    if length == 0:
                        break  # clean terminator
                    if length > _MAX_FRAME:
                        raise FabricPayloadError("oversized /kv frame")
                    payload = _read_exact(r, length)
                    nbytes += _FRAME_LEN + length
                    chunk, claimed, leaves = decode_frame(
                        payload, block_size
                    )
                    ids.extend(chunk)
                    got = chunk_digests(
                        ids, block_size, max_chunks=len(ids) // block_size
                    )[-1]
                    if got != claimed:
                        raise FabricPayloadError(
                            f"running content-key recheck failed at chunk "
                            f"{len(ids) // block_size}: tokens digest to "
                            f"{got}, frame claims {claimed}"
                        )
                    check_layout(leaves, layout)
                    yield tuple(ids), leaves
                if not ids:
                    raise FabricPayloadError("empty /kv stream")
                final = chunk_digests(
                    ids, block_size, max_chunks=len(ids) // block_size
                )[-1]
                if final != digest:
                    raise FabricPayloadError(
                        f"content-key recheck failed: stream tokens digest "
                        f"to {final}, fetched {digest}"
                    )
                ok = True
            except FabricPayloadError as e:
                log.warning("kv_fabric_payload_rejected", peer=peer_url,
                            digest=digest, error=str(e))
                raise
            finally:
                try:
                    r.close()
                except OSError:
                    pass
                if self._m_seconds is not None:
                    self._m_seconds.observe(time.perf_counter() - t0)
                if ok:
                    self.hits += 1
                    self._account_link(nbytes, tier)
                    if self._m_hits is not None:
                        self._m_hits.inc()
                else:
                    self.misses += 1
                    if self._m_misses is not None:
                        self._m_misses.inc()
                if store is not None and ctx is not None:
                    store.add_span(
                        ctx.trace_id, "fabric.pull", wall0, time.time(),
                        parent_id=ctx.span_id,
                        attrs={
                            "peer": peer_url, "digest": str(digest)[:16],
                            "hit": ok, "streamed": streamed, "tier": tier,
                        },
                    )

        return n_chunks, tier, blocks()

    def push_chain(self, peer_url: str, data: bytes, ctx=None,
                   request_id=None, store=None) -> Optional[int]:
        """POST {peer}/kv — proactively hand a finished wire-encoded
        chain to the decode peer at the prefill->decode handoff, so its
        admission finds the prefix already host-resident instead of
        round-tripping a pull. Returns the peer's accepted block count,
        or None on ANY failure (the pull path remains the fallback —
        a failed push costs nothing but this deadline)."""
        self.pushes += 1
        wall0 = time.time()
        accepted = None
        with request_id_context(request_id, getattr(ctx, "trace_id", None)):
            try:
                url = peer_url.rstrip("/") + "/kv"
                headers = self._headers(ctx, request_id)
                headers["Content-Type"] = "application/octet-stream"
                req = urllib.request.Request(
                    url, data=data, headers=headers, method="POST"
                )
                with urllib.request.urlopen(
                    req, timeout=self.timeout_s
                ) as r:
                    body = json.loads(r.read().decode("utf-8"))
                accepted = int(body.get("accepted", 0))
                self.pushed_blocks += accepted
                self._account_link(len(data), "push")
            except (urllib.error.URLError, urllib.error.HTTPError, OSError,
                    TimeoutError, ValueError) as e:
                log.info("kv_fabric_push_failed", peer=peer_url,
                         error=str(e))
            finally:
                if store is not None and ctx is not None:
                    store.add_span(
                        ctx.trace_id, "fabric.push", wall0, time.time(),
                        parent_id=ctx.span_id,
                        attrs={
                            "peer": peer_url, "bytes": len(data),
                            "accepted": -1 if accepted is None else accepted,
                        },
                    )
        return accepted

    def stats(self) -> dict:
        return {
            "role": self.role,
            "fetches": self.fetches,
            "hits": self.hits,
            "misses": self.misses,
            "bytes": self.bytes,
            "pushes": self.pushes,
            "pushed_blocks": self.pushed_blocks,
            "timeout_s": self.timeout_s,
        }
