"""Minimal S3-protocol :class:`~pagerank_tpu_torch.utils.fsio.FileSystem`.

The reference's literal inputs are 301 ``s3n://`` Common Crawl URIs and
its output an S3 bucket (``Sparky.java:44-58,237``),
resolved by Hadoop's S3 client. This module is the build's concrete
object-store backend for that seam: a dependency-free (stdlib
``http.client``) REST client speaking the S3 wire protocol —
GET/PUT/HEAD/DELETE objects, ListObjectsV2 with prefix/delimiter
pagination, server-side COPY — against a configurable endpoint, with
optional AWS Signature V4 request signing when credentials are present
(anonymous requests otherwise, for stubs and open buckets).

Endpoint/credentials resolve from the environment
(``PAGERANK_TPU_S3_ENDPOINT``, ``AWS_ACCESS_KEY_ID``,
``AWS_SECRET_ACCESS_KEY``, ``AWS_REGION``); when the endpoint variable
is set, ``s3://``/``s3n://``/``s3a://`` paths auto-register through
:func:`pagerank_tpu_torch.utils.fsio.get_fs` — every loader and sink (edge
lists, SequenceFile segments, snapshots, text dumps, metrics JSONL)
then reads and writes S3 URIs with no further wiring. In this
zero-egress environment the protocol is exercised against an in-process
HTTP stub server (tests/s3stub.py + tests/test_s3.py); the signer is
additionally pinned to the published AWS SigV4 test vector.

Addressing is path-style (``endpoint/bucket/key``) — what MinIO/stub
servers and most private object stores speak.

Copy of ``pagerank_tpu/utils/s3.py``, under the same
``PAGERANK_TPU_S3_ENDPOINT`` variable, so one deployment drives both
packages.
"""

from __future__ import annotations

import binascii
import datetime
import hashlib
import hmac
import http.client
import io
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Tuple
from xml.sax.saxutils import escape as ET_escape

from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.utils import fsio
from pagerank_tpu_torch.utils.retry import RetryPolicy, RetryStats

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()

#: HTTP statuses that retry (AWS transient classes): 500 InternalError,
#: 502, 503 SlowDown/ServiceUnavailable, 504. Everything else is
#: semantic (404 NoSuchKey, 403, 400 InvalidPart, ...) and must surface
#: immediately — retrying a permission error only hides it.
RETRYABLE_STATUSES = (500, 502, 503, 504)


class _TransientStatus(Exception):
    """Internal: a response whose status is in RETRYABLE_STATUSES,
    raised inside the retry loop so the policy re-attempts it; when the
    budget runs out the LAST response is returned to the caller, whose
    normal error path (_raise) then reports it."""

    def __init__(self, result):
        super().__init__(f"transient HTTP {result[0]}")
        self.result = result


def _s3_retryable(exc: BaseException) -> bool:
    """The S3 retry matrix's exception half (docs/ROBUSTNESS.md):
    transient statuses, connection reset / refused / broken pipe
    (ConnectionError), timeouts, truncated or malformed responses
    (http.client.HTTPException covers IncompleteRead, BadStatusLine,
    RemoteDisconnected), and socket-level OSErrors. Inside one HTTP
    transaction no semantic OSError (FileNotFoundError etc.) can arise
    — those are raised AFTER the response, outside the retry scope."""
    return isinstance(
        exc, (_TransientStatus, http.client.HTTPException, OSError)
    )


def sign_v4(
    method: str,
    host: str,
    path: str,
    query: str,
    headers: Dict[str, str],
    payload_hash: str,
    *,
    region: str,
    access_key: str,
    secret_key: str,
    amzdate: str,
    service: str = "s3",
) -> str:
    """AWS Signature Version 4 ``Authorization`` header value.

    Pure function of its inputs (``amzdate`` = ``YYYYMMDDTHHMMSSZ``) so
    it can be pinned against AWS's published test vector
    (tests/test_s3.py::test_sigv4_aws_reference_vector). ``headers``
    must already include ``host`` and ``x-amz-date``.
    """
    datestamp = amzdate[:8]
    # Canonical request: URI-encoded path (segments only), sorted
    # canonical query, sorted lowercase headers.
    canon_path = urllib.parse.quote(path, safe="/") or "/"
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    canon_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(pairs)
    )
    items = sorted((k.lower(), " ".join(v.split())) for k, v in headers.items())
    canon_headers = "".join(f"{k}:{v}\n" for k, v in items)
    signed = ";".join(k for k, _ in items)
    canonical = "\n".join(
        [method, canon_path, canon_query, canon_headers, signed, payload_hash]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join(
        ["AWS4-HMAC-SHA256", amzdate, scope,
         hashlib.sha256(canonical.encode()).hexdigest()]
    )

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    return (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}"
    )


def _local(tag: str) -> str:
    """XML tag name with any namespace prefix stripped."""
    return tag.rsplit("}", 1)[-1]


def _find_text(root: Optional[ET.Element], tag: str) -> Optional[str]:
    """Text of the first element named ``tag`` (namespace-agnostic)."""
    for el in root.iter() if root is not None else ():
        if _local(el.tag) == tag:
            return el.text
    return None


def _header(headers: Dict[str, str], name: str) -> Optional[str]:
    """Case-insensitive response-header lookup."""
    return {k.lower(): v for k, v in headers.items()}.get(name)


def _split_uri(path: str) -> Tuple[str, str]:
    """``s3://bucket/key`` -> (bucket, key). Key may be empty."""
    scheme = fsio.scheme_of(path)
    if scheme is None:
        raise ValueError(f"not an object-store URI: {path!r}")
    rest = path[len(scheme) + 3:]
    bucket, _, key = rest.partition("/")
    if not bucket:
        raise ValueError(f"S3 URI has no bucket: {path!r}")
    return bucket, key


class _RangedReader(io.RawIOBase):
    """Seekable read-only stream over one S3 object via Range requests.

    Wrapped in an ``io.BufferedReader`` so sequential consumers fetch
    ~1 MB chunks and whole-file ``read()`` collapses to a single
    ranged GET (``readall``); seek+small-read consumers (zipfile /
    np.load on snapshot .npz) fetch only the regions they touch.

    ``head`` seeds the reader with the object's first bytes (the
    open() probe request already fetched them). If the server ever
    answers a range request with the FULL object (200: Range ignored),
    the body is cached and all further reads are served locally — never
    re-fetch a whole object per read call."""

    def __init__(self, fs: "S3FileSystem", path: str, size: int,
                 head: bytes = b""):
        self._fs = fs
        self._path = path
        self._size = size
        self._pos = 0
        self._head = head
        self._full: Optional[bytes] = None

    def readable(self):
        return True

    def seekable(self):
        return True

    def tell(self):
        return self._pos

    def seek(self, offset, whence=io.SEEK_SET):
        if whence == io.SEEK_SET:
            pos = offset
        elif whence == io.SEEK_CUR:
            pos = self._pos + offset
        elif whence == io.SEEK_END:
            pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        if pos < 0:
            raise OSError("negative seek position")
        self._pos = pos
        return self._pos

    def _fetch(self, lo: int, hi: int) -> bytes:
        """Bytes [lo, hi] from cache/head when possible, else one
        ranged GET (head-overlapping reads fetch only the tail)."""
        if self._full is not None:
            return self._full[lo:hi + 1]
        nh = len(self._head)
        if hi < nh:
            return self._head[lo:hi + 1]
        prefix = self._head[lo:] if lo < nh else b""
        data, entire = self._fs._get_range(self._path, max(lo, nh), hi)
        if entire:  # server ignored Range: cache, serve locally forever
            self._full = data
            return data[lo:hi + 1]
        return prefix + data if prefix else data

    def readinto(self, b):
        if self._pos >= self._size or not len(b):
            return 0
        n = min(len(b), self._size - self._pos)
        data = self._fetch(self._pos, self._pos + n - 1)
        b[: len(data)] = data
        self._pos += len(data)
        return len(data)

    def readall(self):
        if self._pos >= self._size:
            return b""
        data = self._fetch(self._pos, self._size - 1)
        self._pos += len(data)
        return data


#: Sentinel for "use the default retry policy" — distinct from an
#: explicit ``retry_policy=None``, which DISABLES retries.
_DEFAULT_RETRY = object()


class S3FileSystem(fsio.FileSystem):
    """S3 REST client bound to one endpoint.

    Thread-compatible: every request opens its own connection (the
    async snapshot writer commits from a worker thread). Objects are
    written with single-PUT semantics via the shared buffered writer
    (:class:`fsio._MemWriter` commits through :meth:`_commit` at
    CLOSE; ``COMMIT_ON_FLUSH`` is off because re-uploading the whole
    accumulated object per ``flush()`` — e.g. the per-record JSONL
    metrics flush — would be O(records^2) network bytes against a real
    store). Readers never observe partial objects, matching the
    reference's S3 output contract (Sparky.java:237); incremental
    sinks pointed at ``s3://`` get durability at close, not per
    record.
    """

    COMMIT_ON_FLUSH = False

    def __init__(
        self,
        endpoint: str,
        region: str = "us-east-1",
        access_key: Optional[str] = None,
        secret_key: Optional[str] = None,
        timeout: float = 30.0,
        retry_policy=_DEFAULT_RETRY,
    ):
        u = urllib.parse.urlsplit(endpoint)
        if u.scheme not in ("http", "https") or not u.netloc:
            raise ValueError(
                f"S3 endpoint must be http(s)://host[:port], got {endpoint!r}"
            )
        self._secure = u.scheme == "https"
        self._netloc = u.netloc
        self._region = region
        self._access_key = access_key
        self._secret_key = secret_key
        self._timeout = timeout
        #: Transient-failure policy for idempotent requests (GET / PUT /
        #: HEAD / DELETE / initiate are all safe to repeat; multipart
        #: COMPLETE is not — see _multipart). Default: 5 jittered
        #: attempts; pass ``retry_policy=None`` to disable retries.
        self.retry: Optional[RetryPolicy] = (
            RetryPolicy(retryable=_s3_retryable)
            if retry_policy is _DEFAULT_RETRY else retry_policy
        )
        #: Counters the CLI surfaces in its robustness summary.
        self.retry_stats = RetryStats()

    # -- wire protocol ----------------------------------------------------

    def _request(
        self,
        method: str,
        bucket: str,
        key: str,
        query: str = "",
        body: bytes = b"",
        extra_headers: Optional[Dict[str, str]] = None,
        idempotent: bool = True,
    ) -> Tuple[int, Dict[str, str], bytes]:
        """One S3 request, retried under ``self.retry`` when
        ``idempotent`` (each attempt re-signs with a fresh x-amz-date).
        A transient status that survives the whole budget is RETURNED
        (not raised) so callers' normal error paths report it; network
        exceptions that survive the budget propagate."""
        if not idempotent or self.retry is None:
            return self._transact(method, bucket, key, query, body,
                                  extra_headers)

        def once():
            result = self._transact(method, bucket, key, query, body,
                                    extra_headers)
            if result[0] in RETRYABLE_STATUSES:
                raise _TransientStatus(result)
            return result

        def on_retry(failures, delay, exc):
            # Per-instance RetryStats stays the CLI's summary source;
            # the central registry gets the same count so one snapshot
            # covers every S3FileSystem in the process (obs/metrics).
            obs_metrics.counter(
                "s3.request.retries",
                "transparent S3 request re-attempts (transient "
                "status / network error)",
            ).inc()

        try:
            return self.retry.call(once, stats=self.retry_stats,
                                   on_retry=on_retry)
        except _TransientStatus as e:
            return e.result

    def _transact(
        self,
        method: str,
        bucket: str,
        key: str,
        query: str = "",
        body: bytes = b"",
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        path = "/" + bucket + (("/" + key) if key else "")
        payload_hash = hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA256
        headers = {
            "host": self._netloc,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": datetime.datetime.now(datetime.timezone.utc).strftime(
                "%Y%m%dT%H%M%SZ"
            ),
        }
        if extra_headers:
            headers.update(extra_headers)
        if self._access_key and self._secret_key:
            headers["authorization"] = sign_v4(
                method, self._netloc, path, query, headers, payload_hash,
                region=self._region, access_key=self._access_key,
                secret_key=self._secret_key, amzdate=headers["x-amz-date"],
            )
        conn_cls = (
            http.client.HTTPSConnection if self._secure
            else http.client.HTTPConnection
        )
        conn = conn_cls(self._netloc, timeout=self._timeout)
        try:
            url = urllib.parse.quote(path, safe="/") + (f"?{query}" if query else "")
            conn.request(method, url, body=body or None, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def _raise(self, status: int, data: bytes, path: str):
        if status == 404:
            raise FileNotFoundError(path)
        raise OSError(
            f"S3 request failed with HTTP {status} for {path!r}: "
            f"{data[:200].decode(errors='replace')}"
        )

    # -- FileSystem interface ---------------------------------------------

    #: Objects larger than this commit via multipart upload (S3 caps a
    #: single PUT at 5 GB; well before that, one multi-GB request has no
    #: retry granularity). 64 MB parts keep a Twitter-2010-class rank
    #: snapshot (41.7M f64 = 334 MB) at ~6 parts.
    MULTIPART_PART_SIZE = 64 * 1024 * 1024

    def _commit(self, path: str, data: bytes) -> None:
        """PUT the full object (the buffered writer's commit hook);
        objects over :attr:`MULTIPART_PART_SIZE` go through the S3
        multipart protocol (initiate / per-part PUT / complete, abort on
        any failure so no orphan upload accrues storage)."""
        bucket, key = _split_uri(path)
        if len(data) > self.MULTIPART_PART_SIZE:
            self._commit_multipart(bucket, key, data, path)
            return
        status, _, body = self._request("PUT", bucket, key, body=data)
        if status not in (200, 201, 204):
            self._raise(status, body, path)

    @staticmethod
    def _xml_root(body: bytes) -> Optional[ET.Element]:
        """Parse an S3 XML response body, tolerating the keep-alive
        whitespace real S3 streams ahead of the document. None when the
        body holds no parseable XML (callers route that to _raise)."""
        text = body.strip()
        if not text:
            return None
        try:
            return ET.fromstring(text)
        except ET.ParseError:
            return None

    def _commit_multipart(
        self, bucket: str, key: str, data: bytes, path: str
    ) -> None:
        def put_part(num: int, uid: str) -> str:
            off = (num - 1) * self.MULTIPART_PART_SIZE
            status, headers, body = self._request(
                "PUT", bucket, key,
                query=f"partNumber={num}&uploadId={uid}",
                body=data[off:off + self.MULTIPART_PART_SIZE],
            )
            if status != 200:
                self._raise(status, body, path)
            etag = _header(headers, "etag")
            if not etag:
                raise OSError(f"S3 part {num} of {path!r} returned no ETag")
            return etag

        nparts = -(-len(data) // self.MULTIPART_PART_SIZE)
        self._multipart(bucket, key, path, nparts, put_part,
                        expected_size=len(data))

    def _multipart(self, bucket, key, path, nparts, put_part,
                   expected_size=None) -> None:
        """The multipart skeleton: initiate, ``put_part(num, uid) ->
        etag`` per part, complete — abort on any failure so no orphan
        upload accrues storage. Initiate and part PUTs are idempotent
        and ride the standard retry; COMPLETE is not (see
        _complete_multipart)."""
        status, _, body = self._request("POST", bucket, key, query="uploads")
        if status != 200:
            self._raise(status, body, path)
        upload_id = _find_text(self._xml_root(body), "UploadId")
        if not upload_id:
            raise OSError(f"S3 initiate-multipart returned no UploadId for {path!r}")
        uid = urllib.parse.quote(upload_id, safe="-_.~")
        try:
            etags = [put_part(num, uid) for num in range(1, nparts + 1)]
            self._complete_multipart(bucket, key, path, uid, etags,
                                     expected_size=expected_size)
        except BaseException:
            # Best-effort abort: leave no billable orphan parts behind
            # (AbortMultipartUpload is a no-op once a complete landed,
            # so the committed-but-response-lost path is never undone).
            try:
                self._request("DELETE", bucket, key, query=f"uploadId={uid}")
            except Exception:
                pass
            raise

    def _list_parts(
        self, bucket: str, key: str, uid: str, path: str
    ) -> Optional[Dict[int, str]]:
        """ListParts for an in-flight upload: ``{part_number: etag}``,
        or None when the upload no longer exists (NoSuchUpload — the
        complete may have landed server-side)."""
        status, _, body = self._request(
            "GET", bucket, key, query=f"uploadId={uid}"
        )
        if status == 404:
            return None
        if status != 200:
            self._raise(status, body, path)
        parts: Dict[int, str] = {}
        root = self._xml_root(body)
        for el in root.iter() if root is not None else ():
            if _local(el.tag) != "Part":
                continue
            num = etag = None
            for sub in el:
                if _local(sub.tag) == "PartNumber":
                    num = int(sub.text or 0)
                elif _local(sub.tag) == "ETag":
                    etag = sub.text
            if num is not None and etag is not None:
                parts[num] = etag
        return parts

    @staticmethod
    def _multipart_etag(etags: List[str]) -> Optional[str]:
        """The ETag S3 assigns a multipart object: md5 over the
        concatenated BINARY part MD5s, suffixed ``-nparts``. None when
        any part ETag is not a plain hex md5 (e.g. SSE-KMS stores) —
        verification then falls back to size."""
        bins = []
        for t in etags:
            t = (t or "").strip().strip('"')
            if len(t) != 32:
                return None
            try:
                bins.append(binascii.unhexlify(t))
            except (binascii.Error, ValueError):
                return None
        digest = hashlib.md5(b"".join(bins)).hexdigest()
        return f'"{digest}-{len(bins)}"'

    def _object_matches_upload(
        self, bucket: str, key: str, etags: List[str],
        expected_size: Optional[int],
    ) -> bool:
        """Did the lost/failed COMPLETE actually commit OUR upload?
        Mere key existence proves nothing — a previous version of the
        same key (the snapshot overwrite pattern) would pass. Verify
        the object's ETag against the multipart ETag computed from the
        part ETags we just uploaded; when either side is unverifiable,
        fall back to an exact size match; with neither, refuse."""
        status, headers, _ = self._request("HEAD", bucket, key)
        if status != 200:
            return False
        etag = _header(headers, "etag")
        want = self._multipart_etag(etags)
        if etag and want:
            return etag.strip() == want
        if expected_size is not None:
            cl = _header(headers, "content-length")
            return cl is not None and cl.isdigit() and int(cl) == expected_size
        return False

    def _complete_multipart(
        self, bucket: str, key: str, path: str, uid: str, etags: List[str],
        expected_size: Optional[int] = None,
    ) -> None:
        """CompleteMultipartUpload with NON-BLIND recovery. Complete is
        not idempotent (the first attempt may commit server-side while
        its response is lost), so a transient failure is never simply
        re-POSTed: re-LIST the parts first — upload gone + object
        present means the commit already landed (success); parts intact
        and matching means a re-complete is safe; anything else is a
        real error. Attempts/backoff share ``self.retry``'s budget."""
        complete_xml = (
            "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{ET_escape(t)}</ETag></Part>"
                for n, t in enumerate(etags, start=1)
            ) + "</CompleteMultipartUpload>"
        ).encode()
        expected = {n: t for n, t in enumerate(etags, start=1)}
        attempts = self.retry.max_attempts if self.retry is not None else 1
        failures = 0
        while True:
            transient: Optional[BaseException] = None
            status, body = 0, b""
            try:
                status, _, body = self._request(
                    "POST", bucket, key, query=f"uploadId={uid}",
                    body=complete_xml, idempotent=False,
                )
            except BaseException as e:
                if not _s3_retryable(e):
                    raise
                transient = e
            if transient is None:
                # Complete may return 200 and stream an <Error> document
                # after keep-alive whitespace; only a
                # CompleteMultipartUploadResult root is success.
                root = self._xml_root(body) if status == 200 else None
                if root is not None and _local(root.tag) == "CompleteMultipartUploadResult":
                    return
                if status not in RETRYABLE_STATUSES:
                    self._raise(status, body, path)  # semantic: surface now
            failures += 1
            # Recovery probe (idempotent, internally retried): did the
            # lost/failed complete actually commit?
            listed = self._list_parts(bucket, key, uid, path)
            if listed is None:
                if self._object_matches_upload(bucket, key, etags,
                                               expected_size):
                    return  # committed server-side; response was lost
                raise OSError(
                    f"S3 multipart upload for {path!r} disappeared without "
                    f"a verifiable commit — the key's current object does "
                    f"not match the uploaded parts (complete failed with "
                    f"{transient or ('HTTP %d' % status)})"
                )
            if listed != expected:
                raise OSError(
                    f"S3 multipart parts for {path!r} no longer match what "
                    f"was uploaded ({len(listed)}/{len(expected)} parts "
                    f"listed); refusing to re-complete"
                )
            if failures >= attempts:
                if transient is not None:
                    raise transient
                self._raise(status, body, path)
            if self.retry is not None:
                delay = self.retry.backoff(failures)
                self.retry_stats.retries += 1
                self.retry_stats.slept += delay
                obs_metrics.counter("s3.request.retries").inc()
                self.retry.sleep(delay)

    def _get(self, path: str) -> bytes:
        bucket, key = _split_uri(path)
        status, _, data = self._request("GET", bucket, key)
        if status != 200:
            self._raise(status, data, path)
        return data

    def _get_range(self, path: str, lo: int, hi: int) -> Tuple[bytes, bool]:
        """GET bytes [lo, hi] (inclusive) -> (data, entire): ``entire``
        flags a server that ignored Range and sent the whole object
        (200) — callers must then treat ``data`` as the full body."""
        bucket, key = _split_uri(path)
        status, _, data = self._request(
            "GET", bucket, key,
            extra_headers={"range": f"bytes={lo}-{hi}"},
        )
        if status == 206:
            return data, False
        if status == 200:
            return data, True
        self._raise(status, data, path)

    #: Objects at or below this arrive whole in the open() probe GET;
    #: larger ones read through a seekable ranged reader (zip-backed
    #: formats — npz snapshots — then fetch only the members they touch
    #: instead of the whole object).
    STREAM_THRESHOLD = 8 * 1024 * 1024

    def open(self, path, mode="r", **kwargs):
        binary = "b" in mode
        kind = mode.replace("b", "").replace("t", "") or "r"
        if kind == "r":
            # ONE probe GET for the first STREAM_THRESHOLD bytes: small
            # objects arrive complete (no HEAD round-trip — this is the
            # hot path for multi-file segment ingest over s3://), large
            # ones seed the ranged reader with their head + total size
            # from Content-Range.
            bucket, key = _split_uri(path)
            status, headers, data = self._request(
                "GET", bucket, key,
                extra_headers={"range": f"bytes=0-{self.STREAM_THRESHOLD - 1}"},
            )
            if status == 200:  # Range ignored: whole object in hand
                raw: io.IOBase = io.BytesIO(data)
            elif status == 416:
                # Real S3 answers 416 InvalidRange when start >= size —
                # i.e. a zero-byte object (the '_SUCCESS' markers this
                # codebase writes). Plain GET resolves it (or surfaces
                # the real error).
                raw = io.BytesIO(self._get(path))
            elif status == 206:
                total = None
                crange = _header(headers, "content-range")
                if crange and "/" in crange:
                    tail = crange.rsplit("/", 1)[1]
                    if tail.isdigit():
                        total = int(tail)
                if total is None:
                    # A 206 without a parseable Content-Range could hide
                    # bytes past the probe — refuse rather than silently
                    # truncate a big object to its first 8 MB.
                    raise OSError(
                        f"S3 endpoint returned 206 without a usable "
                        f"Content-Range for {path!r}; cannot size the object"
                    )
                if total <= len(data):
                    raw = io.BytesIO(data)
                else:
                    raw = io.BufferedReader(
                        _RangedReader(self, path, total, head=data), 1 << 20
                    )
            else:
                self._raise(status, data, path)
        elif kind in ("w", "x", "a"):
            if kind == "x" and self.isfile(path):
                raise FileExistsError(path)
            initial = b""
            if kind == "a":
                try:
                    initial = self._get(path)
                except FileNotFoundError:
                    pass
            raw = fsio._MemWriter(self, path, initial)
            if kind == "a":
                raw.seek(0, io.SEEK_END)
        else:
            raise ValueError(f"unsupported mode {mode!r}")
        if binary:
            return raw
        kwargs.pop("newline", None)
        kwargs.setdefault("encoding", "utf-8")
        return fsio._MemTextWrapper(raw, **kwargs)

    def isfile(self, path):
        bucket, key = _split_uri(path)
        if not key:
            return False
        status, _, _ = self._request("HEAD", bucket, key)
        return status == 200

    def _list(
        self, bucket: str, prefix: str, delimiter: str = "",
        max_keys: int = 1000,
    ) -> Iterator[Tuple[str, bool]]:
        """Yield (name, is_prefix) from ListObjectsV2, following
        continuation tokens (the client-side half of S3 pagination)."""
        token = None
        while True:
            q = [("list-type", "2"), ("prefix", prefix),
                 ("max-keys", str(max_keys))]
            if delimiter:
                q.append(("delimiter", delimiter))
            if token:
                q.append(("continuation-token", token))
            query = urllib.parse.urlencode(sorted(q))
            status, _, data = self._request("GET", bucket, "", query=query)
            if status != 200:
                self._raise(status, data, f"s3://{bucket}/{prefix}")
            root = ET.fromstring(data)
            token = None
            truncated = False
            for el in root:
                name = _local(el.tag)
                if name == "Contents":
                    for sub in el:
                        if _local(sub.tag) == "Key":
                            yield sub.text or "", False
                elif name == "CommonPrefixes":
                    for sub in el:
                        if _local(sub.tag) == "Prefix":
                            yield sub.text or "", True
                elif name == "NextContinuationToken":
                    token = el.text
                elif name == "IsTruncated":
                    truncated = (el.text or "").strip().lower() == "true"
            if not truncated or not token:
                return

    def isdir(self, path):
        bucket, key = _split_uri(path.rstrip("/") + "/")
        if key == "/":  # bucket root
            key = ""
        for _ in self._list(bucket, key, max_keys=1):
            return True
        return False

    def exists(self, path):
        return self.isfile(path) or self.isdir(path)

    def listdir(self, path):
        bucket, key = _split_uri(path.rstrip("/") + "/")
        if key == "/":
            key = ""
        names = set()
        found = False
        for name, is_prefix in self._list(bucket, key, delimiter="/"):
            found = True
            tail = name[len(key):]
            if is_prefix:
                tail = tail.rstrip("/")
            if tail:
                names.add(tail)
        if not found:
            raise FileNotFoundError(path)
        return sorted(names)

    def makedirs(self, path, exist_ok=True):
        # Object stores have no directories; prefixes exist implicitly
        # once a key is written (mirrors Hadoop-on-S3 behavior).
        return None

    def replace(self, src, dst):
        sb, sk = _split_uri(src)
        db_, dk = _split_uri(dst)
        copy_source = "/" + sb + "/" + urllib.parse.quote(sk)
        status, headers, data = self._request("HEAD", sb, sk)
        if status != 200:
            self._raise(status, data, src)
        size = int(_header(headers, "content-length") or 0)
        if size > self.MULTIPART_PART_SIZE:
            # Real S3 caps single CopyObject at 5 GB; past the part
            # threshold, copy server-side in ranges (UploadPartCopy) —
            # the snapshot tmp+rename path hits this for large objects.
            def copy_part(num: int, uid: str) -> str:
                lo = (num - 1) * self.MULTIPART_PART_SIZE
                hi = min(lo + self.MULTIPART_PART_SIZE, size) - 1
                status, _, body = self._request(
                    "PUT", db_, dk,
                    query=f"partNumber={num}&uploadId={uid}",
                    extra_headers={
                        "x-amz-copy-source": copy_source,
                        "x-amz-copy-source-range": f"bytes={lo}-{hi}",
                    },
                )
                etag = _find_text(
                    self._xml_root(body) if status == 200 else None, "ETag"
                )
                if not etag:  # UploadPartCopy returns the ETag in XML
                    self._raise(status, body, src)
                return etag

            nparts = -(-size // self.MULTIPART_PART_SIZE)
            self._multipart(db_, dk, dst, nparts, copy_part,
                            expected_size=size)
        else:
            status, _, data = self._request(
                "PUT", db_, dk,
                extra_headers={"x-amz-copy-source": copy_source},
            )
            # CopyObject has the same 200-with-streamed-<Error> failure
            # mode as CompleteMultipartUpload.
            root = self._xml_root(data) if status == 200 else None
            if root is None or _local(root.tag) != "CopyObjectResult":
                self._raise(status, data, src)
        status, _, data = self._request("DELETE", sb, sk)
        if status not in (200, 204):
            self._raise(status, data, src)


S3_SCHEMES = ("s3", "s3n", "s3a")
ENDPOINT_ENV = "PAGERANK_TPU_S3_ENDPOINT"


def from_env() -> Optional[S3FileSystem]:
    """Build an :class:`S3FileSystem` from the environment, or None when
    no endpoint is configured. ``PAGERANK_TPU_S3_RETRIES`` (total
    attempts; 1 disables) overrides the default retry budget."""
    endpoint = os.environ.get(ENDPOINT_ENV)
    if not endpoint:
        return None
    policy = _DEFAULT_RETRY
    attempts = os.environ.get("PAGERANK_TPU_S3_RETRIES")
    if attempts:
        n = max(1, int(attempts))
        # 1 total attempt = retries off (None; _DEFAULT_RETRY means
        # "use the default policy", an explicit None disables)
        policy = (
            RetryPolicy(max_attempts=n, retryable=_s3_retryable)
            if n > 1 else None
        )
    return S3FileSystem(
        endpoint,
        region=os.environ.get("AWS_REGION", "us-east-1"),
        access_key=os.environ.get("AWS_ACCESS_KEY_ID"),
        secret_key=os.environ.get("AWS_SECRET_ACCESS_KEY"),
        retry_policy=policy,
    )


def register_s3(
    fs: Optional[S3FileSystem] = None, only_missing: bool = False
) -> Optional[S3FileSystem]:
    """Register ``fs`` (default: :func:`from_env`) for all S3 schemes —
    the reference's inputs are spelled ``s3n://`` (Sparky.java:44-58),
    modern Hadoop uses ``s3a://``, plain ``s3://`` is the native form.
    ``only_missing`` skips schemes that already have a registration (the
    lazy get_fs hook must not silently replace an explicitly registered
    store with the env endpoint)."""
    fs = fs or from_env()
    if fs is not None:
        for scheme in S3_SCHEMES:
            if only_missing and fsio.registered(scheme):
                continue
            fsio.register(scheme, fs)
    return fs
