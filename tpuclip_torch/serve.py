"""HTTP serving mode (PyTorch port of ``tpuclip/serve.py``).

The same endpoints, JSON and single engine lock as tpuclip's server, around
the port's engine. Its fused programs run as CUDA graphs on the card (one
per ladder bucket, ``tpuclip_torch.ops.graphs``), where tpuclip runs one
jitted program per bucket. A small threaded HTTP server (stdlib only):

  GET  /                  → browser search UI (self-contained page driving
                            the JSON endpoints; serve_ui.py)
  GET  /image?path=&size= → image bytes for a row of the images table (exact
                            DB-path match only; thumbnails for PDF/TIF/BMP)
  GET  /health            → {"status": "ok", ...}
  GET  /stats             → index sizes, model, backend
  POST /search            → body {"query": str, "k": int?, "query2": str?,
                            "weights": [w1, w2]?, "negative": str?,
                            "negative_weight": float?, "folders": [str]?,
                            "show_duplicates": bool?}
                            (query strings support the same mini-language as
                            the REPL: "a + b", "a - b", "image:<path>")
                            OR {"image_b64": <base64 raster bytes>, "k"?,
                            "folders"?, "show_duplicates"?} for clients that
                            upload the query image instead of naming a
                            server-local path (raise TPUCLIP_MAX_BODY_MB for
                            large photos)
  POST /classify          → {"labels": [str...]} + one of {"image_b64"} /
                            {"image": <server path>} → zero-shot per-label
                            sigmoid + softmax probabilities (no database)

The model and the device-resident index stay warm across requests. Plain text
queries and ``image_b64`` uploads are MICRO-BATCHED: concurrent requests
arriving within a short window (default 2 ms, ``TPUCLIP_BATCH_WINDOW_MS``)
embed in one tower pass (text and vision groups separately; upload decode
stays on the handler threads) and scan the matrix in one ``search_batch``
device pass — N concurrent queries cost ~1 device pass instead of N; a lone
request takes the fused single-program path instead. Complex queries
(server-path image queries, algebra, negatives) and non-search endpoints
serialize through the engine lock as before (scale-out remains DP replicas
behind a load balancer, one engine per chip).
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog (5) drops connections with
    # ECONNRESET under a 64-client connect storm — found by the r5 serve
    # load bench (scripts/serve_load.py) at c=64 on loopback.
    request_queue_size = 128
    daemon_threads = True
from tpuclip_torch.cli import parse_interactive_line
from tpuclip_torch.utils.logging import log


def _decode_b64_image(b64):
    """base64 string → decoded PIL image, or None for invalid base64 /
    undecodable bytes (the one containment shared by every upload-accepting
    endpoint — /search image_b64, /search_batch images_b64, /classify,
    /embed)."""
    import base64

    from tpuclip_torch.io.decode import load_image_bytes

    try:
        data = base64.b64decode(b64, validate=True)
    except Exception:  # noqa: BLE001
        return None
    return load_image_bytes(data, "<bytes>")


class ServerMetrics:
    """Cumulative request metrics surfaced at /stats (the reference exports
    no metrics at all — SURVEY.md §5 observability)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.search_latencies_ms: list = []

    def record(self, ok: bool, latency_ms: float = None) -> None:
        with self.lock:
            self.requests += 1
            if not ok:
                self.errors += 1
            if latency_ms is not None:
                self.search_latencies_ms.append(latency_ms)
                if len(self.search_latencies_ms) > 10_000:
                    del self.search_latencies_ms[:5_000]

    def snapshot(self) -> dict:
        import numpy as np

        with self.lock:
            lat = list(self.search_latencies_ms)
            out = {"requests": self.requests, "errors": self.errors,
                   "searches": len(lat)}
        if lat:
            arr = np.array(lat)
            out["search_p50_ms"] = round(float(np.percentile(arr, 50)), 2)
            out["search_p90_ms"] = round(float(np.percentile(arr, 90)), 2)
            out["search_p99_ms"] = round(float(np.percentile(arr, 99)), 2)
        return out


class _BatchItem:
    __slots__ = (
        "query", "image", "k", "folders", "show_duplicates", "event",
        "result", "error",
    )

    def __init__(self, query, k: int, folders, show_duplicates: bool, image=None):
        self.query = query          # text query string, or None for images
        self.image = image          # decoded PIL image (upload queries)
        self.k = k
        self.folders = tuple(folders) if folders else None
        self.show_duplicates = show_duplicates
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Collects concurrent plain-text searches AND image uploads into
    single device passes.

    One dispatcher thread drains a queue: after the first request lands it
    waits ``window_s`` for stragglers (bounded by ``max_batch``), embeds the
    unique query strings in ONE text-tower pass (image uploads in one
    vision-tower pass per group), refreshes the index once,
    and runs one ``search_batch`` per distinct (k, folders) group. Duplicate
    filtering stays per-request (it is host-side SQLite work).
    """

    def __init__(self, engine, lock: threading.Lock, window_ms=None, max_batch: int = 64):
        self.engine = engine
        self.lock = lock
        if window_ms is None:
            window_ms = float(os.environ.get("TPUCLIP_BATCH_WINDOW_MS", "2"))
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.queue: "queue_mod.Queue" = queue_mod.Queue()
        self.device_passes = 0  # scan passes actually run
        self.batched_requests = 0
        self.mixed_windows = 0  # groups served by the combined mixed program
        self.windows = 0  # _process calls (formed windows)
        self.window_size_hist: dict = {}  # window size -> count
        self.lock_wait_s = 0.0  # time spent waiting on the engine lock
        self.process_s = 0.0  # total window processing wall (incl. wait)
        self._stats_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="tpuclip-microbatch")
        self._thread.start()

    def submit(self, query: str, k: int, folders, show_duplicates: bool, timeout: float = None):
        if timeout is None:
            # Generous default: the FIRST request of a shape pays its graph
            # capture and must not 500 on a wait the old serialized path
            # would simply have sat out.
            timeout = float(os.environ.get("TPUCLIP_BATCH_TIMEOUT_S", "600"))
        item = _BatchItem(query, k, folders, show_duplicates)
        return self._await(item, timeout)

    def submit_image(self, image, k: int, folders, show_duplicates: bool, timeout: float = None):
        """Queue a decoded upload-image query (decode happens on the handler
        thread — the batcher thread only sees valid PIL images). Concurrent
        uploads in one window share a batched vision-tower pass and one
        search_batch scan."""
        if timeout is None:
            timeout = float(os.environ.get("TPUCLIP_BATCH_TIMEOUT_S", "600"))
        item = _BatchItem(None, k, folders, show_duplicates, image=image)
        return self._await(item, timeout)

    def _await(self, item, timeout):
        self.queue.put(item)
        if not item.event.wait(timeout):
            raise TimeoutError("search timed out in the batching queue")
        if item.error is not None:
            raise item.error
        return item.result

    def shutdown(self) -> None:
        self.queue.put(None)
        self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while True:
            first = self.queue.get()
            if first is None:
                return
            items = [first]
            deadline = time.perf_counter() + self.window_s
            stop = False
            while len(items) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=remaining)
                except queue_mod.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                items.append(nxt)
            self._process(items)
            if stop:
                return

    def _process(self, items) -> None:
        import numpy as np

        from tpuclip_torch.index.dedup import filter_duplicates_many

        passes = 0
        mixed_count = 0
        t_win0 = time.perf_counter()
        lock_wait = 0.0
        try:
            # Explicit acquire so the engine-lock WAIT is measurable: under
            # concurrent load the share of window time spent here is the
            # contention signal /stats reports (serve-load bench, r5).
            t_lk = time.perf_counter()
            self.lock.acquire()
            lock_wait = time.perf_counter() - t_lk
            try:
                self.engine.index.refresh()
                groups: dict = {}
                for it in items:
                    groups.setdefault((it.k, it.folders), []).append(it)
                # Decide fused-ness ONCE per group. can_fuse_text_search
                # re-reads the DB fingerprint (an implicit refresh), so asking
                # again later in the batch could flip the answer under a
                # concurrent writer and orphan the embeds prepared below —
                # and each extra ask costs full-table fingerprint scans.
                fused_group: dict = {
                    key: self.engine.index.can_fuse_text_search(
                        key[0], list(key[1]) if key[1] else None,
                        assume_fresh=True,  # refresh() ran above, same lock
                    )
                    for key in groups
                }
                # LRU-aware batch embed for the groups that need host-side
                # vectors (folder filters / non-fused indexes); fused-text
                # groups never materialize embeddings on the host at all.
                vec_by_text: dict = {}
                need_vecs = sorted({
                    it.query
                    for key, group in groups.items()
                    if not fused_group[key]
                    for it in group
                    if it.image is None
                })
                if need_vecs:
                    vec_by_text = dict(
                        zip(need_vecs, self.engine.embed_texts_cached(need_vecs))
                    )
                for (k, folders), group in groups.items():
                    # Per-group containment: one group's failure must not
                    # discard results already computed for other groups.
                    try:
                        folder_list = list(folders) if folders else None
                        texts = [it for it in group if it.image is None]
                        images = [it for it in group if it.image is not None]
                        done: list = []
                        mixed = (
                            bool(texts) and bool(images)
                            and fused_group[(k, folders)]
                        )
                        if mixed:
                            # Mixed window: both towers + ONE shared scan
                            # in a single device program. The previous
                            # shape (text-fused pass + image pass) paid
                            # the scan's matrix read twice.
                            uniq = sorted({it.query for it in texts})
                            t_res, i_res = self.engine._search_mixed_fused(
                                uniq, [it.image for it in images], k
                            )
                            by_text = dict(zip(uniq, t_res))
                            done += [(it, by_text[it.query]) for it in texts]
                            done += list(zip(images, i_res))
                            passes += 1
                            mixed_count += 1
                        elif texts and fused_group[(k, folders)]:
                            # ONE device round trip: tokenize -> text tower
                            # -> int8 scan -> exact rescore, fused. Dedup
                            # repeated queries first: a batch of identical hot
                            # queries should run the text tower once, then fan
                            # the results back out (the non-fused path gets
                            # this from its embed cache).
                            uniq = sorted({it.query for it in texts})
                            # Pre-gated entry: fused-ness was decided once
                            # for the group above; engine.search_texts would
                            # re-run the fingerprint-scanning gate per call.
                            by_text = dict(
                                zip(uniq, self.engine._search_texts_fused(uniq, k))
                            )
                            done += [(it, by_text[it.query]) for it in texts]
                            passes += 1
                        elif texts:
                            vecs = np.stack([vec_by_text[it.query] for it in texts])
                            batches = self.engine.index.search_batch(
                                vecs, k, filter_folders=folder_list
                            )
                            done += list(zip(texts, batches))
                            passes += 1
                        if images and not mixed:
                            if len(images) == 1 and fused_group[(k, folders)]:
                                # Lone upload: the fused single-program path
                                # (vision tower + scan + rescore, one round
                                # trip; eligibility already decided for the
                                # group — skip the repeat fingerprint scan).
                                done.append((
                                    images[0],
                                    self.engine._search_image_fused(
                                        images[0].image, k
                                    ),
                                ))
                            else:
                                # Concurrent uploads: one batched vision-tower
                                # pass + one search_batch scan for the group.
                                embs = self.engine.embed_pils(
                                    [it.image for it in images]
                                )
                                batches = self.engine.index.search_batch(
                                    embs, k, filter_folders=folder_list
                                )
                                done += list(zip(images, batches))
                            passes += 1
                        # Duplicate filtering: ONE batched binary fetch for
                        # the whole group instead of a connection + query
                        # per request (r5 load bench: ~30% of window time
                        # at c=64 went to per-request dedup SQLite).
                        to_filter = [
                            (it, results) for it, results in done
                            if not it.show_duplicates and results
                        ]
                        if to_filter:
                            try:
                                filtered = filter_duplicates_many(
                                    self.engine.store,
                                    [results for _, results in to_filter],
                                )
                            except Exception:  # noqa: BLE001
                                # Dedup is cosmetic: unfiltered results
                                # beat turning the whole group into 500s.
                                filtered = [r for _, r in to_filter]
                            filt_by_id = {
                                id(it): res
                                for (it, _), res in zip(to_filter, filtered)
                            }
                        else:
                            filt_by_id = {}
                        for it, results in done:
                            it.result = filt_by_id.get(id(it), results)
                    except Exception as e:  # noqa: BLE001
                        for it in group:
                            # A failure partway through the group (e.g. in the
                            # per-item duplicate filter) must not turn items
                            # that already have results into 500s.
                            if it.result is None:
                                it.error = e
            finally:
                self.lock.release()
        except Exception as e:  # noqa: BLE001 - embed/refresh failure fans out
            for it in items:
                if it.error is None and it.result is None:
                    it.error = e
        finally:
            with self._stats_lock:
                self.device_passes += passes
                self.batched_requests += len(items)
                self.mixed_windows += mixed_count
                self.windows += 1
                sz = len(items)
                self.window_size_hist[sz] = self.window_size_hist.get(sz, 0) + 1
                self.lock_wait_s += lock_wait
                self.process_s += time.perf_counter() - t_win0
            for it in items:
                it.event.set()

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "batched_requests": self.batched_requests,
                "device_passes": self.device_passes,
                "mixed_windows": self.mixed_windows,
                "windows": self.windows,
                "window_size_hist": {
                    str(k): v for k, v in sorted(self.window_size_hist.items())
                },
                "lock_wait_s": round(self.lock_wait_s, 3),
                "process_s": round(self.process_s, 3),
                "window_ms": self.window_s * 1000.0,
                "max_batch": self.max_batch,
            }


def _has_text_part(spec) -> bool:
    """Whether a search needs the text tower: a text query, a text second
    query, or a text negative."""
    negatives = zip(spec.negative_queries or [], spec.negative_is_images or [False] * len(spec.negative_queries or []))
    return (not spec.is_image
            or (spec.query2 is not None and not spec.is_image2)
            or (spec.negative_query is not None and not spec.negative_is_image)
            or any(not is_image for _, is_image in negatives))


def make_handler(engine, lock: threading.Lock, metrics: ServerMetrics, batcher: MicroBatcher = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            log(f"  [serve] {self.address_string()} {fmt % args}")

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _raw(self, code: int, ctype: str, body: bytes, headers=None) -> None:
            self.send_response(code)
            if ctype:
                self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                self._json(200, {"status": "ok", "model": engine.model_name})
                return
            if self.path in ("/", "/ui"):
                from tpuclip_torch.serve_ui import UI_HTML

                self._raw(200, "text/html; charset=utf-8", UI_HTML.encode())
                return
            if self.path.startswith("/image?"):
                from urllib.parse import parse_qs, urlparse

                from tpuclip_torch.serve_ui import serve_image

                qs = parse_qs(urlparse(self.path).query)
                size = qs.get("size", [None])[0]
                try:
                    size = int(size) if size is not None else None
                except ValueError:
                    size = None
                code, ctype, body, headers = serve_image(
                    engine,
                    qs.get("path", [""])[0],
                    size=size,
                    if_none_match=self.headers.get("If-None-Match"),
                )
                self._raw(code, ctype, body, headers)
                return
            if self.path == "/stats":
                full, binary = engine.store.count_embeddings()
                payload = {
                    "images": engine.store.count_images(),
                    "full_embeddings": full,
                    "binary_embeddings": binary,
                    "embedding_dim": engine.embedding_dim,
                    "model": engine.model_name,
                    "db_path": engine.db_path,
                    # which scan actually serves: mode + precision, and
                    # whether the cascade gate held after refresh
                    "search_mode": engine.index.search_mode,
                    "search_precision": engine.index.precision,
                    "cascade_active": bool(getattr(engine.index, "_cascade", False)),
                }
                # Verified-shortlist health: proof-checked fused queries and
                # how many missed into the resident-scores fallback.
                payload.update(
                    getattr(engine.index, "shortlist_stats", {}) or {}
                )
                payload.update(metrics.snapshot())
                if batcher is not None:
                    payload.update(batcher.stats())
                self._json(200, payload)
                return
            self._json(404, {"error": "not found"})

        # Request cap: 4 MiB default; image_b64 uploads of large photos may
        # need more (TPUCLIP_MAX_BODY_MB). Bounded either way — one body per
        # handler thread. A malformed value falls back to the default
        # instead of killing server startup.
        try:
            MAX_BODY = max(1, int(float(os.environ.get("TPUCLIP_MAX_BODY_MB", "4") or 4))) << 20
        except (ValueError, OverflowError):  # int(float("inf")) overflows
            MAX_BODY = 4 << 20
        MAX_BATCH_QUERIES = 256  # /search_batch fan-out cap (one tower pass)

        def _read_json(self):
            length = int(self.headers.get("Content-Length", "0"))
            if length < 0:
                # A negative length would make rfile.read() block until the
                # client closes the connection, hanging the handler thread.
                raise ValueError(f"invalid Content-Length ({length})")
            if length > self.MAX_BODY:
                raise ValueError(f"request body too large ({length} bytes)")
            return json.loads(self.rfile.read(length) or b"{}")

        def do_POST(self):  # noqa: N802
            try:
                req = self._read_json()
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if self.path == "/embed":
                self._handle_embed(req)
                return
            if self.path == "/search_batch":
                self._handle_search_batch(req)
                return
            if self.path == "/classify":
                self._handle_classify(req)
                return
            if self.path != "/search":
                self._json(404, {"error": "not found"})
                return
            if req.get("image_b64") is not None:
                # Remote image query: the client uploads the image instead of
                # naming a server-local path (image:<path> still works for
                # local deployments).
                self._handle_image_b64_search(req)
                return
            query = req.get("query")
            if not query or not isinstance(query, str):
                self._json(400, {"error": "missing 'query' string"})
                return

            cmd = parse_interactive_line(query, req.get("negative_weight", 0.5))
            if cmd.kind != "search":
                self._json(400, {"error": f"not a search query ({cmd.kind})"})
                return
            spec = cmd.search
            if req.get("negative") is not None:
                spec.negative_query = req["negative"]
            if req.get("query2") is not None:
                spec.query2 = req["query2"]
            if not engine.has_text_tower and _has_text_part(spec):
                from tpuclip_torch.models.loader import no_text_tower

                self._json(400, {"error": no_text_tower(engine.model_name)})
                return

            import time as _time

            t0 = _time.perf_counter()
            # Plain text queries ride the micro-batching queue: concurrent
            # requests share one tower pass + one matrix scan.
            simple = (
                batcher is not None
                and not spec.is_image
                and spec.query2 is None
                and req.get("query2") is None
                and spec.negative_query is None
                and req.get("negative") is None
                and not getattr(spec, "negative_queries", None)
            )
            if simple:
                try:
                    results = batcher.submit(
                        spec.query,
                        int(req.get("k", 10)),
                        req.get("folders"),
                        bool(req.get("show_duplicates", False)),
                    )
                except Exception as e:  # noqa: BLE001
                    metrics.record(ok=False)
                    self._json(500, {"error": str(e)})
                    return
                metrics.record(ok=True, latency_ms=(_time.perf_counter() - t0) * 1000)
                self._json(
                    200,
                    {
                        "query": query,
                        "results": [
                            {"path": p, "similarity": round(s, 6)} for p, s in results
                        ],
                    },
                )
                return
            try:
                with lock:
                    results = engine.search(
                        spec.query,
                        k=int(req.get("k", 10)),
                        is_image_path=spec.is_image,
                        query2=spec.query2,
                        is_image_path2=spec.is_image2,
                        weights=tuple(req.get("weights", (0.5, 0.5))),
                        negative_query=spec.negative_query,
                        negative_is_image=spec.negative_is_image,
                        negative_weight=float(req.get("negative_weight", 0.5)),
                        negative_queries=spec.negative_queries,
                        negative_is_images=spec.negative_is_images,
                        negative_weights=spec.negative_weights,
                        filter_folders=req.get("folders"),
                        show_duplicates=bool(req.get("show_duplicates", False)),
                    )
            except Exception as e:  # noqa: BLE001 - requests must not kill the server
                metrics.record(ok=False)
                self._json(500, {"error": str(e)})
                return
            metrics.record(ok=True, latency_ms=(_time.perf_counter() - t0) * 1000)
            self._json(
                200,
                {
                    "query": query,
                    "results": [
                        {"path": p, "similarity": round(s, 6)} for p, s in results
                    ],
                },
            )

        def _handle_image_b64_search(self, req) -> None:
            """POST /search with {"image_b64": <base64 raster bytes>}: embed
            the uploaded image and scan the index. k / folders /
            show_duplicates apply as usual; 'query' must not also be set
            (blend algebra stays path/text-based)."""
            import time as _time

            if req.get("query"):
                self._json(400, {"error": "provide either 'query' or 'image_b64', not both"})
                return
            # Decode on THIS handler thread (parallel across uploads).
            img = _decode_b64_image(req["image_b64"])
            if img is None:
                self._json(400, {"error": "could not decode image_b64"})
                return
            t0 = _time.perf_counter()
            try:
                if batcher is not None:
                    # Micro-batch: concurrent uploads in one window share a
                    # batched vision-tower pass + one scan; a lone upload
                    # runs the fused single-program path.
                    results = batcher.submit_image(
                        img,
                        int(req.get("k", 10)),
                        req.get("folders"),
                        bool(req.get("show_duplicates", False)),
                    )
                else:
                    with lock:
                        # Fused when eligible: ONE vision-tower + scan +
                        # rescore device program; two-stage embed + search
                        # otherwise.
                        results = engine.search_image_pil(
                            img, int(req.get("k", 10)),
                            filter_folders=req.get("folders"),
                        )
                        if not bool(req.get("show_duplicates", False)) and results:
                            from tpuclip_torch.index.dedup import filter_duplicates

                            results = filter_duplicates(
                                engine.store, results
                            )
            except Exception as e:  # noqa: BLE001
                metrics.record(ok=False)
                self._json(500, {"error": str(e)})
                return
            metrics.record(ok=True, latency_ms=(_time.perf_counter() - t0) * 1000)
            self._json(
                200,
                {
                    "query": "<image upload>",
                    "results": [
                        {"path": p, "similarity": round(s, 6)} for p, s in results
                    ],
                },
            )

        def _handle_classify(self, req) -> None:
            """Zero-shot classification against the resident engine:
            {"labels": [str...]} plus ONE of {"image_b64": <base64 raster>}
            or {"image": <server-local path>} → per-label sigmoid + softmax
            probabilities, sorted descending (pipelines/classify.py head;
            no database involved)."""
            labels = req.get("labels")
            if (
                not labels
                or not isinstance(labels, list)
                or not all(isinstance(x, str) and x for x in labels)
            ):
                self._json(400, {"error": "missing 'labels' list of strings"})
                return
            if len(labels) > self.MAX_BATCH_QUERIES:
                # Same fan-out cap as /search_batch: an unbounded label list
                # is one un-chunked text-tower pass under the serving lock.
                self._json(400, {
                    "error": f"too many labels ({len(labels)} > "
                             f"{self.MAX_BATCH_QUERIES})"
                })
                return
            has_b64 = req.get("image_b64") is not None
            has_path = req.get("image") is not None
            if has_b64 == has_path:  # neither or both
                self._json(400, {"error": "provide exactly one of 'image_b64' or 'image'"})
                return
            try:
                if has_b64:
                    img = _decode_b64_image(req["image_b64"])
                else:
                    from tpuclip_torch.io.decode import load_image

                    img = load_image(str(req["image"]))
                if img is None:
                    self._json(400, {"error": "could not decode image"})
                    return
                from tpuclip_torch.pipelines.classify import classify_pil

                with lock:
                    ranked = classify_pil(engine, img, [str(x) for x in labels])
            except Exception as e:  # noqa: BLE001
                metrics.record(ok=False)
                self._json(500, {"error": str(e)})
                return
            metrics.record(ok=True)
            self._json(
                200,
                {
                    "labels": [
                        {"label": l, "prob": round(p, 6), "rel": round(sm, 6)}
                        for l, p, sm in ranked
                    ]
                },
            )

        def _handle_embed(self, req) -> None:
            """Raw embeddings for integrations: {"texts": [...]} and/or
            {"images": [paths...]} / {"images_b64": [...]} → L2-normalized
            fp32 vectors."""
            texts = req.get("texts") or []
            images = req.get("images") or []
            images_b64 = req.get("images_b64") or []
            if not all(isinstance(x, list) for x in (texts, images, images_b64)):
                # a bare string would iterate per-character: one embed
                # attempt per char of a path/base64 body
                self._json(400, {"error": "'texts'/'images'/'images_b64' must be lists"})
                return
            if not texts and not images and not images_b64:
                self._json(400, {"error": "provide 'texts', 'images', and/or 'images_b64'"})
                return
            try:
                out = {}
                with lock:
                    if texts:
                        out["text_embeddings"] = engine.embed_texts(list(texts)).tolist()
                    if images:
                        embs = []
                        for p in images:
                            e = engine._get_image_embedding(str(p))
                            embs.append(e.tolist() if e is not None else None)
                        out["image_embeddings"] = embs
                    if images_b64:
                        embs = []
                        for b in images_b64:
                            try:
                                img = _decode_b64_image(b)
                                e = engine._embed_pil(img) if img is not None else None
                            except Exception:  # noqa: BLE001 - None per slot
                                e = None
                            embs.append(e.tolist() if e is not None else None)
                        out["image_b64_embeddings"] = embs
                out["dim"] = engine.embedding_dim
                self._json(200, out)
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": str(e)})

        def _handle_search_batch(self, req) -> None:
            """{"queries": [str...]} and/or {"images_b64": [...]}, "k": int?
            → per-query results; text queries embed in one tower pass and
            image uploads in one vision pass, each scanning the matrix
            once. Undecodable upload slots return null."""
            queries = req.get("queries") or []
            images_b64 = req.get("images_b64") or []
            if not isinstance(queries, list) or not isinstance(images_b64, list):
                self._json(400, {"error": "'queries'/'images_b64' must be lists"})
                return
            if not queries and not images_b64:
                self._json(400, {"error": "missing 'queries' and/or 'images_b64' list"})
                return
            if len(queries) + len(images_b64) > self.MAX_BATCH_QUERIES:
                # Unbounded fan-out would bucket the text tower to the next
                # power of two and can OOM the device on one bad request.
                self._json(400, {
                    "error": f"too many queries ({len(queries) + len(images_b64)} > "
                             f"{self.MAX_BATCH_QUERIES})"
                })
                return
            k = int(req.get("k", 10))
            folders = req.get("folders")
            try:
                image_rows = []
                if images_b64:
                    imgs = [_decode_b64_image(b) for b in images_b64]
                with lock:
                    # No explicit refresh: engine.search_texts refreshes via
                    # can_fuse_text_search / search_batch — doing it here too
                    # would just repeat the full-table fingerprint scans.
                    # engine.search_texts fuses tokenize→tower→scan→rescore
                    # into one device pass when the index is eligible.
                    batches = (
                        engine.search_texts(
                            [str(q) for q in queries], k, filter_folders=folders
                        )
                        if queries
                        else []
                    )
                    if images_b64:
                        valid = [i for i, im in enumerate(imgs) if im is not None]
                        image_rows = [None] * len(imgs)
                        if valid:
                            embs = engine.embed_pils([imgs[i] for i in valid])
                            found = engine.index.search_batch(
                                embs, k, filter_folders=folders
                            )
                            for j, i in enumerate(valid):
                                image_rows[i] = found[j]

                def rows(rs):
                    if rs is None:
                        return None
                    return [{"path": p, "similarity": round(s, 6)} for p, s in rs]

                out = {"results": [rows(rs) for rs in batches]}
                if images_b64:
                    out["image_results"] = [rows(rs) for rs in image_rows]
                self._json(200, out)
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": str(e)})

    return Handler


class SearchServer:
    """Threaded HTTP server around a resident engine."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000, batch_window_ms=None):
        self._lock = threading.Lock()
        self.metrics = ServerMetrics()
        self.batcher = MicroBatcher(engine, self._lock, window_ms=batch_window_ms)
        self.httpd = _Server(
            (host, port), make_handler(engine, self._lock, self.metrics, self.batcher)
        )
        self.host, self.port = self.httpd.server_address[:2]

    def serve_forever(self) -> None:
        log(
            f"Serving on http://{self.host}:{self.port} "
            "(browser UI at /, POST /search, GET /health, /stats)"
        )
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            log("\nShutting down.")
        finally:
            self.httpd.server_close()
            self.batcher.shutdown()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.shutdown()


def warm_programs(engine, k: int = 10) -> int:
    """Capture the COMPLETE bounded serving program matrix.

    The engine buckets request batches to the {1,4,16,64} ladder
    (tpuclip_torch/utils/bucketing.py), so the full matrix is small: 4
    text-only fused programs, the lone-image fused program and 4x4 mixed
    (text-bucket, image-bucket) programs, then 3 batch-search shapes. The
    programs run under the environment as it stands, so their shortlist
    method (``TPUCLIP_SHORTLIST``: ``exact`` / ``extract`` under ``auto``,
    or ``approx`` or ``verified`` when set) is the one live traffic
    resolves (tpuclip's warms ``auto`` and ``approx`` both).
    On the card each fused program is one CUDA graph whose capture would
    otherwise land inside a live request window. Run this at deployment
    startup (``serve --warm``). Returns the number of warm calls made: 24
    on a fused index, 3 otherwise (tpuclip returns 0 there, before its
    batch shapes); a model without a text tower warms the lone-image
    program and the batch shapes, 4 on a fused index."""
    import numpy as np
    from PIL import Image

    from tpuclip_torch.utils.bucketing import BATCH_BUCKETS

    engine.index.refresh()
    rng = np.random.default_rng(0)
    calls = 0
    if engine.index.can_fuse_text_search(k, None, assume_fresh=True):
        pil = Image.fromarray((rng.random((96, 96, 3)) * 255).astype(np.uint8))
        texts = [f"warmup bucket query {i}" for i in range(max(BATCH_BUCKETS))]
        for b in BATCH_BUCKETS if engine.has_text_tower else ():
            engine._search_texts_fused(texts[:b], k)
            calls += 1
        engine._search_image_fused(pil, k)
        calls += 1
        for tb in BATCH_BUCKETS if engine.has_text_tower else ():
            for ib in BATCH_BUCKETS:
                engine._search_mixed_fused(texts[:tb], [pil] * ib, k)
                calls += 1
    # Image-only windows (>=2 uploads, no texts) and /search_batch take
    # embed_pils + the ladder-bucketed index.search_batch, on every index.
    qv = rng.standard_normal((4, engine.embedding_dim)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    for qb in (4, 16, 64):
        engine.index.search_batch(np.repeat(qv, 16, 0)[:qb], k)
        calls += 1
    return calls


def run_serve(args, paths) -> None:
    """CLI entry: load the engine once, serve until interrupted."""
    import sys

    from tpuclip_torch.cli import _make_engine, _require_db_path

    db_path = _require_db_path(args, paths)
    if not os.path.exists(db_path):
        log(f"[X] Error: Database file does not exist: {db_path}")
        sys.exit(2)
    engine = _make_engine(db_path, args)
    engine.index.refresh()  # upload the index before accepting traffic
    # Run (on the card: capture) the bucket-1 text program NOW, at the
    # endpoint's default k: the first live request would otherwise pay it.
    # A failure here stops the server (tpuclip logs and serves on; an empty
    # database searches to no results without raising).
    if engine.has_text_tower:
        engine.search_texts(["warmup"], 10)
    else:  # an image-only model: the lone-image program instead
        from PIL import Image

        engine.search_image_pil(Image.new("RGB", (96, 96), (128, 96, 64)), 10)
    if getattr(args, "warm", False):
        n = warm_programs(engine)
        log(f"Warmed the full serving program matrix ({n} programs).")
    else:
        log("Warmup query ran the bucket-1 text program "
            "(use --warm to capture the full batch-bucket matrix).")
    srv = SearchServer(engine, args.host, args.port)

    # Graceful SIGTERM (the orchestrator-default stop signal): finish
    # in-flight requests, drain the micro-batcher, exit 0 — instead of
    # killing mid-request. serve_forever already handles SIGINT.
    import signal
    import threading

    def _term(_sig, _frm):
        log("SIGTERM: draining and shutting down.")
        # shutdown() must come from another thread: it joins the server
        # loop that this handler interrupted.
        threading.Thread(target=srv.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:  # non-main thread (embedded use) — skip the hook
        pass
    srv.serve_forever()
