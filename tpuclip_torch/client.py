"""Python client for a running ``tpuclip serve`` instance.

Stdlib-only (urllib), so integrations don't need requests/httpx. Mirrors the
HTTP surface documented in serve.py: search (text mini-language, algebra
params, image upload), batch search, raw embeddings, health, stats.

    from tpuclip_torch.client import Client
    c = Client("http://tpu-host:8000")
    for path, sim in c.search("a red bicycle", k=20):
        ...
    vecs = c.embed_texts(["a dog", "a cat"])        # np.float32 (2, D)
    results = c.search_image_file("query.jpg")      # uploads the bytes
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import List, Optional, Sequence, Tuple

import numpy as np

Results = List[Tuple[str, float]]


class ServeError(RuntimeError):
    """Server-side failure; carries the HTTP status and server message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class Client:
    def __init__(self, base_url: str = "http://127.0.0.1:8000", timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # ------------------------------------------------------------- plumbing
    def _request(self, path: str, payload: Optional[dict] = None) -> dict:
        url = f"{self.base_url}{path}"
        if payload is None:
            req = urllib.request.Request(url)
        else:
            req = urllib.request.Request(
                url,
                data=json.dumps(payload).encode("utf-8"),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                message = json.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001
                message = str(e)
            raise ServeError(e.code, message) from None

    @staticmethod
    def _results(payload: dict) -> Results:
        return [(r["path"], r["similarity"]) for r in payload["results"]]

    # ------------------------------------------------------------ endpoints
    def health(self) -> dict:
        return self._request("/health")

    def stats(self) -> dict:
        return self._request("/stats")

    def search(
        self,
        query: str,
        k: int = 10,
        folders: Optional[Sequence[str]] = None,
        show_duplicates: bool = False,
        negative: Optional[str] = None,
        negative_weight: Optional[float] = None,
        query2: Optional[str] = None,
        weights: Optional[Tuple[float, float]] = None,
    ) -> Results:
        """Text search. ``query`` supports the serving mini-language
        ("a + b", "a - b", "image:<server-local path>"); the keyword
        arguments are the explicit-parameter alternative."""
        payload: dict = {"query": query, "k": k, "show_duplicates": show_duplicates}
        if folders:
            payload["folders"] = list(folders)
        if negative is not None:
            payload["negative"] = negative
        if negative_weight is not None:
            payload["negative_weight"] = negative_weight
        if query2 is not None:
            payload["query2"] = query2
        if weights is not None:
            payload["weights"] = list(weights)
        return self._results(self._request("/search", payload))

    def search_image_bytes(
        self,
        data: bytes,
        k: int = 10,
        folders: Optional[Sequence[str]] = None,
        show_duplicates: bool = False,
    ) -> Results:
        """Search by an image the CLIENT holds: uploads the raster bytes."""
        payload: dict = {
            "image_b64": base64.b64encode(data).decode("ascii"),
            "k": k,
            "show_duplicates": show_duplicates,
        }
        if folders:
            payload["folders"] = list(folders)
        return self._results(self._request("/search", payload))

    def search_image_file(self, path: str, **kwargs) -> Results:
        with open(path, "rb") as f:
            return self.search_image_bytes(f.read(), **kwargs)

    def search_batch(
        self,
        queries: Sequence[str],
        k: int = 10,
        folders: Optional[Sequence[str]] = None,
    ) -> List[Results]:
        """Many text queries in one request: the server embeds them in one
        tower pass and scans the matrix once."""
        payload: dict = {"queries": list(queries), "k": k}
        if folders:
            payload["folders"] = list(folders)
        out = self._request("/search_batch", payload)
        return [self._results({"results": rs}) for rs in out["results"]]

    def search_image_bytes_batch(
        self,
        images: Sequence[bytes],
        k: int = 10,
        folders: Optional[Sequence[str]] = None,
    ) -> List[Optional[Results]]:
        """Many upload-image queries in one request: the server embeds them
        in one vision-tower pass and scans the matrix once. None per slot
        that failed to decode."""
        payload: dict = {
            "images_b64": [base64.b64encode(b).decode("ascii") for b in images],
            "k": k,
        }
        if folders:
            payload["folders"] = list(folders)
        out = self._request("/search_batch", payload)
        return [
            self._results({"results": rs}) if rs is not None else None
            for rs in out["image_results"]
        ]

    def classify_image_bytes(
        self, data: bytes, labels: Sequence[str]
    ) -> List[tuple]:
        """Zero-shot classification of an uploaded image: returns
        [(label, sigmoid_prob, softmax_prob)] sorted descending."""
        out = self._request(
            "/classify",
            {
                "image_b64": base64.b64encode(data).decode("ascii"),
                "labels": list(labels),
            },
        )
        return [(r["label"], r["prob"], r["rel"]) for r in out["labels"]]

    def classify_image_file(self, path: str, labels: Sequence[str]) -> List[tuple]:
        with open(path, "rb") as f:
            return self.classify_image_bytes(f.read(), labels)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """L2-normalized text embeddings, fp32 (n, D)."""
        out = self._request("/embed", {"texts": list(texts)})
        return np.asarray(out["text_embeddings"], dtype=np.float32)

    def embed_image_bytes_list(
        self, images: Sequence[bytes]
    ) -> List[Optional[np.ndarray]]:
        """Embeddings for uploaded images; None per slot that failed to
        decode (the server's containment contract)."""
        out = self._request(
            "/embed",
            {"images_b64": [base64.b64encode(b).decode("ascii") for b in images]},
        )
        return [
            np.asarray(e, dtype=np.float32) if e is not None else None
            for e in out["image_b64_embeddings"]
        ]
