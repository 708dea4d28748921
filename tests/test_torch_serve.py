"""The port's HTTP server (``tpuclip_torch.serve``) on the CPU, held to
tpuclip's server over ONE tiny database that both open: the same tiny
checkpoint (written by tpuclip's ``save_checkpoint``), the int8 search with
the rerank rows resident (``TPUCLIP_DEVICE_RERANK=1``), so plain text and
upload queries take the fused programs. Every endpoint answers with the
same status, paths and (within 1e-5) scores; a mixed window, concurrent
requests, ``warm_programs`` and a graceful SIGTERM of
``python -m tpuclip_torch.cli serve --device cpu``."""

import base64
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

import tpuclip.engine as jx_engine
import tpuclip.serve as jx_serve
import tpuclip_torch.engine as pt_engine
import tpuclip_torch.serve as pt_serve
from tpuclip.models.checkpoint import save_checkpoint
from tpuclip.models.configs import get_config
from tpuclip.models.siglip import init_params
from tpuclip_torch.index.search import DeviceIndex as PtIndex

MODEL = "tpuclip/test-tiny"
REPO = Path(__file__).resolve().parents[1]
ENV = {"TPUCLIP_SEARCH_PRECISION": "int8", "TPUCLIP_DEVICE_RERANK": "1", "TPUCLIP_SEARCH_MODE": "exact"}
COLORS = [("red.jpg", (220, 30, 30)), ("green.png", (30, 200, 30)), ("blue.webp", (40, 40, 230)),
          ("grey.png", (128, 128, 128)), ("noise.png", None)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(tmp, model cache, db, tpuclip engine, port engine, tpuclip server,
    port server)."""
    tmp = tmp_path_factory.mktemp("torch_serve")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCLIP_HOME", str(tmp / "home"))
        for key, value in ENV.items():
            mp.setenv(key, value)
        mp.delenv("TPUCLIP_SHORTLIST", raising=False)
        cache = tmp / "models"
        params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(4), get_config(MODEL)))
        save_checkpoint(str(cache / MODEL.replace("/", "--")), params, get_config(MODEL))
        imgs = tmp / "imgs"
        imgs.mkdir()
        rng = np.random.default_rng(9)
        for name, color in COLORS:
            if color is None:
                Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(imgs / name)
            else:
                Image.new("RGB", (64, 64), color).save(imgs / name)
        db = str(tmp / "s.db")
        eng_j = jx_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4)
        eng_j.scan_directory(str(imgs), inference_batch_size=4)
        eng_t = pt_engine.ImageDatabase(db, str(cache), model_name=MODEL, inference_batch_size=4, device="cpu")
        srv_j = jx_serve.SearchServer(eng_j, host="127.0.0.1", port=0)
        srv_t = pt_serve.SearchServer(eng_t, host="127.0.0.1", port=0)
        srv_j.start_background()
        srv_t.start_background()
        try:
            yield tmp, cache, db, eng_j, eng_t, srv_j, srv_t
        finally:
            srv_t.shutdown()
            srv_j.shutdown()


@pytest.fixture()
def env(world, monkeypatch):
    monkeypatch.setenv("TPUCLIP_HOME", str(world[0] / "home"))
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("TPUCLIP_SHORTLIST", raising=False)
    return world


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(srv, path, payload, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64(path):
    return base64.b64encode(Path(path).read_bytes()).decode()


def _same_rows(got, want):
    """Result rows ({"path", "similarity"}) from the two servers."""
    assert len(got) == len(want) > 0
    assert [r["path"] for r in got] == [r["path"] for r in want]
    np.testing.assert_allclose(
        [r["similarity"] for r in got], [r["similarity"] for r in want], rtol=0, atol=1e-5
    )


def test_health_and_stats(env):
    *_, eng_t, srv_j, srv_t = env
    status, body = _get(srv_t, "/health")
    assert (status, body) == _get(srv_j, "/health") == (200, {"status": "ok", "model": MODEL})
    status, body = _get(srv_t, "/stats")
    _, want = _get(srv_j, "/stats")
    assert status == 200
    for key in ("images", "full_embeddings", "binary_embeddings", "embedding_dim", "model",
                "db_path", "search_mode", "search_precision", "cascade_active", "window_ms", "max_batch"):
        assert body[key] == want[key], key
    assert body["images"] == len(COLORS) and body["embedding_dim"] == 64
    assert eng_t.index.can_fuse_text_search(10, None)


@pytest.mark.parametrize(
    "payload",
    [
        {"query": "a red square", "k": 3},
        {"query": "red + blue - green", "k": 3},
        {"query": "a grey square", "k": 5, "show_duplicates": True},
        {"query": "blue", "k": 2, "negative": "green"},
        {"query": "a red square", "k": 4, "folders": ["<imgs>"]},
    ],
    ids=["text", "mini-language", "show-duplicates", "negative", "folder"],
)
def test_search_matches_tpuclip(env, payload):
    tmp, *_, srv_j, srv_t = env
    if "folders" in payload:
        payload = dict(payload, folders=[str(tmp / "imgs")])
    status, body = _post(srv_t, "/search", payload)
    status_j, want = _post(srv_j, "/search", payload)
    assert status == status_j == 200
    assert body["query"] == want["query"]
    _same_rows(body["results"], want["results"])


def test_bad_and_malformed_requests_match_tpuclip(env):
    tmp, *_, srv_j, srv_t = env
    red = _b64(tmp / "imgs" / "red.jpg")
    cases = [
        ("/search", {"k": 5}), ("/nope", {"query": "x"}), ("/search", {"query": "k:20"}),
        ("/search", {"image_b64": red, "query": "x"}), ("/search", {"image_b64": "!!!not-base64!!!"}),
        ("/search", {"image_b64": base64.b64encode(b"hello").decode()}),
        ("/embed", {}), ("/embed", {"texts": "a red car"}), ("/search_batch", {"queries": "notalist"}),
        ("/search_batch", {}), ("/classify", {"labels": ["a"]}), ("/classify", {"image_b64": red}),
        ("/classify", {"image_b64": "!!!", "labels": ["a"]}),
    ]
    for path, payload in cases:
        got, want = _post(srv_t, path, payload), _post(srv_j, path, payload)
        assert got[0] == want[0] and got[0] in (400, 404), (path, payload, got, want)
    raw = b"{not json"
    assert _post(srv_t, "/search", None, raw)[0] == _post(srv_j, "/search", None, raw)[0] == 400
    with urllib.request.urlopen(f"http://127.0.0.1:{srv_t.port}/", timeout=30) as r:
        assert r.status == 200 and b"<html" in r.read().lower()


def test_embed_matches_tpuclip(env):
    tmp, *_, srv_j, srv_t = env
    payload = {"texts": ["red", "blue"], "images_b64": [_b64(tmp / "imgs" / "green.png"), "QUJD"],
               "images": [str(tmp / "imgs" / "red.jpg")]}
    status, body = _post(srv_t, "/embed", payload)
    status_j, want = _post(srv_j, "/embed", payload)
    assert status == status_j == 200 and body["dim"] == want["dim"] == 64
    np.testing.assert_allclose(body["text_embeddings"], want["text_embeddings"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(body["image_embeddings"], want["image_embeddings"], rtol=0, atol=1e-5)
    assert body["image_b64_embeddings"][1] is None and want["image_b64_embeddings"][1] is None
    np.testing.assert_allclose(body["image_b64_embeddings"][0], want["image_b64_embeddings"][0], rtol=0, atol=1e-5)


def test_search_batch_matches_tpuclip(env):
    tmp, *_, srv_j, srv_t = env
    payload = {"queries": ["red", "green", "blue", "grey"], "k": 3,
               "images_b64": [_b64(tmp / "imgs" / "blue.webp"), _b64(tmp / "imgs" / "noise.png"), "QUJD"]}
    status, body = _post(srv_t, "/search_batch", payload)
    status_j, want = _post(srv_j, "/search_batch", payload)
    assert status == status_j == 200
    assert len(body["results"]) == 4 and len(body["image_results"]) == 3
    for got, ref in zip(body["results"] + body["image_results"][:2], want["results"] + want["image_results"][:2]):
        _same_rows(got, ref)
    assert body["image_results"][2] is None
    assert body["image_results"][0][0]["path"] == str(tmp / "imgs" / "blue.webp")


def test_image_b64_search_matches_tpuclip(env):
    tmp, *_, srv_j, srv_t = env
    payload = {"image_b64": _b64(tmp / "imgs" / "noise.png"), "k": 3}
    status, body = _post(srv_t, "/search", payload)
    status_j, want = _post(srv_j, "/search", payload)
    assert status == status_j == 200 and body["query"] == "<image upload>"
    _same_rows(body["results"], want["results"])
    assert body["results"][0]["path"] == str(tmp / "imgs" / "noise.png")


def test_classify_matches_tpuclip(env):
    tmp, *_, srv_j, srv_t = env
    labels = ["a red square", "a green square", "a blue square"]
    for source in ({"image_b64": _b64(tmp / "imgs" / "red.jpg")}, {"image": str(tmp / "imgs" / "noise.png")}):
        payload = dict(source, labels=labels)
        status, body = _post(srv_t, "/classify", payload)
        status_j, want = _post(srv_j, "/classify", payload)
        assert status == status_j == 200
        assert [r["label"] for r in body["labels"]] == [r["label"] for r in want["labels"]]
        for got, ref in zip(body["labels"], want["labels"]):
            assert got["prob"] == pytest.approx(ref["prob"], abs=1e-5)
            assert got["rel"] == pytest.approx(ref["rel"], abs=1e-5)
    status, body = _post(srv_t, "/classify", {"image": str(tmp / "imgs" / "red.jpg"), "labels": ["x"] * 300})
    assert status == 400 and "too many labels" in body["error"]


def _burst(srv, payloads):
    """All payloads to /search at once (behind a barrier); returns bodies."""
    results, errors = [None] * len(payloads), []
    barrier = threading.Barrier(len(payloads))

    def worker(i):
        try:
            barrier.wait(timeout=30)
            status, body = _post(srv, "/search", payloads[i])
            assert status == 200, body
            results[i] = body["results"]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and all(r is not None for r in results), errors
    return results


def test_fused_mixed_window_matches_tpuclip(env):
    """Texts and uploads in one window take the mixed program (both towers
    and one scan): each result equals tpuclip's answer to the same request
    alone, and the window is counted."""
    tmp, cache, db, eng_j, eng_t, srv_j, _ = env
    srv = pt_serve.SearchServer(eng_t, host="127.0.0.1", port=0, batch_window_ms=500)
    srv.start_background()
    try:
        payloads = [{"query": "a red square", "k": 3}, {"query": "something green", "k": 3},
                    {"image_b64": _b64(tmp / "imgs" / "noise.png"), "k": 3},
                    {"image_b64": _b64(tmp / "imgs" / "grey.png"), "k": 3}]
        results = _burst(srv, payloads)
        assert srv.batcher.stats()["mixed_windows"] >= 1
        for got, payload in zip(results, payloads):
            _same_rows(got, _post(srv_j, "/search", payload)[1]["results"])
    finally:
        srv.shutdown()


def test_concurrent_requests_match_tpuclip(env):
    *_, srv_j, srv_t = env
    queries = ["red thing", "green thing", "blue thing"] * 2
    results = _burst(srv_t, [{"query": q, "k": 2} for q in queries])
    want = {q: _post(srv_j, "/search", {"query": q, "k": 2})[1]["results"] for q in set(queries)}
    for q, got in zip(queries, results):
        _same_rows(got, want[q])
    assert srv_t.batcher.stats()["batched_requests"] >= len(queries)


def test_warm_programs_counts(env, monkeypatch):
    """24 warm calls on a fused index (4 text + 1 image + 16 mixed programs,
    then 3 batch shapes), 3 on one without the rerank rows."""
    *_, eng_t, _, _ = env
    assert pt_serve.warm_programs(eng_t, k=3) == 24
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "0")
    fused_index = eng_t.index
    eng_t.index = PtIndex(eng_t.store, device="cpu")
    try:
        assert not eng_t.index.can_fuse_text_search(3, None)
        assert pt_serve.warm_programs(eng_t, k=3) == 3
    finally:
        eng_t.index = fused_index


def test_warm_programs_keeps_the_shortlist_env(env, monkeypatch):
    """The warm runs under the environment as it stands: with
    ``TPUCLIP_SHORTLIST=exact`` every fused program takes ``exact``, the key
    live traffic resolves, and the variable is left as it was."""
    *_, eng_t, _, _ = env
    monkeypatch.setenv("TPUCLIP_SHORTLIST", "exact")
    stats = eng_t.index.shortlist_stats
    before = stats.get("exact_searches", 0), stats.get("extract_searches", 0)
    assert pt_serve.warm_programs(eng_t, k=3) == 24
    assert os.environ["TPUCLIP_SHORTLIST"] == "exact"
    assert stats.get("extract_searches", 0) == before[1]
    assert stats.get("exact_searches", 0) >= before[0] + 21


def test_sigterm_graceful_shutdown(env, tmp_path):
    """``python -m tpuclip_torch.cli serve --device cpu`` serves, then
    drains and exits 0 on SIGTERM."""
    tmp, cache, db, *_ = env
    env_vars = dict(os.environ, PYTHONPATH=str(REPO), TPUCLIP_HOME=str(tmp_path), TPUCLIP_QUIET="0", **ENV)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuclip_torch.cli", "serve", "--db", db, "--port", "0", "--device", "cpu",
         "--model", MODEL, "--model-cache", str(cache)],
        cwd=REPO, env=env_vars, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    try:
        port = None
        deadline = time.time() + 120
        while time.time() < deadline and port is None:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
            lines.append(line)
            if "Serving on http://" in line:
                port = int(line.split(":")[-1].split()[0].strip("/"))
        assert port, "server never reported ready:\n" + "".join(lines[-30:])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
            assert r.status == 200
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/search", data=json.dumps({"query": "red", "k": 2}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200 and len(json.loads(r.read())["results"]) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
