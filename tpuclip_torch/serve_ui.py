"""Browser UI for the serving mode.

The reference's user experience is a static HTML gallery written after each
query (image_database.py:1660-1851, browser.png). The server equivalent is a
live page: ``GET /`` serves a self-contained search UI (no external assets,
works over the same origin it is served from) that drives the existing JSON
endpoints (``/search``, ``/stats``) and renders results via ``GET /image``.

``/image`` only ever serves files that are **rows in the images table** — the
path parameter is matched exactly against ``images.file_path``, so the server
cannot be used to read arbitrary filesystem paths. Formats a browser cannot
display (PDF/TIF/BMP, the same set the gallery substitutes) are served as
their 400x400 JPEG thumbnails (io/thumbnails.py); everything else is served
raw, or re-encoded to a bounded JPEG when ``size=N`` is given (the grid asks
for ``size=400`` so a 50 MP original costs ~30 KB on the wire, mirroring the
gallery's thumbnail economics).
"""

from __future__ import annotations

import io
import os
from typing import Dict, Optional, Tuple

from tpuclip_torch.io.thumbnails import needs_thumbnail

_RAW_CONTENT_TYPES = {
    ".jpg": "image/jpeg",
    ".jpeg": "image/jpeg",
    ".png": "image/png",
    ".gif": "image/gif",
    ".webp": "image/webp",
}

# (status, content_type, body, extra_headers)
ImageResponse = Tuple[int, str, bytes, Dict[str, str]]


def _error(status: int, message: str) -> ImageResponse:
    return status, "text/plain; charset=utf-8", message.encode(), {}


def _etag_for(path: str, size: Optional[int]) -> Optional[str]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return f'W/"{int(st.st_mtime)}-{st.st_size}-{size or 0}"'


def serve_image(
    engine,
    path: str,
    size: Optional[int] = None,
    if_none_match: Optional[str] = None,
) -> ImageResponse:
    """Resolve one ``GET /image`` request.

    ``path`` must equal a stored ``images.file_path`` (the scan pipeline
    stores absolute paths); anything else is a 404 regardless of what exists
    on disk. ``size`` bounds the longest edge via a JPEG re-encode.
    Conditional requests short-circuit on a weak mtime/size ETag so the grid
    re-render after every query costs no image bytes.
    """
    if not path:
        return _error(400, "missing 'path' parameter")
    row = engine.store.lookup_image(path)
    if row is None:
        return _error(404, "path is not in this database")
    _, _, file_hash = row

    serve_path = path
    if needs_thumbnail(path):
        # Browsers render none of PDF/TIF/BMP inline; reuse the gallery's
        # content-hash-named thumbnail (created at scan time, or on demand
        # here for rows scanned before thumbnails existed).
        engine.thumbnailer.ensure_for(path, file_hash)
        thumb = engine.thumbnailer.thumbnail_path(path, file_hash)
        if not os.path.exists(thumb):
            return _error(404, "thumbnail unavailable")
        serve_path = thumb
        size = None  # thumbnails are already bounded JPEGs

    if not os.path.exists(serve_path):
        return _error(404, "file no longer exists on disk")

    etag = _etag_for(serve_path, size)
    headers = {"Cache-Control": "max-age=3600"}
    if etag:
        headers["ETag"] = etag
        if if_none_match and if_none_match == etag:
            return 304, "", b"", headers

    if size is not None:
        size = max(16, min(int(size), 2048))
        try:
            from PIL import Image

            with Image.open(serve_path) as im:
                im = im.convert("RGB")
                im.thumbnail((size, size), Image.Resampling.LANCZOS)
                buf = io.BytesIO()
                im.save(buf, format="JPEG", quality=85)
            return 200, "image/jpeg", buf.getvalue(), headers
        except Exception:  # noqa: BLE001 - fall through to the raw bytes
            pass

    ext = os.path.splitext(serve_path)[1].lower()
    ctype = _RAW_CONTENT_TYPES.get(ext, "application/octet-stream")
    try:
        with open(serve_path, "rb") as f:
            body = f.read()
    except OSError as e:
        return _error(404, f"unreadable: {e}")
    return 200, ctype, body, headers


UI_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>tpuclip</title>
<style>
  body { font-family: system-ui, Arial, sans-serif; max-width: 1400px;
         margin: 0 auto; padding: 20px; background: #f4f5f7; color: #222; }
  h1 { color: #333; margin-bottom: 4px; }
  h1 span { color: #2a6fd0; }
  .sub { color: #777; font-size: 13px; margin-bottom: 16px; }
  form { display: flex; gap: 8px; flex-wrap: wrap; align-items: center;
         background: #fff; padding: 14px; border-radius: 8px;
         box-shadow: 0 1px 4px rgba(0,0,0,.12); }
  #q { flex: 1 1 320px; padding: 10px; font-size: 15px; border: 1px solid #ccc;
       border-radius: 4px; }
  #k { width: 64px; padding: 10px; border: 1px solid #ccc; border-radius: 4px; }
  #folder { flex: 0 1 220px; padding: 10px; border: 1px solid #ccc;
            border-radius: 4px; }
  button, label.upload { padding: 10px 18px; background: #2a6fd0; color: #fff;
           border: 0; border-radius: 4px; font-size: 14px; cursor: pointer; }
  button:hover, label.upload:hover { background: #1c5ab0; }
  label.upload { background: #3c9a4e; }
  label.upload:hover { background: #338343; }
  label.dups { font-size: 13px; color: #555; user-select: none; }
  #status { margin: 14px 2px; color: #555; font-size: 14px; min-height: 18px; }
  #status.err { color: #b03030; }
  .gallery { display: grid;
             grid-template-columns: repeat(auto-fill, minmax(280px, 1fr));
             gap: 18px; margin-top: 6px; }
  .result-item { background: #fff; border-radius: 8px; padding: 12px;
                 box-shadow: 0 1px 4px rgba(0,0,0,.12); }
  .image-container { width: 100%; height: 280px; overflow: hidden;
                     border-radius: 4px; margin-bottom: 8px; background: #eee;
                     display: flex; align-items: center; justify-content: center; }
  .image-container img { max-width: 100%; max-height: 280px; object-fit: contain; }
  .score { font-weight: 600; color: #2a6fd0; }
  .score a.more { font-weight: 400; font-size: 12px; color: #3c9a4e;
                  margin-left: 8px; }
  .file-path { font-size: 11px; color: #666; word-break: break-all; margin-top: 4px; }
  footer { margin-top: 28px; font-size: 12px; color: #888; }
</style>
</head>
<body>
<h1>tpu<span>clip</span></h1>
<div class="sub">semantic image search &mdash; text, blends (<code>a + b</code>),
negatives (<code>a - b</code>), or an uploaded image</div>
<form id="f">
  <input id="q" type="text" placeholder="Query&hellip;" autofocus>
  <input id="k" type="number" value="20" min="1" max="500" title="results">
  <input id="folder" type="text" placeholder="folder filter (optional)">
  <label class="dups"><input id="dups" type="checkbox"> duplicates</label>
  <button type="submit">Search</button>
  <label class="upload">Image&hellip;<input id="file" type="file"
    accept="image/*" hidden></label>
  <label class="upload" style="background:#8a5ac0"
    title="Type comma-separated labels in the query box, then pick an image">
    Classify&hellip;<input id="cfile" type="file" accept="image/*" hidden></label>
</form>
<div id="status"></div>
<div class="gallery" id="g"></div>
<footer id="stats"></footer>
<script>
"use strict";
const $ = id => document.getElementById(id);
const status_ = (msg, err) => { $("status").textContent = msg;
  $("status").className = err ? "err" : ""; };

function body() {
  const b = { k: parseInt($("k").value || "20", 10),
              show_duplicates: $("dups").checked };
  const folder = $("folder").value.trim();
  if (folder) b.folders = [folder];
  return b;
}

function render(data) {
  const g = $("g");
  g.innerHTML = "";
  if (!data.results || !data.results.length) {
    status_("No results."); return;
  }
  status_(`${data.results.length} results`);
  for (const r of data.results) {
    const card = document.createElement("div");
    card.className = "result-item";
    const link = `/image?path=${encodeURIComponent(r.path)}`;
    card.innerHTML =
      `<a href="${link}" target="_blank"><div class="image-container">` +
      `<img loading="lazy" src="${link}&size=400"` +
      ` onerror="this.style.display='none'"></div></a>` +
      `<div class="score">${r.similarity.toFixed(4)}` +
      ` <a class="more" href="#">more like this</a></div>` +
      `<div class="file-path"></div>`;
    card.querySelector(".file-path").textContent = r.path;
    card.querySelector(".more").addEventListener("click", ev => {
      ev.preventDefault();
      // image:<path> rides the REPL mini-language; the path is a DB row's,
      // so the server can always read it.
      search({ query: `image:${r.path}`, ...body() }, "by result image");
      window.scrollTo(0, 0);
    });
    g.appendChild(card);
  }
}

async function search(payload, label) {
  status_(`Searching ${label}…`);
  try {
    const resp = await fetch("/search", { method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify(payload) });
    const data = await resp.json();
    if (!resp.ok) { status_(data.error || resp.statusText, true); return; }
    render(data);
  } catch (e) { status_(String(e), true); }
}

$("f").addEventListener("submit", ev => {
  ev.preventDefault();
  const q = $("q").value.trim();
  if (q) search({ query: q, ...body() }, JSON.stringify(q));
});

$("file").addEventListener("change", () => {
  const f = $("file").files[0];
  if (!f) return;
  const reader = new FileReader();
  reader.onload = () => {
    const b64 = reader.result.split(",", 2)[1];
    search({ image_b64: b64, ...body() }, `by image (${f.name})`);
  };
  reader.readAsDataURL(f);
  $("file").value = "";
});

$("cfile").addEventListener("change", () => {
  // Zero-shot classification: labels come from the query box
  // (comma-separated), the image from the picked file -> POST /classify.
  const f = $("cfile").files[0];
  $("cfile").value = "";
  if (!f) return;
  const labels = $("q").value.split(",").map(s => s.trim()).filter(Boolean);
  if (labels.length < 2) {
    status_("Classify needs 2+ comma-separated labels in the query box", true);
    return;
  }
  const reader = new FileReader();
  reader.onload = async () => {
    const b64 = reader.result.split(",", 2)[1];
    status_(`Classifying ${f.name}…`);
    try {
      const resp = await fetch("/classify", { method: "POST",
        headers: { "Content-Type": "application/json" },
        body: JSON.stringify({ image_b64: b64, labels }) });
      const data = await resp.json();
      if (!resp.ok) { status_(data.error || resp.statusText, true); return; }
      const g = $("g");
      g.innerHTML = "";
      const card = document.createElement("div");
      card.className = "result-item";
      card.innerHTML = `<div class="score"></div>`;
      card.querySelector(".score").textContent = `zero-shot: ${f.name}`;
      for (const row of data.labels) {
        const line = document.createElement("div");
        line.className = "file-path";
        line.style.fontSize = "14px";
        line.textContent =
          `${(row.prob * 100).toFixed(2).padStart(6)}%  (rel ` +
          `${(row.rel * 100).toFixed(1)}%)  ${row.label}`;
        card.appendChild(line);
      }
      g.appendChild(card);
      status_(`${data.labels.length} labels`);
    } catch (e) { status_(String(e), true); }
  };
  reader.readAsDataURL(f);
});

fetch("/stats").then(r => r.json()).then(s => {
  $("stats").textContent =
    `${(s.images || 0).toLocaleString()} images · model ${s.model}` +
    ` · ${s.embedding_dim}-d · mode ${s.search_mode}` +
    `/${s.search_precision}`;
}).catch(() => {});
</script>
</body>
</html>
"""
