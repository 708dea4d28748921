"""Self-contained HTML result galleries.

Functional contract from ``generate_html_gallery`` /
``generate_output_filename`` (image_database.py:1660-1888):
- responsive card grid, similarity to 4 decimal places, filename + full path,
- ``file:///`` display URLs with Windows drive-letter handling,
- ``localexplorer:`` Open Image / Open Folder action links,
- thumbnails substituted for PDF/TIF/BMP (generated on demand for results),
- inline-SVG placeholders for missing thumbs and broken images,
- sanitized, auto-incrementing output filenames under the results dir.
"""

from __future__ import annotations

import base64
import html as html_mod
import re
from pathlib import Path
from typing import List, Optional, Tuple

from tpuclip_torch.utils.logging import log


def _svg_placeholder(text: str) -> str:
    svg = (
        '<svg width="200" height="200" xmlns="http://www.w3.org/2000/svg">'
        '<rect width="200" height="200" fill="#ddd"/>'
        f'<text x="50%" y="50%" font-family="Arial" font-size="14" fill="#999" '
        f'text-anchor="middle" dy=".3em">{text}</text></svg>'
    )
    return "data:image/svg+xml;base64," + base64.b64encode(svg.encode()).decode()


_PLACEHOLDER_NO_THUMB = _svg_placeholder("Thumbnail not available")
_PLACEHOLDER_NOT_FOUND = _svg_placeholder("Image not found")

_STYLE = """
    body { font-family: system-ui, Arial, sans-serif; max-width: 1400px;
           margin: 0 auto; padding: 20px; background: #f4f5f7; color: #222; }
    h1 { color: #333; }
    .query { background: #eef4fb; border-left: 4px solid #2a6fd0; padding: 14px;
             margin: 18px 0; border-radius: 4px; font-size: 16px; }
    .query strong { color: #1c5ab0; }
    .gallery { display: grid; grid-template-columns: repeat(auto-fill, minmax(300px, 1fr));
               gap: 18px; margin-top: 18px; }
    .result-item { background: #fff; border-radius: 8px; padding: 14px;
                   box-shadow: 0 1px 4px rgba(0,0,0,.12); transition: transform .15s; }
    .result-item:hover { transform: translateY(-2px);
                         box-shadow: 0 4px 10px rgba(0,0,0,.16); }
    .image-container { width: 100%; max-height: 400px; overflow: hidden;
                       border-radius: 4px; margin-bottom: 10px; background: #eee;
                       display: flex; align-items: center; justify-content: center; }
    .image-container img { max-width: 100%; max-height: 400px; object-fit: contain; }
    .score { font-weight: 600; color: #2a6fd0; margin-bottom: 6px; }
    .file-path { font-size: 12px; color: #666; word-break: break-all; margin-top: 6px; }
    .file-path strong { color: #333; }
    .actions { margin-top: 8px; display: flex; gap: 8px; flex-wrap: wrap; }
    .actions a { padding: 6px 12px; background: #2a6fd0; color: #fff;
                 text-decoration: none; border-radius: 4px; font-size: 12px; }
    .actions a:hover { background: #1c5ab0; }
    .actions a.folder-link { background: #3c9a4e; }
    .actions a.folder-link:hover { background: #338343; }
"""


def file_display_url(path: str) -> str:
    """Path → file:// URL; Windows drive-letter paths get three slashes
    (image_database.py:1810-1823)."""
    url = path.replace("\\", "/")
    if len(url) > 2 and url[1] == ":":
        return f"file:///{url}"
    if url.startswith("/"):
        return f"file://{url}"
    return f"file:///{url}"


def generate_html_gallery(
    results: List[Tuple[str, float]],
    output_file: str = "results.html",
    query: Optional[str] = None,
    thumbnailer=None,
) -> None:
    from tpuclip_torch.io.thumbnails import needs_thumbnail

    cards = []
    for file_path, similarity in results:
        file_url = f"localexplorer:{file_path}"
        folder_url = f"localexplorer:{Path(file_path).parent}"
        filename = Path(file_path).name

        if thumbnailer is not None and needs_thumbnail(file_path):
            thumb = thumbnailer.create(file_path)
            display_url = file_display_url(thumb) if thumb else _PLACEHOLDER_NO_THUMB
        else:
            display_url = file_display_url(file_path)

        cards.append(
            f"""        <div class="result-item">
            <div class="image-container">
                <img src="{html_mod.escape(display_url, quote=True)}" alt="{html_mod.escape(filename, quote=True)}" loading="lazy"
                     onerror="this.src='{_PLACEHOLDER_NOT_FOUND}';">
            </div>
            <div class="score">Similarity: {similarity:.4f}</div>
            <div class="file-path">
                <strong>{html_mod.escape(filename)}</strong><br>
                <small>{html_mod.escape(file_path)}</small>
            </div>
            <div class="actions">
                <a href="{html_mod.escape(file_url, quote=True)}">Open Image</a>
                <a href="{html_mod.escape(folder_url, quote=True)}" class="folder-link">Open Folder</a>
            </div>
        </div>"""
        )

    query_div = (
        f'<div class="query"><strong>Query:</strong> {html_mod.escape(query)}</div>'
        if query
        else ""
    )
    doc = f"""<!DOCTYPE html>
<html lang="en">
<head>
    <meta charset="UTF-8">
    <meta name="viewport" content="width=device-width, initial-scale=1.0">
    <title>Image Search Results</title>
    <style>{_STYLE}</style>
</head>
<body>
    <h1>Image Search Results</h1>
    {query_div}
    <p>Found {len(results)} results</p>
    <div class="gallery">
{chr(10).join(cards)}
    </div>
</body>
</html>"""

    with open(output_file, "w", encoding="utf-8") as f:
        f.write(doc)
    log(f"HTML gallery saved to {output_file}")


def generate_output_filename(
    query: str, is_image_path: bool = False, results_dir: Optional[Path] = None
) -> str:
    """Sanitized, auto-incrementing results path (image_database.py:1854-1888)."""
    if results_dir is None:
        from tpuclip_torch.config import default_paths

        results_dir = Path(default_paths().results_dir)
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)

    if is_image_path:
        query_name = Path(query).stem
    else:
        query_name = re.sub(r'[<>:"/\\|?*]', "_", query)
        query_name = query_name.replace(" ", "_")
        if len(query_name) > 100:
            query_name = query_name[:100]
        query_name = query_name.rstrip(". ")
        if not query_name:
            query_name = "query"

    output_file = results_dir / f"{query_name}.html"
    counter = 1
    while output_file.exists():
        counter += 1
        output_file = results_dir / f"{query_name}_{counter}.html"
    return str(output_file)


def combined_output_filename(
    query: str, query2: str, is_image: bool, is_image2: bool,
    results_dir: Optional[Path] = None,
) -> str:
    """Combined-query filename variant (image_database.py:2333-2348)."""
    if results_dir is None:
        from tpuclip_torch.config import default_paths

        results_dir = Path(default_paths().results_dir)
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    q1 = Path(query).stem if is_image else query[:50]
    q2 = Path(query2).stem if is_image2 else query2[:50]
    name = re.sub(r'[<>:"/\\|?*]', "_", f"{q1}_and_{q2}").replace(" ", "_")[:100]
    output_file = results_dir / f"{name}.html"
    counter = 1
    while output_file.exists():
        counter += 1
        output_file = results_dir / f"{name}_{counter}.html"
    return str(output_file)
