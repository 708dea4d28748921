"""The framework-neutral modules the port carries as copies
(``tpuclip_torch/{config,index/store,index/cache,io/*,text/*,utils/*,
gallery/html}.py``) against tpuclip's originals, on the same seeded inputs:
path resolution, the SQLite schema and the matrix-cache files (a database
written by either package opens in the other), decoded and resized bytes,
the walker's census, file hashes, tokenizer ids, the gallery's HTML, and
what the logging and profiling helpers print."""

import dataclasses
import hashlib
import json
import sqlite3
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import tpuclip.config as jx_config
import tpuclip.gallery.html as jx_html
import tpuclip.index.cache as jx_cache
import tpuclip.index.store as jx_store
import tpuclip.io.decode as jx_decode
import tpuclip.io.hashing as jx_hashing
import tpuclip.io.prefetch as jx_prefetch
import tpuclip.io.preprocess as jx_preprocess
import tpuclip.io.thumbnails as jx_thumbnails
import tpuclip.io.walker as jx_walker
import tpuclip.text.sentencepiece as jx_sp
import tpuclip.text.tokenizer as jx_tokenizer
import tpuclip.utils.bucketing as jx_bucketing
import tpuclip.utils.logging as jx_logging
import tpuclip.utils.profiling as jx_profiling
import tpuclip_torch.config as pt_config
import tpuclip_torch.gallery.html as pt_html
import tpuclip_torch.index.cache as pt_cache
import tpuclip_torch.index.store as pt_store
import tpuclip_torch.io.decode as pt_decode
import tpuclip_torch.io.hashing as pt_hashing
import tpuclip_torch.io.prefetch as pt_prefetch
import tpuclip_torch.io.preprocess as pt_preprocess
import tpuclip_torch.io.thumbnails as pt_thumbnails
import tpuclip_torch.io.walker as pt_walker
import tpuclip_torch.text.sentencepiece as pt_sp
import tpuclip_torch.text.tokenizer as pt_tokenizer
import tpuclip_torch.utils.bucketing as pt_bucketing
import tpuclip_torch.utils.logging as pt_logging
import tpuclip_torch.utils.profiling as pt_profiling

DIM = 64
PACKAGES = {"port": (pt_store, pt_cache), "tpuclip": (jx_store, jx_cache)}


def _images(root: Path, n: int = 6):
    """Seeded images of several sizes and modes, as PNG and JPEG files."""
    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        h, w = int(rng.integers(20, 300)), int(rng.integers(20, 300))
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if i % 3 == 1:
            img = img.convert("L")
        elif i % 3 == 2:
            img = img.convert("RGBA")
        path = root / f"img_{i}.{'png' if i % 2 else 'jpg'}"
        img.convert("RGB").save(path) if path.suffix == ".jpg" else img.save(path)
        paths.append(path)
    return paths


def test_config_resolves_as_the_original(tmp_path, monkeypatch):
    base = tmp_path / "repo"
    base.mkdir()
    (base / "config.json").write_text(json.dumps({
        "database_dir": "dbs", "model_cache_dir": str(tmp_path / "abs_models"),
        "results_dir": "out", "thumbnails_dir": "th",
    }))
    (tmp_path / "dbs").mkdir()
    for name in ("b.db", "a.DB", "notes.txt"):
        (tmp_path / "dbs" / name).touch()
    assert pt_config.DEFAULT_CONFIG == jx_config.DEFAULT_CONFIG
    assert pt_config.load_config(base) == jx_config.load_config(base)
    assert pt_config.load_config(tmp_path / "none") == jx_config.load_config(tmp_path / "none")
    assert dataclasses.asdict(pt_config.get_paths(base)) == dataclasses.asdict(jx_config.get_paths(base))
    legacy = {"database_path": "old/image_database.db"}
    assert pt_config.resolve_db_dir("", base, legacy) == jx_config.resolve_db_dir("", base, legacy)
    db_dir = str(tmp_path / "dbs")
    assert pt_config.list_db_files(db_dir) == jx_config.list_db_files(db_dir)
    for args in ((None, "lib", db_dir), (None, "lib.db", db_dir), ("/x/y.db", None, db_dir)):
        assert pt_config.resolve_db_path(*args) == jx_config.resolve_db_path(*args)
    for module in (pt_config, jx_config):
        with pytest.raises(ValueError):
            module.resolve_db_path(None, None, db_dir)
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    assert dataclasses.asdict(pt_config.default_paths()) == dataclasses.asdict(jx_config.default_paths())
    monkeypatch.delenv("TPUCLIP_HOME")
    assert dataclasses.asdict(pt_config.default_paths()) == dataclasses.asdict(jx_config.default_paths())


def _write_db(store_mod, cache_mod, path, vecs, vector_dtype):
    store = store_mod.MetadataStore(str(path), embedding_dim=DIM, vector_dtype=vector_dtype)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    batch = [(f"/lib/set_{i % 3}/{i:04d}.jpg", float(i), f"h{i}", vecs[i]) for i in range(len(vecs))]
    store.commit_with_retry(conn.cursor(), conn, batch, save_full_embeddings=True)
    conn.close()
    cache_mod.MatrixCache(store).load()
    return store


def _schema(path):
    conn = sqlite3.connect(path)
    try:
        return sorted(conn.execute("SELECT type, name, sql FROM sqlite_master").fetchall(), key=str)
    finally:
        conn.close()


@pytest.mark.parametrize("vector_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("writer", ["port", "tpuclip"])
def test_database_written_by_one_opens_in_the_other(tmp_path, writer, vector_dtype):
    """The writer's store and matrix cache build a database; the other
    package's store and cache read it back unchanged, and each package's own
    database has the same schema and the same cache files, byte for byte."""
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((40, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    reader = "tpuclip" if writer == "port" else "port"
    w_store, w_cache = PACKAGES[writer]
    r_store, r_cache = PACKAGES[reader]
    db = tmp_path / "w.db"
    written = _write_db(w_store, w_cache, db, vecs, vector_dtype)
    store = r_store.MetadataStore(str(db), embedding_dim=DIM)
    cache = r_cache.MatrixCache(store)
    manifest = (Path(str(db) + ".cache") / "manifest.json").read_bytes()
    ids, got = cache.load()
    want_ids, want = w_cache.MatrixCache(written).load()
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (Path(str(db) + ".cache") / "manifest.json").read_bytes() == manifest  # no rebuild
    bin_ids, bits = cache.load_binary()
    want_bin_ids, want_bits = w_cache.MatrixCache(written).load_binary()
    np.testing.assert_array_equal(bin_ids, want_bin_ids)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(want_bits))
    assert store.stored_embedding_dim() == written.stored_embedding_dim() == DIM
    assert store.count_images() == written.count_images() == len(vecs)
    assert store.embeddings_fingerprint() == written.embeddings_fingerprint()
    assert store.fetch_paths_for_ids(ids.tolist()) == written.fetch_paths_for_ids(ids.tolist())
    assert store.folder_filter_ids(["/lib/set_1"]) == written.folder_filter_ids(["/lib/set_1"])
    paths = ["/lib/set_0/0000.jpg", "/lib/set_2/0005.jpg"]
    got_bin, want_bin = store.fetch_binary_for_paths(paths), written.fetch_binary_for_paths(paths)
    assert set(got_bin) == set(want_bin) == set(paths)
    for p in paths:
        np.testing.assert_array_equal(got_bin[p], want_bin[p])
    # The reader's own database of the same rows: same schema, same cache files.
    own = tmp_path / "r.db"
    _write_db(r_store, r_cache, own, vecs, vector_dtype)
    assert _schema(own) == _schema(db)
    for name in sorted(p.name for p in Path(str(db) + ".cache").iterdir()):
        assert (Path(str(own) + ".cache") / name).read_bytes() == (Path(str(db) + ".cache") / name).read_bytes(), name
    assert pt_store._quantize_int8_blob(vecs[0]) == jx_store._quantize_int8_blob(vecs[0])


def test_decode_and_preprocess_bytes_equal(tmp_path):
    paths = _images(tmp_path)
    assert pt_decode.supported_extensions() == jx_decode.supported_extensions()
    decoded = []
    for path in paths:
        a, b = pt_decode.load_image(str(path)), jx_decode.load_image(str(path))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        data = path.read_bytes()
        for draft in (None, 64):
            np.testing.assert_array_equal(np.asarray(pt_decode.load_image_bytes(data, str(path), draft)),
                                          np.asarray(jx_decode.load_image_bytes(data, str(path), draft)))
        for size in (16, 224):
            np.testing.assert_array_equal(pt_preprocess.resize_to_uint8(a, size),
                                          jx_preprocess.resize_to_uint8(b, size))
        np.testing.assert_array_equal(pt_prefetch.decode_single(str(path), 32),
                                      jx_prefetch.decode_single(str(path), 32))
        patches = pt_preprocess.preprocess_naflex(a, 16, 64)
        want = jx_preprocess.preprocess_naflex(b, 16, 64)
        for x, y in zip(patches, want):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        decoded.append(a)
    assert pt_decode.load_image(str(tmp_path / "missing.jpg")) is None
    batch = pt_preprocess.preprocess_batch([*decoded, None], 32)
    np.testing.assert_array_equal(batch, jx_preprocess.preprocess_batch([*decoded, None], 32))
    np.testing.assert_array_equal(pt_preprocess.normalize_reference(batch),
                                  jx_preprocess.normalize_reference(batch))


def test_prefetch_batches_equal(tmp_path):
    files = [(str(p), float(i)) for i, p in enumerate(_images(tmp_path))]
    files.append((str(tmp_path / "missing.jpg"), 0.0))  # a decode failure: an invalid slot
    got = list(pt_prefetch.prefetch_batches(iter(files), batch_size=4, image_size=16))
    want = list(jx_prefetch.prefetch_batches(iter(files), batch_size=4, image_size=16))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.pixels, b.pixels)
        np.testing.assert_array_equal(a.valid, b.valid)
        assert [(i.path, i.file_hash) for i in a.items] == [(i.path, i.file_hash) for i in b.items]
    assert pt_prefetch.default_workers() == jx_prefetch.default_workers()
    assert pt_prefetch.default_procs() == jx_prefetch.default_procs()


def test_walker_census_equal(tmp_path):
    for rel in ["a/x.jpg", "a/y.PNG", "a/._fork.jpg", "a/notes.txt", "b/deep/z.webp",
                "skip/secret.jpg", *[f"burst/DSC_{i:04d}.jpg" for i in range(250)]]:
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.touch()
    args = (str(tmp_path),)
    kwargs = dict(exclude_paths=[str(tmp_path / "skip")], verbose=False)
    files, excluded = pt_walker.census(*args, **kwargs)
    assert (files, excluded) == jx_walker.census(*args, **kwargs)
    assert len(files) == 253 and excluded == 1  # no ._fork, no .txt, not under skip/
    assert pt_walker.group_by_folder(files) == jx_walker.group_by_folder(files)
    assert pt_walker.sample_folder_sequences(files) == jx_walker.sample_folder_sequences(files)


def test_file_hashes_equal(tmp_path):
    rng = np.random.default_rng(6)
    for i, size in enumerate((0, 1, 65536, 3 * 2**20 + 17)):
        path = tmp_path / f"f{i}.bin"
        path.write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        want = hashlib.sha256(path.read_bytes()).hexdigest()
        assert pt_hashing.file_sha256(str(path)) == jx_hashing.file_sha256(str(path)) == want


def _unigram_model(sp):
    m = sp.SentencePieceModel(model_type=sp.UNIGRAM)
    for piece, score, kind in [
        ("<pad>", 0.0, 3), ("<eos>", 0.0, 3), ("<bos>", 0.0, 3), ("<unk>", 0.0, 2),
        ("▁", -3.0, 1), ("a", -2.0, 1), ("b", -2.0, 1), ("c", -2.5, 1), ("r", -2.6, 1),
        ("e", -2.6, 1), ("d", -2.6, 1), ("ab", -2.5, 1), ("▁a", -2.2, 1), ("▁red", -3.0, 1),
        ("car", -3.1, 1), ("photo", -4.0, 1), ("▁photo", -3.5, 1), ("▁of", -3.3, 1),
        ("▁this", -3.2, 1), ("▁is", -3.2, 1),
    ]:
        m.pieces.append(piece)
        m.scores.append(score)
        m.types.append(kind)
    m.unk_id, m.bos_id, m.eos_id, m.pad_id = 3, 2, 1, 0
    return m.finalize()


PROMPTS = ["a red car", "A Red CAR!", "this is a photo of abc", "", "naïve café  résumé", "x" * 300]


@pytest.mark.parametrize("model_name", ["google/siglip-base-patch16-224", "google/siglip2-so400m-patch14-224"])
def test_tokenizer_ids_equal(tmp_path, model_name):
    model = _unigram_model(jx_sp)
    blob = jx_sp.serialize_model(model)
    assert pt_sp.serialize_model(_unigram_model(pt_sp)) == blob
    (tmp_path / "tokenizer.model").write_bytes(blob)
    assert pt_sp.load_model(str(tmp_path / "tokenizer.model")).encode("a red car") == model.encode("a red car")
    got = pt_tokenizer.load_tokenizer(model_name, str(tmp_path))
    want = jx_tokenizer.load_tokenizer(model_name, str(tmp_path))
    prompts = [pt_tokenizer.build_prompt(p) for p in PROMPTS]
    assert prompts == [jx_tokenizer.build_prompt(p) for p in PROMPTS]
    assert [pt_tokenizer.canonicalize_text(p) for p in PROMPTS] == [jx_tokenizer.canonicalize_text(p) for p in PROMPTS]
    for a, b in zip(got.encode_batch_with_mask(prompts), want.encode_batch_with_mask(prompts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt_tokenizer.HashBackend(vocab_size=1000).encode_batch(prompts),
                                  jx_tokenizer.HashBackend(vocab_size=1000).encode_batch(prompts))
    assert pt_tokenizer.MAX_LENGTH == jx_tokenizer.MAX_LENGTH


def test_gallery_html_equal(tmp_path):
    (tmp_path / "src").mkdir()
    doc = tmp_path / "src" / "doc.bmp"
    Image.new("RGB", (600, 500), (10, 20, 30)).save(doc)
    results = [("/data/a.jpg", 0.91234), (r"C:\pics\b.png", 0.5), ("/data/<x>.jpg", 0.25),
               (str(doc), 0.125)]
    pages = []
    for name, html, thumbs in (("port", pt_html, pt_thumbnails), ("tpuclip", jx_html, jx_thumbnails)):
        out = tmp_path / f"{name}.html"
        thumbnailer = thumbs.Thumbnailer(str(tmp_path / f"thumbs_{name}"))
        html.generate_html_gallery(results, str(out), query="cats + dogs - birds", thumbnailer=thumbnailer)
        made = sorted((tmp_path / f"thumbs_{name}").glob("*.jpg"))
        assert len(made) == 1
        pages.append(out.read_text().replace(f"thumbs_{name}", "thumbs"))
        pages.append(made[0].read_bytes())
    assert pages[0] == pages[2] and pages[1] == pages[3]
    for path in ("/data/a.jpg", r"C:\pics\b.png", "rel/c.gif"):
        assert pt_html.file_display_url(path) == jx_html.file_display_url(path)
    for query, is_image in (("red car?", False), ("/img/sun.jpg", True), ("", False), ("x" * 300, False)):
        a = pt_html.generate_output_filename(query, is_image, results_dir=tmp_path / "r1")
        b = jx_html.generate_output_filename(query, is_image, results_dir=tmp_path / "r1")
        assert a == b
    assert pt_html.combined_output_filename("red car", "/img/sun.jpg", False, True, results_dir=tmp_path) == \
        jx_html.combined_output_filename("red car", "/img/sun.jpg", False, True, results_dir=tmp_path)


def test_thumbnails_equal(tmp_path):
    for path in ("/a/b.jpg", "/a/b.HEIC", "/a/b.bmp", "/a/b.pdf"):
        assert pt_thumbnails.needs_thumbnail(path) == jx_thumbnails.needs_thumbnail(path)
    src = _images(tmp_path, 2)[0]
    made = []
    for name, mod in (("port", pt_thumbnails), ("tpuclip", jx_thumbnails)):
        thumbnailer = mod.Thumbnailer(str(tmp_path / name))
        out = thumbnailer.create(str(src), max_size=(64, 64))
        made.append((Path(out).name, Path(out).read_bytes()))
    assert made[0] == made[1]


def test_bucketing_equal():
    sizes = list(range(0, 300)) + [1000, 4096, 10**6]
    assert [pt_bucketing.batch_bucket(n) for n in sizes if n > 0] == \
        [jx_bucketing.batch_bucket(n) for n in sizes if n > 0]


def test_logging_and_profiling_print_the_same(capsys, monkeypatch):
    monkeypatch.delenv("TPUCLIP_QUIET", raising=False)
    printed = []
    for logging, profiling in ((pt_logging, pt_profiling), (jx_logging, jx_profiling)):
        logging.banner("Scan")
        logging.log("one", 2, sep="|")
        logging.safe_print_path("Error: ", "/p/ümlaut.jpg", ValueError("bad"))
        steps = profiling.StepTimers()
        steps.totals.update({"decode": 1.5, "embed": 0.5})
        steps.counts.update({"decode": 30, "embed": 3})
        steps.report(processed=64)
        timings = profiling.Timings()
        timings["embed"] = 0.012
        timings["scan"] = 0.003
        timings.report()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "Throughput: 32.0 images/second" in printed[0]
    monkeypatch.setenv("TPUCLIP_QUIET", "1")
    pt_logging.log("hidden")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ["serve_ui", "client"])
def test_serving_copies_differ_only_in_imports(name):
    """``serve_ui.py`` and ``client.py`` are tpuclip's with the package name
    in their imports (and the client's usage line) changed, nothing else."""
    repo = Path(__file__).resolve().parents[1]
    original = (repo / "tpuclip" / f"{name}.py").read_text().splitlines()
    copy = (repo / "tpuclip_torch" / f"{name}.py").read_text().splitlines()
    assert len(copy) == len(original)
    changed = [(a, b) for a, b in zip(original, copy) if a != b]
    assert changed and all(
        b == a.replace("from tpuclip.", "from tpuclip_torch.") and "import" in a for a, b in changed
    ), changed


def test_serve_ui_serves_the_same_page_and_images(tmp_path):
    """The UI page, and ``serve_image``'s answers for an indexed image, a
    thumbnail size, an unknown path and a matching ETag."""
    import types

    import tpuclip.serve_ui as jx_ui
    import tpuclip_torch.serve_ui as pt_ui

    assert pt_ui.UI_HTML == jx_ui.UI_HTML
    src = tmp_path / "a.png"
    Image.fromarray(np.random.default_rng(2).integers(0, 256, (80, 120, 3), dtype=np.uint8)).save(src)
    answers = []
    for ui, store_mod, thumbs in ((pt_ui, pt_store, pt_thumbnails), (jx_ui, jx_store, jx_thumbnails)):
        store = store_mod.MetadataStore(str(tmp_path / f"{ui.__name__}.db"), embedding_dim=DIM)
        store.init_schema()
        conn = sqlite3.connect(store.db_path)
        conn.execute("INSERT INTO images (file_path, last_modified, file_hash) VALUES (?, ?, ?)",
                     (str(src), src.stat().st_mtime, "h" * 64))
        conn.commit()
        conn.close()
        engine = types.SimpleNamespace(store=store, thumbnailer=thumbs.Thumbnailer(str(tmp_path / ui.__name__)))
        got = [ui.serve_image(engine, str(src)), ui.serve_image(engine, str(src), size=32),
               ui.serve_image(engine, str(tmp_path / "missing.png"))]
        etag = (got[0][3] or {}).get("ETag")
        got.append(ui.serve_image(engine, str(src), if_none_match=etag))
        answers.append(got)
    assert answers[0] == answers[1]
