"""Every subcommand of the port's CLI against tpuclip's, on the CPU.

Each case runs one command line through ``tpuclip_torch.cli.main`` and
``tpuclip.cli.main``, each package in a work directory of its own that
holds copies of the same seeded databases (written with tpuclip's store),
with the same tiny checkpoint (tpuclip's ``save_checkpoint``) for the
commands that load a model. Held equal: the exit code, what the command
prints (the package name and the work directory masked; an argparse error
by its last line, since the port's usage lines list ``--device``), and
every file the command leaves in its work directory (SQLite tables, npz /
npy arrays, other files byte for byte). The port alone: ``train`` exits 2,
and ``gc --db <missing> --decode-cache DIR`` bounds the cache before it
refuses (tpuclip exits first)."""

import os
import shutil
import sqlite3
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

import tpuclip.cli as jx_cli
import tpuclip_torch.cli as pt_cli
from tpuclip.index.store import MetadataStore
from tpuclip.models.checkpoint import save_checkpoint
from tpuclip.models.configs import get_config
from tpuclip.models.siglip import init_params

MODEL = "tpuclip/test-tiny"
DIM = 64
CLIS = {"port": pt_cli, "tpuclip": jx_cli}


def _write_db(path, rows):
    store = MetadataStore(str(path), embedding_dim=DIM)
    store.init_schema(verbose=False)
    conn = sqlite3.connect(store.db_path)
    store.commit_with_retry(conn.cursor(), conn, rows, save_full_embeddings=True)
    conn.close()


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    """Images on disk, databases and a checkpoint, made once from seeds."""
    base = tmp_path_factory.mktemp("cli_seed")
    rng = np.random.default_rng(12)
    paths = []
    for i in range(10):
        folder = base / "imgs" / ("a" if i < 5 else "b")
        folder.mkdir(parents=True, exist_ok=True)
        path = folder / f"img_{i}.png"
        Image.fromarray(rng.integers(0, 256, (32 + i, 40, 3), dtype=np.uint8)).save(path)
        paths.append(str(path))
    paths += [str(base / "imgs" / "a" / "gone_0.png"), str(base / "imgs" / "b" / "gone_1.png")]
    vecs = rng.standard_normal((12, DIM)).astype(np.float32)
    vecs[11] = vecs[2]  # an exact duplicate
    vecs[9] = vecs[1]
    vecs[9, :3] = -vecs[9, :3]  # three bits from row 1
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    dbs = base / "dbs"
    dbs.mkdir()
    _write_db(dbs / "lib.db", [(p, float(i), f"h{i}", vecs[i]) for i, p in enumerate(paths)])
    other = rng.standard_normal((3, DIM)).astype(np.float32)
    _write_db(dbs / "other.db", [
        ("/elsewhere/x.jpg", 1.0, "hx", other[0]), ("/elsewhere/y.jpg", 2.0, "hy", other[1]),
        (paths[0], 99.0, "h0new", other[2]),  # newer copy of a lib.db row
    ])
    shutil.copyfile(dbs / "lib.db", dbs / "broken.db")
    conn = sqlite3.connect(dbs / "broken.db")
    conn.execute("DELETE FROM images WHERE id = 3")  # orphans its embeddings
    conn.commit()
    conn.close()
    from test_migrate import _make_reference_db

    _make_reference_db(str(dbs / "ref.db"), vecs[:9])
    (dbs / "junk.db").write_bytes(b"this is not a database, only bytes " * 40)
    conn = sqlite3.connect(dbs / "schema.db")
    conn.execute("CREATE TABLE other (x)")
    conn.commit()
    conn.close()
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(3), get_config(MODEL)))
    save_checkpoint(str(base / "models" / MODEL.replace("/", "--")), params, get_config(MODEL))
    return base


def _prepare(seed, tmp_path):
    for name in CLIS:
        work = tmp_path / name
        shutil.copytree(seed / "dbs", work)
        (work / "dc").mkdir()
        for i in range(3):  # decode-cache entries of 1,000 bytes
            (work / "dc" / f"e{i}.npy").write_bytes(bytes(1000))
            os.utime(work / "dc" / f"e{i}.npy", (1000 + i, 1000 + i))


def _expand(argv, name, work, seed):
    out = []
    for a in argv:
        if a == "{DEV}":
            out += ["--device", "cpu"] if name == "port" else []
        else:
            out.append(a.replace("{W}", str(work)).replace("{S}", str(seed)))
    return out


def _run(name, argv, seed, tmp_path, monkeypatch, capsys):
    work = tmp_path / name
    monkeypatch.setenv("TPUCLIP_HOME", str(work / "home"))
    code = 0
    try:
        CLIS[name].main(_expand(argv, name, work, seed))
    except SystemExit as e:
        code = e.code
    cap = capsys.readouterr()

    def mask(text):
        return text.replace(str(work), "<W>").replace("tpuclip_torch", "tpuclip")

    return code, mask(cap.out), mask(cap.err)


def _table_rows(path):
    conn = sqlite3.connect(path)
    try:
        out = {}
        names = [r[0] for r in conn.execute("SELECT name FROM sqlite_master WHERE type = 'table' "
                                          "AND sql NOT LIKE 'CREATE VIRTUAL%' ORDER BY name")]
        for t in names:
            cols = [c[1] for c in conn.execute(f'PRAGMA table_info("{t}")') if c[1] != "created_at"]
            if cols:
                sel = ", ".join(f'"{c}"' for c in cols)
                out[t] = sorted(conn.execute(f'SELECT {sel} FROM "{t}"').fetchall(), key=repr)
        return out
    finally:
        conn.close()


def _files(work):
    """What a work directory holds: SQLite tables, arrays, bytes."""
    out = {}
    for p in sorted(work.rglob("*")):
        rel = str(p.relative_to(work))
        if p.is_dir() or rel.startswith("home") or p.name.endswith(("-wal", "-shm", "-journal")):
            continue
        if p.suffix == ".db" and p.read_bytes()[:16] == b"SQLite format 3\x00":
            out[rel] = _table_rows(p)
        elif p.suffix == ".npz":
            with np.load(p, allow_pickle=False) as z:
                out[rel] = {k: z[k].tolist() for k in z.files}
        else:
            out[rel] = p.read_bytes()
    return out


def _compare(argv, seed, tmp_path, monkeypatch, capsys):
    _prepare(seed, tmp_path)
    got = {name: _run(name, argv, seed, tmp_path, monkeypatch, capsys) for name in CLIS}
    (pc, pout, perr), (jc, jout, jerr) = got["port"], got["tpuclip"]
    assert pc == jc, (pout, perr, jout, jerr)
    if pc == 2 and perr:  # an argparse error: its message, not the usage lines
        assert perr.strip().splitlines()[-1] == jerr.strip().splitlines()[-1]
    else:
        assert perr == jerr
    assert pout == jout
    assert _files(tmp_path / "port") == _files(tmp_path / "tpuclip")
    return pc, pout


CASES = {
    "info": (["info", "--db", "{W}/lib.db"], 0, "Full embeddings:   12"),
    "info-missing": (["info", "--db", "{W}/nope.db"], 2, "Database file does not exist"),
    "info-no-db": (["info"], 2, "No database selected"),
    "check": (["check", "--db", "{W}/lib.db"], 0, "Database OK"),
    "check-broken": (["check", "--db", "{W}/broken.db"], 1, "orphaned_embeddings"),
    "check-fix": (["check", "--db", "{W}/broken.db", "--fix"], 0, "Database OK after fix."),
    "check-missing": (["check", "--db-name", "nope"], 2, "Database file does not exist"),
    "prune-dry": (["prune", "--db", "{W}/lib.db", "--dry-run"], 0, "2 files no longer exist"),
    "prune": (["prune", "--db", "{W}/lib.db"], 0, "2 files no longer exist"),
    "prune-folder": (["prune", "--db", "{W}/lib.db", "--folder", "{S}/imgs/b"], 0, "1 files no longer exist"),
    "migrate-dry": (["migrate", "--db", "{W}/ref.db", "--dry-run"], 0, "would migrate 9 vectors"),
    "migrate": (["migrate", "--db", "{W}/ref.db"], 0, "Migrated 9 vectors"),
    "migrate-not-reference": (["migrate", "--db", "{W}/lib.db"], 2, "nothing to migrate"),
    "migrate-not-sqlite": (["migrate", "--db", "{W}/junk.db"], 2, "[X] Error:"),
    "export-npz": (["export", "{W}/out.npz", "--db", "{W}/lib.db", "--binary"], 0, "Exported 12"),
    "export-npy": (["export", "{W}/out.npy", "--db", "{W}/lib.db"], 0, "Exported 12"),
    "export-jsonl": (["export", "{W}/out.jsonl", "--db", "{W}/lib.db"], 0, "Exported 12"),
    "export-format": (["export", "{W}/out.txt", "--db", "{W}/lib.db", "--format", "jsonl"], 0, "Exported 12"),
    "export-default-npz": (["export", "{W}/out.bin", "--db", "{W}/lib.db"], 0, "(npz)"),
    "merge": (["merge", "{W}/merged.db", "{W}/lib.db", "{W}/other.db"], 0, "Merge complete"),
    "duplicates": (["duplicates", "--db", "{W}/lib.db"], 0, "Found 1 duplicate cluster"),
    "duplicates-t3": (["duplicates", "--db", "{W}/lib.db", "--tolerance", "3"], 0, "Found 2 duplicate cluster"),
    "gc-dry": (["gc", "--dry-run", "--db", "{W}/lib.db"], 0, "Would remove 0 orphaned thumbnail"),
    "gc-no-databases": (["gc"], 2, "refusing to GC"),
    "gc-bad-cache": (["gc", "--decode-cache", "{W}/no_such", "--decode-cache-max-gb", "1"], 2, "is not a directory"),
    "gc-cache-report": (["gc", "--decode-cache", "{W}/dc"], 0, "Decode cache: 0.00 GB"),
    "gc-cache-bound": (["gc", "--decode-cache", "{W}/dc", "--decode-cache-max-gb", "0.0000015"], 0, "Removed 2 decode-cache"),
    "gc-max-gb-alone": (["gc", "--db", "{W}/lib.db", "--decode-cache-max-gb", "1"], 0, "[WARNING] --decode-cache-max-gb"),
    "convert-dir": (["convert", "{S}/models/tpuclip--test-tiny", "{W}/conv"], 0, "[OK] Wrote tpuclip checkpoint"),
    "convert-name": (["convert", MODEL, "{W}/conv", "--model-cache", "{S}/models"], 0, "[OK] Wrote tpuclip checkpoint"),
    "convert-missing": (["convert", "nope/model", "{W}/conv", "--model-cache", "{S}/models"], 2, "neither a directory"),
    "classify": (["classify", "{S}/imgs/a/img_0.png", "--labels", "a red car, a dog,noise", "--model", MODEL,
                  "--model-cache", "{S}/models", "{DEV}"], 0, "Zero-shot classification"),
    "classify-no-labels": (["classify", "{S}/imgs/a/img_0.png", "--labels", " , ", "{DEV}"], 2, "at least one label"),
    "search-missing-db": (["search", "x", "--db", "{W}/nope.db", "{DEV}"], 2, "does not exist"),
    "search-bad-schema": (["search", "x", "--db", "{W}/schema.db", "{DEV}"], 2, "does not contain the expected schema"),
    "search-no-db": (["search", "x", "{DEV}"], 2, "No database selected"),
    "scan-no-db": (["scan", "{S}/imgs", "{DEV}"], 2, "No database selected"),
    "selftest-nothing-to-load": (["selftest", "--no-download", "--model-cache", "{W}/empty", "--model", MODEL,
                                  "{DEV}"], 1, "[FAIL] locate"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_subcommand_matches_tpuclip(case, seed, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("TPUCLIP_QUIET", raising=False)
    argv, want_code, want_text = CASES[case]
    code, out = _compare(argv, seed, tmp_path, monkeypatch, capsys)
    assert code == want_code
    assert want_text in out


MALFORMED = {
    "duplicates-tolerance": ["duplicates", "--tolerance", "two"],
    "export-no-output": ["export"],
    "export-bad-format": ["export", "{W}/o", "--format", "xml"],
    "merge-no-sources": ["merge", "{W}/m.db"],
    "unknown-subcommand": ["bogus"],
    "search-bad-k": ["search", "x", "-k", "many"],
    "classify-no-labels-flag": ["classify", "img.png"],
    "gc-bad-max-gb": ["gc", "--decode-cache-max-gb", "lots"],
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_arguments_match_tpuclip(case, seed, tmp_path, monkeypatch, capsys):
    code, _ = _compare(MALFORMED[case], seed, tmp_path, monkeypatch, capsys)
    assert code == 2


def test_every_tpuclip_subcommand_has_the_same_flags():
    """Each subparser of tpuclip's CLI exists in the port's with the same
    options (the port adds ``--device`` where a model loads)."""

    def flags(parser):
        sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
        return {name: {tuple(a.option_strings) or (a.dest,): (a.nargs, a.default, a.choices)
                       for a in p._actions if a.dest != "help"}
                for name, p in sub.choices.items()}

    port, want = flags(pt_cli.build_parser()), flags(jx_cli.build_parser())
    assert set(port) == set(want)
    for name in want:
        extra = {k: v for k, v in port[name].items() if k not in want[name]}
        assert {k: v for k, v in port[name].items() if k in want[name]} == want[name], name
        assert extra == ({("--device",): (None, "cuda", ["cuda", "cpu"])}
                         if name in ("scan", "search", "serve", "classify", "selftest") else {}), name


def test_train_is_refused(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("TPUCLIP_QUIET", raising=False)
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    with pytest.raises(SystemExit) as exc:
        pt_cli.main(["train", str(tmp_path), "--output", str(tmp_path / "out")])
    assert exc.value.code == 2
    assert "ROADMAP Queue 1 item 9" in capsys.readouterr().out
    assert not (tmp_path / "out").exists()


def test_selftest_without_model_flag(tmp_path, monkeypatch, capsys):
    """``selftest`` with no ``--model`` takes the default model in the port.
    tpuclip raises UnboundLocalError there (``DEFAULT_MODEL`` is bound only
    by imports in other branches of its ``main``), a fault of the
    reference that the port does not copy."""
    monkeypatch.delenv("TPUCLIP_QUIET", raising=False)
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    argv = ["selftest", "--no-download", "--model-cache", str(tmp_path / "empty")]
    with pytest.raises(SystemExit) as exc:
        pt_cli.main(argv + ["--device", "cpu"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "Selftest: real-checkpoint bring-up for google/siglip2-so400m-patch14-224" in out
    assert "[FAIL] locate: not in cache and --no-download given" in out
    with pytest.raises(UnboundLocalError):
        jx_cli.main(argv)


def test_help_lists_the_same_subcommands(capsys):
    printed = []
    for cli in (pt_cli, jx_cli):
        cli.main([])
        printed.append(capsys.readouterr().out)
    choices = "{scan,search,convert,train,serve,merge,duplicates,classify,info,gc,check,prune,migrate,selftest,export}"
    assert all(choices in out for out in printed)


def test_merge_of_mismatched_dims_raises_alike(seed, tmp_path):
    _prepare(seed, tmp_path)
    errors = []
    for name, cli in CLIS.items():
        wide = tmp_path / name / "wide.db"
        store = MetadataStore(str(wide), embedding_dim=DIM * 2)
        store.init_schema(verbose=False)
        conn = sqlite3.connect(wide)
        store.commit_with_retry(conn.cursor(), conn, [("/w.jpg", 1.0, "hw", np.ones(DIM * 2, np.float32))],
                                save_full_embeddings=True)
        conn.close()
        with pytest.raises(ValueError) as exc:
            cli.main(["merge", str(tmp_path / name / "m.db"), str(tmp_path / name / "lib.db"), str(wide)])
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "mismatched embedding dims" in errors[0]


def test_gc_missing_db_still_bounds_the_decode_cache(seed, tmp_path, monkeypatch, capsys):
    """``gc --db <missing> --decode-cache DIR --decode-cache-max-gb 0``: the
    port evicts the cache's entries, then refuses the thumbnail GC with
    tpuclip's message and exits 2. tpuclip exits 2 before it touches the
    cache (a known fault of the reference)."""
    monkeypatch.delenv("TPUCLIP_QUIET", raising=False)
    _prepare(seed, tmp_path)
    argv = ["gc", "--db", "{W}/missing.db", "--decode-cache", "{W}/dc", "--decode-cache-max-gb", "0"]
    port = _run("port", argv, seed, tmp_path, monkeypatch, capsys)
    ref = _run("tpuclip", argv, seed, tmp_path, monkeypatch, capsys)
    refusal = "No databases found; refusing to GC (every thumbnail would look orphaned)."
    assert port[0] == ref[0] == 2
    assert ref[1].strip() == refusal
    assert port[1].splitlines() == [
        "Removed 3 decode-cache entr(ies), reclaiming 0.00 GB; 0.00 GB kept", refusal]
    assert sorted(os.listdir(tmp_path / "port" / "dc")) == []
    assert len(os.listdir(tmp_path / "tpuclip" / "dc")) == 3


def test_convert_hf_layout_matches_tpuclip(tmp_path, monkeypatch, capsys):
    """An HF-layout directory (``save_pretrained``) converted by both CLIs:
    the same tpuclip-native files; each package loads the other's with equal
    parameters."""
    transformers = pytest.importorskip("transformers")
    import torch

    from tpuclip.models.checkpoint import load_checkpoint as jx_load
    from tpuclip_torch.models.checkpoint import load_checkpoint as pt_load

    cfg = transformers.SiglipConfig(
        text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=16),
        vision_config=dict(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                           num_attention_heads=4, image_size=28, patch_size=14),
    )
    torch.manual_seed(0)
    transformers.SiglipModel(cfg).save_pretrained(str(tmp_path / "hf"), safe_serialization=True)
    monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / "home"))
    for name, cli in CLIS.items():
        cli.main(["convert", str(tmp_path / "hf"), str(tmp_path / name)])
    for f in ("tpuclip.json", "model.safetensors"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "tpuclip" / f).read_bytes(), f
    for reader in (pt_load, jx_load):
        (c1, p1), (c2, p2) = reader(str(tmp_path / "port")), reader(str(tmp_path / "tpuclip"))
        assert c1 == c2
        flat1, flat2 = jax.tree_util.tree_leaves_with_path(p1), jax.tree_util.tree_leaves_with_path(p2)
        assert [k for k, _ in flat1] == [k for k, _ in flat2]
        for (_, a), (_, b) in zip(flat1, flat2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_single_shot_gallery_title(seed, tmp_path, monkeypatch):
    """``search --no-session`` titles its gallery with ``display_query_string``
    (query, ``+ query2``, ``- negative``), as tpuclip does."""
    titles = {}
    for name, cli in CLIS.items():
        gallery = __import__(f"{cli.__name__.rsplit('.', 1)[0]}.gallery.html", fromlist=["x"])
        seen = []
        monkeypatch.setattr(gallery, "generate_html_gallery",
                            lambda results, out, query=None, **kw: seen.append(query))
        monkeypatch.setenv("TPUCLIP_HOME", str(tmp_path / name / "home"))
        db = tmp_path / f"{name}.db"
        shutil.copyfile(seed / "dbs" / "lib.db", db)
        argv = ["search", "a red car", "--query2", "blue sky", "--negative", "night", "-k", "3", "--no-session",
                "--db", str(db), "--model", MODEL, "--model-cache", str(seed / "models")]
        cli.main(argv + (["--device", "cpu"] if name == "port" else []))
        titles[name] = seen
    assert titles["port"] == titles["tpuclip"] == ["a red car + blue sky - night"]
