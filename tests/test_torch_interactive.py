"""The port's interactive search session against tpuclip's, on the CPU.

The scenarios of ``tests/test_interactive.py`` and the single shot of
``tests/test_cli_golden.py``, plus non-tty stdin, ``--output`` on the first
query only, a failing first query, CLI modifiers on the first line and
several negatives: the same scripted lines drive ``tpuclip_torch.cli.main``
and ``tpuclip.cli.main`` over copies of one database (scanned once by
tpuclip with a tiny checkpoint that both load). Held equal: the session's
transcript (the session's own lines, scores and home directories masked),
and every gallery it writes: the same paths in the same order, the same
output file and title, and scores within 1e-5 (two implementations of the
tiny towers in fp32 on the CPU). Both run the int8 search with the
resident rerank copy (``TPUCLIP_DEVICE_RERANK=1``). Every line of
``tests/test_repl_parsing.py``, and a seeded fuzz, goes through both
``parse_interactive_line``s."""

import dataclasses
import random
import re
import shutil

import jax
import numpy as np
import pytest
from PIL import Image

import tpuclip.cli as jx_cli
import tpuclip.gallery.html as jx_html
import tpuclip_torch.cli as pt_cli
import tpuclip_torch.gallery.html as pt_html
from tpuclip.models.checkpoint import save_checkpoint
from tpuclip.models.configs import get_config
from tpuclip.models.siglip import init_params

MODEL = "tpuclip/test-tiny"
SCORE_TOL = 1e-5  # fp32 towers of two frameworks on the CPU, as tests/test_torch_slice.py
PACKAGES = {"port": (pt_cli, pt_html), "tpuclip": (jx_cli, jx_html)}

# The session's own lines (the engine's and the pipeline's logs differ
# between the packages: devices, compile notes, timings).
_SESSION_LINE = re.compile(
    r"^(=+$|Interactive Search Session|Processing initial query|Model loaded and ready|Commands:|  - |"
    r"Number of results|Added folder filter|Folder already|Current folder filters|Folder filters cleared|"
    r"Duplicate images will|Warning: Folder|Invalid|k must be|Searching for:|Combined search:|"
    r"  Query [12]:|  Weights:|  Negative|Found \d+ results|\s+\d+\. |Results saved to|No results found|"
    r"Ending session|Error:|Interrupted)"
)
_SCORE = re.compile(r"(\d+\. )-?\d+\.\d{4}:")


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """The images of tests/test_interactive.py plus seeded noise images and
    a byte copy, scanned once by tpuclip's CLI."""
    base = tmp_path_factory.mktemp("session_lib")
    imgs = base / "imgs"
    (imgs / "sub").mkdir(parents=True)
    for name, c in [("red.jpg", (220, 30, 30)), ("green.png", (30, 200, 30))]:
        Image.new("RGB", (64, 64), c).save(imgs / name)
    Image.new("RGB", (64, 64), (10, 10, 200)).save(imgs / "sub" / "blue.png")
    rng = np.random.default_rng(8)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)).save(imgs / "sub" / f"n{i}.png")
    shutil.copyfile(imgs / "red.jpg", imgs / "sub" / "red_copy.jpg")
    cache = base / "models"
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(5), get_config(MODEL)))
    save_checkpoint(str(cache / MODEL.replace("/", "--")), params, get_config(MODEL))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCLIP_HOME", str(base / "home"))
        jx_cli.main(["scan", str(imgs), "--db", str(base / "lib.db"), "--model", MODEL,
                     "--model-cache", str(cache), "--inference-batch-size", "4"])
    return base


@pytest.fixture()
def session(library, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("TPUCLIP_QUIET", raising=False)
    monkeypatch.setenv("TPUCLIP_SEARCH_PRECISION", "int8")
    monkeypatch.setenv("TPUCLIP_DEVICE_RERANK", "1")
    monkeypatch.delenv("TPUCLIP_SHORTLIST", raising=False)
    monkeypatch.delenv("TPUCLIP_SEARCH_MODE", raising=False)

    def run(name, lines, argv, tty=True):
        """Runs one package's ``main`` with scripted input; returns (the
        session transcript, the galleries as (results, output, title), the
        lines left unread)."""
        cli, html = PACKAGES[name]
        home = tmp_path / name / "home"
        db = tmp_path / name / "lib.db"
        if not db.exists():
            db.parent.mkdir(parents=True)
            shutil.copyfile(library / "lib.db", db)
        monkeypatch.setenv("TPUCLIP_HOME", str(home))
        pending = [ln.replace("{I}", str(library / "imgs")).replace("{T}", str(tmp_path)) for ln in lines]

        def fake_input(prompt=""):
            if not pending:
                raise EOFError
            return pending.pop(0)

        galleries = []
        monkeypatch.setattr("builtins.input", fake_input)
        monkeypatch.setattr(cli, "is_tty", lambda: tty)
        monkeypatch.setattr(html, "generate_html_gallery",
                            lambda results, out, query=None, **kw: galleries.append((list(results), out, query)))
        argv = [a.replace("{I}", str(library / "imgs")).replace("{T}", str(tmp_path)) for a in argv]
        argv += ["--db", str(db), "--model", MODEL, "--model-cache", str(library / "models")]
        cli.main(argv + (["--device", "cpu"] if name == "port" else []))
        out = capsys.readouterr().out.replace(str(home), "<H>").replace("tpuclip_torch", "tpuclip")
        transcript = [_SCORE.sub(r"\1<s>:", ln) for ln in out.splitlines() if _SESSION_LINE.match(ln)]
        return transcript, [(r, path.replace(str(home), "<H>"), q) for r, path, q in galleries], pending

    def compare(lines, argv, tty=True):
        got = {name: run(name, lines, argv, tty) for name in PACKAGES}
        (pt_lines, pt_gal, pt_left), (jx_lines, jx_gal, jx_left) = got["port"], got["tpuclip"]
        assert pt_lines == jx_lines
        assert pt_left == jx_left
        assert len(pt_gal) == len(jx_gal)
        for (pr, po, pq), (jr, jo, jq) in zip(pt_gal, jx_gal):
            assert (po, pq) == (jo, jq)
            assert [p for p, _ in pr] == [p for p, _ in jr]
            np.testing.assert_allclose([s for _, s in pr], [s for _, s in jr], rtol=0, atol=SCORE_TOL)
        return pt_lines, pt_gal, pt_left

    return compare


def test_session_commands_and_search(session, library):
    lines, galleries, _ = session(
        ["k:2", "duplicates:show", "folder:{I}/sub", "a blue square", "folder:clear", "red - green", "quit"],
        ["search", "--interactive"],
    )
    assert "Number of results set to 2" in lines and "Folder filters cleared" in lines
    assert "  Negative: green (text)" in lines and lines[-1] == "Ending session. Goodbye!"
    assert len(galleries) == 2 and all(len(r) == 2 for r, _, _ in galleries)
    assert all(p.startswith(str(library / "imgs" / "sub")) for p, _ in galleries[0][0])
    assert galleries[1][2] == "red - green"


def test_session_invalid_commands_keep_session(session):
    lines, galleries, _ = session(
        ["k:notanumber", "duplicates:maybe", "folder:/does/not/exist", "k:0", "", "exit"],
        ["search", "--interactive"],
    )
    assert "Invalid number. Usage: k:20" in lines and "k must be >= 1. Usage: k:20" in lines
    assert "Invalid option. Use 'duplicates:show' or 'duplicates:hide'" in lines
    assert "Warning: Folder does not exist: /does/not/exist" in lines
    assert galleries == []


def test_session_first_cli_query_then_loop(session):
    lines, galleries, _ = session(["green", "q"], ["search", "a red thing", "-k", "2"])
    assert sum(ln == "Found 2 results:" for ln in lines) == 2
    assert [q for _, _, q in galleries] == ["a red thing", "green"]


def test_session_eof_exits_cleanly(session):
    lines, galleries, _ = session([], ["search", "--interactive"])
    assert lines[-1] == "Ending session. Goodbye!" and galleries == []


def test_cli_query_session_command_applies(session):
    lines, galleries, _ = session(["a red thing", "quit"], ["search", "k:2"])
    assert "Number of results set to 2" in lines
    assert len(galleries) == 1 and len(galleries[0][0]) == 2


def test_failing_first_query_does_not_leak_output(session, tmp_path):
    """The first (CLI) query fails; the interactive query after it derives
    its own gallery name: ``--output`` is not handed on."""
    lines, galleries, _ = session(
        ["green", "quit"], ["search", "{T}/missing.jpg", "--image", "--output", "{T}/mine.html"])
    assert "No results found." in lines
    assert len(galleries) == 1 and galleries[0][1] == "<H>/results/green.html"


def test_output_applies_to_the_first_query_only(session, tmp_path):
    _, galleries, _ = session(["green", "quit"], ["search", "a red thing", "--output", "{T}/mine.html"])
    assert [out for _, out, _ in galleries] == [str(tmp_path / "mine.html"), "<H>/results/green.html"]


def test_non_tty_runs_the_cli_query_and_exits(session):
    lines, galleries, left = session(["never read"], ["search", "a red thing", "-k", "3"], tty=False)
    assert left == ["never read"]
    assert len(galleries) == 1 and len(galleries[0][0]) == 3
    assert "Ending session. Goodbye!" not in lines


def test_non_tty_without_query_reads_nothing(session):
    lines, galleries, left = session(["never read"], ["search", "--interactive"], tty=False)
    assert left == ["never read"] and galleries == [] and "Model loaded and ready! Enter queries below." in lines


def test_negatives_images_and_combined_lines(session):
    lines, galleries, _ = session(
        ["red - green - blue - image:{I}/green.png", "image:{I}/red.jpg + a bright colour",
         "image:{I}/red.jpg", "a + b - c", "duplicates:show", "image:{I}/red.jpg", "quit"],
        ["search", "--interactive", "-k", "4"],
    )
    assert any(ln.startswith("  Negatives (3): green, blue, ") for ln in lines)
    titles = [q for _, _, q in galleries]
    assert titles[0].startswith("red - green - blue - ") and titles[3] == "a + b - c"
    assert "Combined search:" in lines
    hidden, shown = galleries[2][0], galleries[4][0]
    assert len(shown) == 4 and len(hidden) <= 4
    # The byte copy of red.jpg is filtered as a duplicate until shown.
    assert {p.rsplit("/", 1)[-1] for p, _ in shown[:2]} == {"red.jpg", "red_copy.jpg"}
    assert [p.rsplit("/", 1)[-1] for p, _ in hidden].count("red_copy.jpg") + \
        [p.rsplit("/", 1)[-1] for p, _ in hidden].count("red.jpg") == 1


def test_cli_modifiers_preset_the_first_line(session):
    """``--negative`` / ``--query2`` / ``--weights`` from the command line
    apply to the first query, and suppress the mini-language they preset."""
    lines, galleries, _ = session(
        ["red - green", "quit"],
        ["search", "a - b", "--negative", "blue", "--query2", "image:{I}/red.jpg", "--weights", "0.7", "0.3"],
    )
    assert any(ln.startswith("  Query 2: image:") and ln.endswith("(text)") for ln in lines)
    assert galleries[0][2].startswith("a - b + image:") and galleries[0][2].endswith(" - blue")
    assert galleries[1][2] == "red - green"


def test_single_shot_matches_tpuclip(session):
    """tests/test_cli_golden.py's single shot: ``--no-session --profile``."""
    lines, galleries, left = session(["never read"], ["search", "something red", "-k", "2", "--no-session",
                                                      "--profile"])
    assert left == ["never read"]
    assert "Found 2 results:" in lines
    assert len(galleries) == 1 and galleries[0][1] == "<H>/results/something_red.html"


# Every line of tests/test_repl_parsing.py's cases, and more edge forms.
PARSE_LINES = [
    "quit", "exit", "q", "QUIT", " Exit ", "   ", "", "k:25", "k:abc", "K: 30", "k:0", "k:-5", "k:1",
    "folder:/data/photos", "folder:clear", "folder:CLEAR", "duplicates:show", "duplicates:hide",
    "duplicates:maybe", "a red car", "image:/data/img.jpg", r"image:C:\pics\cat.jpg",
    "colourful design - grey monochrome", "design - grey - abstract", "cat - image:/neg.jpg",
    "red car + sunset", "image:/a.jpg + blue sky", "red car + sunset - grey - noise",
    "blue-green pattern", "a + b - c - d", "+ b", "image:", "a - ", " - b", "a + b + c",
    "image:image:/x.jpg", "IMAGE:/Upper.JPG + image:/b.png",
]


@pytest.mark.parametrize("line", PARSE_LINES)
def test_parse_line_equals_tpuclip(line):
    for weight in (0.5, 0.0, 2.5):
        got, want = pt_cli.parse_interactive_line(line, weight), jx_cli.parse_interactive_line(line, weight)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if got.kind == "search":
            assert pt_cli.display_query_string(got.search) == jx_cli.display_query_string(want.search)
    preset = dict(query="x", is_image=True, query2=None, is_image2=False, negative_query="n",
                  negative_is_image=True)
    got = pt_cli.parse_interactive_line(line, preset=pt_cli.SearchSpec(**preset))
    want = jx_cli.parse_interactive_line(line, preset=jx_cli.SearchSpec(**preset))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_parser_fuzz_equals_tpuclip():
    """tests/test_repl_parsing.py's seeded fuzz, through both parsers."""
    rng = random.Random(99)
    tokens = [
        "image:", "k:", "folder:", "duplicates:", "+", " - ", "-", ":", "", "quit", "a red car",
        "C:\\photos\\x.jpg", "/abs/path.png", "show", "hide", "clear", "0", "-3",
        "9999999999999999999999", "café", "\x00", "\t", " ", '"', "'", "image:image:", "k:k:", "++",
        "--", "a + b + c", "a - ", " - b", "+ a", "\u202e", "🙂",
    ]
    for _ in range(3000):
        parts = [rng.choice(tokens) for _ in range(rng.randrange(1, 6))]
        line = rng.choice(["", " "]).join(parts)
        got, want = pt_cli.parse_interactive_line(line), jx_cli.parse_interactive_line(line)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), line
