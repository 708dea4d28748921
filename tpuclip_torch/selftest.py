"""Real-checkpoint bring-up and product smoke of the PyTorch port:
``python -m tpuclip_torch.cli selftest``.

PyTorch port of ``tpuclip/selftest.py``, the same steps and report. The
drill: locate or download the pretrained checkpoint, convert it to the
tpuclip-native format and prove the round trip, golden-check the tokenizer
(against the Rust ``tokenizers`` oracle when the checkpoint ships a
``tokenizer.json``), and spot-check the port's towers against the
HF/PyTorch ``SiglipModel`` loaded from the same files (cosine >= 0.999;
SKIP with a reason where ``transformers`` does not import). The product
smoke (``--e2e``): scan a bundled ~20-image tree, then text and image
self-retrieval, the duplicate filter, the gallery and ``check``. Both run
their towers on ``device`` (the card unless the caller names the CPU).
One PASS/FAIL line per step; exit code 0 iff every non-skipped step
passed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from tpuclip_torch.device import DeviceLike, resolve_device
from tpuclip_torch.utils.logging import log

DEFAULT_PARITY_BOUND = 0.999  # BASELINE.json north star: cos >= 0.999 vs PyTorch


@dataclass
class StepResult:
    name: str
    status: str  # PASS | FAIL | SKIP | WARN (non-fatal, e.g. convention-only)
    detail: str = ""


@dataclass
class SelftestReport:
    steps: List[StepResult] = field(default_factory=list)

    def add(self, name: str, status: str, detail: str = "") -> None:
        self.steps.append(StepResult(name, status, detail))
        mark = {"PASS": "[PASS]", "FAIL": "[FAIL]", "SKIP": "[SKIP]",
                "WARN": "[WARN]"}[status]
        log(f"  {mark} {name}: {detail}" if detail else f"  {mark} {name}")

    @property
    def ok(self) -> bool:
        return all(s.status != "FAIL" for s in self.steps) and any(
            s.status == "PASS" for s in self.steps
        )

    def summary(self) -> str:
        passed = sum(s.status == "PASS" for s in self.steps)
        failed = sum(s.status == "FAIL" for s in self.steps)
        skipped = sum(s.status == "SKIP" for s in self.steps)
        verdict = "PASS" if self.ok else "FAIL"
        return (
            f"SELFTEST {verdict} ({passed} passed, {failed} failed, "
            f"{skipped} skipped)"
        )


def _download(model_name: str, model_cache_dir: Optional[str]) -> Optional[Path]:
    """HF hub snapshot download into the cache layout load_model probes
    (<cache>/models--org--name/snapshots/<rev>/). Returns the snapshot dir."""
    from huggingface_hub import snapshot_download  # transformers dependency

    path = snapshot_download(repo_id=model_name, cache_dir=model_cache_dir)
    return Path(path)


def _deterministic_pixels(image_size: int, n: int = 2) -> np.ndarray:
    """Bundled spot-check inputs: deterministic smooth pseudo-photos in the
    model's normalized range [-1, 1] (no asset files to ship or rot)."""
    rng = np.random.default_rng(1234)
    low = rng.random((n, image_size // 8, image_size // 8, 3), np.float32)
    # bilinear-ish upsample by repetition + light noise: structured content,
    # deterministic across platforms (pure numpy)
    img = low.repeat(8, axis=1).repeat(8, axis=2)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0) * 2.0 - 1.0


_SPOT_PROMPTS = ("Cat", "a red car on a street", "Fine Art — café")


def _strip_edge_specials(ids_list, specials):
    """Drop leading/trailing special tokens (bos/eos/pad) from a token-id
    list. Conventions differ between a tokenizer.json's post-processor and
    the raw-SP SigLIP contract; the oracle comparison is over CORE pieces
    so a correct tokenizer is not false-FAILed on bos/eos placement.
    Edge-only on purpose: a special id appearing mid-sequence would be a
    real mismatch and must survive."""
    ids_list = list(ids_list)
    while ids_list and ids_list[0] in specials:
        ids_list = ids_list[1:]
    while ids_list and ids_list[-1] in specials:
        ids_list = ids_list[:-1]
    return ids_list


def run_selftest(
    model_name: str,
    model_cache_dir: Optional[str],
    source: Optional[str] = None,
    allow_download: bool = True,
    parity_bound: float = DEFAULT_PARITY_BOUND,
    skip_parity: bool = False,
    convert_dst: Optional[str] = None,
    device: DeviceLike = None,
) -> SelftestReport:
    from tpuclip_torch.models.loader import find_local_checkpoint, load_checkpoint_dir

    report = SelftestReport()
    log(f"Selftest: real-checkpoint bring-up for {model_name}")

    # ---------------------------------------------------------------- locate
    src: Optional[Path] = None
    if source:
        src = Path(source)
        if not (src / "config.json").exists():
            report.add("locate", "FAIL", f"--source {source} has no config.json")
            return report
        report.add("locate", "PASS", f"using --source {src}")
    else:
        src = find_local_checkpoint(model_name, model_cache_dir)
        if src is not None:
            report.add("locate", "PASS", f"local cache hit: {src}")
        elif allow_download:
            try:
                src = _download(model_name, model_cache_dir)
                report.add("locate", "PASS", f"downloaded: {src}")
            except Exception as e:  # noqa: BLE001 - network/auth/zero-egress
                report.add(
                    "locate", "FAIL",
                    f"not in cache and download failed ({type(e).__name__}: "
                    f"{str(e)[:120]}). Place the HF checkpoint at "
                    f"<model_cache>/{model_name.replace('/', '--')}/ or pass "
                    "--source <dir>.",
                )
                return report
        else:
            report.add(
                "locate", "FAIL",
                "not in cache and --no-download given",
            )
            return report

    # --------------------------------------------------------------- convert
    cfg = params = None
    try:
        cfg, params = load_checkpoint_dir(str(src), model_name)
        report.add(
            "load", "PASS",
            f"{cfg.name}: vision {cfg.vision.num_layers}L/{cfg.vision.hidden_size}d, "
            f"text {cfg.text.num_layers}L/{cfg.text.hidden_size}d, "
            f"dim {cfg.embedding_dim}",
        )
    except Exception as e:  # noqa: BLE001
        report.add("load", "FAIL", f"{type(e).__name__}: {str(e)[:200]}")

    if params is not None:
        try:
            from tpuclip_torch.models.checkpoint import (
                is_tpuclip_checkpoint,
                load_checkpoint,
                save_checkpoint,
            )

            dst = convert_dst or (
                os.path.join(
                    model_cache_dir or str(src.parent),
                    f"tpuclip--{model_name.replace('/', '--')}",
                )
            )
            save_checkpoint(dst, params, cfg)
            if not is_tpuclip_checkpoint(dst):
                raise RuntimeError("written checkpoint not recognized")
            cfg2, params2 = load_checkpoint(dst)
            # Round-trip proof on real leaves, not just metadata.
            leaves1 = _flatten(params)
            leaves2 = _flatten(params2)
            if sorted(leaves1) != sorted(leaves2):
                raise RuntimeError("round-trip param tree mismatch")
            for k in sorted(leaves1)[:: max(1, len(leaves1) // 8)]:
                a, b = np.asarray(leaves1[k]), np.asarray(leaves2[k])
                if a.shape != b.shape or not np.allclose(a, b):
                    raise RuntimeError(f"round-trip value mismatch at {k}")
            report.add("convert", "PASS", f"native checkpoint round-trips: {dst}")
        except Exception as e:  # noqa: BLE001
            report.add("convert", "FAIL", f"{type(e).__name__}: {str(e)[:200]}")

    # ------------------------------------------------------------- tokenizer
    tok = None
    try:
        from tpuclip_torch.text.tokenizer import build_prompt, load_tokenizer

        vocab = cfg.text.vocab_size if cfg is not None else 256000
        tok = load_tokenizer(model_name, str(src), vocab_size=vocab)
        backend = type(tok).__name__
        if backend == "HashBackend":
            raise RuntimeError(
                "no tokenizer files in the checkpoint dir (hash fallback "
                "would produce garbage embeddings against pretrained weights)"
            )
        prompt = build_prompt("Cat")  # lowercase+template contract (:517-529)
        ids, mask = tok.encode_with_mask(prompt)
        ids2, mask2 = tok.encode_with_mask(prompt)
        n_tok = int(np.asarray(mask).sum())
        if len(ids) != 64:
            raise RuntimeError(f"padded length {len(ids)} != 64")
        if not np.array_equal(ids, ids2) or not np.array_equal(mask, mask2):
            raise RuntimeError("non-deterministic encoding")
        if n_tok < 4:
            raise RuntimeError(f"suspiciously short encoding ({n_tok} tokens)")
        if int(np.asarray(ids).max()) >= vocab:
            raise RuntimeError("token id out of vocab range")
        report.add("tokenizer", "PASS", f"{backend}, {n_tok} tokens, 64-padded")
    except Exception as e:  # noqa: BLE001
        report.add("tokenizer", "FAIL", f"{type(e).__name__}: {str(e)[:200]}")

    # Golden ids vs the independent Rust `tokenizers` oracle, when the
    # checkpoint ships a tokenizer.json (the real SigLIP2 repos do).
    if tok is not None and type(tok).__name__ == "SentencePieceBackend":
        tok_json = Path(src) / "tokenizer.json"
        oracle_detail = None
        try:
            if not tok_json.exists():
                oracle_detail = ("SKIP", "checkpoint ships no tokenizer.json")
            else:
                from tokenizers import Tokenizer as RustTokenizer

                from tpuclip_torch.text.tokenizer import build_prompt

                rust = RustTokenizer.from_file(str(tok_json))
                specials = {tok.bos_id, tok.eos_id, 0}
                mismatches, convention_only = [], []
                for word in _SPOT_PROMPTS:
                    prompt = build_prompt(word)
                    ids, mask = tok.encode_with_mask(prompt)
                    ours = list(np.asarray(ids)[: int(np.asarray(mask).sum())])
                    enc = rust.encode(prompt)
                    want = list(enc.ids)
                    # Prefer the oracle's own special-token mask; fall back
                    # to edge-stripping the known special ids.
                    stm = getattr(enc, "special_tokens_mask", None)
                    if stm is not None and len(stm) == len(want):
                        want_core = [i for i, s in zip(want, stm) if not s]
                    else:
                        want_core = _strip_edge_specials(want, specials)
                    ours_core = _strip_edge_specials(list(ours), specials)
                    if ours_core != want_core:
                        mismatches.append((prompt, ours, want))
                    elif ours != want:
                        convention_only.append((prompt, ours, want))
                if mismatches:
                    p, o, w = mismatches[0]
                    oracle_detail = (
                        "FAIL",
                        f"{len(mismatches)}/{len(_SPOT_PROMPTS)} prompts differ in "
                        f"core pieces; e.g. {p!r}: ours={o} oracle={w}",
                    )
                elif convention_only:
                    p, o, w = convention_only[0]
                    oracle_detail = (
                        "WARN",
                        f"core pieces match on all {len(_SPOT_PROMPTS)} prompts; "
                        f"{len(convention_only)} differ only in bos/eos "
                        f"convention, e.g. {p!r}: ours={o} oracle={w}",
                    )
                else:
                    oracle_detail = (
                        "PASS", f"{len(_SPOT_PROMPTS)} prompts match tokenizer.json"
                    )
        except ImportError:
            oracle_detail = ("SKIP", "tokenizers (Rust) not installed")
        except Exception as e:  # noqa: BLE001
            oracle_detail = ("FAIL", f"{type(e).__name__}: {str(e)[:160]}")
        report.add("tokenizer_oracle", *oracle_detail)

    # ----------------------------------------------------- embedding parity
    if skip_parity:
        report.add("parity", "SKIP", "--skip-parity")
    elif params is None:
        report.add("parity", "SKIP", "no loaded params")
    else:
        try:
            _check_parity(report, src, cfg, params, tok, parity_bound, device)
        except ImportError as e:
            report.add("parity", "SKIP", f"oracle unavailable ({e})")
        except Exception as e:  # noqa: BLE001
            report.add("parity", "FAIL", f"{type(e).__name__}: {str(e)[:200]}")

    log(report.summary())
    return report


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    else:
        out[prefix] = tree
    return out


def _check_parity(report, src, cfg, params, tok, bound, device: DeviceLike = None) -> None:
    """Cosine spot check of the port's towers (fp32 on ``device``) against
    the HF/PyTorch model loaded from the SAME checkpoint files, on bundled
    deterministic inputs."""
    import torch

    from tpuclip_torch.models.convert import load_jax_params
    from tpuclip_torch.models.siglip import build_model

    # SiglipModel explicit class first, AutoModel fallback: the reference's
    # own load order (image_database.py:200-210).
    try:
        from transformers import SiglipModel

        hf_model = SiglipModel.from_pretrained(str(src)).eval()
    except Exception:  # noqa: BLE001
        from transformers import AutoModel

        hf_model = AutoModel.from_pretrained(str(src), trust_remote_code=False).eval()

    pixels = _deterministic_pixels(cfg.vision.image_size)
    if tok is not None and type(tok).__name__ != "HashBackend":
        from tpuclip_torch.text.tokenizer import build_prompt

        enc = [tok.encode_with_mask(build_prompt(p)) for p in _SPOT_PROMPTS[:2]]
        ids = np.stack([np.asarray(i) for i, _ in enc]).astype(np.int32)
        mask = np.stack([np.asarray(m) for _, m in enc]).astype(np.int32)
    else:
        rng = np.random.default_rng(5)
        ids = rng.integers(0, cfg.text.vocab_size, size=(2, 64)).astype(np.int32)
        mask = np.ones((2, 64), np.int32)

    device = resolve_device(device)
    model = load_jax_params(build_model(cfg, device, torch.float32), params)
    ours_img = model.get_image_features(torch.from_numpy(pixels).to(device)).cpu().numpy()
    ours_txt = model.get_text_features(
        torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    ).cpu().numpy()
    with torch.no_grad():
        hf_img = hf_model.get_image_features(
            pixel_values=torch.from_numpy(pixels).permute(0, 3, 1, 2)
        ).numpy()
        hf_txt = hf_model.get_text_features(
            input_ids=torch.from_numpy(ids.astype(np.int64)),
            attention_mask=torch.from_numpy(mask.astype(np.int64)),
        ).numpy()

    def norm(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    img_cos = float(np.min(np.sum(norm(ours_img) * norm(hf_img), axis=-1)))
    txt_cos = float(np.min(np.sum(norm(ours_txt) * norm(hf_txt), axis=-1)))
    detail = f"image cos {img_cos:.6f}, text cos {txt_cos:.6f} (bound {bound})"
    if img_cos >= bound and txt_cos >= bound:
        report.add("parity", "PASS", detail)
    else:
        report.add("parity", "FAIL", detail)


# =============================================================================
# Full-product end-to-end smoke (`selftest --e2e`)
# =============================================================================


def _build_smoke_tree(root: Path, n: int = 20):
    """Deterministic ~20-image tree covering the product surface: two
    folders, mixed formats (JPEG/PNG/BMP — BMP exercises the thumbnailer,
    reference image_database.py:354-357), one byte-identical duplicate pair
    (exercises the search-time Hamming dedup filter, reference :1207), no
    asset files to ship. Returns (all_paths, dup_pair)."""
    from PIL import Image

    rng = np.random.default_rng(42)
    paths = []
    (root / "photos").mkdir(parents=True, exist_ok=True)
    (root / "art").mkdir(parents=True, exist_ok=True)
    for i in range(n - 2):
        folder = "photos" if i % 2 == 0 else "art"
        ext = ("jpg", "png", "bmp")[i % 3]
        # Structured content (blocks + gradient), unique per image.
        base = rng.random((8, 8, 3), np.float32)
        img = (base.repeat(12, axis=0).repeat(12, axis=1) * 255).astype(np.uint8)
        img[:, :, i % 3] = np.linspace(0, 255, 96, dtype=np.uint8)[None, :]
        p = root / folder / f"img_{i:03d}.{ext}"
        Image.fromarray(img).save(str(p))
        paths.append(str(p))
    # Byte-identical duplicate pair (same pixels, same format).
    dup_src = root / "photos" / "dup_a.png"
    dup_copy = root / "photos" / "dup_b.png"
    img = (rng.random((96, 96, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(str(dup_src))
    import shutil

    shutil.copyfile(str(dup_src), str(dup_copy))
    paths += [str(dup_src), str(dup_copy)]
    return paths, (str(dup_src), str(dup_copy))


def run_e2e_selftest(
    model_name: str,
    model_cache_dir: Optional[str],
    work_dir: Optional[str] = None,
    report: Optional[SelftestReport] = None,
    k: int = 5,
    source: Optional[str] = None,
    device: DeviceLike = None,
) -> SelftestReport:
    """Scan a bundled synthetic image tree into a temp DB, run text and
    image: searches (image self-retrieval top-1 must be the query), write a
    gallery, and verify DB integrity — one command proving the whole
    pipeline on any backend (the second half of the first-network-day
    drill; reference scan→search round trip image_database.py:722,:1308).

    Works with real weights when a checkpoint is present, else falls back
    to deterministic random init (self-retrieval and the integrity checks
    are weight-agnostic). The engine runs on ``device``."""
    import shutil
    import tempfile

    from tpuclip_torch.models.loader import find_local_checkpoint

    report = report if report is not None else SelftestReport()
    log(f"Selftest --e2e: full product smoke for {model_name}")
    tmp = Path(work_dir) if work_dir else Path(tempfile.mkdtemp(prefix="tpuclip_e2e_"))
    tmp.mkdir(parents=True, exist_ok=True)
    owns_tmp = work_dir is None
    prev_init = os.environ.get("TPUCLIP_INIT")
    try:
        tree = tmp / "tree"
        try:
            paths, dup_pair = _build_smoke_tree(tree)
            report.add("e2e_tree", "PASS", f"{len(paths)} images in 2 folders")
        except Exception as e:  # noqa: BLE001
            report.add("e2e_tree", "FAIL", f"{type(e).__name__}: {str(e)[:160]}")
            return report

        if source and (Path(source) / "config.json").exists():
            # Honor --source: expose the explicit checkpoint
            # dir to the engine's cache-probing loader through a flat-
            # layout link in a private cache dir.
            shim_cache = tmp / "source_cache"
            shim_cache.mkdir(parents=True, exist_ok=True)
            link = shim_cache / model_name.replace("/", "--")
            if not link.exists():
                try:
                    link.symlink_to(Path(source).resolve(),
                                    target_is_directory=True)
                except OSError:
                    import shutil as _sh

                    _sh.copytree(str(source), str(link))
            model_cache_dir = str(shim_cache)
        ckpt = find_local_checkpoint(model_name, model_cache_dir)
        weights = "checkpoint" if ckpt else "random-init (no checkpoint found)"
        if ckpt is None:
            os.environ["TPUCLIP_INIT"] = "random"
        db_path = str(tmp / "selftest.db")
        try:
            from tpuclip_torch.engine import ImageDatabase
            from tpuclip_torch.pipelines.scan import scan_directory

            engine = ImageDatabase(
                db_path=db_path, model_cache_dir=model_cache_dir,
                model_name=model_name, inference_batch_size=8, device=device,
            )
            stats = scan_directory(engine, str(tree), verbose=False)
            indexed = engine.store.count_images()
            if stats is None or indexed != len(paths):
                report.add(
                    "e2e_scan", "FAIL",
                    f"indexed {indexed}/{len(paths)} images ({weights})",
                )
                return report
            report.add("e2e_scan", "PASS", f"{indexed} images indexed ({weights})")
        except Exception as e:  # noqa: BLE001
            report.add("e2e_scan", "FAIL", f"{type(e).__name__}: {str(e)[:200]}")
            return report

        from tpuclip_torch.pipelines.search import search as run_search

        try:
            results = run_search(engine, "a red picture", k=k)
            sims = [s for _, s in results]
            if not results or not all(np.isfinite(sims)) or max(sims) > 1.0 + 1e-3:
                report.add("e2e_text_search", "FAIL",
                           f"{len(results)} results, sims={sims[:3]}")
                return report
            report.add("e2e_text_search", "PASS",
                       f"top-{len(results)}, best {max(sims):.4f}")
        except Exception as e:  # noqa: BLE001
            report.add("e2e_text_search", "FAIL", f"{type(e).__name__}: {str(e)[:200]}")
            return report

        try:
            failures = []
            for q in (paths[0], paths[7], dup_pair[0]):
                res = run_search(engine, q, k=1, is_image_path=True,
                                 show_duplicates=True)
                top1 = res[0][0] if res else None
                # A byte-identical duplicate has the same embedding — either
                # member of the pair may rank first.
                accept = {q} | (set(dup_pair) if q in dup_pair else set())
                if top1 not in accept or res[0][1] < 0.99:
                    failures.append((q, top1, res[0][1] if res else None))
            if failures:
                report.add("e2e_image_self_retrieval", "FAIL", f"{failures[:2]}")
                return report
            report.add("e2e_image_self_retrieval", "PASS",
                       "top-1 self at sim>=0.99 for 3/3 queries")
        except Exception as e:  # noqa: BLE001
            report.add("e2e_image_self_retrieval", "FAIL",
                       f"{type(e).__name__}: {str(e)[:200]}")
            return report

        try:
            res = run_search(engine, "anything", k=k, show_duplicates=False)
            res_paths = {p for p, _ in res}
            if set(dup_pair) <= res_paths:
                report.add("e2e_duplicate_filter", "FAIL",
                           "both members of the identical pair survived")
            else:
                report.add("e2e_duplicate_filter", "PASS",
                           "identical pair collapsed to one result")
        except Exception as e:  # noqa: BLE001
            report.add("e2e_duplicate_filter", "FAIL",
                       f"{type(e).__name__}: {str(e)[:160]}")

        try:
            from tpuclip_torch.gallery.html import generate_html_gallery

            out = str(tmp / "gallery.html")
            generate_html_gallery(results, out, query="a red picture",
                                  thumbnailer=engine.thumbnailer)
            html_text = open(out, encoding="utf-8").read()
            if "localexplorer:" not in html_text or "file://" not in html_text:
                report.add("e2e_gallery", "FAIL", "missing expected markup")
            else:
                report.add("e2e_gallery", "PASS", f"{len(html_text)} bytes")
        except Exception as e:  # noqa: BLE001
            report.add("e2e_gallery", "FAIL", f"{type(e).__name__}: {str(e)[:160]}")

        try:
            from tpuclip_torch.pipelines.check import check_database

            result = check_database(db_path, verbose=False)
            if result.ok:
                report.add("e2e_check", "PASS", "database integrity OK")
            else:
                report.add("e2e_check", "FAIL", f"{result}")
        except Exception as e:  # noqa: BLE001
            report.add("e2e_check", "FAIL", f"{type(e).__name__}: {str(e)[:160]}")
    finally:
        if prev_init is None:
            os.environ.pop("TPUCLIP_INIT", None)
        else:
            os.environ["TPUCLIP_INIT"] = prev_init
        if owns_tmp:
            shutil.rmtree(tmp, ignore_errors=True)

    log(report.summary())
    return report
