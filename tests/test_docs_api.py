"""The generated per-module API reference (docs/gen_api.py): coverage
and freshness — the committed pages must match what the generator emits
from the current source (CI runs ``--check`` before the docs build), and
every public module must have a page documenting its public surface."""

import importlib.util
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def gen_api():
    spec = importlib.util.spec_from_file_location(
        "gen_api", REPO / "docs" / "gen_api.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pages(gen_api):
    return gen_api.generate()


def test_generated_pages_are_fresh(gen_api, pages):
    out = REPO / "docs" / "api"
    committed = {p.name for p in out.glob("*.md")}
    assert committed == set(pages), (
        "page set drifted — run `python docs/gen_api.py`")
    stale = [n for n, text in pages.items()
             if (out / n).read_text() != text]
    assert not stale, (
        f"stale generated API pages {stale[:5]} — run "
        f"`python docs/gen_api.py`")


def test_every_public_module_has_a_page(gen_api, pages):
    mods = gen_api.public_modules()
    # the whole public tree, not a curated subset
    for must in ("audian_tpu.data.data", "audian_tpu.ops.fused",
                 "audian_tpu.parallel.pipeline", "audian_tpu.app.browser",
                 "audian_tpu.view.render", "audian_tpu.analysis.events",
                 "audian_tpu.cache.fulltrace", "audian_tpu.gui.qt",
                 "audian_tpu.ops.window_matmul"):
        assert must in mods
    for m in mods:
        assert f"{m}.md" in pages
        assert f"# `{m}`" in pages[f"{m}.md"]
    assert "index.md" in pages
    for m in mods:
        assert f"[`{m}`]({m}.md)" in pages["index.md"]


def test_pages_document_key_symbols(pages):
    checks = {
        "audian_tpu.data.data.md": ["### `class Data", "get_region",
                                    "update_times", "content_epoch"],
        "audian_tpu.ops.fused.md": ["### `class FusedChainCF",
                                    "chain_cf"],
        "audian_tpu.parallel.pipeline.md": ["### `class ShardedPipeline",
                                            "padded_length"],
        "audian_tpu.ops.envdet.md": ["### `class EnvDet"],
        "audian_tpu.analysis.events.md": ["### `detect(", "### `band_env("],
    }
    for page, needles in checks.items():
        text = pages[page]
        for needle in needles:
            assert needle in text, (page, needle)


def test_nav_and_ci_wire_the_generated_docs():
    mkdocs = (REPO / "mkdocs.yml").read_text()
    assert "api/index.md" in mkdocs
    ci = (REPO / ".github" / "workflows" / "tests.yml").read_text()
    assert "gen_api.py --check" in ci
