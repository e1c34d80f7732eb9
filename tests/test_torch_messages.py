"""The port's messages and docstrings send a reader to ROADMAP.md's queue
1 by an item's name, not its number, so that renumbering the queue cannot
stale them; and every name they give is an item of that queue."""

import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "stego_torch").rglob("*.py")) + sorted(
    (REPO / "stego_torch" / "csrc").glob("*.cu*"))


def _text(path):
    """The file's text with adjacent string literals joined and runs of
    white space made one space, so that a message split over lines reads
    as it prints."""
    text = re.sub(r"\"\s*\n\s*f?\"", "", path.read_text())
    return re.sub(r"\s+", " ", text)


def _queue_1_items():
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue = roadmap.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    return [name.rstrip(".:") for name in
            re.findall(r"^\d+\. \*\*(.+?)\*\*", queue, re.M)]


def test_no_numbered_roadmap_items():
    found = [f"{p.relative_to(REPO)}: {m.group(0)}" for p in SOURCES
             for m in re.finditer(r"\bitem \d", _text(p))]
    assert not found, found


def test_named_roadmap_items_exist():
    items = _queue_1_items()
    assert "Multi-GPU (DDP)" in items
    cited = [(p, m.group(1)) for p in SOURCES
             for m in re.finditer(r"queue 1, (.{40})", _text(p))]
    assert cited
    for path, text in cited:
        assert any(text.startswith(item) for item in items), (path, text)
