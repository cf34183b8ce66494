"""Shared pieces of the benchmark's own tests.

    python3 -m pytest codecbench/tests -q

They run on the CPU, through the port's plain versions (``device="cpu"``),
at sizes a test can hold.  Tests marked ``card`` run a cell on a CUDA card
and skip without one; the look for the card is made in the ``card``
fixture, never at import.
"""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent

# a tiny mix: objects of 256 KB (4 blocks of 64 KB) in 64 KB segments, half
# of them noise, each frame read twice
TINY = {"generator": "stdlib_text", "object_MiB": 0.25, "pool": 2,
        "segment_MiB": 0.0625, "noise_share": 0.5, "reads_per_write": 2}
TINY_HC = dict(TINY, object_MiB=0.125)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: runs on a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def add_cell(root: Path, cell: str, config: str, traffic: str,
             metrics=None) -> None:
    """An entry for ``cell`` in the copy's ``BENCHMARK.json``, named in the
    ``workloads`` of ``metrics`` (by default every metric that lists
    cells)."""
    path = root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a tiny cell of the tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and (metrics is None or m["name"] in metrics):
            m["workloads"].append(cell)
    path.write_text(json.dumps(bench, indent=1))


def add_metric(root: Path, kind: str, entry: dict) -> None:
    path = root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench[kind].append(entry)
    path.write_text(json.dumps(bench, indent=1))


def tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark's folder and of ``BENCHMARK.json`` with two
    tiny cells, ``tiny-fast`` and ``tiny-hc``, added as files and entries
    only."""
    root = tmp_path / "codecbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (root / "traffic" / "tiny.json").write_text(json.dumps(TINY))
    (root / "traffic" / "tiny-hc.json").write_text(json.dumps(TINY_HC))
    add_cell(root, "tiny-fast", "lz4-fast-bd", "tiny")
    add_cell(root, "tiny-hc", "lz4-hc9", "tiny-hc")
    return root


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
