"""Whole runs of a cell on the CPU, through the port's plain versions, at a
tiny size: the harness skips only its look for a card.  A sound run is
correct; the control and every planted fault are not.  Also: a run without
a card, or without the port, exits non-zero and prints no result; and a
cell, a configuration, a traffic mix, a generator and a metric added as
files and entries only are found by name."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from codecbench import control, run

from .conftest import REPO, add_cell, add_metric, last_json, tiny_root


def run_cell(capsys, root, cell, wrap=None, trace=0, seed=2**31 + 17):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", str(trace)], device="cpu", wrap=wrap,
                  root=root)
    out, err = capsys.readouterr()
    assert rc == 0, err
    return last_json(out), err


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("cell", ["tiny-fast", "tiny-hc"])
def test_a_sound_run_is_correct(capsys, root, cell):
    res, err = run_cell(capsys, root, cell)
    assert res["correct"] is True, err
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"compress_MBps", "decompress_MBps",
                                   "decompress_p95_ms", "ratio", "setup_s"}
    assert res["build_s"] == 0.0           # no kernel library on the CPU
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert res["checks"]["frames_checked"]["value"] >= 1
    assert res["checks"]["outputs_checked"]["value"] >= 1
    # the last lines of standard error are the checks, each with its limit
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


class Faulty:
    """The system under test with one fault planted in every call."""

    def __init__(self, system, fault):
        self.system, self.fault = system, fault
        self.device = system.device

    def compress(self, data):
        f = self.fault
        if f == "compress_returns_input":
            return bytes(data)
        if f == "compress_half_left_out":
            return self.system.compress(data[:len(data) // 2])
        frame = self.system.compress(data)
        if f == "frame_byte_altered":
            b = bytearray(frame)
            b[len(b) // 2] ^= 0x10
            return bytes(b)
        return frame

    def decompress(self, frame):
        f = self.fault
        if f == "decompress_returns_input":
            return bytes(frame), len(frame)
        content, used = self.system.decompress(frame)
        if f == "decompress_half_left_out":
            return content[:len(content) // 2], used
        if f == "output_byte_altered":
            b = bytearray(content)
            b[len(b) // 3] ^= 0x01
            return bytes(b), used
        return content, used


FAULTS = ["compress_returns_input", "decompress_returns_input",
          "compress_half_left_out", "decompress_half_left_out",
          "frame_byte_altered", "output_byte_altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(capsys, root, fault):
    res, err = run_cell(capsys, root, "tiny-fast",
                        wrap=lambda s: Faulty(s, fault))
    assert res["correct"] is False, fault
    assert any(line.endswith(" FAIL") for line in err.splitlines())


@pytest.mark.parametrize("cell", ["tiny-fast", "tiny-hc"])
def test_the_control_is_not_correct(capsys, root, cell):
    rc = control.main(["--workload", cell, "--seconds", "0.2", "--seeds",
                       "1", "2", "--control-seeds", "3", "4"],
                      device="cpu", root=root)
    assert rc == 0
    res = last_json(capsys.readouterr().out)
    assert res["program_correct"] is True
    assert res["control_incorrect"] is True
    assert all(v == 0 for v in res["lower"].values())
    assert res["upper"]["header_bad"] >= 1


def test_cells_metrics_and_configs_are_found_by_name(capsys, tmp_path):
    """A throwaway configuration, generator, traffic mix, cell and metrics,
    added as files and as entries of ``BENCHMARK.json`` to a copy of the
    benchmark, with no other edit."""
    root = tiny_root(tmp_path)
    (root / "configs" / "lz4-fast-bd-copy.json").write_text(
        (root / "configs" / "lz4-fast-bd.json").read_text())
    add_metric(root, "configs", {
        "name": "lz4-fast-bd-copy", "source": "https://github.com/lz4/lz4",
        "file": "codecbench/configs/lz4-fast-bd-copy.json", "reduced": [],
        "why": "a throwaway copy"})
    (root / "traffic" / "repeated_byte.py").write_text(
        'def make_objects(params, seed):\n'
        '    n = int(params["object_MiB"] * 2**20)\n'
        '    return [bytes([(seed + k) % 251]) * n\n'
        '            for k in range(params["pool"])]\n')
    (root / "traffic" / "throwaway.json").write_text(json.dumps(
        {"generator": "repeated_byte", "object_MiB": 0.125, "pool": 3,
         "reads_per_write": 0}))
    # in no metric's list of cells: only the metrics of every cell
    add_cell(root, "throwaway", "lz4-fast-bd-copy", "throwaway",
             metrics=set())
    (root / "metrics" / "calls_made.py").write_text(
        'def read(run):\n    return len(run.calls)\n')
    add_metric(root, "end_to_end", {
        "name": "calls_made", "unit": "calls", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["throwaway"]})
    # no "workloads": reported where the metric it moves is
    (root / "metrics" / "spans_seen.py").write_text(
        'def read(run):\n    return len(run.trace.spans)\n')
    add_metric(root, "per_layer", {
        "name": "spans_seen", "unit": "spans", "better": "higher",
        "source": "program_span", "layer": "the harness",
        "moves": "compress_MBps"})
    # moves a metric the throwaway cell does not report: left out
    (root / "metrics" / "decode_spans.py").write_text(
        'def read(run):\n    return len(run.trace.spans)\n')
    add_metric(root, "per_layer", {
        "name": "decode_spans", "unit": "spans", "better": "higher",
        "source": "program_span", "layer": "the harness",
        "moves": "decompress_MBps"})
    res, _ = run_cell(capsys, root, "throwaway")
    assert res["correct"] is True
    assert set(res["metrics"]) == {"compress_MBps", "calls_made", "ratio",
                                   "setup_s"}
    assert res["metrics"]["calls_made"] == {"value": res["attempted"],
                                            "unit": "calls"}
    assert res["metrics"]["ratio"]["value"] < 0.01    # one repeated byte
    res, _ = run_cell(capsys, root, "throwaway", trace=1)
    assert set(res["metrics"]) == {"spans_seen"}
    assert res["metrics"]["spans_seen"]["value"] == res["attempted"]
    assert "busy_s" in res["device"] and "breakdown" in res


def _python(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_no_card_exits_nonzero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "codecbench.run", "--workload",
                        "fast-bd.text64m.rw", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_without_the_port_exits_nonzero_with_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark."""
    shutil.copytree(REPO / "codecbench", tmp_path / "codecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "codecbench.run", "--workload",
                        "fast-bd.text64m.rw", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0
    assert not p.stdout.strip().startswith("{")


FORBIDDEN = {"jax", "jaxlib", "flax", "lz4_tpu"}


def test_a_run_loads_no_jax_and_the_reference_no_port(tmp_path):
    """In fresh processes: a whole CPU run of a tiny cell loads no module
    whose top-level name is jax, jaxlib, flax or lz4_tpu (compared whole:
    lz4_tpu_torch begins with lz4_tpu), and the reference loads nothing
    of the port."""
    root = tiny_root(tmp_path)
    code = (
        "import sys, json\n"
        "from codecbench import run\n"
        f"rc = run.main(['--workload', 'tiny-fast', '--seed', '9', "
        f"'--seconds', '0.2', '--trace', '0'], device='cpu', "
        f"root={str(root)!r})\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'rc': rc, 'tops': tops}))\n")
    p = _python(code, REPO)
    res = last_json(p.stdout)
    assert res["rc"] == 0, p.stderr
    assert "lz4_tpu_torch" in res["tops"]
    assert not FORBIDDEN & set(res["tops"])
    code = ("import sys, json\n"
            "import codecbench.reference.lz4frame, "
            "codecbench.reference.xxh32, codecbench.check\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    tops = set(last_json(_python(code, REPO).stdout))
    assert not (FORBIDDEN | {"lz4_tpu_torch", "torch"}) & tops


def test_the_run_refuses_a_forbidden_module(capsys, root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    rc = run.main(["--workload", "tiny-fast", "--seed", "1", "--seconds",
                   "0.1", "--trace", "0"], device="cpu",
                  root=root)
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "jax" in err


@pytest.mark.card
@pytest.mark.parametrize("cell", ["fast-bd.text64m.rw", "hc9.text64m.read8"])
def test_a_cell_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "-m", "codecbench.run", "--workload",
                        cell, "--seed", "2718281828", "--seconds", "3",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = last_json(p.stdout)
    assert res["correct"] is True, p.stderr[-4000:]
    assert res["device"]["platform"] == "gpu"
