"""The port's examples (``examples/torch_*.py``) run end to end on the CPU,
each in a fresh interpreter as a user starts it: the quickstart and the
overlap demo (bytes checked on the device they are given), the train
preset for 2 steps and the serve preset for 2 requests."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, *args, timeout=300):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_quickstart():
    out = _run("torch_quickstart.py", "--device", "cpu")
    assert out.count("OK on cpu") == 2 and "quickstart OK" in out


def test_ckio_overlap():
    out = _run("torch_ckio_overlap.py", "--device", "cpu")
    assert "overlap fraction" in out and "window on cpu: OK" in out


def _last_json(out):
    """The last JSON object a driver printed (its summary)."""
    out = "\n" + out
    start = out.rindex("\n{\n") + 1
    return json.loads(out[start:out.index("\n}\n", start) + 2])


def test_train_preset(tmp_path):
    out = _run("torch_train_lm.py", "--device", "cpu", "--steps", "2",
               "--data", str(tmp_path / "tokens.bin"),
               "--ckpt-dir", str(tmp_path / "ck"))
    assert "arch=qwen2-moe-a2.7b" in out
    summary = _last_json(out)
    assert summary["steps"] == 2 and summary["device"] == "cpu"
    assert summary["ingest"]["device_steps"] == 2


def test_serve_preset(tmp_path):
    out = _run("torch_serve_lm.py", "--device", "cpu", "--requests", "2",
               "--data", str(tmp_path / "prompts.bin"))
    summary = _last_json(out)
    assert summary["mode"] == "static" and summary["requests"] == 2
    assert summary["all_completed"] and summary["new_tokens"] == 16
