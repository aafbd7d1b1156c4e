"""Nothing the harness or the reference loads is JAX, Flax or the JAX
package; the reference loads nothing of the program; no card, no result."""

import os
import shutil
import subprocess
import sys

from trackbench import spec

REPO = os.path.dirname(spec.ROOT)
FORBIDDEN = {"jax", "jaxlib", "flax", "bundletrack_tpu"}


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
                          "for m in sys.modules})))"], cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split("\n")[-2].split())


def test_a_run_loads_no_jax_flax_or_jax_package():
    loaded = _top_level_after("from trackbench.tests.tiny import tiny_run\nassert tiny_run('lfnet.s8', trace=True)"
                              "['correct']\nfrom trackbench import readings, flops")
    assert "bundletrack_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = []
    for dirpath, _, files in os.walk(os.path.join(spec.ROOT, "reference")):
        rel = os.path.relpath(dirpath, REPO).replace(os.sep, ".")
        mods += [f"{rel}.{f[:-3]}" for f in files if f.endswith(".py") and f != "__init__.py"]
    loaded = _top_level_after("\n".join(f"import {m}" for m in mods))
    assert not loaded & (FORBIDDEN | {"bundletrack_tpu_torch"})


def test_without_a_card_there_is_no_result():
    out = subprocess.run([sys.executable, "-m", "trackbench.run", "--workload", "classical.s8", "--seed",
                          str(2**31 + 1), "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.ROOT, tmp_path / "trackbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "trackbench.run", "--workload", "classical.s8", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
